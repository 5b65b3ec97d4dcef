"""Helpers shared by the port's benchmarks and smoke runs."""
