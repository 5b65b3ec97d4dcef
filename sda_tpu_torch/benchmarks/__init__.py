"""Benchmarks of the port: counterparts of the repo's ``benchmarks/``
scripts, run as ``python -m sda_tpu_torch.benchmarks.<name>``."""
