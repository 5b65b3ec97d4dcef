"""The benchmark of the PyTorch and CUDA port (``sda_tpu_torch``):
streamed secure-aggregation rounds, one cell of ``BENCHMARK.json`` a run
(``python3 aggbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``). Nothing here imports JAX or the JAX package."""
