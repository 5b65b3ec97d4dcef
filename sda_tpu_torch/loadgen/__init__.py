"""Load & capacity plane: open/closed-loop workload generation against the
real HTTP stack, with per-route latency histograms and capacity reports.

The measurement counterpart to ``sda_tpu_torch.chaos``: chaos proves the round
survives faults, loadgen proves (and quantifies) how it survives traffic —
sustained RPS, p50/p95/p99 tails per route, shed/retry behavior under the
server's admission control. Entry points: ``sda-sim --load`` (CLI) and
``run_load`` (tests, notebooks). ``docs/load.md`` has the tuning guide.
"""

from .connstorm import ConnstormProfile, run_connstorm
from .devscale import DevScaleProfile, run_devscale
from .driver import (
    LoadProfile,
    latency_report_ms,
    run_fleet_scaling,
    run_load,
)
from .pickup import PickupProfile, run_pickup_bench

# ``inputbench`` (the participation input-path micro-bench behind
# ``python -m sda_tpu_torch.loadgen.inputbench``) is intentionally NOT imported
# eagerly: importing a ``-m`` target from its package __init__ trips
# runpy's double-import warning. ``from sda_tpu_torch.loadgen.inputbench import
# run_input_bench`` for programmatic use.
__all__ = ["ConnstormProfile", "DevScaleProfile", "LoadProfile",
           "PickupProfile", "latency_report_ms", "run_connstorm",
           "run_devscale", "run_fleet_scaling", "run_load",
           "run_pickup_bench"]
