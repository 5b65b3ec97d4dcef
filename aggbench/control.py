"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, accumulated in float32, which gives
up the exact sum mod p that the configurations state. Its aggregates of as
many rounds as a run makes are judged by the benchmark's own comparison;
each seed must come out not correct. The benchmark's runs never run it.

    python3 aggbench/control.py --workload <cell> --seeds <n> [<n> ...] \\
        [--rounds 32]

Prints one JSON line a seed: the mismatched elements (the number a run
holds to its limit, 0) out of the elements compared.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "aggbench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_reading(cell: dict, seed: int, rounds: int, device) -> dict:
    """Hold ``rounds`` of the control's aggregates to the reference on the
    cell's inputs of ``seed``."""
    import torch

    from aggbench import inputs
    from aggbench.cell import tiling
    from aggbench.reference import Reference, mismatched_elements

    config, traffic = cell["config"], cell["traffic"]
    P, d = config["participants"], config["dimension"]
    pc, dc = tiling(config, traffic)
    p = config["prime_modulus"]
    pool = inputs.make_pool(min(pc, P), min(dc, d), config["value_bits"],
                            seed, device)
    control = Reference(pool, P, d, pc, dc, p, dtype=torch.float32)
    outputs = [(r, control.aggregate(r)) for r in range(rounds)]
    del control
    bad = mismatched_elements(Reference(pool, P, d, pc, dc, p), outputs)
    return {"seed": seed, "rounds": rounds,
            "mismatched_elements": sum(bad.values()),
            "elements": rounds * d,
            "failed_rounds": sum(1 for n in bad.values() if n)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rounds", type=int, default=32)
    args = ap.parse_args(argv)

    import torch

    from aggbench.cell import load_cell

    cell = load_cell(args.workload)
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "device": device,
                          **control_reading(cell, seed, args.rounds,
                                            device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
