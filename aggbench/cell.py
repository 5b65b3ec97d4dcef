"""A cell of ``BENCHMARK.json``: its configuration and traffic files, the
program's entry that the window drives, and the tiles of one round.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name in ``BENCHMARK.json``:
``configs/<name>.json`` (the ``file`` of the configuration),
``traffic/<name>.json`` and ``metrics/<name>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """{"workload", "config", "traffic", "end_to_end", "per_layer"} of the
    cell named ``workload``: its entry of ``BENCHMARK.json``, its
    configuration's file, its traffic's file, and the metrics of
    ``BENCHMARK.json`` that it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())

    def reports(metric):
        return workload in metric.get("workloads", [workload])

    return {"workload": cell, "config": config, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)]}


def metric_reader(name: str):
    """The ``read(view)`` function of ``metrics/<name>.py``; a metric split
    by cells, ``<quantity>.<cells>``, without a file of its own reads its
    quantity's, ``metrics/<quantity>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"aggbench.metrics.{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def grain(config: dict, traffic: dict) -> int:
    """The entry's dim grain: whole packing columns, times the ChaCha block
    width under ChaCha masks, times the mesh's d shards."""
    g = config["scheme"]["secret_count"]
    if traffic["masking"] == "chacha":
        g = math.lcm(g, 8)
    return g * config.get("mesh", [1, 1])[1]


def tiling(config: dict, traffic: dict) -> tuple:
    """(participant chunk, dim tile) as the entry drives them: the
    configuration's, rounded up to the mesh's p shards and to the grain."""
    ps = config.get("mesh", [1, 1])[0] if config["entry"] == "pod" else 1
    g = grain(config, traffic)
    return (-(-config["participants_chunk"] // ps) * ps,
            -(-config["dim_tile"] // g) * g)


def tiles(config: dict, traffic: dict) -> list:
    """[(rows, width)] of the blocks one round folds, as the entry pads
    them: a tile's width rounded up to the grain; a pod's rows padded to
    the participant chunk, a single device's participant tail kept."""
    P, d = config["participants"], config["dimension"]
    pc, dc = tiling(config, traffic)
    g = grain(config, traffic)
    pod = config["entry"] == "pod"
    out = []
    for d0 in range(0, d, dc):
        width = -(-(min(dc, d - d0)) // g) * g
        for p0 in range(0, P, pc):
            out.append((pc if pod else min(pc, P - p0), width))
    return out


def build_entry(config: dict, traffic: dict, device, chips: int = 1):
    """The program's entry that the window drives, and the modulus: a
    ``StreamingAggregator`` on ``device`` (``"entry": "streaming"``) or a
    ``StreamedPod`` over a mesh of ``config["mesh"]`` shards laid on the
    cell's ``chips`` in turn, from ``device`` on (``"pod"``); both on the
    K1 lane."""
    import torch

    from sda_tpu_torch.fields import numtheory
    from sda_tpu_torch.mesh import StreamedPod, StreamingAggregator, make_mesh
    from sda_tpu_torch.protocol import (ChaChaMasking, FullMasking,
                                        PackedShamirSharing)

    sc = config["scheme"]
    k, n = sc["secret_count"], sc["share_count"]
    t, p, w2, w3 = numtheory.generate_packed_params(k, n, sc["modulus_bits"])
    stated = (sc["privacy_threshold"], config["prime_modulus"])
    if (t, p) != stated:
        raise ValueError(f"the configuration states t={stated[0]}, "
                         f"p={stated[1]}; the parameters give t={t}, p={p}")
    scheme = PackedShamirSharing(k, n, t, p, w2, w3)
    if traffic["masking"] == "chacha":
        masking = ChaChaMasking(p, config["dimension"],
                                traffic["seed_bitsize"])
    elif traffic["masking"] == "full":
        masking = FullMasking(p)
    else:
        raise ValueError(f"unknown masking {traffic['masking']!r}")
    common = dict(participants_chunk=config["participants_chunk"],
                  dim_chunk=config["dim_tile"], use_pallas=True)
    if config["entry"] == "streaming":
        return StreamingAggregator(scheme, masking, device=device,
                                   **common), p
    if config["entry"] == "pod":
        ps, ds = config["mesh"]
        device = torch.device(device)
        devices = [device if device.type != "cuda" else
                   torch.device("cuda", (device.index or 0) + i % chips)
                   for i in range(ps * ds)]
        return StreamedPod(scheme, masking,
                           mesh=make_mesh(ps, ds, devices=devices),
                           **common), p
    raise ValueError(f"unknown entry {config['entry']!r}")
