"""The model-scale device-plane bench: counterpart of
``sda_tpu/loadgen/devscale.py`` (``sda-sim --devscale`` in the reference).

The full mask -> share -> combine -> reconstruct round at FL-model
dimension (dim >= 1e8), sharded over the ``('p', 'd')`` mesh and streamed
through device memory at the watermark-derived tile width
(``StreamedPod`` over the device block provider; K1 a shard a tile when
``pallas``), with the clerk-pipeline-fed ``DeviceTileSink`` lane in the
same run. One BENCH-style record with the reference's keys:

- ``value`` = ``participants * dim / round_seconds_marginal`` (elements
  a second through the complete round, over the timed rounds after the
  warm one);
- ``exact`` — against the host oracle: full column sums at drill dims,
  seeded sampled windows at model scale; and (``device_oracle``) every
  column of the warm and the last round against the device provider's
  column sums;
- ``retraces`` (0: eager torch compiles nothing) and the stages'
  signatures (``compiled_shapes``: a ragged dim tail is a second one);
- ``roofline_utilization`` and the ``hbm`` watermark advisory
  (``hbm_peak_bytes / watermark``);
- the comparability tags ``dim / p_shards / d_shards / pallas``,

plus ``framework: "torch"`` and ``platform: "cuda" | "cpu"``. The mesh's
``p_shards x d_shards`` shards are placed on the available devices in
turn (all eight of a 4x2 mesh on one card), and each plans its tile under
its share of its device's watermark. ``host_scaled`` marks a CPU run: its
times are the host's, no device metric.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = ["DevScaleProfile", "run_devscale"]

#: the ROADMAP's model-scale rung (``fl/flagship.py::DEVSCALE_DIM``)
DEVSCALE_DIM = 100_000_000


@dataclass
class DevScaleProfile:
    """Knobs for the model-scale round bench."""

    dim: int = DEVSCALE_DIM           # target dimension (>= 1e8 = ROADMAP rung)
    family: Optional[str] = None      # mobilelite | lora | devscale (sets dim)
    participants: int = 8
    participants_chunk: int = 8
    p_shards: Optional[int] = None    # default: gcd(devices, committee)
    d_shards: Optional[int] = None
    clerks: int = 8
    modulus_bits: int = 28            # Solinas prime -> Solinas lane
    mask: str = "full"                # none | full | chacha
    dim_tile: Optional[int] = None    # None -> watermark rule
    pallas: bool = False
    rounds: int = 3                   # 1 warm + (rounds-1) timed
    seed: int = 0
    scan_lane: Optional[bool] = None  # ModelScaleRound A/B (auto: small dims)
    clerk_fed: bool = True            # DeviceTileSink-fed round
    oracle_windows: int = 4
    oracle_window_cols: int = 4096
    device: Optional[str] = None      # CUDA unless "cpu"

    def validate(self) -> None:
        if self.dim <= 0 and not self.family:
            raise ValueError("dim must be positive (or set family)")
        if self.participants <= 0:
            raise ValueError("participants must be positive")
        if self.rounds < 2:
            raise ValueError("rounds must be >= 2 (round 1 is the warmup)")
        if self.mask not in ("none", "full", "chacha"):
            raise ValueError(f"unknown mask {self.mask!r}")


def _oracle_check(out, host_provider, participants, dim, modulus, profile):
    """Bit-exactness vs the host oracle lane: full column sums when the
    host can afford them, seeded sampled windows at model scale."""
    full = dim <= (1 << 17)
    windows = []
    if full:
        windows.append((0, dim))
    else:
        w = min(int(profile.oracle_window_cols), dim)
        rng = np.random.default_rng(profile.seed ^ 0x0AC1E)
        offsets = {0, dim - w}
        for _ in range(max(0, int(profile.oracle_windows) - 2)):
            offsets.add(int(rng.integers(0, max(1, dim - w))))
        windows = sorted((o, o + w) for o in offsets)
    checked = 0
    for d0, d1 in windows:
        block = np.asarray(
            host_provider(0, participants, d0, d1)).astype(np.int64)
        expected = block.sum(axis=0) % modulus
        if not np.array_equal(np.asarray(out[d0:d1]), expected):
            return False, {"mode": "full" if full else "sampled",
                           "windows": len(windows), "cols": checked,
                           "failed_window": [d0, d1]}
        checked += d1 - d0
    return True, {"mode": "full" if full else "sampled",
                  "windows": len(windows), "cols": checked}


def _device_oracle_check(outs, dev_provider, participants, dim, modulus,
                         rows, tile):
    """Every column of each of ``outs`` ([dim] host arrays) against the
    int64 column sum mod ``modulus`` of the device provider's rows, built
    ``rows`` x ``tile`` at a time on the provider's device: independent of
    the round, and a full check at model scale, where the host oracle can
    only sample."""
    import torch

    checked = 0
    for d0 in range(0, dim, tile):
        d1 = min(d0 + tile, dim)
        acc = None
        for p0 in range(0, participants, rows):
            part = dev_provider(p0, min(p0 + rows, participants), d0, d1)
            part = part.to(torch.int64).sum(0)
            acc = part if acc is None else acc + part
        expected = (acc % modulus).cpu().numpy()
        for out in outs:
            if not np.array_equal(np.asarray(out[d0:d1]), expected):
                return False, {"cols": checked, "outputs": len(outs),
                               "failed_window": [d0, d1]}
        checked += d1 - d0
    return True, {"cols": checked, "outputs": len(outs)}


def run_devscale(profile: DevScaleProfile) -> dict:
    """Run the model-scale round bench and return the BENCH record."""
    profile.validate()
    from .. import obs
    from ..fields import numtheory
    from ..mesh import default_mesh_shape, make_mesh
    from ..mesh.simpod import _device_list
    from ..obs import devprof
    from ..protocol import (
        ChaChaMasking,
        FullMasking,
        NoMasking,
        PackedShamirSharing,
    )

    dim = int(profile.dim)
    if profile.family:
        from ..fl.flagship import flagship_dim

        dim = flagship_dim(profile.family)

    k = 3
    t, p, w2, w3 = numtheory.generate_packed_params(
        k, profile.clerks, profile.modulus_bits)
    scheme = PackedShamirSharing(k, profile.clerks, t, p, w2, w3)
    masking = {
        "none": NoMasking(),
        "full": FullMasking(p),
        "chacha": ChaChaMasking(p, dim, 128),
    }[profile.mask]

    devices = _device_list(None if profile.device is None
                           else [profile.device])
    n_devices = len(devices)
    p_shards = profile.p_shards or default_mesh_shape(
        n_devices, scheme.output_size)[0]
    d_shards = profile.d_shards or max(1, n_devices // p_shards)
    # the shards in turn on the available devices
    mesh = make_mesh(p_shards, d_shards, devices=[
        devices[i % n_devices] for i in range(p_shards * d_shards)])

    obs.reset_all()
    capture_was = devprof.cost_analysis_enabled()
    devprof.enable_cost_analysis()
    try:
        return _run(profile, dim, scheme, masking, mesh)
    finally:
        devprof.enable_cost_analysis(capture_was)


def _run(profile, dim, scheme, masking, mesh) -> dict:
    from ..mesh import (DeviceTileSink, ModelScaleRound, StreamedPod,
                        watermark_dim_tile)
    from ..mesh.streaming import (
        synthetic_block_provider32,
        synthetic_device_block_provider32,
    )
    from ..obs import devprof
    from ..utils import metrics

    p = scheme.prime_modulus
    family = profile.family
    p_shards, d_shards = mesh.devices.shape
    home = mesh.devices[0, 0]
    platform = home.type
    cpu = platform == "cpu"

    watermark = devprof.hbm_watermark(home)
    dim_tile = profile.dim_tile or watermark_dim_tile(
        scheme, masking, participants_chunk=profile.participants_chunk,
        p_shards=p_shards, d_shards=d_shards, pallas=profile.pallas,
        watermark_bytes=watermark, dim=dim,
        shards_per_device=mesh.shards_per_device())

    pod = StreamedPod(
        scheme, masking, mesh=mesh,
        participants_chunk=profile.participants_chunk,
        dim_chunk=dim_tile, use_pallas=profile.pallas)
    dev_provider = synthetic_device_block_provider32(p, seed=profile.seed,
                                                     device=home)
    host_provider = synthetic_block_provider32(p, seed=profile.seed)
    P_total = profile.participants

    wall0 = time.perf_counter()
    out = pod.aggregate_blocks(dev_provider, P_total, dim, profile.seed)
    warm_s = time.perf_counter() - wall0
    out_warm = out

    def _stage_compiles():
        return {name: (devprof.profile(name).compiles,
                       len(devprof.profile(name).shapes))
                for name in ("stream.pod.step", "stream.pod.finale")}

    compiles_after_warm = _stage_compiles()
    t0 = time.perf_counter()
    for r in range(1, profile.rounds):
        out = pod.aggregate_blocks(dev_provider, P_total, dim,
                                   profile.seed + r)
    timed_s = time.perf_counter() - t0
    per_round = timed_s / max(1, profile.rounds - 1)
    compiles_after = _stage_compiles()
    retraces = metrics.counter_report("xla.compile.retrace").get(
        "xla.compile.retrace", 0)
    warm_reused = compiles_after == compiles_after_warm

    exact, oracle = _oracle_check(
        out, host_provider, P_total, dim, p, profile)
    device_exact, device_oracle = _device_oracle_check(
        (out_warm, out), dev_provider, P_total, dim, p,
        pod.participants_chunk, pod.dim_chunk)
    exact = exact and device_exact

    # -- clerk-pipeline-fed device tiles: the decode stage (standing in
    # for the decrypt pipeline's product) runs on the crypto pool and
    # lands uint32 tiles on the card ahead of the consumer; the SAME round
    # seed must reveal the SAME bytes as the device-generated lane
    clerk_fed = None
    if profile.clerk_fed:
        sink = DeviceTileSink(
            host_provider, P_total, dim, pod.participants_chunk,
            pod.dim_chunk, device=home)
        s0 = time.perf_counter()
        out_sink = pod.aggregate_blocks(sink.provider(), P_total, dim,
                                        profile.seed)
        sink_s = time.perf_counter() - s0
        clerk_fed = {
            "exact": bool(np.array_equal(out_sink, out_warm)),
            "round_seconds": round(sink_s, 4),
            "sink_hits": metrics.counter_report("devscale.sink.").get(
                "devscale.sink.hit", 0),
            "sink_misses": metrics.counter_report("devscale.sink.").get(
                "devscale.sink.miss", 0),
        }

    # -- the tile round (ModelScaleRound): A/B'd when the sharded input is
    # small enough to materialize
    scan_lane = profile.scan_lane
    if scan_lane is None:
        scan_lane = dim * P_total <= (1 << 24)
    scan = None
    if scan_lane:
        inputs = np.asarray(host_provider(0, P_total, 0, dim))
        msr = ModelScaleRound(scheme, masking, mesh=mesh,
                              dim_tile=dim_tile, use_pallas=profile.pallas)
        s0 = time.perf_counter()
        out_scan = msr.aggregate(inputs, profile.seed)
        scan_s = time.perf_counter() - s0
        expected = inputs.astype(np.int64).sum(axis=0) % p
        scan = {
            "exact": bool(np.array_equal(out_scan.cpu().numpy(), expected)),
            "round_seconds": round(scan_s, 4),
            "dim_tile": msr.dim_tile,
        }

    wall = time.perf_counter() - wall0
    roofline = devprof.roofline(seconds=wall, platform=platform)
    hbm = devprof.watermark_report(device=home)
    value = P_total * dim / per_round if per_round > 0 else 0

    tiles = -(-dim // pod.dim_chunk)
    record = {
        "metric": ("model-scale device round elements/sec "
                   "(packed-Shamir n=%d, %s mask, sharded+streamed)"
                   % (profile.clerks, profile.mask)),
        "value": round(value),
        "unit": "elements/sec",
        "framework": "torch",
        "platform": platform,
        "pallas": bool(pod.pallas_active),
        "dim": dim,
        "participants": P_total,
        "p_shards": p_shards,
        "d_shards": d_shards,
        "dim_tile": pod.dim_chunk,
        "tiles": tiles,
        "participants_chunk": pod.participants_chunk,
        "tile_rule": ("explicit" if profile.dim_tile
                      else "hbm_watermark"),
        "rounds": profile.rounds,
        "round_seconds_marginal": round(per_round, 4),
        "compile_seconds": round(max(0.0, warm_s - per_round), 2),
        "exact": bool(exact),
        "oracle": oracle,
        "device_oracle": device_oracle,
        "retraces": int(retraces),
        "warm_program_reused": bool(warm_reused),
        "compiled_shapes": {name: shapes for name, (comp, shapes)
                            in compiles_after.items()},
        "roofline": roofline,
        "roofline_utilization": roofline.get("utilization"),
        "hbm": hbm,
        "hbm_watermark_ratio": hbm.get("hbm_watermark_ratio"),
        "host_scaled": cpu,
        "seed": profile.seed,
        "xla": devprof.compile_totals(),
    }
    if family:
        record["family"] = family
    if clerk_fed is not None:
        record["clerk_fed"] = clerk_fed
    if scan is not None:
        record["scan_lane"] = scan
    if cpu:
        record["note"] = ("CPU stand-in: same schedule and verdicts as a "
                          "card run; its times are the host's")
    record["ok"] = bool(
        exact and retraces == 0 and warm_reused
        and (clerk_fed is None or clerk_fed["exact"])
        and (scan is None or scan["exact"])
        and hbm.get("within_watermark", True))
    return record
