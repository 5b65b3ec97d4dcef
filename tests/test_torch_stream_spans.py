"""The streamed round's ranges outside the kernels, read from a
``torch.profiler`` trace of a round on the CPU: each ``stream.finale``
holds one ``stream.finale.reveal``, one ``.copy`` and one ``.store``, in
that order; ``stream.feed.pad`` opens once for each chunk of a ragged dim
tile, inside its ``stream.feed``, and never for an aligned tile; the
phase registry counts what the trace holds. For the single-device
``StreamingAggregator`` and for a 1x1 ``StreamedPod``."""

import json

import numpy as np
import pytest
import torch

from sda_tpu_torch.mesh import StreamedPod, StreamingAggregator, make_mesh
from sda_tpu_torch.protocol import FullMasking, PackedShamirSharing
from sda_tpu_torch.utils import phase_report, reset_phase_report

GOLDEN = PackedShamirSharing(3, 8, 4, 433, 354, 150)
PARTS = ("stream.finale.reveal", "stream.finale.copy", "stream.finale.store")
NAMES = ("stream.feed", "stream.feed.pad", "stream.finale") + PARTS


def _entry(kind):
    """(entry, participants, participant chunk); the pod pads a ragged
    participant chunk too, so its participants fill whole chunks."""
    if kind == "streaming":
        return StreamingAggregator(GOLDEN, FullMasking(433),
                                   participants_chunk=4, dim_chunk=24,
                                   device="cpu"), 10, 4
    return StreamedPod(GOLDEN, FullMasking(433),
                       mesh=make_mesh(1, 1, devices=["cpu"]),
                       participants_chunk=4, dim_chunk=24), 8, 4


def _traced_round(entry, participants, dim, tmp_path):
    """The round's output and {range name: sorted [(start, end)]} of its
    host ranges in the exported Chrome trace."""
    x = np.random.default_rng(5).integers(0, 433, size=(participants, dim))
    reset_phase_report()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = entry.aggregate(x, seed=7)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = {name: sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                           for e in events
                           if e.get("ph") == "X" and e.get("name") == name)
              for name in NAMES}
    np.testing.assert_array_equal(out, x.sum(axis=0) % 433)
    return ranges


def _inside(span, outer):
    return outer[0] <= span[0] and span[1] <= outer[1]


@pytest.mark.parametrize("kind", ["streaming", "pod"])
def test_each_finale_holds_reveal_copy_store_in_order(kind, tmp_path):
    entry, participants, _ = _entry(kind)
    ranges = _traced_round(entry, participants, 61, tmp_path)
    finales = ranges["stream.finale"]
    assert len(finales) == 3  # dim tiles of 24, 24 and 13
    for finale in finales:
        parts = [[s for s in ranges[name] if _inside(s, finale)]
                 for name in PARTS]
        assert [len(p) for p in parts] == [1, 1, 1]
        (reveal,), (copy,), (store,) = parts
        assert reveal[1] <= copy[0] and copy[1] <= store[0]
    assert all(len(ranges[name]) == 3 for name in PARTS)


@pytest.mark.parametrize("kind", ["streaming", "pod"])
def test_padding_opens_once_a_chunk_of_the_ragged_tile(kind, tmp_path):
    entry, participants, pc = _entry(kind)
    ranges = _traced_round(entry, participants, 61, tmp_path)
    chunks = -(-participants // pc)
    feeds = ranges["stream.feed"]
    assert len(feeds) == 3 * chunks
    pads = ranges["stream.feed.pad"]
    # the last dim tile's feeds, and no other, each hold one pad
    assert len(pads) == chunks
    for i, feed in enumerate(feeds):
        held = [p for p in pads if _inside(p, feed)]
        assert len(held) == (1 if i >= 2 * chunks else 0)


@pytest.mark.parametrize("kind", ["streaming", "pod"])
def test_an_aligned_dimension_pads_nothing(kind, tmp_path):
    entry, participants, _ = _entry(kind)
    ranges = _traced_round(entry, participants, 60, tmp_path)
    assert ranges["stream.feed"]
    assert ranges["stream.feed.pad"] == []


@pytest.mark.parametrize("kind", ["streaming", "pod"])
def test_phase_report_counts_what_the_trace_holds(kind, tmp_path):
    entry, participants, _ = _entry(kind)
    ranges = _traced_round(entry, participants, 61, tmp_path)
    report = phase_report()
    for name in NAMES:
        assert report[name]["count"] == len(ranges[name]), name
