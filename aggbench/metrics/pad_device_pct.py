"""The ragged tile's padding's share of the window: the union of the
device events (kernels, copies, memsets) launched from inside the
program's ``stream.feed.pad`` ranges (``mesh/streaming.py::_block_tensor``:
the zero fill and the copy of a block into its padded tile), matched by
``launches.launched_inside``, over the window of complete rounds."""

from aggbench import launches
from aggbench.traceparse import union_us


def read(view):
    if not view.range_us("stream.feed.pad") or view.window_us <= 0:
        return None
    inside = launches.launched_inside(view._trace, "stream.feed.pad")
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in view.device if inside(e)]
    if not spans:
        return None
    return 100.0 * union_us(spans, view.lo, view.hi) / view.window_us
