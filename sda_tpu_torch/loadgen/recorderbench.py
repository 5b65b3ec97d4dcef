"""Flight-recorder overhead benchmark: spans/sec, recorder off vs on.

The recorder's contract (docs/observability.md) is that turning it on is
operationally free — no protocol bytes change and the per-span cost is
one dict build + one buffered line write. This bench holds that promise
the same way every other lever in the BENCH lineage is held: measure the
span hot path with the sink detached, measure it again spooling into a
real segment directory (rotation and eviction armed at realistic caps),
and emit a BENCH-shaped record whose headline ``value`` is
recorder-**on** spans/sec (higher is better) with ``overhead_pct`` riding
as an advisory detail. ci.sh runs it fixed-cap and gates the record
advisory through ``obs/regress.py``.

CLI: ``python -m sda_tpu_torch.loadgen.recorderbench [--spans N]``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

from .. import obs
from ..obs import recorder as recorder_mod

#: Attribute payload shaped like a real server span's (route + ids), so
#: the serialization cost measured is the cost production spans pay.
_ATTRS = {
    "http.method": "POST",
    "http.route": "POST:/v1/aggregations/{id}/participations",
    "request_id": "bench-0000",
    "node_id": "bench-w0",
}


def _spin_spans(n: int) -> float:
    """``n`` parent+child span pairs through the tracer; returns spans/sec
    (2n spans). Events ride on every child like chaos marks would."""
    t0 = time.perf_counter()
    for i in range(n):
        with obs.span("bench.request", attributes=_ATTRS):
            with obs.span("bench.store", attributes={"op": "put", "i": i}):
                obs.add_event("bench.mark", step=i)
    elapsed = time.perf_counter() - t0
    return (2 * n) / elapsed if elapsed > 0 else 0.0


def run_bench(spans: int = 20000, warmup: int = 2000) -> dict:
    """Measure off/on rates in THIS process (the recorder must not be
    already installed) and return the BENCH record dict."""
    if recorder_mod.installed() is not None:
        raise RuntimeError("flight recorder already installed; the off "
                           "rung would not be off")
    pairs = max(1, spans // 2)
    _spin_spans(max(1, warmup // 2))  # warm allocator + ring buffer
    obs.reset_spans()

    off_rate = _spin_spans(pairs)
    obs.reset_spans()

    spool = tempfile.mkdtemp(prefix="sda-recorder-bench-")
    try:
        rec = recorder_mod.install(spool, node_id="bench",
                                   segment_bytes=1 << 20,
                                   max_bytes=8 << 20,
                                   snapshot_s=0.0)
        on_rate = _spin_spans(pairs)
        report = rec.report()
    finally:
        recorder_mod.uninstall()
        shutil.rmtree(spool, ignore_errors=True)
        obs.reset_spans()

    overhead_pct = (
        (off_rate / on_rate - 1.0) * 100.0 if on_rate > 0 else float("inf")
    )
    return {
        "metric": "recorder-on span throughput (2-deep spans with events, "
                  "1MiB segments)",
        "value": round(on_rate, 1),
        "unit": "spans/sec",
        "platform": "cpu",
        "direction": "higher",
        "spans": 2 * pairs,
        "spans_per_sec_off": round(off_rate, 1),
        "spans_per_sec_on": round(on_rate, 1),
        "overhead_pct": round(overhead_pct, 2),
        "segments_written": report["segments_written"],
        "records": report["records"],
        "dropped": report["dropped"],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sda_tpu_torch.loadgen.recorderbench",
        description="flight-recorder span-throughput overhead bench")
    parser.add_argument("--spans", type=int, default=20000,
                        help="spans per rung (default 20000)")
    parser.add_argument("--max-overhead-pct", type=float, default=None,
                        help="exit 1 when overhead exceeds this (a local "
                             "absolute gate on top of the regress lineage)")
    args = parser.parse_args(argv)
    record = run_bench(spans=args.spans)
    print(json.dumps(record))
    if (args.max_overhead_pct is not None
            and record["overhead_pct"] > args.max_overhead_pct):
        print(f"recorder overhead {record['overhead_pct']}% exceeds "
              f"--max-overhead-pct {args.max_overhead_pct}%",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
