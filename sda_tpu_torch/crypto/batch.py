"""Bounded crypto worker pool — host-side parallelism for sealed boxes.

libsodium calls go through ctypes, which releases the GIL for the duration
of the C call, so a small thread pool turns the client's per-item
encrypt/decrypt loops into genuinely parallel work on a multicore host.
The pool is shared, lazily created, and bounded (``SDA_CRYPTO_WORKERS``,
default ``min(8, cpu_count)``) so a process full of clients cannot fork an
unbounded thread army; ``SDA_CRYPTO_WORKERS=1`` (or ``0``) disables
threading entirely and every helper degrades to the plain sequential loop
— bit-identical results either way, the pool is a latency optimization,
never a correctness dependency.

``pmap`` is the order-preserving parallel map; ``prefetch_map`` is the
double-buffered pipeline primitive the clerk hot path uses: it yields
batch results in order while keeping the NEXT batch's items in flight on
the pool, so host crypto overlaps the consumer's (device) work without
ever staging more than ``prefetch + 1`` batches of decrypted material.
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
from typing import Callable, Iterator, List, Optional, Sequence, TypeVar

T = TypeVar("T")
R = TypeVar("R")

_lock = threading.Lock()
_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
_pool_workers = 0


def worker_count() -> int:
    """Configured pool width; <=1 means sequential."""
    raw = os.environ.get("SDA_CRYPTO_WORKERS")
    if raw:
        try:
            return max(0, int(raw))
        except ValueError:
            pass
    return min(8, os.cpu_count() or 1)


def _get_pool(workers: int) -> concurrent.futures.ThreadPoolExecutor:
    global _pool, _pool_workers
    with _lock:
        if _pool is None or _pool_workers != workers:
            if _pool is not None:
                _pool.shutdown(wait=False)
            _pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="sda-crypto"
            )
            _pool_workers = workers
        return _pool


def reset() -> None:
    """Tear the shared pool down (tests; safe to call anytime)."""
    global _pool, _pool_workers
    with _lock:
        if _pool is not None:
            _pool.shutdown(wait=False)
        _pool, _pool_workers = None, 0


class _Now:
    """Pre-resolved future look-alike for the sequential fallback."""

    __slots__ = ("_value",)

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


def submit(fn: Callable[[], R]):
    """Run ``fn`` on the pool, returning a ``.result()``-able handle —
    the single-task overlap primitive (e.g. hiding a metadata fetch
    behind the decrypt pipeline). Sequential fallback runs ``fn``
    immediately, preserving call order and fail-fast semantics."""
    if worker_count() <= 1:
        return _Now(fn())
    return _get_pool(worker_count()).submit(fn)


def pmap(fn: Callable[[T], R], items: Sequence[T]) -> List[R]:
    """Order-preserving parallel map over the shared pool.

    Falls back to a plain loop when the pool is disabled or the input is
    too small to amortize the dispatch. The first worker exception
    propagates (remaining futures are cancelled best-effort), matching
    the sequential loop's fail-fast semantics.
    """
    items = list(items)
    workers = worker_count()
    if workers <= 1 or len(items) <= 1:
        return [fn(item) for item in items]
    pool = _get_pool(workers)
    futures = [pool.submit(fn, item) for item in items]
    try:
        return [f.result() for f in futures]
    except BaseException:
        for f in futures:
            f.cancel()
        raise


def prefetch_map(
    fn: Callable[[T], R],
    items: Sequence[T],
    batch_size: int,
    prefetch: int = 1,
) -> Iterator[List[R]]:
    """Yield ``fn``-mapped batches in order, keeping up to ``prefetch``
    later batches' items in flight while the caller consumes the current
    one — the decrypt/combine overlap of the clerk pipeline. Bounded
    staging: at most ``(prefetch + 1) * batch_size`` results exist at
    once. Sequential (zero threads, zero staging beyond one batch) when
    the pool is disabled.
    """
    items = list(items)
    batch_size = max(1, int(batch_size))
    workers = worker_count()
    if workers <= 1:
        for lo in range(0, len(items), batch_size):
            yield [fn(item) for item in items[lo:lo + batch_size]]
        return
    pool = _get_pool(workers)
    pending: List[concurrent.futures.Future] = []
    next_item = 0

    def fill(upto: int) -> None:
        nonlocal next_item
        upto = min(upto, len(items))
        while next_item < upto:
            pending.append(pool.submit(fn, items[next_item]))
            next_item += 1

    lo = 0
    try:
        while lo < len(items):
            hi = min(lo + batch_size, len(items))
            fill(hi + prefetch * batch_size)
            batch = [pending.pop(0).result() for _ in range(hi - lo)]
            yield batch
            lo = hi
    except BaseException:
        for f in pending:
            f.cancel()
        raise
