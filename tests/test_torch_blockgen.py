"""K6, the device block provider's coordinate hash
(``sda_tpu_torch/fields/blockgen.py``, ``csrc/blockgen.cu``), on the CPU:
the plain provider bit for bit against the JAX package's jitted
``synthetic_device_block_provider32`` and its host provider, at offsets
across 2^32; the kernel's host-side arithmetic (the remainder multiplier,
the wrapped coordinates, the seed word) emulated in numpy and held to
``%`` and to the plain version; the wrapper's CPU leg and its bound."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sda_tpu.mesh import streaming as ref_streaming

from sda_tpu_torch.benchmarks import bounds
from sda_tpu_torch.fields import blockgen, numtheory
from sda_tpu_torch.mesh import (synthetic_block_provider32,
                                synthetic_device_block_provider32)

P29 = numtheory.generate_packed_params(3, 8, 28)[1]
#: the bounds the port's paths take: the flagship prime, the inputs'
#: 2^20, the widest bound and the tests' small prime
BOUNDS = [(P29, None), (P29, 1 << 20), (P29, 0xFFFFFFFF), (433, None)]
SEEDS = [0, 4, 7]
SHAPES = [(1, 1), (5, 17), (3, 1003)]
#: (p0, d0): the origin, rows across 2^32, columns across 2^32, both
OFFSETS = [(0, 0), ((1 << 32) - 3, 11), (6, (1 << 32) - 8),
           ((1 << 32) - 2, (1 << 32) - 5)]
#: the divisors whose multipliers are most likely to go wrong: 1 (M wraps
#: to 0), powers of two, small and large odd ones, 2^32 - 1
EDGE_DIVISORS = [1, 2, 3, 433, P29, 1 << 20, 1 << 31, (1 << 32) - 1]
U32 = np.uint64(0xFFFFFFFF)


def _fastmod_np(x, bound: int, mult: int):
    """K6's remainder (``csrc/blockgen.cu::fastmod``) in numpy uint64:
    low = M * x mod 2^64, then the high 64 bits of low * bound from the
    32-bit halves of low."""
    x = np.asarray(x, dtype=np.uint64)
    b, m = np.uint64(bound), np.uint64(mult)
    with np.errstate(over="ignore"):
        low = m * x
    l0, l1 = low & U32, low >> np.uint64(32)
    t = l1 * b + ((l0 * b) >> np.uint64(32))
    return t >> np.uint64(32)


def _kernel_np(args, rows: int, cols: int):
    """K6's block from its launch scalars, as the kernel computes it: the
    row's word once, each column's product, the hash, the remainder."""
    p0w, d0w, sd, bound, mult = args
    with np.errstate(over="ignore"):
        r = (np.uint32(p0w) + np.arange(rows, dtype=np.uint32))[:, None]
        c = (np.uint32(d0w) + np.arange(cols, dtype=np.uint32))[None, :]
        rw = r * np.uint32(0x9E3779B1) ^ np.uint32(sd)
        x = rw ^ c * np.uint32(0x85EBCA77)
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x846CA68B)
        x = x ^ (x >> np.uint32(16))
    return _fastmod_np(x, bound, mult).astype(np.int64)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("modulus,max_value", BOUNDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_plain_provider_is_the_jax_device_provider(seed, modulus, max_value,
                                                   shape):
    """The port's device provider on the CPU (K6's plain version) gives the
    JAX package's jitted provider's values and its host provider's, at
    every offset, across 2^32 in rows and columns."""
    port = synthetic_device_block_provider32(modulus, seed=seed,
                                             max_value=max_value,
                                             device="cpu")
    ref = ref_streaming.synthetic_device_block_provider32(
        modulus, seed=seed, max_value=max_value)
    host = synthetic_block_provider32(modulus, seed=seed,
                                      max_value=max_value)
    rows, cols = shape
    for p0, d0 in OFFSETS:
        coords = (p0, p0 + rows, d0, d0 + cols)
        blk = port(*coords)
        assert blk.dtype == torch.int64 and blk.shape == shape
        assert blk.is_contiguous()
        want = np.asarray(ref(*coords)).astype(np.int64)
        np.testing.assert_array_equal(blk.numpy(), want)
        np.testing.assert_array_equal(blk.numpy(), host(*coords))


@pytest.mark.parametrize("bound", EDGE_DIVISORS)
def test_fastmod_at_the_edges(bound):
    """The remainder formula at the x most likely to break it: around each
    multiple of the bound that fits, and the ends of the uint32 range."""
    mult = blockgen.fastmod_multiplier(bound)
    q = np.array([0, 1, 2, (1 << 32) // bound - 1, (1 << 32) // bound],
                 dtype=np.uint64)
    x = np.concatenate([q * np.uint64(bound) + np.uint64(d)
                        for d in (0, 1, bound - 1)]
                       + [np.array([0, 1, (1 << 32) - 2, (1 << 32) - 1],
                                   dtype=np.uint64)])
    x = x[x < np.uint64(1 << 32)]
    np.testing.assert_array_equal(_fastmod_np(x, bound, mult),
                                  x % np.uint64(bound))


@settings(max_examples=300, deadline=None)
@given(xs=st.lists(st.integers(0, (1 << 32) - 1), min_size=1, max_size=64),
       bound=st.one_of(st.sampled_from(EDGE_DIVISORS),
                       st.integers(1, (1 << 32) - 1)))
def test_fastmod_is_the_remainder(xs, bound):
    """K6's host multiplier and device formula give x % b for any x < 2^32
    and any 0 < b < 2^32."""
    x = np.array(xs, dtype=np.uint64)
    got = _fastmod_np(x, bound, blockgen.fastmod_multiplier(bound))
    np.testing.assert_array_equal(got, x % np.uint64(bound))


def test_fastmod_multiplier_values():
    """M = floor((2^64 - 1) / b) + 1 mod 2^64: 0 for b = 1 (it wraps),
    2^64 / b for a power of two."""
    assert blockgen.fastmod_multiplier(1) == 0
    assert blockgen.fastmod_multiplier(2) == 1 << 63
    assert blockgen.fastmod_multiplier(1 << 31) == 1 << 33
    assert blockgen.fastmod_multiplier(3) == (1 << 64) // 3 + 1
    for bad in (0, -1, 1 << 32):
        with pytest.raises(ValueError, match="fit uint32"):
            blockgen.fastmod_multiplier(bad)


@pytest.mark.parametrize("p0,d0", [(0, 0), ((1 << 32) - 3, 11),
                                   (6, (1 << 32) - 8), ((1 << 32) + 5, 3),
                                   (2, (1 << 33) + 1)])
@pytest.mark.parametrize("seed", SEEDS + [(1 << 40) + 9])
@pytest.mark.parametrize("bound", [P29, 1 << 20, 0xFFFFFFFF, 433, 1])
def test_launch_args_emulated_are_the_plain_block(p0, d0, seed, bound):
    """K6's launch scalars (coordinates and seed word mod 2^32, the bound
    and its multiplier) through the kernel's arithmetic in numpy give the
    plain block, whose coordinates wrap mod 2^32 as the reference's uint32
    arithmetic does (the host provider's at the wrapped offsets)."""
    args = blockgen.launch_args(p0, d0, seed, bound)
    assert args[:3] == (p0 & 0xFFFFFFFF, d0 & 0xFFFFFFFF,
                        (seed ^ 0x5851F42D) & 0xFFFFFFFF)
    assert args[3:] == (bound, blockgen.fastmod_multiplier(bound))
    rows, cols = 4, 21
    plain = blockgen.block_plain(p0, p0 + rows, d0, d0 + cols, seed, bound,
                                 "cpu")
    np.testing.assert_array_equal(_kernel_np(args, rows, cols), plain.numpy())
    # the host provider takes offsets below 2^32: beyond, the plain block
    # is the host's at the wrapped offsets
    p0w, d0w = args[:2]
    host = synthetic_block_provider32(bound, seed=seed)(p0w, p0w + rows, d0w,
                                                        d0w + cols)
    np.testing.assert_array_equal(plain.numpy(), host)


def test_wrapper_cpu_leg_counts_no_launch():
    """On the CPU the wrapper runs the plain version and counts no launch;
    an empty block is an empty tensor; a reversed one raises; without a
    device it asks for CUDA, which is absent here."""
    before = blockgen.coordinate_block.launches
    out = blockgen.coordinate_block(3, 5, 7, 10, 4, 433, "cpu")
    np.testing.assert_array_equal(
        out.numpy(), blockgen.block_plain(3, 5, 7, 10, 4, 433, "cpu").numpy())
    assert blockgen.coordinate_block(3, 3, 7, 10, 4, 433, "cpu").shape == (
        0, 3)
    assert blockgen.coordinate_block.launches == before
    with pytest.raises(ValueError, match="reversed"):
        blockgen.coordinate_block(5, 3, 0, 1, 0, 433, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            blockgen.coordinate_block(0, 1, 0, 1, 0, 433)


def test_blockgen_bound_at_the_streamed_tile():
    """K6's bound at the streamed round's tile [250, 3,145,728]: its bytes,
    8 a value written, 1.878 ms at the memory rate, bind before its
    operations."""
    ms, by, detail = bounds.blockgen_bound(250, 3_145_728)
    assert by == "bytes"
    assert ms == pytest.approx(8 * 250 * 3_145_728 / 3.35e12 * 1e3)
    assert round(ms, 3) == 1.878
    assert detail.startswith("6291456000 bytes -> 1.8780 ms")
    ops_ms = max(7 * 250 * 3_145_728 / bounds.PIPE_OPS_PER_S,
                 14 * 250 * 3_145_728 / bounds.INSTR_PER_S) * 1e3
    assert ops_ms < ms
    # counted from a compiled loop's mix instead: operations bind when an
    # element takes more than ~40 on a pipe
    assert bounds.blockgen_bound(250, 3_145_728, alu_ops=41)[1] == (
        "operations")
