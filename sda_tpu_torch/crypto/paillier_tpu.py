"""Batched Paillier ciphertext premixing on the device (K4) — port of
``sda_tpu/crypto/paillier_tpu.py``.

The server's Paillier hot loop is the homomorphic premix: folding P
ciphertexts per (clerk, slot) by multiplication mod n^2 (reference server
snapshot premixing, server/src/snapshot.rs:4-47, with the PackedPaillier
scheme, protocol/src/crypto.rs:164-174). The JAX package runs it as jnp
Montgomery lanes over 8-bit limbs in int32 (the TPU's VPU has no wide
multiply); here it is a hand-written CUDA kernel for Hopper
(``fields/csrc/montgomery.cu``, built by ``fields._build``) over 32-bit
limbs. This module holds

- ``MontgomeryContext``: the limb constants of an odd modulus m, with
  L = ceil(bits(m) / 32) limbs and R = 2^(32 L) (the reference's R is
  256^ceil(bits(m) / 8): the two agree only when bits(m) is a multiple of
  32, so ``mont_mul`` is held to a * b * R^-1 mod m with THIS R, and
  ``premix``, which does not depend on R, to the reference's integers);
  host conversion between Python ints and [B, L] int32 limb tensors (the
  bits of uint32 limbs, least significant first), ``fold_fix``,
  ``mont_mul``, ``premix_limbs`` and the host API ``premix``;
- ``montgomery_kernel``: the wrapper of the C entries. For CUDA tensors
  it launches K4 on the current stream (a launch error raises
  RuntimeError) and counts the launch in ``montgomery_kernel.launches``
  and by operation in ``montgomery_kernel.op_launches``; for CPU tensors
  it runs the plain version. Every L runs on the card: 32, 64 and 128
  limbs (512-, 1024- and 2048-bit keys) on unrolled instances, any other
  on the wide instance;
- the plain versions ``mont_mul_plain`` and ``premix_plain``: the same
  functions in int64 torch, CIOS over 2L limbs of 16 bits (products stay
  below 2^32) with the same R, so they give K4's exact integers. They are
  what the wrapper runs on the CPU, and what tests and ``chip_smoke.py``
  hold the kernel to; no CUDA path calls them.

Folding P normal-form ciphertexts through montmul leaves
prod * R^-(P-1) whatever the order; one last montmul by R^P mod m
(``fold_fix``) restores the exact product, so no ciphertext is converted
into or out of the Montgomery domain. The kernel folds the rows as a tree,
one launch a level (P/2 row pairs x B lanes at the first), the odd row of a
level passing through unchanged.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import List, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..fields import _build

_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF
#: the limb counts with an unrolled instance of K4 (n^2 of 512-, 1024- and
#: 2048-bit keys); every other L runs the wide instance
UNROLLED_LIMBS = (32, 64, 128)
#: the wide instance's threads at most (a grid-stride loop): bounds its
#: workspace of L + 2 words a thread (50 MB at L = 192)
WIDE_THREADS = 1 << 16
OPS = ("mont_mul", "fold", "fix")


class MontgomeryContext:
    """Precomputed 32-bit-limb constants for an odd modulus."""

    def __init__(self, modulus: int):
        if modulus <= 0 or modulus % 2 == 0:
            raise ValueError("Montgomery requires a positive odd modulus")
        self.modulus = modulus
        self.L = (modulus.bit_length() + 31) // 32
        #: m's uint32 limbs, least significant first
        self.m_words = [int(w) for w in np.frombuffer(
            modulus.to_bytes(4 * self.L, "little"), dtype="<u4")]
        # n' = -m^-1 mod 2^32 (m odd -> invertible)
        self.n_prime = (-pow(modulus, -1, 1 << 32)) % (1 << 32)
        self.R = pow(2, 32 * self.L, modulus)

    # -- host <-> limb conversion ----------------------------------------
    def to_limbs(self, values: Sequence[int]) -> np.ndarray:
        """[B] Python ints (each in [0, modulus)) -> [B, L] int32 limbs."""
        width = 4 * self.L
        raw = bytearray()
        for v in values:
            if not 0 <= v < self.modulus:
                raise ValueError("value out of range for modulus")
            raw += v.to_bytes(width, "little")
        # a bytearray gives a writable array without a copy
        return np.frombuffer(raw, dtype=np.int32).reshape(len(values), self.L)

    def from_limbs(self, arr) -> List[int]:
        """[B, L] int32 (or uint32) limbs, tensor or array -> [B] Python
        ints."""
        if isinstance(arr, torch.Tensor):
            arr = arr.cpu().numpy()
        a = np.ascontiguousarray(arr).view("<u4")
        if a.ndim != 2 or a.shape[1] != self.L:
            raise ValueError(f"limbs must be [B, {self.L}], got {a.shape}")
        raw = a.tobytes()
        width = 4 * self.L
        return [int.from_bytes(raw[i:i + width], "little")
                for i in range(0, len(raw), width)]

    def fold_fix(self, count: int) -> np.ndarray:
        """[L] limbs of R^count mod m: folding ``count`` normal-form
        factors through montmul leaves prod * R^-(count-1); one final
        montmul by this constant (another * R^-1) restores the product."""
        return self.to_limbs([pow(self.R, count, self.modulus)])[0]

    # -- on a device ------------------------------------------------------
    def mont_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """[B, L] int32 limbs a, b (each below m) -> a * b * R^-1 mod m,
        fully reduced, on their device."""
        return montgomery_kernel("mont_mul", self, a, b)

    def premix_limbs(self, cts: torch.Tensor) -> torch.Tensor:
        """[P, B, L] int32 limbs of normal-form values below m -> [B, L]
        limbs of their product over P, mod m, on their device."""
        fix = torch.from_numpy(self.fold_fix(cts.shape[0]))
        return montgomery_kernel("fold", self, cts, fix.to(cts.device))

    def premix(self, cts_ints: Sequence[Sequence[int]], device=None
               ) -> List[int]:
        """Host API: [P][B] Python-int ciphertexts -> [B] products mod m,
        folded on ``device`` (CUDA unless ``device="cpu"``)."""
        dev = resolve_device(device)
        P = len(cts_ints)
        if P == 0:
            raise ValueError("nothing to premix")
        B = len(cts_ints[0])
        flat = [v for row in cts_ints for v in row]
        if len(flat) != P * B:
            raise ValueError("premix rows differ in length")
        cts = torch.from_numpy(self.to_limbs(flat).reshape(P, B, self.L))
        return self.from_limbs(self.premix_limbs(cts.to(dev)))


# ---------------------------------------------------------------------------
# Plain versions (int64 torch, any device): CIOS over 2L 16-bit limbs

def _to16(x: torch.Tensor) -> torch.Tensor:
    """[..., L] 32-bit limbs (int32 bits, or int64 words) -> [..., 2L]
    int64 16-bit limbs."""
    w = x.to(torch.int64) & _MASK32
    return torch.stack([w & _MASK16, w >> 16], dim=-1).flatten(-2)


def _from16(h: torch.Tensor) -> torch.Tensor:
    """[..., 2L] int64 16-bit limbs -> [..., L] int32 limb bits."""
    pairs = h.unflatten(-1, (h.shape[-1] // 2, 2))
    w = pairs[..., 0] | (pairs[..., 1] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _mont_mul16(a16, b16, m16, n16: int):
    """[N, H] 16-bit limbs (H = 2L) -> a * b * 2^(-16 H) mod m, canonical
    [N, H]. Redundant CIOS: H steps of [N, H] multiply-accumulates with
    columns below 2^42, one carry pass, one conditional subtract."""
    N, H = a16.shape
    t = torch.zeros((N, H + 1), dtype=torch.int64, device=a16.device)
    for i in range(H):
        t[:, :H] += a16[:, i:i + 1] * b16
        u = ((t[:, 0] & _MASK16) * n16) & _MASK16
        t[:, :H] += u[:, None] * m16[None, :]
        c0 = t[:, 0] >> 16  # t[:, 0] == 0 mod 2^16 by the choice of u
        t = torch.cat([t[:, 1:], torch.zeros_like(t[:, :1])], dim=1)
        t[:, 0] += c0
    # carry-normalise to canonical 16-bit limbs (the value is below 2m)
    cols = []
    carry = torch.zeros(N, dtype=torch.int64, device=a16.device)
    for j in range(H + 1):
        tot = t[:, j] + carry
        cols.append(tot & _MASK16)
        carry = tot >> 16
    t = torch.stack(cols, dim=1)
    # subtract m once where t >= m
    borrow = torch.zeros(N, dtype=torch.int64, device=a16.device)
    diff = []
    for j in range(H + 1):
        d = t[:, j] - (m16[j] if j < H else 0) - borrow
        diff.append(d & _MASK16)
        borrow = (d < 0).to(torch.int64)
    take = (borrow == 0)[:, None]
    return torch.where(take, torch.stack(diff, dim=1), t)[:, :H]


def _plain_constants(ctx: MontgomeryContext, device):
    m16 = _to16(torch.tensor(ctx.m_words, dtype=torch.int64, device=device))
    return m16, (-pow(ctx.modulus, -1, 1 << 16)) % (1 << 16)


def mont_mul_plain(ctx: MontgomeryContext, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """K4's ``mont_mul`` in plain torch: [B, L] int32 limbs a, b ->
    a * b * R^-1 mod m, R = 2^(32 L), as [B, L] int32 limbs."""
    m16, n16 = _plain_constants(ctx, a.device)
    return _from16(_mont_mul16(_to16(a), _to16(b), m16, n16))


def premix_plain(ctx: MontgomeryContext, cts: torch.Tensor,
                 fix: torch.Tensor) -> torch.Tensor:
    """K4's fold in plain torch: [P, B, L] int32 limbs and the [L] fix-up
    constant -> [B, L] limbs of the product mod m, by the kernel's tree."""
    m16, n16 = _plain_constants(ctx, cts.device)
    x = _to16(cts)  # [P, B, H]
    while x.shape[0] > 1:
        pairs = x.shape[0] // 2
        a = x[0:2 * pairs:2].reshape(-1, x.shape[-1])
        b = x[1:2 * pairs:2].reshape(-1, x.shape[-1])
        folded = _mont_mul16(a, b, m16, n16).reshape(pairs, *x.shape[1:])
        x = torch.cat([folded, x[2 * pairs:]]) if x.shape[0] % 2 else folded
    f = _to16(fix.to(cts.device))[None, :].expand_as(x[0])
    return _from16(_mont_mul16(x[0], f, m16, n16))


# ---------------------------------------------------------------------------
# K4: kernel wrapper

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built ``csrc/montgomery.cu`` with its C interface declared
    (ctypes would otherwise pass pointers as 32-bit ints)."""
    lib = _build.load("montgomery")
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    operands = [ptr, i64, ptr, i64, i64, i64, ptr, i64, i64, i64, ptr,
                ctypes.c_int, ctypes.c_uint32]
    lib.sda_montmul.argtypes = operands + [ptr]
    lib.sda_montmul_wide.argtypes = operands + [ptr, i64, ptr]
    lib.sda_montmul.restype = lib.sda_montmul_wide.restype = ctypes.c_int
    return lib


def _check_limbs(ctx: MontgomeryContext, x: torch.Tensor, ndim: int,
                 name: str) -> None:
    if x.dtype != torch.int32 or x.dim() != ndim or x.shape[-1] != ctx.L:
        raise ValueError(f"{name} must be int32 limbs with {ndim} dims and "
                         f"{ctx.L} limbs, got {x.dtype}{tuple(x.shape)}")


def _wide_args(ctx, dev, n):
    """The wide instance's modulus and workspace on ``dev`` for launches of
    at most ``n`` montmuls, or None where L has an unrolled instance."""
    if ctx.L in UNROLLED_LIMBS:
        return None
    m = torch.from_numpy(np.array(ctx.m_words, dtype="<u4").view(np.int32))
    work = torch.empty((ctx.L + 2, max(1, min(n, WIDE_THREADS))),
                       dtype=torch.int32, device=dev)
    return m.to(dev), work


def _launch(lib, ctx, wide, a, a_pair, b, b_pair, b_limb, b_lane, out,
            out_pair, lanes, pairs, stream, op, level=None):
    args = (a.data_ptr(), a_pair, b.data_ptr(), b_pair, b_limb, b_lane,
            out.data_ptr(), out_pair, lanes, pairs)
    if wide is None:
        m = (ctypes.c_uint32 * ctx.L)(*ctx.m_words)
        err = lib.sda_montmul(*args, ctypes.cast(m, ctypes.c_void_p), ctx.L,
                              ctx.n_prime, stream)
    else:
        m, work = wide
        err = lib.sda_montmul_wide(*args, m.data_ptr(), ctx.L, ctx.n_prime,
                                   work.data_ptr(), work.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"K4 {op} kernel launch failed: CUDA error {err}")
    montgomery_kernel.launches += 1
    montgomery_kernel.op_launches[op] += 1
    if level is not None:
        montgomery_kernel.level_launches[level] += 1


def montgomery_kernel(op: str, ctx: MontgomeryContext, x: torch.Tensor,
                      y: torch.Tensor) -> torch.Tensor:
    """One K4 call on ``x``'s device:

    - ``mont_mul``: x, y [B, L] int32 limbs -> x * y * R^-1 mod m;
    - ``fold``: x [P, B, L] limbs, y the [L] fix-up constant -> [B, L]
      limbs of the product of x's rows times y times R^-P mod m: one
      launch a level of the row tree and one (``fix``) for the fix-up.

    A CUDA tensor launches the kernel (a launch error raises); a CPU
    tensor runs the plain version. Inputs must be below m. Malformed
    operands raise ValueError; a device that cannot run the call raises
    RuntimeError.
    """
    if op not in ("mont_mul", "fold"):
        raise ValueError(f"unknown K4 operation {op!r}")
    if op == "mont_mul":
        _check_limbs(ctx, x, 2, "a")
        _check_limbs(ctx, y, 2, "b")
        if x.shape != y.shape:
            raise ValueError("mont_mul operands differ in shape")
    else:
        _check_limbs(ctx, x, 3, "rows")
        _check_limbs(ctx, y, 1, "fix")
        if x.shape[0] == 0:
            raise ValueError("nothing to fold")
    dev = x.device
    if y.device != dev:
        raise ValueError(f"operands on {dev} and {y.device}")
    if dev.type == "cpu":
        if op == "mont_mul":
            return mont_mul_plain(ctx, x, y)
        return premix_plain(ctx, x, y)
    if dev.type != "cuda":
        raise RuntimeError(f"K4 runs on CUDA or the CPU, not {dev}")
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return _launches(lib, stream, op, ctx, x, y)


def _launches(lib, stream, op, ctx, x, y):
    """The launches of one K4 call on checked operands: the kernel reads
    limb-major blocks ([L, B] an operand row), so the [.., B, L] operands
    are transposed on their device first and the result back."""
    if op == "mont_mul":
        B = x.shape[0]
        a = x.t().contiguous()
        b = y.t().contiguous()
        out = torch.empty((ctx.L, B), dtype=torch.int32, device=x.device)
        _launch(lib, ctx, _wide_args(ctx, x.device, B), a, 0, b, 0, B, 1,
                out, 0, B, 1, stream, "mont_mul")
        return out.t().contiguous()
    rows = x.transpose(1, 2).contiguous()  # [P, L, B]
    return _fold_launches(lib, stream, ctx, rows, y).t().contiguous()


def _fold_launches(lib, stream, ctx, rows, fix):
    """The fold's launches on limb-major rows [P, L, B] and the [L] fix-up
    constant -> [L, B] limbs of the product: one launch a tree level, then
    the fix-up."""
    L, dev, B = ctx.L, rows.device, rows.shape[2]
    wide = _wide_args(ctx, dev, max(1, rows.shape[0] // 2) * B)
    level = 0
    while rows.shape[0] > 1:
        n = rows.shape[0]
        pairs = n // 2
        nxt = torch.empty((pairs + n % 2, L, B), dtype=torch.int32,
                          device=dev)
        _launch(lib, ctx, wide, rows, 2 * L * B, rows[1], 2 * L * B, B, 1,
                nxt, L * B, B, pairs, stream, "fold", level)
        if n % 2:  # the odd row passes through the level unchanged
            nxt[pairs].copy_(rows[n - 1])
        rows = nxt
        level += 1
    out = torch.empty((L, B), dtype=torch.int32, device=dev)
    _launch(lib, ctx, wide, rows[0], 0, fix.contiguous(), 0, 1, 0, out, 0, B,
            1, stream, "fix")
    return out


montgomery_kernel.launches = 0
#: launches by operation: ``mont_mul`` calls, ``fold`` (one a tree level)
#: and ``fix`` (one a fold); they add up to ``launches``
montgomery_kernel.op_launches = dict.fromkeys(OPS, 0)
#: ``fold`` launches by tree level (0: the level that reads the P rows)
montgomery_kernel.level_launches = collections.Counter()
