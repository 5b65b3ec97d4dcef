"""Uniform field-kernel interface over the two arithmetic lanes — port of
``sda_tpu/fields/ops.py``.

- the **Solinas lane** (`fastfield`): shift/add reduction for moduli of
  form 2^b - delta, every intermediate below 2^32;
- the **generic lane** (`modular`): any modulus < 2^31 (matmul) or
  < 2^62 (elementwise).

Both hold canonical residues in int64 tensors; results are bit-identical
between lanes. ``FieldOps.create`` picks the Solinas lane when the modulus
qualifies AND the caller's cross-device sums provably fit 32 bits
(``cross_terms`` = the maximum residues summed by a collective before the
next canonicalize). Torch has no uint64 arithmetic, so the reference's
``from_u64`` (the reduction of uint64 stream draws) is fused into K3's
windowed stream, ``fields.chacha_device.stream_residues_at``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import fastfield, modular


class FieldOps:
    """Field/ring ops mod ``m``; ``sp`` non-None selects the Solinas lane.

    Additive sharing only needs ring structure, so a *composite*
    Solinas-form modulus still rides the Solinas lane — none of these ops
    divide. The packed-Shamir matmuls (which do need a prime) dispatch in
    mesh.simpod's share/reconstruct stages, not here.
    """

    __slots__ = ("m", "sp")

    def __init__(self, m: int, sp: Optional[fastfield.SolinasPrime]):
        self.m = int(m)
        self.sp = sp

    @classmethod
    def create(cls, modulus: int, *, cross_terms: int = 1) -> "FieldOps":
        sp = fastfield.SolinasPrime.try_from(modulus)
        if sp is not None and cross_terms * (modulus - 1) >= (1 << 32):
            sp = None  # collective partial sums could pass 32 bits
        return cls(modulus, sp)

    # -- conversions ------------------------------------------------------
    def to_residues(self, inputs):
        """Any-integer tensor -> canonical int64 residues."""
        if self.sp is not None:
            return fastfield.to_residues32(inputs, self.sp)
        return modular.canon(inputs.to(torch.int64), self.m)

    def to_int64(self, x):
        return x.to(torch.int64)

    # -- arithmetic -------------------------------------------------------
    def canon(self, x):
        if self.sp is not None:
            return fastfield.canon32(x, self.sp)
        return modular.canon(x, self.m)

    def add(self, a, b):
        if self.sp is not None:
            return fastfield.modadd32(a, b, self.sp)
        return modular.modadd(a, b, self.m)

    def sub(self, a, b):
        if self.sp is not None:
            return fastfield.modsub32(a, b, self.sp)
        return modular.modsub(a, b, self.m)

    def sum(self, x, axis=0):
        if self.sp is not None:
            return fastfield.modsum32(x, self.sp, axis=axis)
        return modular.modsum(x, self.m, axis=axis)

    def uniform(self, generator: torch.Generator, shape):
        if self.sp is not None:
            return fastfield.uniform32(generator, shape, self.sp)
        return modular.uniform_mod(generator, tuple(shape), self.m)
