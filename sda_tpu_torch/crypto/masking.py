"""Scheme-dispatched masking: None / Full / ChaCha.

Reference semantics (client/src/crypto/masking/): the participant masks its
secrets so the committee only ever sees ``secret + mask`` while the recipient
gets the mask (encrypted); unmasking subtracts the combined masks from the
reconstructed combined masked secrets.

- None (none.rs): empty mask, identity.
- Full (full.rs): per-element fresh uniform mask, uploaded in full — drawn
  by ``crypto.rand`` (host ChaCha by default, the role's device in ``fast``
  mode); above ``HOST_PATH_MAX`` the add and subtract run on the role's
  device.
- ChaCha (chacha.rs): the uploaded "mask" is the PRG *seed* (u32 words,
  serialized as i64s); both sides expand it with the scheme's tagged
  ChaCha20 PRG (sda_tpu_torch.fields.chacha; K3 on a CUDA device) — the default CHACHA_PRG_RAND03 is
  the exact rand-0.3 ChaChaRng stream the reference draws (rand-0.3 wire
  interop), CHACHA_PRG_V1 the TPU-native opt-in spec.

Port of ``sda_tpu/crypto/masking.py``: every masker holds the role's device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from .._lazy import torch

from .. import fields
from ..fields import chacha, chacha_device
from ..protocol import (
    ChaChaMasking,
    FullMasking,
    LinearMaskingScheme,
    NoMasking,
)
from . import rand
from .sharing import _small, _to_device, _to_host, mod_combine


class SecretMasker:
    def mask(self, secrets: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """-> (mask-to-upload, masked secrets)."""
        raise NotImplementedError


class MaskCombiner:
    def combine(self, masks: Sequence[np.ndarray]) -> np.ndarray:
        """Sum uploaded masks (expanding seeds where applicable)."""
        raise NotImplementedError


class SecretUnmasker:
    def unmask(self, mask: np.ndarray, masked: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class NoneMasker(SecretMasker, MaskCombiner, SecretUnmasker):
    def mask(self, secrets):
        return np.zeros(0, dtype=np.int64), np.asarray(secrets, dtype=np.int64)

    def combine(self, masks):
        assert all(len(m) == 0 for m in masks)
        return np.zeros(0, dtype=np.int64)

    def unmask(self, mask, masked):
        assert len(mask) == 0
        return np.asarray(masked, dtype=np.int64)


class FullMasker(SecretMasker, MaskCombiner, SecretUnmasker):
    def __init__(self, modulus: int, device):
        self.modulus = modulus
        self.device = device

    def mask(self, secrets):
        arr = np.asarray(secrets, dtype=np.int64)
        masks = rand.uniform(arr.shape, self.modulus, device=self.device)
        if _small(arr.size):
            return masks, (arr + masks) % self.modulus
        masked = _to_host(fields.modadd(
            _to_device(arr, self.device), _to_device(masks, self.device),
            self.modulus))
        return masks, masked

    def combine(self, masks):
        return mod_combine(masks, self.modulus, self.device)

    def unmask(self, mask, masked):
        masked = np.asarray(masked, dtype=np.int64)
        mask = np.asarray(mask, dtype=np.int64)
        if _small(masked.size):
            return (masked - mask) % self.modulus
        return _to_host(fields.modsub(
            _to_device(masked, self.device), _to_device(mask, self.device),
            self.modulus))


class ChaChaMasker(SecretMasker, MaskCombiner, SecretUnmasker):
    """Seed masks, expanded where the role's device says: on a CUDA device
    by K3 (``fields.chacha_device``: ``expand_mask`` for a participant's
    mask, ``combine_masks`` for the recipient's sum), on the CPU by the
    native C++ kernel when it builds, else by numpy — as the JAX package
    takes ``fields/chacha_jax.py`` on its accelerator and the host
    expansion on a CPU backend. Every leg gives the host spec's bits."""

    def __init__(self, modulus: int, dimension: int, seed_bitsize: int,
                 prg: str = chacha.CHACHA_PRG_RAND03, *, device):
        if prg not in chacha._EXPANDERS:  # defense in depth vs the scheme
            raise ValueError(f"unknown ChaCha PRG {prg!r}")
        self.modulus = modulus
        self.dimension = dimension
        self.seed_bitsize = seed_bitsize
        self.prg = prg
        self.device = torch.device(device)

    def _on_card(self) -> bool:
        return self.device.type == "cuda"

    def _expand(self, seed):
        from .. import native

        if self._on_card():
            return chacha_device.expand_mask(
                seed, self.dimension, self.modulus, prg=self.prg,
                device=self.device)
        if native.available():
            return native.chacha_expand_mask(
                seed, self.dimension, self.modulus, prg=self.prg
            )
        return chacha.expand_mask_for(self.prg, seed, self.dimension, self.modulus)

    def mask(self, secrets):
        secrets = np.asarray(secrets, dtype=np.int64)
        assert secrets.shape == (self.dimension,)
        seed = chacha.random_seed(self.seed_bitsize)
        mask_vec = self._expand(seed)
        masked = (secrets + mask_vec) % self.modulus
        return np.asarray(seed, dtype=np.int64), masked

    def combine(self, seeds):
        """Re-expand every participant's seed — the recipient hot loop
        (receive.rs:102-118 for the ChaCha case, chacha.rs:57-77); served by
        K3 on a CUDA device, else by the native C++ kernel when present."""
        from .. import native

        if len(seeds) == 0:
            return np.zeros(self.dimension, dtype=np.int64)
        stacked = np.stack([np.asarray(s, dtype=np.int64) for s in seeds])
        if self._on_card():
            return chacha_device.combine_masks(
                stacked, self.dimension, self.modulus, prg=self.prg,
                device=self.device)
        if native.available():
            return native.chacha_combine_masks(
                stacked, self.dimension, self.modulus, prg=self.prg
            )
        result = np.zeros(self.dimension, dtype=np.int64)
        for seed in stacked:
            expanded = chacha.expand_mask_for(
                self.prg, seed, self.dimension, self.modulus
            )
            result = (result + expanded) % self.modulus
        return result

    def unmask(self, mask, masked):
        return (np.asarray(masked, dtype=np.int64) - np.asarray(mask, dtype=np.int64)) % self.modulus


def new_secret_masker(scheme: LinearMaskingScheme, device) -> SecretMasker:
    return _dispatch(scheme, device)


def new_mask_combiner(scheme: LinearMaskingScheme, device) -> MaskCombiner:
    return _dispatch(scheme, device)


def new_secret_unmasker(scheme: LinearMaskingScheme, device) -> SecretUnmasker:
    return _dispatch(scheme, device)


def _dispatch(scheme: LinearMaskingScheme, device):
    if isinstance(scheme, NoMasking):
        return NoneMasker()
    if isinstance(scheme, FullMasking):
        return FullMasker(scheme.modulus, device)
    if isinstance(scheme, ChaChaMasking):
        return ChaChaMasker(
            scheme.modulus, scheme.dimension, scheme.seed_bitsize,
            prg=scheme.prg, device=device,
        )
    raise ValueError(f"unknown masking scheme {scheme!r}")
