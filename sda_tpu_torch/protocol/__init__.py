"""Scheme parameters (the masking and sharing lattice) of the round."""

from .crypto import (
    CHACHA_PRG_RAND03,
    CHACHA_PRG_V1,
    AdditiveSharing,
    BasicShamirSharing,
    ChaChaMasking,
    FullMasking,
    LinearMaskingScheme,
    LinearSecretSharingScheme,
    NoMasking,
    PackedShamirSharing,
)

__all__ = [name for name in dir() if not name.startswith("_")]
