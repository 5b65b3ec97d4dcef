"""Carry a round's parameters across from the JAX package.

The system has no weights: a round's "parameters" are its schemes and the
host-built share and reconstruct matrices. Schemes cross as their
``to_obj()`` dicts (pure data, the same wire shape in both packages),
matrices as numpy arrays, inputs and external bits as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .fields import numtheory
from .protocol import LinearMaskingScheme, LinearSecretSharingScheme


def schemes_from_reference(sharing_obj, masking_obj=None):
    """The reference schemes' ``to_obj()`` dicts -> (sharing, masking)
    scheme objects of this package (masking None when not given)."""
    sharing = LinearSecretSharingScheme.from_obj(sharing_obj)
    masking = None if masking_obj is None \
        else LinearMaskingScheme.from_obj(masking_obj)
    return sharing, masking


def matrices_from_numpy(m_host, l_host, device=None, *, scheme):
    """The reference's share and reconstruct matrices (numpy; the
    reconstruct matrix over all clerks) -> int64 tensors on ``device``,
    after checking that they equal this package's own ``numtheory``
    matrices for ``scheme``. Raises ``ValueError`` on any difference."""
    dev = resolve_device(device)
    expected = (numtheory.share_matrix_for(scheme),
                numtheory.reconstruct_matrix_for(
                    scheme, tuple(range(scheme.share_count))))
    got = (np.asarray(m_host), np.asarray(l_host))
    for name, want, have in zip(("share", "reconstruct"), expected, got):
        if want.shape != have.shape or not np.array_equal(want, have):
            raise ValueError(
                f"{name} matrix differs from this package's numtheory for "
                f"{scheme!r}")
    return tuple(torch.as_tensor(np.array(a, dtype=np.int64), device=dev)
                 for a in got)
