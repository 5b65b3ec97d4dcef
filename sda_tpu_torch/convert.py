"""Carry a round's parameters across from the JAX package.

The system has no weights: a round's "parameters" are its schemes and the
host-built share and reconstruct matrices, and the protocol's are its
resources and on-disk stores. Schemes and resources cross as their
``to_obj()`` objects (pure data, the same wire shape in both packages),
matrices as numpy arrays, inputs and external bits as numpy arrays. The
on-disk stores (jsonfs, sqlite, the ``Filebased`` keystore) hold the same
wire objects, so either package opens the other's directory.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .device import resolve_device
from .fields import numtheory
from . import protocol
from .protocol import LinearMaskingScheme, LinearSecretSharingScheme
from .protocol.resources import signed_encryption_key_from_obj


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


#: resources whose wire object has no ``from_obj`` classmethod of its own
_FROM_OBJ = {
    "SignedEncryptionKey": signed_encryption_key_from_obj,
    "LinearMaskingScheme": LinearMaskingScheme.from_obj,
    "LinearSecretSharingScheme": LinearSecretSharingScheme.from_obj,
    "AdditiveEncryptionScheme": protocol.AdditiveEncryptionScheme.from_obj,
}


def resource_from_reference(cls_name: str, obj):
    """A reference resource's wire object (its ``to_obj()``, or its
    canonical JSON as ``bytes``) -> this package's resource of the class
    named ``cls_name`` (a class of ``sda_tpu_torch.protocol``, or one of
    the union names in ``_FROM_OBJ``)."""
    if isinstance(obj, bytes):
        obj = json.loads(obj)
    parse = _FROM_OBJ.get(cls_name)
    if parse is None:
        parse = getattr(protocol, cls_name).from_obj
    return parse(obj)
