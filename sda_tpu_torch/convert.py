"""Carry a round's parameters, and a model family's weights, across from
the JAX package.

A round's "parameters" are its schemes and the
host-built share and reconstruct matrices, and the protocol's are its
resources and on-disk stores. Schemes and resources cross as their
``to_obj()`` objects (pure data, the same wire shape in both packages),
matrices as numpy arrays, inputs and external bits as numpy arrays. The
on-disk stores (jsonfs, sqlite, the ``Filebased`` keystore) hold the same
wire objects, so either package opens the other's directory. A model
family's weights cross as numpy arrays under flax's names
(``family_params_from_flax`` / ``family_params_to_flax``).
"""

from __future__ import annotations

import json
from collections import OrderedDict

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


def _flax_to_torch_layout(key: str, value: np.ndarray) -> np.ndarray:
    """flax's kernel layouts -> torch's: a dense kernel ``[in, out]`` ->
    ``[out, in]``, a conv kernel HWIO ``[kh, kw, in / groups, out]`` ->
    OIHW (a depthwise ``[3, 3, 1, C]`` -> ``[C, 1, 3, 3]``)."""
    if key == "kernel" and value.ndim == 2:
        return value.T
    if key == "kernel" and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    return value


def family_params_from_flax(family, flax_params) -> "OrderedDict":
    """A reference family's params (numpy arrays under flax's names, with
    or without the ``"params"`` level) -> ``family``'s ``state_dict`` (a
    ``torch.nn.Module`` of ``sda_tpu_torch.models.families``), each tensor
    on the module's device and dtype. ``kernel``/``scale`` become
    ``weight`` (kernels transposed to torch's layout); submodule names are
    flax's. Raises ``ValueError`` unless names and shapes match exactly."""
    tree = flax_params["params"] if "params" in flax_params else flax_params
    got = {}

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
                continue
            name = ".".join(path + ({"kernel": "weight", "scale": "weight"}
                                    .get(key, key),))
            got[name] = _flax_to_torch_layout(key, np.asarray(value))

    walk(tree, ())
    want = family.state_dict()
    if set(got) != set(want):
        raise ValueError(
            f"flax params do not name {type(family).__name__}'s: missing "
            f"{sorted(set(want) - set(got))}, extra "
            f"{sorted(set(got) - set(want))}")
    out = OrderedDict()
    for name, ref in want.items():
        if tuple(got[name].shape) != tuple(ref.shape):
            raise ValueError(f"{name}: flax shape {got[name].shape} -> "
                             f"{tuple(got[name].shape)}, module's "
                             f"{tuple(ref.shape)}")
        out[name] = torch.from_numpy(np.array(got[name])).to(
            ref.device, ref.dtype)
    return out


def family_params_to_flax(family_or_state) -> dict:
    """The inverse of :func:`family_params_from_flax`: a family module or
    its ``state_dict`` -> ``{"params": tree}`` of numpy arrays under
    flax's names and layouts (a 1-D ``weight`` is a GroupNorm ``scale``,
    any other a ``kernel``)."""
    state = family_or_state.state_dict() \
        if isinstance(family_or_state, torch.nn.Module) else family_or_state
    tree = {}
    for name, tensor in state.items():
        *path, leaf = name.split(".")
        value = tensor.detach().cpu().numpy()
        if leaf == "weight":
            leaf = "scale" if value.ndim == 1 else "kernel"
            if value.ndim == 2:
                value = value.T
            elif value.ndim == 4:
                value = value.transpose(2, 3, 1, 0)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(value)
    return {"params": tree}
