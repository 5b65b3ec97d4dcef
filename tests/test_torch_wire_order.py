"""The recipes of ``tests/test_wire_order.py`` against the port's
protocol: the key order of every ``to_obj`` dict literal, read from the
source with ``ast``, is the order canonical-JSON signing serializes.

The reference derives its order from the Rust declarations when that
checkout is at hand. Here the second source is the reference package
itself: the port's key order, extracted the same mechanical way, must
equal the reference's for every struct of ``resources.py`` and
``helpers.py`` and every scheme variant of ``crypto.py``, so a port
signature verifies under the reference and the reverse. The emitted
dicts are checked too, field by field."""

import ast
import inspect

import pytest

import sda_tpu.protocol.crypto as ref_crypto_mod
import sda_tpu.protocol.helpers as ref_helpers_mod
import sda_tpu.protocol.resources as ref_resources_mod
import sda_tpu_torch.protocol.crypto as crypto_mod
import sda_tpu_torch.protocol.helpers as helpers_mod
import sda_tpu_torch.protocol.resources as resources_mod


def to_obj_key_order(cls):
    """Key order of the dict literal in ``cls.to_obj``: the outer dict's
    keys, or the inner dict's for a single-key externally-tagged wrapper
    ({"Variant": {...}}, serde's external enum tagging)."""
    tree = ast.parse(inspect.getsource(cls.to_obj).lstrip())
    for node in ast.walk(tree):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            d = node.value
            keys = [k.value for k in d.keys if isinstance(k, ast.Constant)]
            if len(keys) == 1 and isinstance(d.values[0], ast.Dict):
                inner = d.values[0]
                return [k.value for k in inner.keys
                        if isinstance(k, ast.Constant)]
            return keys
    raise AssertionError(f"{cls.__name__}.to_obj has no dict-literal return")


def _structs(module):
    """Classes defined in ``module`` whose ``to_obj`` returns a dict
    literal."""
    out = {}
    for name, cls in vars(module).items():
        if not inspect.isclass(cls) or cls.__module__ != module.__name__ \
                or "to_obj" not in vars(cls):
            continue
        try:
            out[name] = to_obj_key_order(cls)
        except AssertionError:
            continue
    return out


@pytest.mark.parametrize("port, reference", [
    (resources_mod, ref_resources_mod),
    (helpers_mod, ref_helpers_mod),
    (crypto_mod, ref_crypto_mod),
], ids=["resources", "helpers", "crypto"])
def test_struct_field_order_matches_reference(port, reference):
    ours, theirs = _structs(port), _structs(reference)
    assert set(ours) == set(theirs)
    for name, fields in theirs.items():
        assert ours[name] == fields, f"{name} wire order diverges"
    # every protocol noun of resources.rs is among them
    assert len(theirs) >= (10 if reference is ref_resources_mod else 2)


def test_helper_structs_match_reference_field_order():
    for name in ("Signed", "Labelled"):
        assert to_obj_key_order(getattr(helpers_mod, name)) == \
            to_obj_key_order(getattr(ref_helpers_mod, name)) == \
            {"Signed": ["signature", "signer", "body"],
             "Labelled": ["id", "body"]}[name]


def test_scheme_variants_match_reference_field_order():
    """The variants of ``crypto.rs`` the reference checks, with the wire
    dict each emits in that order."""
    schemes = {
        "Full": (crypto_mod.FullMasking(433), ["modulus"]),
        "ChaCha": (crypto_mod.ChaChaMasking(433, 4, 128),
                   ["modulus", "dimension", "seed_bitsize"]),
        "Additive": (crypto_mod.AdditiveSharing(3, 433),
                     ["share_count", "modulus"]),
        "PackedShamir": (crypto_mod.PackedShamirSharing(3, 8, 4, 433, 354,
                                                        150),
                         ["secret_count", "share_count", "privacy_threshold",
                          "prime_modulus", "omega_secrets", "omega_shares"]),
    }
    for variant, (scheme, fields) in schemes.items():
        cls = type(scheme)
        assert to_obj_key_order(cls) == to_obj_key_order(
            getattr(ref_crypto_mod, cls.__name__)), variant
        obj = scheme.to_obj()
        assert list(obj) == [variant] and list(obj[variant]) == fields
        ref_obj = getattr(ref_crypto_mod, cls.__name__).from_obj(obj).to_obj()
        assert list(ref_obj[variant]) == fields
