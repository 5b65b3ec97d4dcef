"""The port's numpy copies (numtheory, oracle) and the carry-across
(convert) against the JAX package's."""

import numpy as np
import pytest
import torch

from sda_tpu.fields import numtheory as ref_nt
from sda_tpu.fields import oracle as ref_oracle
from sda_tpu import protocol as ref_proto

from sda_tpu_torch import convert
from sda_tpu_torch import protocol as proto
from sda_tpu_torch.fields import numtheory, oracle


def _flagship_obj():
    t, p, w2, w3 = ref_nt.generate_packed_params(3, 8, 28)
    return ref_proto.PackedShamirSharing(3, 8, t, p, w2, w3)


SCHEMES = {
    "packed433": lambda: ref_proto.PackedShamirSharing(3, 8, 4, 433, 354, 150),
    "flagship": _flagship_obj,
    "basic433": lambda: ref_proto.BasicShamirSharing(5, 2, 433),
    "basic_solinas": lambda: ref_proto.BasicShamirSharing(
        8, 3, _flagship_obj().prime_modulus),
}


def _port_scheme(ref_scheme):
    return proto.LinearSecretSharingScheme.from_obj(ref_scheme.to_obj())


@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_share_and_reconstruct_matrices_equal_reference(name):
    ref = SCHEMES[name]()
    port = _port_scheme(ref)
    assert port.to_obj() == ref.to_obj()
    np.testing.assert_array_equal(numtheory.share_matrix_for(port),
                                  ref_nt.share_matrix_for(ref))
    n = ref.share_count
    need = ref.reconstruction_threshold
    rng = np.random.default_rng(5)
    subsets = [tuple(range(n)), tuple(range(n - need, n)),
               tuple(sorted(int(i) for i in rng.choice(n, size=need, replace=False)))]
    for idx in subsets:
        np.testing.assert_array_equal(
            numtheory.reconstruct_matrix_for(port, idx),
            ref_nt.reconstruct_matrix_for(ref, idx))


@pytest.mark.parametrize("k,n,bits", [(3, 8, 28), (1, 8, 0), (5, 8, 20),
                                      (3, 26, 28), (2, 2, 0)])
def test_generate_packed_params_equal_reference(k, n, bits):
    assert numtheory.generate_packed_params(k, n, bits) == \
        ref_nt.generate_packed_params(k, n, bits)


def test_oracle_copy_equals_reference():
    ref = SCHEMES["packed433"]()
    port = _port_scheme(ref)
    rng = np.random.default_rng(6)
    secrets = rng.integers(0, 433, size=100)
    rand = rng.integers(0, 433, size=(4, 34))
    shares = oracle.packed_share_from_randomness(secrets, rand, port)
    np.testing.assert_array_equal(
        shares, ref_oracle.packed_share_from_randomness(secrets, rand, ref))
    np.testing.assert_array_equal(
        oracle.packed_reconstruct(range(8), shares, port, 100), secrets)
    draws = rng.integers(0, 433, size=(4, 50))
    np.testing.assert_array_equal(
        oracle.additive_share_from_randomness(secrets[:50], draws, 433),
        ref_oracle.additive_share_from_randomness(secrets[:50], draws, 433))


@pytest.mark.parametrize("masking", ["none", "full", "chacha"])
def test_schemes_from_reference_round_trip(masking):
    ref = SCHEMES["flagship"]()
    p = ref.prime_modulus
    ref_mask = {
        "none": ref_proto.NoMasking(),
        "full": ref_proto.FullMasking(p),
        "chacha": ref_proto.ChaChaMasking(p, 10, 128,
                                          prg=ref_proto.CHACHA_PRG_V1),
    }[masking]
    sharing, mask = convert.schemes_from_reference(ref.to_obj(),
                                                   ref_mask.to_obj())
    assert isinstance(sharing, proto.PackedShamirSharing)
    assert sharing.to_obj() == ref.to_obj()
    assert type(mask).__name__ == type(ref_mask).__name__
    assert mask.to_obj() == ref_mask.to_obj()
    assert sharing.reconstruction_threshold == ref.reconstruction_threshold
    assert convert.schemes_from_reference(ref.to_obj())[1] is None


@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_matrices_from_numpy(name):
    ref = SCHEMES[name]()
    port = _port_scheme(ref)
    m = ref_nt.share_matrix_for(ref)
    l_ = ref_nt.reconstruct_matrix_for(ref, tuple(range(ref.share_count)))
    mt, lt = convert.matrices_from_numpy(m, l_, "cpu", scheme=port)
    assert mt.dtype == lt.dtype == torch.int64
    assert torch.equal(mt, torch.from_numpy(np.array(m)))
    assert torch.equal(lt, torch.from_numpy(np.array(l_)))
    bad = np.array(m)
    bad[0, 1] = (bad[0, 1] + 1) % port.prime_modulus
    with pytest.raises(ValueError, match="share matrix"):
        convert.matrices_from_numpy(bad, l_, "cpu", scheme=port)
    with pytest.raises(ValueError, match="reconstruct matrix"):
        convert.matrices_from_numpy(m, l_[:, :-1], "cpu", scheme=port)
