"""The port's fixed-point codec (``sda_tpu_torch.models``) against the JAX
package's: the host lane is a copy (pinned by ``test_torch_drift.py``) and
must agree value for value; ``encode_device`` is torch on an explicit
device and must equal the reference's host ``encode`` bit for bit over the
clip boundaries, negative halves, the q_max boundary, half-to-even ties,
adversarial floats and a random cloud (the probes of
``tests/test_models.py``)."""

import numpy as np
import pytest
import torch

from sda_tpu.models import FixedPointCodec as RefCodec
from sda_tpu.models import field_capacity as ref_capacity

from sda_tpu_torch.models import (FieldSizingError, FixedPointCodec,
                                  field_capacity, field_headroom_check)

M31 = (1 << 31) - 1

MATRIX = [
    (M31, 12, 4, 4.0),            # wide modulus, generous headroom
    (M31, 16, 100, 1.0),          # fine grid, many summands
    ((1 << 20), 8, 3, None),      # small power-of-two modulus, derived clip
    ((1 << 24) - 3, 4, 50, None),  # coarse grid at the capacity-derived cap
]


def _probes(codec):
    step = 1.0 / codec.scale
    eps = step / 8.0
    ties = (np.arange(-9, 9, dtype=np.float64) + 0.5) * step
    return np.concatenate([
        np.array([0.0, -0.0, codec.clip, -codec.clip,
                  codec.clip - eps, -codec.clip + eps,
                  codec.clip + 1.0, -codec.clip - 1.0,
                  codec.clip * 3, -codec.clip * 3]),
        ties, -ties[::-1],
        np.array([step, -step, step / 2, -step / 2,
                  1.5 * step, -1.5 * step, 2.5 * step, -2.5 * step]),
        np.random.default_rng(17).normal(0, codec.clip, size=64),
        np.array([np.nan, -np.nan, np.inf, -np.inf, 1e300, -1e300]),
    ])


@pytest.mark.parametrize("modulus,fractional_bits,max_summands,clip", MATRIX)
def test_encode_device_equals_reference_host_encode(
        modulus, fractional_bits, max_summands, clip):
    codec = FixedPointCodec(modulus, fractional_bits, max_summands,
                            clip=clip)
    ref = RefCodec(modulus, fractional_bits, max_summands, clip=clip)
    assert repr(codec) == repr(ref) and codec.q_max == ref.q_max
    probes = _probes(codec)
    want = ref.encode(probes)
    np.testing.assert_array_equal(codec.encode(probes), want)
    got = codec.encode_device(probes, device="cpu")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # a tensor input, and a 2-D batch, give the same residues
    np.testing.assert_array_equal(
        codec.encode_device(torch.from_numpy(probes), device="cpu").numpy(),
        want)
    batch = probes[:60].reshape(3, 20)
    np.testing.assert_array_equal(
        codec.encode_device(batch, device="cpu").numpy(), ref.encode(batch))
    # both lanes clamp to the q_max boundary exactly
    centered = want - np.where(want > modulus // 2, modulus, 0)
    assert centered.max() == codec.q_max and centered.min() == -codec.q_max


@pytest.mark.parametrize("modulus,fractional_bits,max_summands,clip", MATRIX)
def test_host_lane_matches_reference(modulus, fractional_bits, max_summands,
                                     clip):
    codec = FixedPointCodec(modulus, fractional_bits, max_summands,
                            clip=clip)
    ref = RefCodec(modulus, fractional_bits, max_summands, clip=clip)
    probes = _probes(codec)
    np.testing.assert_array_equal(codec.quantize(probes),
                                  ref.quantize(probes))
    total = np.mod(codec.encode(probes) * 3, modulus)
    np.testing.assert_array_equal(codec.decode_sum(total, 3),
                                  ref.decode_sum(total, 3))
    np.testing.assert_array_equal(codec.decode_mean(total, 3),
                                  ref.decode_mean(total, 3))
    assert field_capacity(modulus, max_summands) == \
        ref_capacity(modulus, max_summands)


def test_encode_device_refuses_what_the_reference_refuses():
    normed = FixedPointCodec(M31, 12, 4, clip=4.0, norm_clip=1.0)
    with pytest.raises(ValueError, match="host-lane contract"):
        normed.encode_device([1.0], device="cpu")
    wide = FixedPointCodec(M31, 30, 1)
    with pytest.raises(ValueError, match="exact-integer range"):
        wide.encode_device([1.0], device="cpu")
    with pytest.raises(FieldSizingError, match="increase the modulus"):
        field_headroom_check(10, 100, 433, context="probe")
    assert field_headroom_check(1, 100, 433) == 433 // 2 - 1 - 100
