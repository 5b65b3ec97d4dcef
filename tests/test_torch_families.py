"""The port's model families (``sda_tpu_torch.models.families``) and
``ravel_pytree`` on the CPU: the recipes of ``tests/test_models.py``
(families, ravel) against the port, and the port held to the JAX
package's flax families on the same weights, carried across by
``convert.family_params_from_flax``: logits within rtol 1e-4, atol 1e-5;
parameter counts equal, the defaults sized on the meta device; flax's
"SAME" padding at stride 2 on an odd and an even size; ``ravel_pytree``'s
vector equal to the reference's on the same dict tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from sda_tpu.models import families as ref
from sda_tpu.models import ravel_pytree as ref_ravel

from sda_tpu_torch.convert import (family_params_from_flax,
                                   family_params_to_flax)
from sda_tpu_torch.models import (
    LeNet,
    LoRAMLP,
    MobileLite,
    lora_adapter_params,
    merge_lora_params,
    param_count,
    ravel_pytree,
)
from sda_tpu_torch.models import families


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run many small tensor ops: with one intra-op thread
    they do not spin against the suite's other workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the reference's recipes

def test_ravel_pytree_roundtrip():
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.float32),
                  "d": torch.zeros(())}}
    vec, unravel = ravel_pytree(tree)
    assert vec.shape == (11,) and vec.dtype == torch.float64
    back = unravel(vec + 1.0)
    np.testing.assert_array_equal(back["a"].numpy(),
                                  np.arange(6).reshape(2, 3) + 1)
    assert back["b"]["d"].shape == ()
    assert back["a"].dtype == torch.float32
    # unravel builds new tensors: the caller's tree is unchanged
    assert float(tree["b"]["c"].sum()) == 4.0
    with pytest.raises(ValueError, match="expected shape"):
        unravel(np.zeros(10))


def test_lenet_is_the_60k_family():
    model = LeNet(device="cpu")
    n = param_count(model)
    assert 50_000 < n < 80_000, n
    out = model(torch.zeros((2, 28, 28, 1)))
    assert out.shape == (2, 10)


def test_mobilelite_and_lora_forward():
    tiny = MobileLite(width=8, block_channels=(16, 24), device="cpu")
    assert tiny(torch.zeros((2, 32, 32, 3))).shape == (2, 10)

    lora = LoRAMLP(features=64, layers=2, rank=4, in_features=16,
                   device="cpu", generator=torch.Generator().manual_seed(1))
    assert lora(torch.zeros((3, 16))).shape == (3, 10)
    adapters = lora_adapter_params(lora)
    assert set(adapters) == {"lora_a_0", "lora_b_0", "lora_a_1", "lora_b_1"}
    lp = dict(lora.state_dict())
    merged = merge_lora_params(lp, adapters)
    assert param_count(merged) == param_count(lp) == param_count(lora)
    # the base and the head are frozen, the adapters train
    assert {n for n, p in lora.named_parameters() if p.requires_grad} \
        == set(adapters)


def test_family_flagship_sizes():
    """The default widths land on the benchmark workload sizes, sized on
    the meta device (no storage)."""
    mob = MobileLite(device="meta")
    assert all(p.is_meta for p in mob.parameters())
    n_mob = param_count(mob)
    assert 2_500_000 < n_mob < 5_000_000, n_mob

    lora = LoRAMLP(device="meta")
    n_ad = param_count(lora_adapter_params(lora))
    assert 9_000_000 < n_ad < 18_000_000, n_ad


# ---------------------------------------------------------------------------
# the port against the flax families

def _pair(name):
    """(reference module, port module, NHWC input shape, init shape)."""
    if name == "lenet":
        return ref.LeNet(width=1), LeNet(width=1, device="cpu"), (28, 28, 1)
    if name == "mobilelite":
        return (ref.MobileLite(width=8, block_channels=(16, 24)),
                MobileLite(width=8, block_channels=(16, 24), device="cpu"),
                (32, 32, 3))
    return (ref.LoRAMLP(64, 2, 4), LoRAMLP(64, 2, 4, in_features=16,
                                           device="cpu"), (4, 4, 1))


@pytest.mark.parametrize("name", ["lenet", "mobilelite", "lora"])
def test_logits_equal_reference_on_the_same_weights(name):
    rmod, tmod, shape = _pair(name)
    x = np.random.default_rng(7).normal(size=(3,) + shape).astype(np.float32)
    params = _numpy_tree(rmod.init(jax.random.PRNGKey(0), x[:1]))
    if name == "lora":
        # the adapters start as a no-op (lora_b zero): give B values so
        # the adapter path shows in the logits
        rng = np.random.default_rng(8)
        params = {"params": {
            k: (rng.normal(0, 0.1, v.shape).astype(v.dtype)
                if k.startswith("lora_b_") else v)
            for k, v in params["params"].items()}}
    tmod.load_state_dict(family_params_from_flax(tmod, params))
    want = np.asarray(rmod.apply(params, x))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # and back: the port's state_dict under flax's names and layouts
    back = family_params_to_flax(tmod)
    flat_ref = jax.tree_util.tree_leaves_with_path(params)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, value in flat_ref:
        np.testing.assert_array_equal(
            flat_back[path], np.asarray(value).astype(np.float32))


@pytest.mark.parametrize("name", ["lenet", "mobilelite", "lora"])
def test_param_count_equals_reference(name):
    rmod, tmod, shape = _pair(name)
    shapes = jax.eval_shape(
        lambda k: rmod.init(k, jnp.zeros((1,) + shape)),
        jax.random.PRNGKey(0))
    assert param_count(tmod) == ref.param_count(shapes)
    if name == "lora":
        assert param_count(lora_adapter_params(tmod)) == ref.param_count(
            ref.lora_adapter_params(shapes))


@pytest.mark.parametrize("name", ["lenet", "mobilelite", "lora"])
def test_default_param_count_equals_reference_on_meta(name):
    rmod, tmod, shape = {
        "lenet": (ref.LeNet(), LeNet(device="meta"), (28, 28, 1)),
        "mobilelite": (ref.MobileLite(), MobileLite(device="meta"),
                       (32, 32, 3)),
        "lora": (ref.LoRAMLP(), LoRAMLP(device="meta"), (28, 28)),
    }[name]
    shapes = jax.eval_shape(
        lambda k: rmod.init(k, jnp.zeros((1,) + shape)),
        jax.random.PRNGKey(0))
    want = ref.param_count(shapes)
    assert param_count(tmod) == want
    if name == "lora":
        assert param_count(lora_adapter_params(tmod)) == ref.param_count(
            ref.lora_adapter_params(shapes)) == 11_782_400
    if name == "mobilelite":
        assert want == 3_731_890


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("groups", [1, 8])
def test_same_padding_at_stride_2_equals_flax(size, groups):
    """flax pads "SAME" with the smaller half first: (0, 1) at stride 2 on
    an even size, (1, 1) on an odd one. A torch ``padding=1`` conv would
    shift every output on the even size."""
    assert families._same_pads(size, 3, 2) == ((0, 1) if size % 2 == 0
                                                else (1, 1))
    cin = 8
    x = np.random.default_rng(size).normal(
        size=(2, size, size, cin)).astype(np.float32)
    conv = nn.Conv(8, (3, 3), strides=(2, 2), padding="SAME",
                   feature_group_count=groups, use_bias=False)
    params = _numpy_tree(conv.init(jax.random.PRNGKey(1), x))
    want = np.asarray(conv.apply(params, x))
    port = families._SameConv(cin, 8, 3, stride=2, groups=groups,
                              bias=False)
    kernel = params["params"]["kernel"]          # HWIO [3, 3, cin/g, 8]
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(
            np.array(kernel.transpose(3, 2, 0, 1))))
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, -(-size // 2), -(-size // 2), 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_initializers_follow_the_reference():
    """lecun-normal kernels (variance 1/fan_in, truncated at 2 sigma of the
    untruncated normal), zero biases, unit GroupNorm scales at eps 1e-6,
    lora_a normal(0.02), lora_b zero; one generator seed, one model."""
    lora = LoRAMLP(features=256, layers=2, rank=64, in_features=256,
                   device="cpu", generator=torch.Generator().manual_seed(3))
    again = LoRAMLP(features=256, layers=2, rank=64, in_features=256,
                    device="cpu", generator=torch.Generator().manual_seed(3))
    for (name, p), q in zip(lora.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(p, q), name
    assert not lora.lora_b_0.any() and not lora.base_0.bias.any()
    assert abs(float(lora.lora_a_0.detach().std()) - 0.02) < 0.002
    w = lora.base_1.weight.detach()
    sigma = (1 / 256) ** 0.5 / families._TRUNC_STD
    assert abs(float(w.std()) - (1 / 256) ** 0.5) < 0.1 * (1 / 256) ** 0.5
    assert float(w.abs().max()) <= 2 * sigma
    mob = MobileLite(width=8, block_channels=(16, 24), device="cpu")
    norms = [m for m in mob.modules() if isinstance(m, torch.nn.GroupNorm)]
    assert norms and all(m.eps == 1e-6 and bool((m.weight == 1).all())
                         for m in norms)


def test_ravel_vector_equals_reference_on_the_same_tree():
    rng = np.random.default_rng(4)
    tree = {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32),
            "z": {"y": rng.normal(size=(2, 2, 2)).astype(np.float32),
                  "a": np.float32(1.5)},
            "list": [rng.normal(size=(5,)).astype(np.float32)]}
    ref_vec, _ = ref_ravel(tree)
    ours, unravel = ravel_pytree(jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), tree))
    np.testing.assert_array_equal(ours.numpy(), ref_vec)
    back = unravel(ours)
    np.testing.assert_array_equal(back["z"]["y"].numpy(), tree["z"]["y"])
    # a module's state_dict: the same coordinates as its flax tree's
    tmod = LeNet(width=1, device="cpu")
    flax_tree = family_params_to_flax(tmod)
    flax_vec, _ = ref_ravel(flax_tree)
    port_vec, _ = ravel_pytree(tmod.state_dict())
    assert port_vec.shape == flax_vec.shape
    np.testing.assert_array_equal(np.sort(port_vec.numpy()),
                                  np.sort(flax_vec))
