"""Secure FedAvg on the port (``sda_tpu_torch.models.federated``) on the
CPU: the recipes of ``tests/test_models.py`` (the protocol surface over
the port's ``SdaClient(device="cpu")``, the mesh surface over pods of
``["cpu"] * 8``) and the port held to the JAX package:

- ``LocalTrainer``: 3 SGD steps from the same LeNet weights and batches
  give params within atol 1e-5 and a mean loss within rtol 1e-5 of the
  reference's trainer with ``optax.sgd``; the caller's params unchanged;
- ``pod_fedavg_round``: the same float client vectors through the
  reference's pods (jax's CPU devices) and the port's (plain lane and
  K1's plain version) give the same new global vector, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from sda_tpu import mesh as ref_mesh
from sda_tpu import protocol as ref_proto
from sda_tpu.models import LocalTrainer as RefTrainer
from sda_tpu.models import FixedPointCodec as RefCodec
from sda_tpu.models import families as ref_families
from sda_tpu.models import pod_fedavg_round as ref_pod_fedavg_round

from sda_tpu_torch.convert import (family_params_from_flax,
                                   family_params_to_flax)
from sda_tpu_torch.fields import numtheory
from sda_tpu_torch.mesh import SimulatedPod, StreamedPod, make_mesh
from sda_tpu_torch.models import (
    FederatedSession,
    FixedPointCodec,
    LeNet,
    LoRAMLP,
    LocalTrainer,
    lora_adapter_params,
    merge_lora_params,
    pod_fedavg_round,
    ravel_pytree,
    sgd,
)
from sda_tpu_torch.protocol import (AdditiveSharing, FullMasking,
                                    PackedShamirSharing)

M31 = (1 << 31) - 1  # Mersenne prime, the widest additive modulus allowed
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run many small tensor ops: with one intra-op thread
    they do not spin against the suite's other workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_modulus_mismatch_is_rejected():
    """A codec/aggregation modulus mismatch must fail loudly, not decode
    garbage (both FedAvg surfaces validate it)."""
    from sda_tpu_torch.mesh import SimulatedPod, make_mesh
    from sda_tpu_torch.protocol import AdditiveSharing

    pod = SimulatedPod(AdditiveSharing(share_count=8, modulus=M31),
                       mesh=make_mesh(4, 2, devices=CPU8))
    codec = FixedPointCodec((1 << 29) - 3, fractional_bits=8,
                            max_summands=2, clip=1.0)
    with pytest.raises(ValueError, match="modulus"):
        pod_fedavg_round(pod, codec, np.zeros(8), np.zeros((2, 8)))


def _new_client(service):
    from sda_tpu_torch.client import SdaClient
    from sda_tpu_torch.crypto import MemoryKeystore

    ks = MemoryKeystore()
    return SdaClient(SdaClient.new_agent(ks), ks, service, device="cpu")


def test_federated_session_exact_round():
    from sda_tpu_torch.protocol import (
        AdditiveSharing,
        Aggregation,
        AggregationId,
        NoMasking,
        SodiumEncryption,
    )
    from sda_tpu_torch.server import new_memory_server

    dim, n_part = 24, 3
    service = new_memory_server()
    recipient = _new_client(service)
    rkey = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(rkey)
    clerks = [_new_client(service) for _ in range(3)]
    for c in clerks:
        ck = c.new_encryption_key()
        c.upload_agent()
        c.upload_encryption_key(ck)
    participants = [_new_client(service) for _ in range(n_part)]
    for p in participants:
        p.upload_agent()

    template = Aggregation(
        id=AggregationId.random(), title="fedavg", vector_dimension=dim,
        modulus=M31, recipient=recipient.agent.id, recipient_key=rkey,
        masking_scheme=NoMasking(),
        committee_sharing_scheme=AdditiveSharing(share_count=3, modulus=M31),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    codec = FixedPointCodec(M31, fractional_bits=16, max_summands=n_part, clip=4.0)
    session = FederatedSession(template, codec, recipient, clerks, participants)

    rng = np.random.default_rng(3)
    deltas = rng.normal(0, 1, size=(n_part, dim))
    mean = session.round(list(deltas))
    expected = np.stack([codec.quantize(d) for d in deltas]).sum(0) \
        / codec.scale / n_part
    np.testing.assert_array_equal(mean, expected)

    # a second round creates a fresh aggregation and still reveals exactly
    mean2 = session.round(list(-deltas))
    np.testing.assert_array_equal(mean2, -expected)


def test_federated_session_packed_shamir_semantics():
    """FedAvg over Packed-Shamir: values live in Z_m but are SHARED in
    Z_p (p > m). Negative encodings sit near m, so exactness needs
    n_participants * m < p — the codec's modulus is m and the final
    positive() lift mod m recovers the centered sum. Pins that the wrap
    algebra composes (reference: crypto.rs derived properties +
    receive.rs:14-21 lift)."""
    from sda_tpu_torch.fields import numtheory
    from sda_tpu_torch.protocol import (
        Aggregation,
        AggregationId,
        FullMasking,
        PackedShamirSharing,
        SodiumEncryption,
    )
    from sda_tpu_torch.server import new_memory_server

    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    m = 1 << 20  # n * m = 3 * 2^20 << p = 5.4e8: no Z_p wrap
    dim, n_part = 12, 3
    service = new_memory_server()
    recipient = _new_client(service)
    rkey = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(rkey)
    clerks = [_new_client(service) for _ in range(8)]
    for c in clerks:
        ck = c.new_encryption_key()
        c.upload_agent()
        c.upload_encryption_key(ck)
    participants = [_new_client(service) for _ in range(n_part)]
    for part in participants:
        part.upload_agent()

    template = Aggregation(
        id=AggregationId.random(), title="fedavg-shamir",
        vector_dimension=dim, modulus=m,
        recipient=recipient.agent.id, recipient_key=rkey,
        masking_scheme=FullMasking(m),
        committee_sharing_scheme=PackedShamirSharing(3, 8, t, p, w2, w3),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    codec = FixedPointCodec(m, fractional_bits=8, max_summands=n_part)
    session = FederatedSession(template, codec, recipient, clerks,
                               participants)
    rng = np.random.default_rng(9)
    deltas = rng.normal(0, 100, size=(n_part, dim))  # mixed signs, clipped
    mean = session.round(list(deltas))
    expected = np.stack([codec.quantize(d) for d in deltas]).sum(0) \
        / codec.scale / n_part
    np.testing.assert_array_equal(mean, expected)

    # fault tolerance composes with the model layer: one clerk never runs
    # chores, the reconstruction threshold (t + k = 4+3 = 7 of 8) is still
    # met, and the round reveals the exact mean (crypto.rs:146-153)
    session_drop = FederatedSession(
        template, codec, recipient,
        [c for c in clerks if c is not clerks[5]], participants)
    mean2 = session_drop.round(list(-deltas))
    np.testing.assert_array_equal(mean2, -expected)


def test_federated_session_surfaces_typed_round_verdict():
    """A round that cannot complete (additive sharing, one clerk never
    clerks) must surface a typed lifecycle verdict from ``await_result``
    within the deadline — not hang, not silently decode a partial
    committee sum, not a bare NotFound."""
    from sda_tpu_torch.protocol import (
        AdditiveSharing,
        Aggregation,
        AggregationId,
        NoMasking,
        RoundFailed,
        SodiumEncryption,
    )
    from sda_tpu_torch.server import new_memory_server

    dim, n_part = 8, 2
    service = new_memory_server()
    recipient = _new_client(service)
    rkey = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(rkey)
    clerks = [_new_client(service) for _ in range(3)]
    for c in clerks:
        c.upload_agent()
        c.upload_encryption_key(c.new_encryption_key())
    participants = [_new_client(service) for _ in range(n_part)]
    for p in participants:
        p.upload_agent()
    template = Aggregation(
        id=AggregationId.random(), title="fedavg-dead", vector_dimension=dim,
        modulus=M31, recipient=recipient.agent.id, recipient_key=rkey,
        masking_scheme=NoMasking(),
        # a 4-of-4 committee over exactly 4 key-holders (recipient + 3
        # clerks): election MUST include clerk 2, whose chores the
        # session below never runs — deterministic regardless of the
        # uuid-sorted suggestion order (the recipient's own chores ARE
        # run by FederatedSession.round)
        committee_sharing_scheme=AdditiveSharing(share_count=4, modulus=M31),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    codec = FixedPointCodec(M31, fractional_bits=8, max_summands=n_part,
                            clip=1.0)
    # clerk 2 never runs chores: additive n-of-n can never reconstruct
    session = FederatedSession(template, codec, recipient, clerks[:2],
                               participants)
    deltas = np.random.default_rng(1).normal(0, 0.5, size=(n_part, dim))
    with pytest.raises(RoundFailed):  # RoundExpired subclasses RoundFailed
        session.round(list(deltas), deadline=1.0)


def test_participation_input_ndarray_fast_path():
    """The encoded int64 ndarray goes through ``participate`` without a
    per-element Python conversion; raw float arrays are rejected (a
    silent float->int64 truncation would bypass the codec contract)."""
    from sda_tpu_torch.protocol import (
        AdditiveSharing,
        Aggregation,
        AggregationId,
        NoMasking,
        SodiumEncryption,
    )
    from sda_tpu_torch.server import new_memory_server

    service = new_memory_server()
    recipient = _new_client(service)
    rkey = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(rkey)
    clerks = [_new_client(service) for _ in range(3)]
    for c in clerks:
        c.upload_agent()
        c.upload_encryption_key(c.new_encryption_key())
    participant = _new_client(service)
    participant.upload_agent()
    aggregation = Aggregation(
        id=AggregationId.random(), title="nd", vector_dimension=16,
        modulus=M31, recipient=recipient.agent.id, recipient_key=rkey,
        masking_scheme=NoMasking(),
        committee_sharing_scheme=AdditiveSharing(share_count=3, modulus=M31),
        recipient_encryption_scheme=SodiumEncryption(),
        committee_encryption_scheme=SodiumEncryption(),
    )
    recipient.upload_aggregation(aggregation)
    recipient.begin_aggregation(aggregation.id)
    codec = FixedPointCodec(M31, fractional_bits=8, max_summands=2, clip=1.0)
    encoded = codec.encode(np.random.default_rng(2).normal(0, 0.4, size=16))
    assert encoded.dtype == np.int64
    participant.participate(encoded, aggregation.id)  # ndarray, no list()
    status = service.get_aggregation_status(recipient.agent, aggregation.id)
    assert status.number_of_participations == 1
    with pytest.raises(ValueError, match="FixedPointCodec"):
        participant.new_participation(
            np.zeros(16, dtype=np.float64), aggregation.id)


# ---------------------------------------------------------------------------
# secure FedAvg — mesh surface + real training

def test_pod_fedavg_training_improves():
    """Two secure FedAvg rounds on the 8-shard pod mesh train a real model.

    Linear regression on synthetic data; every client update is encoded,
    shared, and aggregated through SimulatedPod. Loss must drop and the
    aggregate must match the plaintext quantized mean exactly.
    """
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(8,))
    xs = rng.normal(size=(4, 16, 8)).astype(np.float32)  # 4 clients
    ys = (xs @ w_true).astype(np.float32)

    def loss_fn(params, batch):
        x, y = batch
        pred = x @ params["w"] + params["b"]
        return torch.mean((pred - y) ** 2)

    trainer = LocalTrainer(loss_fn, sgd(0.05), device="cpu")
    global_params = {"w": torch.zeros((8,), dtype=torch.float32),
                     "b": torch.zeros((), dtype=torch.float32)}
    global_vec, unravel = ravel_pytree(global_params)
    global_vec = global_vec.numpy()

    pod = SimulatedPod(AdditiveSharing(share_count=8, modulus=M31),
                       mesh=make_mesh(4, 2, devices=CPU8))
    codec = FixedPointCodec(M31, fractional_bits=16, max_summands=4, clip=4.0)

    def global_loss(params):
        return float(np.mean([
            float(loss_fn(params, (torch.from_numpy(xs[i]),
                                   torch.from_numpy(ys[i]))))
            for i in range(4)]))

    losses = [global_loss(global_params)]
    for _ in range(2):
        client_vecs = []
        for i in range(4):
            p = unravel(global_vec)
            st = trainer.init_state(p)
            batches = (np.tile(xs[i][None], (3, 1, 1)),
                       np.tile(ys[i][None], (3, 1)))
            p, st, _ = trainer.fit(p, st, batches)
            vec, _ = ravel_pytree(p)
            client_vecs.append(vec.numpy())

        # plaintext oracle for the same quantized round
        deltas = np.stack(client_vecs) - global_vec[None, :]
        expected_mean = np.stack(
            [codec.quantize(d) for d in deltas]).sum(0) / codec.scale / 4

        new_vec = pod_fedavg_round(pod, codec, global_vec, client_vecs,
                                   len(losses))
        np.testing.assert_allclose(new_vec - global_vec, expected_mean,
                                   rtol=0, atol=0)
        global_vec = new_vec
        global_params = unravel(global_vec)
        losses.append(global_loss(global_params))

    assert losses[-1] < losses[0] * 0.7, losses


def test_streamed_fedavg_lora_adapters():
    """pod_fedavg_round is polymorphic over the aggregation surfaces: the
    same call drives StreamedPod (the large-model path, i.e. the lora-13m
    setting) with LoRA adapter vectors, exactly."""
    lora = LoRAMLP(features=32, layers=2, rank=4, in_features=16,
                   device="cpu")
    adapters = lora_adapter_params(lora)
    gvec, unravel = ravel_pytree(adapters)
    gvec = gvec.numpy()

    pod = StreamedPod(AdditiveSharing(share_count=8, modulus=M31),
                      mesh=make_mesh(4, 2, devices=CPU8), dim_chunk=256)
    codec = FixedPointCodec(M31, fractional_bits=16, max_summands=3, clip=2.0)

    rng = np.random.default_rng(5)
    client_vecs = gvec[None, :] + rng.normal(0, 0.1, size=(3, gvec.size))
    deltas = client_vecs - gvec[None, :]
    expected = np.stack([codec.quantize(d) for d in deltas]).sum(0) \
        / codec.scale / 3

    new_vec = pod_fedavg_round(pod, codec, gvec, client_vecs, 9)
    # compare the updated vector itself: (g + m) - g re-rounds in float64
    np.testing.assert_array_equal(new_vec, gvec + expected)
    merged = merge_lora_params(dict(lora.state_dict()), unravel(new_vec))
    out = torch.func.functional_call(lora, merged, (torch.zeros((2, 16)),))
    assert out.shape == (2, 10)


# ---------------------------------------------------------------------------
# the port against the JAX package

def test_local_trainer_equals_reference_sgd():
    """3 SGD steps of LeNet from the same weights and batches: params
    within atol 1e-5, the mean loss within rtol 1e-5; the caller's params
    are not changed (the reference is functional)."""
    rng = np.random.default_rng(11)
    xs = rng.normal(size=(3, 8, 28, 28, 1)).astype(np.float32)
    ys = rng.integers(0, 10, size=(3, 8)).astype(np.int32)
    rmod = ref_families.LeNet(width=1)
    rparams = jax.tree_util.tree_map(
        np.asarray, rmod.init(jax.random.PRNGKey(2), xs[0, :1]))

    def ref_loss(params, batch):
        x, y = batch
        return optax.softmax_cross_entropy_with_integer_labels(
            rmod.apply(params, x), y).mean()

    ref_trainer = RefTrainer(ref_loss, optax.sgd(0.1))
    ref_out, _, ref_mean = ref_trainer.fit(
        rparams, ref_trainer.init_state(rparams),
        (jnp.asarray(xs), jnp.asarray(ys)))

    tmod = LeNet(width=1, device="cpu")
    params = dict(family_params_from_flax(tmod, rparams))
    before = {k: v.clone() for k, v in params.items()}

    def loss_fn(p, batch):
        x, y = batch
        return F.cross_entropy(torch.func.functional_call(tmod, p, (x,)),
                               y.long())

    trainer = LocalTrainer(loss_fn, sgd(0.1), device="cpu")
    out, state, mean = trainer.fit(params, trainer.init_state(params),
                                   (xs, ys))
    assert state == ()
    for k, v in params.items():
        assert torch.equal(v, before[k]), k
    assert float(mean) == pytest.approx(float(ref_mean), rel=1e-5)
    want = jax.tree_util.tree_leaves_with_path(ref_out)
    got = dict(jax.tree_util.tree_leaves_with_path(
        family_params_to_flax(out)))
    for path, value in want:
        np.testing.assert_allclose(got[path], np.asarray(value), rtol=0,
                                   atol=1e-5)
    # the steps moved every param
    assert all(not torch.equal(out[k], before[k]) for k in before)


@pytest.mark.parametrize("caller_tf32", [True, False])
def test_local_trainer_steps_run_without_tf32(caller_tf32):
    """The trainer's step and the families' forward (training and eval)
    run under the TF32 setting ``models.precision`` states (off: full
    float32 convolutions and matrix products), set in scope only: the
    caller's setting stands before and after."""
    from sda_tpu_torch.models import precision

    assert precision.CUDNN_TF32 is False
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = caller_tf32
    try:
        seen = []
        tmod = LeNet(width=1, device="cpu")
        tmod.Conv_0.register_forward_pre_hook(lambda *_: seen.append(
            ("conv", cudnn.allow_tf32, matmul.allow_tf32)))

        def loss_fn(p, batch):
            seen.append(("step", cudnn.allow_tf32, matmul.allow_tf32))
            x, y = batch
            return F.cross_entropy(torch.func.functional_call(tmod, p, (x,)),
                                   y.long())

        rng = np.random.default_rng(12)
        xs = rng.normal(size=(2, 4, 28, 28, 1)).astype(np.float32)
        ys = rng.integers(0, 10, size=(2, 4))
        params = dict(tmod.state_dict())
        trainer = LocalTrainer(loss_fn, sgd(0.1), device="cpu")
        trainer.fit(params, trainer.init_state(params), (xs, ys))
        assert seen == [("step", False, False), ("conv", False, False)] * 2
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (caller_tf32,
                                                         caller_tf32)
        with torch.no_grad():  # eval: the forward alone
            tmod(torch.from_numpy(xs[0]))
        assert seen[-1] == ("conv", False, False)
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (caller_tf32,
                                                         caller_tf32)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def _flagship():
    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    return PackedShamirSharing(3, 8, t, p, w2, w3), p


def _ref_scheme(obj):
    if isinstance(obj, FullMasking):
        return ref_proto.LinearMaskingScheme.from_obj(obj.to_obj())
    return ref_proto.LinearSecretSharingScheme.from_obj(obj.to_obj())


@pytest.mark.parametrize("surface", ["simulated", "simulated-k1",
                                     "streamed", "streamed-k1"])
def test_pod_fedavg_round_equals_reference_bit_for_bit(surface):
    """The same float cohort through the reference's pod (jax's 8 CPU
    devices) and the port's (``["cpu"] * 8``): the same new global vector,
    bit for bit. The masks cancel, so the aggregate is the exact sum."""
    scheme, p = _flagship()
    masking = FullMasking(p)
    P, d = 7, 1_001
    rng = np.random.default_rng(21)
    global_vec = rng.normal(0, 1, size=d)
    client_vecs = global_vec[None, :] + rng.normal(0, 0.3, size=(P, d))
    client_vecs[0, :5] += 7.0          # clipped coordinates
    codec = FixedPointCodec(p, 16, P, clip=1.0)
    ref_codec = RefCodec(p, 16, P, clip=1.0)
    k1 = surface.endswith("-k1")
    if surface.startswith("simulated"):
        pod = SimulatedPod(scheme, masking, mesh=make_mesh(4, 2,
                                                           devices=CPU8),
                           use_pallas=k1)
        ref_pod = ref_mesh.SimulatedPod(
            _ref_scheme(scheme), masking_scheme=_ref_scheme(masking),
            mesh=ref_mesh.make_mesh(4, 2))
    else:
        pod = StreamedPod(scheme, masking, mesh=make_mesh(4, 2,
                                                          devices=CPU8),
                          participants_chunk=4, dim_chunk=300,
                          use_pallas=k1)
        ref_pod = ref_mesh.StreamedPod(
            _ref_scheme(scheme), masking_scheme=_ref_scheme(masking),
            mesh=ref_mesh.make_mesh(4, 2), participants_chunk=4,
            dim_chunk=300)
    want = ref_pod_fedavg_round(ref_pod, ref_codec, global_vec, client_vecs,
                                jax.random.PRNGKey(4))
    got = pod_fedavg_round(pod, codec, global_vec, client_vecs, 4)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, np.asarray(want))
    # a cohort given as a tensor (read in place on the pod's device), and
    # as a list of vectors, gives the same vector
    np.testing.assert_array_equal(pod_fedavg_round(
        pod, codec, torch.from_numpy(global_vec),
        torch.from_numpy(client_vecs), 5), got)
    np.testing.assert_array_equal(pod_fedavg_round(
        pod, codec, global_vec, list(client_vecs), 6), got)


def test_pod_fedavg_round_keeps_the_reference_checks():
    scheme, p = _flagship()
    pod = SimulatedPod(scheme, FullMasking(p),
                       mesh=make_mesh(1, 1, devices=["cpu"]))
    codec = FixedPointCodec(p, 16, 2, clip=1.0)
    with pytest.raises(ValueError, match="incompatible with global"):
        pod_fedavg_round(pod, codec, np.zeros(4), np.zeros((2, 5)))
    with pytest.raises(ValueError, match="exceed codec capacity 2"):
        pod_fedavg_round(pod, codec, np.zeros(4), np.zeros((3, 4)))
    with pytest.raises(ValueError, match="the decoded mean would be"):
        pod_fedavg_round(pod, FixedPointCodec(M31, 16, 2, clip=1.0),
                         np.zeros(4), np.zeros((2, 4)))
