"""The broker's Paillier premix in the port's server: the recipes of
``tests/test_paillier.py`` (``test_server_premixes_paillier_clerk_columns``,
``test_premix_survives_malformed_participation``,
``test_premix_over_http_seam``) through ``sda_tpu_torch``.

Every role is an ``SdaClient(..., device="cpu")``. With
``SDA_PREMIX_DEVICE=1`` the snapshot folds each clerk's column through K4,
here its plain version (``encryption.PREMIX_DEVICE = "cpu"``); the size
floor is lowered to 1 so these tiny columns reach it, as the reference's
test does. Every round reveals exactly, and every clerk job holds the
premixed batch count.
"""

import functools

import numpy as np
import pytest

from sda_tpu_torch.client import SdaClient
from sda_tpu_torch.crypto import MemoryKeystore, encryption
from sda_tpu_torch.protocol import (
    AdditiveSharing,
    Aggregation,
    AggregationId,
    FullMasking,
    PackedPaillierEncryption,
)
from sda_tpu_torch.server import new_memory_server

SCHEME = PackedPaillierEncryption(
    component_count=3, component_bitsize=32, max_value_bitsize=16,
    min_modulus_bitsize=512,
)


@pytest.fixture
def device_legs(monkeypatch):
    """The premix runs on the CPU; returns the row counts of every fold
    that took the device leg."""
    legs = []
    leg = encryption._device_premix_rows
    monkeypatch.setattr(encryption, "PREMIX_DEVICE", "cpu")
    monkeypatch.setattr(encryption, "_device_premix_rows",
                        lambda pk, rows: legs.append(len(rows))
                        or leg(pk, rows))
    return legs


def _client(service, keystore=None):
    keystore = keystore if keystore is not None else MemoryKeystore()
    agent = SdaClient.new_agent(keystore)
    return SdaClient(agent, keystore, service, device="cpu")


def _aggregation(recipient, recipient_key, title, committee_scheme):
    return Aggregation(
        id=AggregationId.random(),
        title=title,
        vector_dimension=4,
        modulus=433,
        recipient=recipient.agent.id,
        recipient_key=recipient_key,
        masking_scheme=FullMasking(433),
        committee_sharing_scheme=AdditiveSharing(share_count=3, modulus=433),
        recipient_encryption_scheme=SCHEME,
        committee_encryption_scheme=committee_scheme,
    )


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("capacity_bits", [16, 1], ids=["one-batch", "chunked"])
def test_server_premixes_paillier_clerk_columns(capacity_bits, device,
                                                monkeypatch, device_legs):
    if device:
        monkeypatch.setenv("SDA_PREMIX_DEVICE", "1")
        monkeypatch.setattr(encryption, "_DEVICE_PREMIX_MIN_MODMULS", 1)
    else:
        monkeypatch.delenv("SDA_PREMIX_DEVICE", raising=False)
    service = new_memory_server()
    service.server.premix_paillier = True
    scheme = PackedPaillierEncryption(3, 16 + capacity_bits, 16, 512)

    recipient = _client(service)
    recipient_key = recipient.new_encryption_key(SCHEME)
    recipient.upload_agent()
    recipient.upload_encryption_key(recipient_key)
    aggregation = _aggregation(recipient, recipient_key, "premix", scheme)
    recipient.upload_aggregation(aggregation)
    clerks = [_client(service) for _ in range(3)]
    for clerk in clerks:
        clerk.upload_agent()
        clerk.upload_encryption_key(clerk.new_encryption_key(scheme))
    recipient.begin_aggregation(aggregation.id)

    n_participants = 5
    rng = np.random.default_rng(11)
    vectors = rng.integers(0, 433, size=(n_participants, 4))
    for v in vectors:
        participant = _client(service)
        participant.upload_agent()
        participant.participate([int(x) for x in v], aggregation.id)
    recipient.end_aggregation(aggregation.id)

    capacity = scheme.additive_capacity
    expected_batches = -(-n_participants // capacity)
    # the device leg folds every chunk of more than one batch
    chunks = [min(capacity, n_participants - lo)
              for lo in range(0, n_participants, capacity)]
    assert device_legs == ([c for c in chunks if c > 1] * 3 if device else [])
    store = service.server.clerking_job_store
    seen_jobs = 0
    for clerk in clerks + [recipient]:
        job = store.poll_clerking_job(clerk.agent.id)
        if job is None:
            continue
        seen_jobs += 1
        assert len(job.encryptions) == expected_batches, (
            f"clerk column not premixed: {len(job.encryptions)} batches")
    assert seen_jobs == 3

    recipient.run_chores(-1)
    for clerk in clerks:
        clerk.run_chores(-1)
    output = recipient.reveal_aggregation(aggregation.id)
    np.testing.assert_array_equal(output.positive().values,
                                  vectors.sum(axis=0) % 433)


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_premix_survives_malformed_participation(device, monkeypatch,
                                                 device_legs):
    """A forged ciphertext frame makes the server skip premixing for the
    affected columns (enqueued unmixed) instead of failing the recipient's
    end_aggregation."""
    from sda_tpu_torch.protocol import Binary, Encryption

    if device:
        monkeypatch.setenv("SDA_PREMIX_DEVICE", "1")
        monkeypatch.setattr(encryption, "_DEVICE_PREMIX_MIN_MODMULS", 1)
    else:
        monkeypatch.delenv("SDA_PREMIX_DEVICE", raising=False)
    service = new_memory_server()
    service.server.premix_paillier = True

    recipient = _client(service)
    recipient_key = recipient.new_encryption_key(SCHEME)
    recipient.upload_agent()
    recipient.upload_encryption_key(recipient_key)
    aggregation = _aggregation(recipient, recipient_key, "premix-hostile",
                               SCHEME)
    recipient.upload_aggregation(aggregation)
    clerks = [_client(service) for _ in range(3)]
    for clerk in clerks:
        clerk.upload_agent()
        clerk.upload_encryption_key(clerk.new_encryption_key(SCHEME))
    recipient.begin_aggregation(aggregation.id)

    honest = _client(service)
    honest.upload_agent()
    honest.participate([1, 2, 3, 4], aggregation.id)

    hostile = _client(service)
    hostile.upload_agent()
    participation = hostile.new_participation([5, 6, 7, 8], aggregation.id)
    forged = bytes([3, 0x7F]) + bytes(8)  # count=3, summands=127
    participation.clerk_encryptions = [
        (cid, Encryption("PackedPaillier", Binary(forged)))
        for (cid, _) in participation.clerk_encryptions
    ]
    service.create_participation(hostile.agent, participation)

    recipient.end_aggregation(aggregation.id)
    assert device_legs == []  # the frame is refused before any fold
    store = service.server.clerking_job_store
    job = store.poll_clerking_job(clerks[0].agent.id)
    if job is None:
        job = store.poll_clerking_job(recipient.agent.id)
    assert job is not None
    assert len(job.encryptions) == 2  # unmixed: one per participation


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_premix_over_http_seam(device, tmp_path, monkeypatch, device_legs):
    """Clerks polling over HTTP receive the homomorphically combined
    batches and the round stays exact."""
    from sda_tpu_torch.http.client import SdaHttpClient
    from sda_tpu_torch.http.server import SdaHttpServer
    from sda_tpu_torch.store import Filebased

    if device:
        monkeypatch.setenv("SDA_PREMIX_DEVICE", "1")
        monkeypatch.setattr(encryption, "_DEVICE_PREMIX_MIN_MODMULS", 1)
    else:
        monkeypatch.delenv("SDA_PREMIX_DEVICE", raising=False)
    service = new_memory_server()
    service.server.premix_paillier = True
    httpd = SdaHttpServer(service, bind="127.0.0.1:0").start_background()
    try:
        def new_client(name):
            ks = Filebased(tmp_path / name)
            agent = SdaClient.new_agent(ks)
            return SdaClient(agent, ks, SdaHttpClient(httpd.address, ks),
                             device="cpu")

        recipient = new_client("recipient")
        recipient_key = recipient.new_encryption_key(SCHEME)
        recipient.upload_agent()
        recipient.upload_encryption_key(recipient_key)
        aggregation = _aggregation(recipient, recipient_key, "premix-http",
                                   SCHEME)
        recipient.upload_aggregation(aggregation)
        clerks = [new_client(f"clerk-{i}") for i in range(3)]
        for clerk in clerks:
            clerk.upload_agent()
            clerk.upload_encryption_key(clerk.new_encryption_key(SCHEME))
        recipient.begin_aggregation(aggregation.id)
        for i in range(4):
            participant = new_client(f"p-{i}")
            participant.upload_agent()
            participant.participate([i, 2, 3, 4], aggregation.id)
        recipient.end_aggregation(aggregation.id)
        assert device_legs == ([4] * 3 if device else [])

        premixed_jobs = 0
        for member in clerks + [recipient]:
            polled = service.get_clerking_job(member.agent, member.agent.id)
            if polled is not None:
                assert len(polled.encryptions) == 1
                premixed_jobs += 1
        assert premixed_jobs == 3

        recipient.run_chores(-1)
        for clerk in clerks:
            clerk.run_chores(-1)
        output = recipient.reveal_aggregation(aggregation.id)
        np.testing.assert_array_equal(output.positive().values,
                                      [6 % 433, 8, 12, 16])
    finally:
        httpd.shutdown()


def _premix_round(service, committee_scheme, vectors):
    """Recipient and three clerks with keys of ``committee_scheme`` (the
    recipient may sit on the committee) and one participant a vector, up
    to the snapshot (end_aggregation)."""
    recipient = _client(service)
    recipient_key = recipient.new_encryption_key(committee_scheme)
    recipient.upload_agent()
    recipient.upload_encryption_key(recipient_key)
    aggregation = _aggregation(recipient, recipient_key, "premix-wide",
                               committee_scheme)
    recipient.upload_aggregation(aggregation)
    clerks = [_client(service) for _ in range(3)]
    for clerk in clerks:
        clerk.upload_agent()
        clerk.upload_encryption_key(clerk.new_encryption_key(committee_scheme))
    recipient.begin_aggregation(aggregation.id)
    for v in vectors:
        participant = _client(service)
        participant.upload_agent()
        participant.participate([int(x) for x in v], aggregation.id)
    recipient.end_aggregation(aggregation.id)
    return recipient, clerks, aggregation


def test_premix_folds_keys_above_2048_bits(monkeypatch, device_legs):
    """A 3072-bit committee key (n^2 of 192 limbs: K4's wide instance on
    the card) is premixed on the device leg like any other, never skipped
    as malformed input. One key pair serves the recipient and the three
    clerks, so the test makes a single 3072-bit key."""
    from sda_tpu_torch.crypto import paillier
    from sda_tpu_torch.utils import metrics

    monkeypatch.setenv("SDA_PREMIX_DEVICE", "1")
    monkeypatch.setattr(encryption, "_DEVICE_PREMIX_MIN_MODMULS", 1)
    monkeypatch.setattr(paillier, "keygen",
                        functools.lru_cache(maxsize=None)(paillier.keygen))
    skipped = metrics.counter_report().get("server.premix.skipped_malformed",
                                           0)
    service = new_memory_server()
    service.server.premix_paillier = True
    scheme = PackedPaillierEncryption(3, 32, 16, 3072)
    vectors = np.random.default_rng(12).integers(0, 433, size=(3, 4))
    recipient, clerks, aggregation = _premix_round(service, scheme, vectors)

    assert device_legs == [3] * 3
    assert 192 in {ctx.L for ctx in encryption._MONT_CTX_CACHE.values()}
    assert metrics.counter_report().get("server.premix.skipped_malformed",
                                        0) == skipped
    store = service.server.clerking_job_store
    jobs = [store.poll_clerking_job(m.agent.id) for m in clerks + [recipient]]
    assert sorted(len(j.encryptions) for j in jobs if j is not None) == [1] * 3
    recipient.run_chores(-1)
    for clerk in clerks:
        clerk.run_chores(-1)
    output = recipient.reveal_aggregation(aggregation.id)
    np.testing.assert_array_equal(output.positive().values,
                                  vectors.sum(axis=0) % 433)


def test_premix_device_failure_is_not_taken_for_malformed_input(
        monkeypatch, device_legs):
    """A device leg that fails (K4 raising RuntimeError) fails the snapshot:
    it is not counted as a malformed ciphertext and the column is not
    enqueued unmixed, and no host fold stands in for it."""
    from sda_tpu_torch.crypto import paillier_tpu
    from sda_tpu_torch.utils import metrics

    def broken(*args):
        raise RuntimeError("K4 kernel launch failed")

    monkeypatch.setenv("SDA_PREMIX_DEVICE", "1")
    monkeypatch.setattr(encryption, "_DEVICE_PREMIX_MIN_MODMULS", 1)
    monkeypatch.setattr(paillier_tpu, "montgomery_kernel", broken)
    skipped = metrics.counter_report().get("server.premix.skipped_malformed",
                                           0)
    service = new_memory_server()
    service.server.premix_paillier = True
    with pytest.raises(RuntimeError, match="K4 kernel launch failed"):
        _premix_round(service, SCHEME, [[1, 2, 3, 4], [5, 6, 7, 8]])
    assert device_legs == [2]
    assert metrics.counter_report().get("server.premix.skipped_malformed",
                                        0) == skipped
