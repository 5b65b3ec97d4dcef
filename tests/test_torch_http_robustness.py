"""The recipes of ``tests/test_http_robustness.py`` against the port's
HTTP server and serde: hostile and malformed requests map to the same
clean 4xx statuses the reference's server gives (both servers are asked
the same requests), never a 500 or a wedged connection; the seeded serde
fuzz and the varint fuzz agree with the reference object for object."""

import base64
import json
import urllib.error
import urllib.request
import uuid

import numpy as np
import pytest

import sda_tpu.protocol as ref_protocol
from sda_tpu.crypto import varint as ref_varint
from sda_tpu.http.server import SdaHttpServer as RefSdaHttpServer
from sda_tpu.server import new_memory_server as ref_new_memory_server
from sda_tpu_torch.http.server import SdaHttpServer
from sda_tpu_torch.protocol import (AdditiveSharing, Aggregation,
                                    AggregationId, AgentId, ChaChaMasking,
                                    EncryptionKeyId, FullMasking, NoMasking,
                                    PackedPaillierEncryption,
                                    PackedShamirSharing, SodiumEncryption)
from sda_tpu_torch.server import new_memory_server

AUTH = "aa0c2e05-5f7a-4169-9b45-477d57d5b131:tok"


@pytest.fixture
def servers():
    """The port's server and the reference's, each over its memory
    service."""
    both = [SdaHttpServer(new_memory_server(), bind="127.0.0.1:0"),
            RefSdaHttpServer(ref_new_memory_server(), bind="127.0.0.1:0")]
    for server in both:
        server.start_background()
    yield both
    for server in both:
        server.shutdown()


def _status(req):
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers)


def _post(url, body: bytes, auth: str = AUTH):
    req = urllib.request.Request(url, data=body, method="POST")
    req.add_header("Content-Type", "application/json")
    req.add_header("Authorization",
                   "Basic " + base64.b64encode(auth.encode()).decode())
    return _status(req)


def test_malformed_json_bodies_return_400_not_500(servers):
    for srv in servers:
        url = srv.address + "/v1/agents/me"
        for body in (b"{", b"not json at all", b"[1,2,", b"\xff\xfe\x00"):
            status, _ = _post(url, body)
            assert status == 400, f"body {body!r} -> {status}"
        # connection/threading still healthy afterwards
        assert urllib.request.urlopen(srv.address + "/v1/ping",
                                      timeout=10).status == 200


def test_wrong_shape_resources_return_400(servers):
    cases = [
        {},  # missing everything
        {"id": 42, "verification_key": None},  # wrong types
        {"id": "aa0c2e05-5f7a-4169-9b45-477d57d5b131",
         "verification_key": {"id": "x",
                              "body": {"Sodium": "!!notbase64!!"}}},
    ]
    for obj in cases:
        got = [_post(srv.address + "/v1/agents/me",
                     json.dumps(obj).encode())[0] for srv in servers]
        assert got == [400, 400], f"{obj} -> {got}"


def test_missing_and_bad_auth_return_401(servers):
    for srv in servers:
        req = urllib.request.Request(srv.address + "/v1/aggregations",
                                     method="GET")
        assert _status(req)[0] == 401
        # garbage Basic header (undecodable base64): 401, not 500
        req = urllib.request.Request(srv.address + "/v1/aggregations",
                                     method="GET")
        req.add_header("Authorization", "Basic %%%garbage%%%")
        assert _status(req)[0] == 401


def test_resource_not_found_header_distinguishes_404s(servers, tmp_path):
    """Missing RESOURCE answers 404 + X-Resource-Not-Found (the client
    maps it to None); missing ROUTE answers 404 without the header (the
    client raises NotFound), lib.rs:338-343 semantics."""
    from sda_tpu_torch.client import SdaClient
    from sda_tpu_torch.http.client import SdaHttpClient
    from sda_tpu_torch.protocol import NotFound
    from sda_tpu_torch.store import Filebased

    srv = servers[0]
    ks = Filebased(tmp_path)
    client = SdaClient(SdaClient.new_agent(ks), ks,
                       SdaHttpClient(srv.address, ks), device="cpu")
    client.upload_agent()
    assert client.service.get_aggregation(
        client.agent, AggregationId.random()) is None
    http = client.service
    with pytest.raises(NotFound):
        http._get(client.agent, "/v1/definitely/not/a/route")
    user, token = http._auth(client.agent)  # the really-minted token
    req = urllib.request.Request(srv.address + "/v1/definitely/not/a/route")
    req.add_header("Authorization", "Basic " + base64.b64encode(
        f"{user}:{token}".encode()).decode())
    code, headers = _status(req)
    assert code == 404  # authenticated route-miss
    assert "X-Resource-Not-Found" not in headers


# ---------------------------------------------------------------------------
# randomized serde round-trip fuzz

def _random_sharing(rng):
    if rng.choice([True, False]):
        return AdditiveSharing(share_count=int(rng.integers(1, 50)),
                               modulus=int(rng.integers(2, 1 << 40)))
    return PackedShamirSharing(
        secret_count=int(rng.integers(1, 10)),
        share_count=int(rng.integers(2, 100)),
        privacy_threshold=int(rng.integers(1, 20)),
        prime_modulus=int(rng.integers(2, 1 << 30)),
        omega_secrets=int(rng.integers(1, 1 << 20)),
        omega_shares=int(rng.integers(1, 1 << 20)),
    )


def _random_masking(rng, modulus, dim):
    pick = rng.integers(0, 3)
    if pick == 0:
        return NoMasking()
    if pick == 1:
        return FullMasking(modulus)
    return ChaChaMasking(modulus, dim, int(rng.choice([64, 128, 256])))


def _random_encryption(rng):
    if rng.choice([True, False]):
        return SodiumEncryption()
    mvb = int(rng.integers(1, 40))
    window = mvb + int(rng.integers(0, 20))
    count = int(rng.integers(1, 16))
    return PackedPaillierEncryption(count, window, mvb,
                                    max(512, count * window + 1))


def test_aggregation_serde_roundtrip_fuzz():
    rng = np.random.default_rng(20260730)

    def seeded_id(cls):
        # ids from the seeded rng, so a failure replays exactly
        return cls(str(uuid.UUID(bytes=rng.bytes(16), version=4)))

    for _ in range(200):
        dim = int(rng.integers(1, 1 << 24))
        sharing = _random_sharing(rng)
        modulus = getattr(sharing, "modulus", None) or sharing.prime_modulus
        agg = Aggregation(
            id=seeded_id(AggregationId),
            title="t" * int(rng.integers(0, 30)) + str(rng.integers(0, 10**9)),
            vector_dimension=dim,
            modulus=modulus,
            recipient=seeded_id(AgentId),
            recipient_key=seeded_id(EncryptionKeyId),
            masking_scheme=_random_masking(rng, modulus, dim),
            committee_sharing_scheme=sharing,
            recipient_encryption_scheme=_random_encryption(rng),
            committee_encryption_scheme=_random_encryption(rng),
        )
        wire = json.dumps(agg.to_obj())
        back = Aggregation.from_obj(json.loads(wire))
        assert back.to_obj() == agg.to_obj()
        assert back.committee_sharing_scheme == agg.committee_sharing_scheme
        assert back.masking_scheme.to_obj() == agg.masking_scheme.to_obj()
        assert back.recipient_encryption_scheme == \
            agg.recipient_encryption_scheme
        # the reference reads the same text to the same object
        theirs = ref_protocol.Aggregation.from_obj(json.loads(wire))
        assert json.dumps(theirs.to_obj()) == wire


def test_varint_decode_fuzz_never_crashes():
    """Garbage byte streams: a clean ValueError or a valid decode, never
    another exception, and the reference decodes (or refuses) each one
    alike."""
    from sda_tpu_torch.crypto import varint

    rng = np.random.default_rng(41)
    decoded_some = False
    for size in [0, 1, 3, 9, 64, 513]:
        for _ in range(50):
            raw = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
            try:
                decoded = varint.decode(raw)
            except ValueError:
                with pytest.raises(ValueError):
                    ref_varint.decode(raw)
                continue
            decoded_some = True
            np.testing.assert_array_equal(
                varint.decode(varint.encode(decoded)), decoded)
            np.testing.assert_array_equal(ref_varint.decode(raw), decoded)
            assert varint.encode(decoded) == ref_varint.encode(decoded)
    assert decoded_some
