"""Twin of ``tests/test_bincodec.py`` on the port: the binary wire codec
(``application/x-sda-bin``) of ``sda_tpu_torch.protocol.bincodec``.

The reference file's recipes run against the port with the same resources
and sizes; wherever both packages produce a result, the two are held
equal: the encoded bytes of every resource, the decoded arrays, and the
codec counters of a round over the real HTTP stack (clients on
``device="cpu"``). Every port resource also decodes with the reference's
codec, and every reference encoding with the port's.
"""

import json
import uuid

import numpy as np
import pytest

from sda_tpu.protocol import bincodec as ref_bincodec
from sda_tpu_torch.protocol import (
    AgentId,
    AggregationId,
    Binary,
    ClerkingJob,
    ClerkingJobId,
    ClerkingResult,
    Encryption,
    Participation,
    ParticipationId,
    SnapshotId,
    bincodec,
)

from torch_util import to_reference


def _uuid(n: int) -> uuid.UUID:
    return uuid.UUID(int=n)


def _participation(recipient_encryption=True, clerks=3) -> Participation:
    return Participation(
        id=ParticipationId(_uuid(1)),
        participant=AgentId(_uuid(2)),
        aggregation=AggregationId(_uuid(3)),
        recipient_encryption=(
            Encryption("Sodium", Binary(b"mask-ciphertext"))
            if recipient_encryption else None
        ),
        clerk_encryptions=[
            (AgentId(_uuid(10 + i)),
             Encryption("Sodium", Binary(bytes([i]) * (i + 2))))
            for i in range(clerks)
        ],
    )


def _job() -> ClerkingJob:
    return ClerkingJob(
        id=ClerkingJobId(_uuid(4)),
        clerk=AgentId(_uuid(5)),
        aggregation=AggregationId(_uuid(6)),
        snapshot=SnapshotId(_uuid(7)),
        encryptions=[
            Encryption("Sodium", Binary(b"column-entry-0")),
            Encryption("PackedPaillier", Binary(b"\x02\x01\x01\x2a")),
        ],
    )


def _result() -> ClerkingResult:
    return ClerkingResult(
        job=ClerkingJobId(_uuid(8)),
        clerk=AgentId(_uuid(9)),
        encryption=Encryption("Sodium", Binary(b"combined")),
    )


# -- golden round-trips ------------------------------------------------------

@pytest.mark.parametrize("resource", [
    _participation(),
    _participation(recipient_encryption=False, clerks=1),
    _participation(clerks=0),
    _job(),
    _result(),
], ids=["participation", "participation-nomask", "participation-empty",
        "job", "result"])
def test_round_trip_equals_json_wire(resource):
    raw = bincodec.encode(resource)
    decoded = bincodec.decode(raw)
    assert decoded == resource
    # same value as the JSON wire derives from the same object
    assert decoded == type(resource).from_obj(resource.to_obj())
    # the reference encodes the same resource to the same bytes, and each
    # package decodes the other's
    ref = to_reference(resource)
    assert ref_bincodec.encode(ref) == raw
    assert ref_bincodec.decode(raw) == ref
    assert bincodec.decode(ref_bincodec.encode(ref)) == resource


def test_golden_bytes_pinned():
    # format drift tripwire: any change to field order, framing, or
    # endianness must show up here as a deliberate golden update
    raw = bincodec.encode(_participation(clerks=1))
    assert raw.hex() == (
        "53444142"  # magic "SDAB"
        "01"        # version
        "01"        # tag: participation
        "00000000000000000000000000000001"  # id
        "00000000000000000000000000000002"  # participant
        "00000000000000000000000000000003"  # aggregation
        "01"        # recipient encryption present
        "00"        # variant Sodium
        "000f" + b"mask-ciphertext".hex() +  # u1 array frame, len 15
        "01"        # one clerk encryption
        "0000000000000000000000000000000a"  # clerk id
        "00"        # variant Sodium
        "0002"      # u1 array frame, len 2
        "0000"      # payload bytes([0]) * 2
    )
    assert raw == ref_bincodec.encode(to_reference(_participation(clerks=1)))


def test_binary_is_smaller_than_json():
    p = _participation(clerks=8)
    assert len(bincodec.encode(p)) < len(json.dumps(p.to_obj()).encode())


# -- array primitive ---------------------------------------------------------

@pytest.mark.parametrize("arr", [
    np.array([], dtype=np.int64),
    np.array([-5, 0, 7, 2**62, -(2**62)], dtype=np.int64),
    np.arange(100, dtype=np.uint32),
    np.frombuffer(b"raw-bytes", dtype=np.uint8),
])
def test_array_round_trip(arr):
    out = []
    bincodec.write_array(out, arr)
    raw = b"".join(out)
    decoded, pos = bincodec.read_array(raw, 0)
    assert pos == len(raw)
    assert decoded.dtype.kind == arr.dtype.kind
    np.testing.assert_array_equal(decoded, arr)
    ref_out = []
    ref_bincodec.write_array(ref_out, arr)
    assert b"".join(ref_out) == raw
    ref_decoded, ref_pos = ref_bincodec.read_array(raw, 0)
    assert ref_pos == pos and ref_decoded.dtype == decoded.dtype
    np.testing.assert_array_equal(ref_decoded, decoded)


def test_array_rejects_garbage():
    with pytest.raises(ValueError):
        bincodec.read_array(b"\xff\x04abcd", 0)  # unknown dtype tag
    out = []
    bincodec.write_array(out, np.array([1, 2], dtype=np.int64))
    with pytest.raises(ValueError):
        bincodec.read_array(b"".join(out)[:-3], 0)  # truncated payload


# -- malformed payloads ------------------------------------------------------

@pytest.mark.parametrize("mutate", [
    lambda raw: b"JSON" + raw[4:],          # bad magic
    lambda raw: raw[:4] + b"\x63" + raw[5:],  # wrong version
    lambda raw: raw[:5] + b"\x7f" + raw[6:],  # unknown tag
    lambda raw: raw[:-1],                    # truncated
    lambda raw: raw + b"\x00",               # trailing bytes
], ids=["magic", "version", "tag", "truncated", "trailing"])
def test_malformed_payload_raises(mutate):
    raw = bincodec.encode(_participation())
    with pytest.raises(ValueError):
        bincodec.decode(mutate(raw))
    with pytest.raises(ValueError):
        ref_bincodec.decode(mutate(raw))


def test_decode_rejects_wrong_resource_for_typed_decoder():
    with pytest.raises(ValueError):
        bincodec.decode_clerking_job(bincodec.encode(_result()))


# -- incremental (feed-based) decode ----------------------------------------

_FEED_RESOURCES = [
    _participation(),
    _participation(recipient_encryption=False, clerks=1),
    _participation(clerks=0),
    _job(),
    _result(),
]


@pytest.mark.parametrize("resource", _FEED_RESOURCES, ids=[
    "participation", "participation-nomask", "participation-empty",
    "job", "result"])
@pytest.mark.parametrize("chunk", [1, 2, 3, 7, 16, 64, 10_000])
def test_feed_decoder_matches_one_shot_at_every_chunk_size(resource, chunk):
    """The streaming decoder is the same wire contract, delivered in
    arbitrary network-chunk slices: byte-for-byte equal results, and
    equal to the reference's streaming decoder on the same slices."""
    raw = bincodec.encode(resource)
    decoder = bincodec.FeedDecoder()
    ref_decoder = ref_bincodec.FeedDecoder()
    for pos in range(0, len(raw), chunk):
        decoder.feed(raw[pos:pos + chunk])
        ref_decoder.feed(raw[pos:pos + chunk])
    assert decoder.done and ref_decoder.done
    assert decoder.fed_bytes == ref_decoder.fed_bytes == len(raw)
    assert decoder.finish() == resource
    assert ref_decoder.finish() == to_reference(resource)
    # the convenience iterator wrapper agrees
    assert bincodec.decode_stream(
        raw[pos:pos + chunk] for pos in range(0, len(raw), chunk)
    ) == resource


def test_feed_decoder_expect_tag_pins_resource_kind():
    raw = bincodec.encode(_result())
    decoder = bincodec.FeedDecoder(bincodec.TAG_PARTICIPATION)
    with pytest.raises(ValueError):
        decoder.feed(raw)
    assert bincodec.TAG_PARTICIPATION == ref_bincodec.TAG_PARTICIPATION


def test_feed_decoder_truncation_and_trailing():
    raw = bincodec.encode(_participation())
    decoder = bincodec.FeedDecoder()
    decoder.feed(raw[:-1])
    assert not decoder.done
    with pytest.raises(ValueError):
        decoder.finish()  # truncated
    decoder = bincodec.FeedDecoder()
    with pytest.raises(ValueError):
        decoder.feed(raw + b"\x00")  # trailing bytes
    # trailing bytes in a LATER chunk are caught too
    decoder = bincodec.FeedDecoder()
    decoder.feed(raw)
    with pytest.raises(ValueError):
        decoder.feed(b"\x00")


@pytest.mark.parametrize("mutate", [
    lambda raw: b"JSON" + raw[4:],
    lambda raw: raw[:4] + b"\x63" + raw[5:],
    lambda raw: raw[:5] + b"\x7f" + raw[6:],
], ids=["magic", "version", "tag"])
def test_feed_decoder_malformed_header_raises_midstream(mutate):
    raw = mutate(bincodec.encode(_participation()))
    decoder = bincodec.FeedDecoder()
    with pytest.raises(ValueError):
        for pos in range(0, len(raw), 3):
            decoder.feed(raw[pos:pos + 3])


def test_feed_decoder_releases_consumed_bytes():
    """O(frame) memory: after feeding everything but the tail, the
    internal buffer holds only the unparsed remainder — consumed field
    bytes (the big ciphertexts) are not retained as raw input."""
    big = Participation(
        id=ParticipationId(_uuid(1)), participant=AgentId(_uuid(2)),
        aggregation=AggregationId(_uuid(3)), recipient_encryption=None,
        clerk_encryptions=[
            (AgentId(_uuid(10 + i)),
             Encryption("Sodium", Binary(bytes(200_000))))
            for i in range(8)
        ],
    )
    raw = bincodec.encode(big)
    decoder = bincodec.FeedDecoder()
    for pos in range(0, len(raw), 65536):
        decoder.feed(raw[pos:pos + 65536])
        # transient buffer never holds more than one unparsed frame tail
        assert len(decoder._buf) < 256_000
    assert decoder.finish() == big


# -- mixed-version negotiation over the real HTTP stack ----------------------

sodium_available = pytest.importorskip(
    "sda_tpu.crypto.sodium", reason="libsodium needed"
).available()
pytestmark_http = pytest.mark.skipif(not sodium_available,
                                     reason="libsodium not present")


@pytest.fixture
def codec_counters():
    from sda_tpu_torch import obs
    from sda_tpu_torch.utils import metrics

    obs.reset_all()
    yield lambda: metrics.counter_report("http.codec.")
    obs.reset_all()


def _run_round(codec: str, bin_server: bool):
    """The reference file's round (``test_full_loop.check_full_aggregation``
    on its default aggregation) through the port's HTTP stack, clients on
    the CPU."""
    import test_torch_full_loop as tfl
    from sda_tpu_torch.http import SdaHttpClient, SdaHttpServer
    from sda_tpu_torch.server import new_memory_server

    server = SdaHttpServer(new_memory_server(), bind="127.0.0.1:0",
                           bin_codec=bin_server).start_background()
    try:
        proxy = SdaHttpClient(server.address, token="codec-test", codec=codec)
        tfl.check_full_aggregation(tfl.agg_default(), proxy)
    finally:
        server.shutdown()


@pytestmark_http
def test_auto_client_upgrades_against_bin_server(codec_counters):
    _run_round("auto", bin_server=True)
    counters = codec_counters()
    # hot POSTs (participations + results) binary, job downloads binary
    assert counters.get("http.codec.bin.in", 0) > 0
    assert counters.get("http.codec.bin.out", 0) > 0


@pytestmark_http
def test_auto_client_stays_json_against_old_server(codec_counters):
    # old server: no advert, no binary parsing — the round still works
    _run_round("auto", bin_server=False)
    counters = codec_counters()
    assert counters.get("http.codec.bin.in", 0) == 0
    assert counters.get("http.codec.bin.out", 0) == 0


@pytestmark_http
def test_json_pinned_client_stays_json_against_bin_server(codec_counters):
    _run_round("json", bin_server=True)
    counters = codec_counters()
    assert counters.get("http.codec.bin.in", 0) == 0
    assert counters.get("http.codec.bin.out", 0) == 0
    assert counters.get("http.codec.json.in", 0) > 0


@pytestmark_http
def test_forced_bin_client_against_bin_server(codec_counters):
    _run_round("bin", bin_server=True)
    counters = codec_counters()
    assert counters.get("http.codec.bin.in", 0) > 0
    assert counters.get("http.codec.json.in", 0) == 0


@pytestmark_http
@pytest.mark.parametrize("codec,bin_server", [
    ("auto", True), ("auto", False), ("json", True), ("bin", True)])
def test_codec_counters_match_reference(codec, bin_server):
    """The same round through both packages' HTTP stacks counts the same
    requests by codec and direction."""
    import test_full_loop as ref_tfl
    from sda_tpu import obs as ref_obs
    from sda_tpu.http import SdaHttpClient as RefClient
    from sda_tpu.http import SdaHttpServer as RefServer
    from sda_tpu.server import new_memory_server as ref_memory_server
    from sda_tpu.utils import metrics as ref_metrics
    from sda_tpu_torch import obs
    from sda_tpu_torch.utils import metrics

    obs.reset_all()
    ref_obs.reset_all()
    try:
        _run_round(codec, bin_server)
        server = RefServer(ref_memory_server(), bind="127.0.0.1:0",
                           bin_codec=bin_server).start_background()
        try:
            ref_tfl.check_full_aggregation(ref_tfl.agg_default(), RefClient(
                server.address, token="codec-test", codec=codec))
        finally:
            server.shutdown()
        assert metrics.counter_report("http.codec.") == \
            ref_metrics.counter_report("http.codec.")
    finally:
        obs.reset_all()
        ref_obs.reset_all()


def test_unknown_codec_mode_rejected():
    from sda_tpu_torch.http import SdaHttpClient

    with pytest.raises(ValueError):
        SdaHttpClient("http://localhost:1", token="t", codec="cbor")
