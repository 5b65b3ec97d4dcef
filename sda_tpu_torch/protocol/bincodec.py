"""``application/x-sda-bin`` — the binary wire codec for hot-path resources.

JSON frames every ciphertext as base64 text (+33% bytes) inside a parsed
object tree; at production dimension the serialization tax dominates a
participation upload. This codec frames the three hot-path resources —
``Participation`` uploads, ``ClerkingJob`` payloads, ``ClerkingResult``
uploads — as tight binary:

    header   := MAGIC "SDAB" | version u8 | resource tag u8
    uuid     := 16 raw bytes (RFC 4122 byte order)
    varlen   := LEB128 (the exact framing ``crypto/encryption.py`` uses
                inside PackedPaillier payloads — one framing, two layers)
    array    := dtype tag u8 | varlen(byte length) | raw little-endian
                bytes (``np.ndarray.tobytes`` / ``np.frombuffer``)
    bytes    := array with dtype tag ``u1``
    string   := varlen | utf-8 bytes
    option   := presence u8 (0/1) | value
    list     := varlen(count) | items
    encryption := variant u8 (0=Sodium, 1=PackedPaillier) | bytes

Integer vectors (share payloads, seeds) ride the ``array`` primitive —
dtype-tagged little-endian buffers that decode with one ``frombuffer``
call instead of a Python-int-per-element JSON parse.

Content negotiation lives in ``http/``: the server advertises
``X-SDA-Codecs: bin`` on every response and accepts both content types on
the hot POST routes; the client upgrades after seeing the advert (or is
pinned with ``codec="json"|"bin"``). Old JSON-only peers interoperate
transparently in both directions. See ``docs/performance.md``.

Malformed input raises ``ValueError`` — the HTTP layer maps it to 400,
same as malformed JSON.
"""

from __future__ import annotations

import uuid as _uuid
from typing import List, Optional, Tuple

import numpy as np

from ..crypto.encryption import leb128, read_leb128
from .crypto import Encryption
from .helpers import Binary
from .resources import (
    AgentId,
    AggregationId,
    ClerkingJob,
    ClerkingJobId,
    ClerkingResult,
    Participation,
    ParticipationId,
    SnapshotId,
)

#: The negotiated content type (and the server's advert token, "bin").
CONTENT_TYPE = "application/x-sda-bin"
CODECS_HEADER = "X-SDA-Codecs"

MAGIC = b"SDAB"
VERSION = 1

TAG_PARTICIPATION = 1
TAG_CLERKING_JOB = 2
TAG_CLERKING_RESULT = 3

#: Wire order is the codec contract: appending a variant is
#: backward-compatible, reordering is not.
_ENC_VARIANTS = ("Sodium", "PackedPaillier")

#: dtype tag -> numpy dtype. Little-endian on the wire regardless of host
#: byte order; ``u1`` doubles as the raw-bytes frame.
_DTYPES = ("u1", "<i8", "<u8", "<i4", "<u4")
_DTYPE_TAG = {np.dtype(d): tag for tag, d in enumerate(_DTYPES)}


# ---------------------------------------------------------------------------
# Primitives

def _need(raw: bytes, pos: int, n: int) -> None:
    if pos + n > len(raw):
        raise ValueError("truncated x-sda-bin payload")


def write_array(out: List[bytes], arr: np.ndarray) -> None:
    """Dtype-tagged little-endian array frame (1-D)."""
    arr = np.ascontiguousarray(arr)
    dtype = np.dtype(arr.dtype.str.replace(">", "<"))
    tag = _DTYPE_TAG.get(dtype)
    if tag is None:
        raise ValueError(f"unsupported array dtype {arr.dtype}")
    payload = arr.astype(dtype, copy=False).tobytes()
    out.append(bytes([tag]) + leb128(len(payload)))
    out.append(payload)


def read_array(raw: bytes, pos: int) -> Tuple[np.ndarray, int]:
    _need(raw, pos, 1)
    tag = raw[pos]
    if tag >= len(_DTYPES):
        raise ValueError(f"unknown array dtype tag {tag}")
    nbytes, pos = read_leb128(raw, pos + 1)
    _need(raw, pos, nbytes)
    dtype = np.dtype(_DTYPES[tag])
    if nbytes % dtype.itemsize:
        raise ValueError("array byte length not a multiple of its itemsize")
    arr = np.frombuffer(raw[pos:pos + nbytes], dtype=dtype)
    return arr, pos + nbytes


def _w_bytes(out: List[bytes], data: bytes) -> None:
    out.append(bytes([0]) + leb128(len(data)))  # dtype tag 0 == u1
    out.append(data)


def _r_bytes(raw: bytes, pos: int) -> Tuple[bytes, int]:
    arr, pos = read_array(raw, pos)
    if arr.dtype != np.uint8:
        raise ValueError("expected a u1 byte frame")
    return arr.tobytes(), pos


def _w_uuid(out: List[bytes], rid) -> None:
    out.append(rid.uuid.bytes)


def _r_uuid(raw: bytes, pos: int, cls):
    _need(raw, pos, 16)
    return cls(_uuid.UUID(bytes=raw[pos:pos + 16])), pos + 16


def _w_encryption(out: List[bytes], enc: Encryption) -> None:
    try:
        variant = _ENC_VARIANTS.index(enc.variant)
    except ValueError:
        raise ValueError(f"unsupported encryption variant {enc.variant}")
    out.append(bytes([variant]))
    _w_bytes(out, enc.value.data)


def _r_encryption(raw: bytes, pos: int) -> Tuple[Encryption, int]:
    _need(raw, pos, 1)
    variant = raw[pos]
    if variant >= len(_ENC_VARIANTS):
        raise ValueError(f"unknown encryption variant tag {variant}")
    data, pos = _r_bytes(raw, pos + 1)
    return Encryption(_ENC_VARIANTS[variant], Binary(data)), pos


# ---------------------------------------------------------------------------
# Resource codecs

def _header(tag: int) -> bytes:
    return MAGIC + bytes([VERSION, tag])


def _check_header(raw: bytes, want_tag: Optional[int] = None) -> int:
    if len(raw) < 6 or raw[:4] != MAGIC:
        raise ValueError("not an x-sda-bin payload (bad magic)")
    if raw[4] != VERSION:
        raise ValueError(f"unsupported x-sda-bin version {raw[4]}")
    tag = raw[5]
    if want_tag is not None and tag != want_tag:
        raise ValueError(f"unexpected resource tag {tag} (want {want_tag})")
    return tag


def encode_participation(p: Participation) -> bytes:
    if p.forwarded_masks is not None:
        # tree-relay participations carry forwarded mask ciphertexts the
        # v1 frame has no slot for; encoding would silently DROP them and
        # corrupt the root's unmask. The HTTP client falls back to JSON
        # for these (rare: one per leaf group per round).
        raise ValueError(
            "x-sda-bin v1 cannot frame forwarded_masks; use JSON")
    out: List[bytes] = [_header(TAG_PARTICIPATION)]
    _w_uuid(out, p.id)
    _w_uuid(out, p.participant)
    _w_uuid(out, p.aggregation)
    if p.recipient_encryption is None:
        out.append(b"\x00")
    else:
        out.append(b"\x01")
        _w_encryption(out, p.recipient_encryption)
    out.append(leb128(len(p.clerk_encryptions)))
    for clerk_id, enc in p.clerk_encryptions:
        _w_uuid(out, clerk_id)
        _w_encryption(out, enc)
    return b"".join(out)


def decode_participation(raw: bytes) -> Participation:
    _check_header(raw, TAG_PARTICIPATION)
    pos = 6
    pid, pos = _r_uuid(raw, pos, ParticipationId)
    participant, pos = _r_uuid(raw, pos, AgentId)
    aggregation, pos = _r_uuid(raw, pos, AggregationId)
    _need(raw, pos, 1)
    recipient_encryption = None
    if raw[pos] not in (0, 1):
        raise ValueError("malformed option byte")
    present, pos = raw[pos], pos + 1
    if present:
        recipient_encryption, pos = _r_encryption(raw, pos)
    count, pos = read_leb128(raw, pos)
    clerk_encryptions = []
    for _ in range(count):
        clerk_id, pos = _r_uuid(raw, pos, AgentId)
        enc, pos = _r_encryption(raw, pos)
        clerk_encryptions.append((clerk_id, enc))
    if pos != len(raw):
        raise ValueError("trailing bytes after participation payload")
    return Participation(
        id=pid, participant=participant, aggregation=aggregation,
        recipient_encryption=recipient_encryption,
        clerk_encryptions=clerk_encryptions,
    )


def encode_clerking_job(job: ClerkingJob) -> bytes:
    out: List[bytes] = [_header(TAG_CLERKING_JOB)]
    _w_uuid(out, job.id)
    _w_uuid(out, job.clerk)
    _w_uuid(out, job.aggregation)
    _w_uuid(out, job.snapshot)
    out.append(leb128(len(job.encryptions)))
    for enc in job.encryptions:
        _w_encryption(out, enc)
    return b"".join(out)


def decode_clerking_job(raw: bytes) -> ClerkingJob:
    _check_header(raw, TAG_CLERKING_JOB)
    pos = 6
    jid, pos = _r_uuid(raw, pos, ClerkingJobId)
    clerk, pos = _r_uuid(raw, pos, AgentId)
    aggregation, pos = _r_uuid(raw, pos, AggregationId)
    snapshot, pos = _r_uuid(raw, pos, SnapshotId)
    count, pos = read_leb128(raw, pos)
    encryptions = []
    for _ in range(count):
        enc, pos = _r_encryption(raw, pos)
        encryptions.append(enc)
    if pos != len(raw):
        raise ValueError("trailing bytes after clerking-job payload")
    return ClerkingJob(id=jid, clerk=clerk, aggregation=aggregation,
                       snapshot=snapshot, encryptions=encryptions)


def encode_clerking_result(result: ClerkingResult) -> bytes:
    out: List[bytes] = [_header(TAG_CLERKING_RESULT)]
    _w_uuid(out, result.job)
    _w_uuid(out, result.clerk)
    _w_encryption(out, result.encryption)
    return b"".join(out)


def decode_clerking_result(raw: bytes) -> ClerkingResult:
    _check_header(raw, TAG_CLERKING_RESULT)
    pos = 6
    job, pos = _r_uuid(raw, pos, ClerkingJobId)
    clerk, pos = _r_uuid(raw, pos, AgentId)
    encryption, pos = _r_encryption(raw, pos)
    if pos != len(raw):
        raise ValueError("trailing bytes after clerking-result payload")
    return ClerkingResult(job=job, clerk=clerk, encryption=encryption)


_ENCODERS = {
    Participation: encode_participation,
    ClerkingJob: encode_clerking_job,
    ClerkingResult: encode_clerking_result,
}
_DECODERS = {
    TAG_PARTICIPATION: decode_participation,
    TAG_CLERKING_JOB: decode_clerking_job,
    TAG_CLERKING_RESULT: decode_clerking_result,
}


def encode(resource) -> bytes:
    """Resource -> framed binary (dispatch on type)."""
    encoder = _ENCODERS.get(type(resource))
    if encoder is None:
        raise ValueError(f"no binary codec for {type(resource).__name__}")
    return encoder(resource)


def decode(raw: bytes):
    """Framed binary -> resource (dispatch on the header tag)."""
    tag = _check_header(raw)
    decoder = _DECODERS.get(tag)
    if decoder is None:
        raise ValueError(f"unknown resource tag {tag}")
    return decoder(raw)


# ---------------------------------------------------------------------------
# Incremental (feed-based) decode — the streaming wire path
#
# The one-shot decoders above need the whole body in memory before the
# first field parses; at production dimension that doubles a request's
# peak memory (raw bytes + decoded arrays side by side) and, worse, forces
# the HTTP planes to buffer entire dim-1e8 uploads per connection. The
# FeedDecoder consumes the same wire format chunk by chunk: completed
# fields (ids, one encryption blob at a time) move straight into the
# resource under construction and their raw bytes are released, so the
# transient buffer is bounded by the largest SINGLE field frame plus one
# network chunk — O(frame), not O(body) — regardless of how many clerk
# encryptions the upload carries.
#
# The parsers are generators speaking a tiny pull protocol: ``yield n``
# returns exactly n bytes once the driver has them. They mirror the
# one-shot decoders field for field; tests pin chunked == one-shot on
# golden payloads at every chunk size.

def _g_leb():
    n = shift = 0
    while True:
        b = (yield 1)[0]
        if shift > 63:
            raise ValueError("oversized varint in x-sda-bin payload")
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n
        shift += 7


def _g_array():
    tag = (yield 1)[0]
    if tag >= len(_DTYPES):
        raise ValueError(f"unknown array dtype tag {tag}")
    nbytes = yield from _g_leb()
    payload = yield nbytes
    dtype = np.dtype(_DTYPES[tag])
    if nbytes % dtype.itemsize:
        raise ValueError("array byte length not a multiple of its itemsize")
    return np.frombuffer(payload, dtype=dtype)


def _g_bytes():
    arr = yield from _g_array()
    if arr.dtype != np.uint8:
        raise ValueError("expected a u1 byte frame")
    return arr.tobytes()


def _g_uuid(cls):
    raw = yield 16
    return cls(_uuid.UUID(bytes=bytes(raw)))


def _g_encryption():
    variant = (yield 1)[0]
    if variant >= len(_ENC_VARIANTS):
        raise ValueError(f"unknown encryption variant tag {variant}")
    data = yield from _g_bytes()
    return Encryption(_ENC_VARIANTS[variant], Binary(data))


def _g_header(want_tag):
    head = yield 6
    if bytes(head[:4]) != MAGIC:
        raise ValueError("not an x-sda-bin payload (bad magic)")
    if head[4] != VERSION:
        raise ValueError(f"unsupported x-sda-bin version {head[4]}")
    tag = head[5]
    if want_tag is not None and tag != want_tag:
        raise ValueError(f"unexpected resource tag {tag} (want {want_tag})")
    return tag


def _g_participation():
    pid = yield from _g_uuid(ParticipationId)
    participant = yield from _g_uuid(AgentId)
    aggregation = yield from _g_uuid(AggregationId)
    present = (yield 1)[0]
    if present not in (0, 1):
        raise ValueError("malformed option byte")
    recipient_encryption = None
    if present:
        recipient_encryption = yield from _g_encryption()
    count = yield from _g_leb()
    clerk_encryptions = []
    for _ in range(count):
        clerk_id = yield from _g_uuid(AgentId)
        enc = yield from _g_encryption()
        clerk_encryptions.append((clerk_id, enc))
    return Participation(
        id=pid, participant=participant, aggregation=aggregation,
        recipient_encryption=recipient_encryption,
        clerk_encryptions=clerk_encryptions,
    )


def _g_clerking_job():
    jid = yield from _g_uuid(ClerkingJobId)
    clerk = yield from _g_uuid(AgentId)
    aggregation = yield from _g_uuid(AggregationId)
    snapshot = yield from _g_uuid(SnapshotId)
    count = yield from _g_leb()
    encryptions = []
    for _ in range(count):
        enc = yield from _g_encryption()
        encryptions.append(enc)
    return ClerkingJob(id=jid, clerk=clerk, aggregation=aggregation,
                       snapshot=snapshot, encryptions=encryptions)


def _g_clerking_result():
    job = yield from _g_uuid(ClerkingJobId)
    clerk = yield from _g_uuid(AgentId)
    encryption = yield from _g_encryption()
    return ClerkingResult(job=job, clerk=clerk, encryption=encryption)


_G_PARSERS = {
    TAG_PARTICIPATION: _g_participation,
    TAG_CLERKING_JOB: _g_clerking_job,
    TAG_CLERKING_RESULT: _g_clerking_result,
}


def _g_resource(want_tag):
    tag = yield from _g_header(want_tag)
    parser = _G_PARSERS.get(tag)
    if parser is None:
        raise ValueError(f"unknown resource tag {tag}")
    result = yield from parser()
    return result


class FeedDecoder:
    """Incremental ``x-sda-bin`` decoder: ``feed()`` body chunks as they
    arrive, ``finish()`` once the body is done.

    Malformed input raises ``ValueError`` from the offending ``feed`` (or
    from ``finish`` for truncation/trailing bytes) — the same error
    contract as the one-shot decoders, so the HTTP layer's 400 mapping
    is unchanged. ``expect_tag`` pins the resource kind the route expects
    (a participation POST must not decode as a clerking result)."""

    __slots__ = ("_buf", "_gen", "_want", "_result", "_done", "fed_bytes")

    def __init__(self, expect_tag: Optional[int] = None):
        self._buf = bytearray()
        self._gen = _g_resource(expect_tag)
        self._want = self._gen.send(None)
        self._result = None
        self._done = False
        #: total body bytes consumed (request accounting/logging)
        self.fed_bytes = 0

    def feed(self, chunk: bytes) -> None:
        if not chunk:
            return
        self.fed_bytes += len(chunk)
        if self._done:
            raise ValueError("trailing bytes after x-sda-bin payload")
        self._buf += chunk
        while not self._done and len(self._buf) >= self._want:
            piece = bytes(self._buf[:self._want])
            del self._buf[:self._want]
            try:
                self._want = self._gen.send(piece)
            except StopIteration as stop:
                self._result = stop.value
                self._done = True
        if self._done and self._buf:
            raise ValueError("trailing bytes after x-sda-bin payload")

    @property
    def done(self) -> bool:
        return self._done

    def finish(self):
        """The decoded resource; raises if the stream ended early."""
        if not self._done:
            raise ValueError("truncated x-sda-bin payload")
        return self._result


def decode_stream(chunks, expect_tag: Optional[int] = None):
    """Decode an iterable of body chunks incrementally (the threaded HTTP
    plane's streaming read path); returns the resource."""
    decoder = FeedDecoder(expect_tag)
    for chunk in chunks:
        decoder.feed(chunk)
    return decoder.finish()
