"""The recipes of ``tests/test_snapshot_mask_stream.py`` against the
port's streamed snapshot-mask collection (``server/snapshot.py`` and
``put_snapshot_mask_chunk`` on the memory, sqlite and jsonfs stores):
chunks concatenate in order, trims drop a replay's excess, identical
streams converge, the pre-chunking layouts still read, and a round's
pipeline writes O(batch) chunks with an exact reveal. The pre-chunking
rows and files are laid out as the reference's test writes them, and the
reference's jsonfs store reads the chunks the port's wrote."""

import json

import numpy as np
import pytest

from sda_tpu.server import new_jsonfs_server as ref_new_jsonfs_server
from sda_tpu_torch.protocol import Encryption, FullMasking, SnapshotId
from sda_tpu_torch.server import (new_jsonfs_server, new_memory_server,
                                  new_sqlite_server)


def enc(ix):
    return Encryption.sodium(b"mask-%04d" % ix)


@pytest.fixture(params=["memory", "sqlite", "jsonfs"])
def agg_store(request, tmp_path):
    if request.param == "memory":
        service = new_memory_server()
    elif request.param == "sqlite":
        service = new_sqlite_server(str(tmp_path / "db.sqlite"))
    else:
        service = new_jsonfs_server(str(tmp_path / "jfs"))
    return service.server.aggregation_store


class TestChunkStore:
    def test_chunks_concatenate_in_order(self, agg_store):
        snap = SnapshotId.random()
        agg_store.put_snapshot_mask_chunk(snap, 0, [enc(0), enc(1)])
        agg_store.put_snapshot_mask_chunk(snap, 1, [enc(2)])
        agg_store.put_snapshot_mask_chunk(snap, 2, [enc(3), enc(4)])
        assert agg_store.get_snapshot_mask(snap) == [enc(i) for i in range(5)]

    def test_trim_drops_excess_chunks(self, agg_store):
        """A replay chunked with a larger batch ends with a trim that
        drops the crashed predecessor's excess chunks."""
        snap = SnapshotId.random()
        for ix in range(4):
            agg_store.put_snapshot_mask_chunk(snap, ix, [enc(100 + ix)])
        agg_store.put_snapshot_mask_chunk(snap, 0, [enc(0)])
        agg_store.put_snapshot_mask_chunk(snap, 1, [enc(1)])
        agg_store.trim_snapshot_mask_chunks(snap, 2)
        assert agg_store.get_snapshot_mask(snap) == [enc(0), enc(1)]

    def test_contended_identical_streams_converge(self, agg_store):
        """Two workers replaying one pipeline write identical chunk
        sequences; chunk writes are upserts, so every interleaving shows a
        correct prefix or the whole mask, and the end state is exact."""
        snap = SnapshotId.random()
        stream = [(0, [enc(0), enc(1)]), (1, [enc(2)]), (2, [enc(3)])]
        agg_store.put_snapshot_mask_chunk(snap, *stream[0])
        agg_store.put_snapshot_mask_chunk(snap, *stream[1])
        for ix, chunk in stream:
            agg_store.put_snapshot_mask_chunk(snap, ix, chunk)
        complete = [enc(i) for i in range(4)]
        assert agg_store.get_snapshot_mask(snap) == complete
        agg_store.put_snapshot_mask_chunk(snap, *stream[2])
        agg_store.trim_snapshot_mask_chunks(snap, 3)
        assert agg_store.get_snapshot_mask(snap) == complete

    def test_create_snapshot_mask_still_whole(self, agg_store):
        """The one-shot API keeps working (chunk 0 underneath)."""
        snap = SnapshotId.random()
        agg_store.create_snapshot_mask(snap, [enc(0), enc(1)])
        assert agg_store.get_snapshot_mask(snap) == [enc(0), enc(1)]
        agg_store.create_snapshot_mask(snap, [enc(9)])
        assert agg_store.get_snapshot_mask(snap) == [enc(9)]

    def test_missing_mask_is_none(self, agg_store):
        assert agg_store.get_snapshot_mask(SnapshotId.random()) is None


class TestLegacyFallback:
    def test_sqlite_reads_pre_chunking_rows(self, tmp_path):
        store = new_sqlite_server(
            str(tmp_path / "db.sqlite")).server.aggregation_store
        snap = SnapshotId.random()
        store._exec(
            "INSERT INTO snapshot_masks (snapshot, doc) VALUES (?, ?)",
            (str(snap), json.dumps([enc(0).to_obj(), enc(1).to_obj()])),
        )
        assert store.get_snapshot_mask(snap) == [enc(0), enc(1)]

    def test_jsonfs_reads_pre_chunking_file(self, tmp_path):
        store = new_jsonfs_server(str(tmp_path / "jfs")).server \
            .aggregation_store
        snap = SnapshotId.random()
        path = store.root / "masks" / f"{snap}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps([enc(7).to_obj()]))
        assert store.get_snapshot_mask(snap) == [enc(7)]

    def test_reference_reads_the_ports_chunks(self, tmp_path):
        """The reference's jsonfs store reads the chunks the port's wrote
        over the same directory, in order."""
        from sda_tpu.protocol import SnapshotId as RefSnapshotId

        store = new_jsonfs_server(str(tmp_path / "jfs")).server \
            .aggregation_store
        snap = SnapshotId.random()
        store.put_snapshot_mask_chunk(snap, 0, [enc(0), enc(1)])
        store.put_snapshot_mask_chunk(snap, 1, [enc(2)])
        ref_store = ref_new_jsonfs_server(str(tmp_path / "jfs")).server \
            .aggregation_store
        got = ref_store.get_snapshot_mask(RefSnapshotId(str(snap)))
        assert [e.to_obj() for e in got] == [enc(i).to_obj()
                                             for i in range(3)]


def _round(monkeypatch, batch, clerks=3):
    """A Full-masked aggregation begun over a memory service, its
    recipient and clerks on the CPU; masks are collected in
    ``batch``-sized chunks."""
    from test_torch_full_loop import agg_default, new_client

    monkeypatch.setenv("SDA_SNAPSHOT_MASK_BATCH", str(batch))
    service = new_memory_server()
    aggregation = agg_default().replace(masking_scheme=FullMasking(433))
    recipient = new_client(service)
    recipient_key = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(recipient_key)
    aggregation = aggregation.replace(recipient=recipient.agent.id,
                                      recipient_key=recipient_key)
    recipient.upload_aggregation(aggregation)
    committee = [new_client(service) for _ in range(clerks)]
    for clerk in committee:
        clerk.upload_agent()
        clerk.upload_encryption_key(clerk.new_encryption_key())
    recipient.begin_aggregation(aggregation.id)
    return service, aggregation, recipient, committee


def _participate(service, aggregation, participants):
    from test_torch_full_loop import new_client

    for _ in range(participants):
        participant = new_client(service)
        participant.upload_agent()
        participant.participate([1, 2, 3, 4], aggregation.id)


class TestPipelineBounded:
    """The snapshot pipeline itself: O(batch) chunks, bit-exact reveal."""

    def test_full_round_streams_bounded_chunks(self, monkeypatch):
        service, aggregation, recipient, clerks = _round(monkeypatch, 4)
        store = service.server.aggregation_store
        chunks = []
        original = store.put_snapshot_mask_chunk

        def recording(snapshot, index, encryptions):
            chunks.append((index, len(encryptions)))
            return original(snapshot, index, encryptions)

        monkeypatch.setattr(store, "put_snapshot_mask_chunk", recording)
        _participate(service, aggregation, 10)
        recipient.end_aggregation(aggregation.id)
        # 10 masks through batch 4 -> chunks 4/4/2, never the whole set
        assert chunks == [(0, 4), (1, 4), (2, 2)]
        for clerk in [recipient] + clerks:
            clerk.run_chores(-1)
        output = recipient.reveal_aggregation(aggregation.id)
        np.testing.assert_array_equal(output.positive().values,
                                      [10, 20, 30, 40])

    def test_replayed_pipeline_converges(self, monkeypatch):
        """Re-running the snapshot pipeline (a crash replay or a contended
        peer) rewrites the identical chunk stream: the stored mask does
        not change."""
        from sda_tpu_torch.protocol import Snapshot
        from sda_tpu_torch.server import snapshot as snapshot_mod

        service, aggregation, recipient, _ = _round(monkeypatch, 2)
        _participate(service, aggregation, 5)
        snap = Snapshot(id=SnapshotId.random(), aggregation=aggregation.id)
        assert snapshot_mod.snapshot(service.server, snap) is True
        store = service.server.aggregation_store
        first = store.get_snapshot_mask(snap.id)
        assert len(first) == 5
        assert snapshot_mod.snapshot(service.server, snap) is False
        assert store.get_snapshot_mask(snap.id) == first
        snapshot_mod._collect_masks_streamed(service.server, aggregation,
                                             snap)
        assert store.get_snapshot_mask(snap.id) == first
