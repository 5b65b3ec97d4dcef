"""Durable participant journal: crash-safe exactly-once participation.

The paper's devices are weak and sporadic (PAPER.md: "many weak, sporadic
devices (mobile phones)") — a phone can die at any instant between
sealing its share bundle and learning the server stored it. Without a
journal, the natural recovery is to recompute the participation with
fresh randomness, which mints a NEW participation id and double-counts
the device the moment both uploads land. The journal closes that hole on
the client side, mirroring the server side's exactly-once ingestion
(``stores.create_participation``):

1. ``SdaClient.participate(..., journal=j)`` persists the fully sealed
   :class:`~sda_tpu_torch.protocol.Participation` — atomically, temp file +
   ``os.replace`` — keyed by ``(agent, aggregation)`` BEFORE the first
   upload attempt;
2. after a crash, ``SdaParticipant.resume(journal)`` re-uploads the SAME
   bytes: no recompute means no new randomness means no new id, so the
   server either inserts them (the crash hit before the upload) or
   recognizes a byte-identical replay and succeeds idempotently (the
   crash ate the ack — ``server.participation.replayed``);
3. entries are reaped on confirmed upload, and on the terminal outcomes
   where re-uploading is moot: the aggregation is gone (``NotFound``) or
   the server already holds a different bundle under our key
   (``ParticipationConflict`` — only possible when something other than
   this journal uploaded for the agent).

The journal directory is plain files, one JSON per pending entry, so it
survives process death and can be handed to a fresh process — exactly
the drill ``sda-sim --chaos --churn`` runs (docs/robustness.md).
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

from ..protocol import AgentId, AggregationId, Participation

#: Journal entry format version, stamped in every file so a future layout
#: change can migrate instead of misparse.
_VERSION = 1


class ParticipationJournal:
    """One directory of pending sealed participations, keyed by
    ``(agent, aggregation)`` — one entry per key, because the protocol
    admits one participation per device per round (the server's
    exactly-once ingestion enforces the same key)."""

    def __init__(self, directory):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, agent_id: AgentId, aggregation_id: AggregationId) -> Path:
        # both ids are UUID strings: filename-safe, unambiguous joined
        return self.dir / f"{agent_id}--{aggregation_id}.json"

    # -- writes ------------------------------------------------------------
    def record(self, participation: Participation) -> None:
        """Persist the sealed bundle BEFORE the first upload attempt —
        atomic temp+replace, so a crash mid-write leaves either the old
        entry or the new one, never a torn file."""
        path = self._path(participation.participant, participation.aggregation)
        fd, tmp = tempfile.mkstemp(dir=str(self.dir), prefix=".tmp-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"version": _VERSION,
                           "participation": participation.to_obj()}, f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def reap(self, agent_id: AgentId, aggregation_id: AggregationId) -> bool:
        """Drop a confirmed (or terminally moot) entry; True if one
        existed."""
        try:
            self._path(agent_id, aggregation_id).unlink()
            return True
        except FileNotFoundError:
            return False

    # -- reads -------------------------------------------------------------
    def load(self, agent_id: AgentId,
             aggregation_id: AggregationId) -> Optional[Participation]:
        path = self._path(agent_id, aggregation_id)
        if not path.exists():
            return None
        obj = json.loads(path.read_text())
        return Participation.from_obj(obj["participation"])

    def pending(self, agent_id: Optional[AgentId] = None
                ) -> List[Participation]:
        """Every journaled participation (optionally one agent's), sorted
        by filename for deterministic resume order."""
        out = []
        for path in sorted(self.dir.glob("*.json")):
            if path.name.startswith("."):
                continue
            if agent_id is not None \
                    and not path.name.startswith(f"{agent_id}--"):
                continue
            obj = json.loads(path.read_text())
            out.append(Participation.from_obj(obj["participation"]))
        return out

    def keys(self) -> List[Tuple[str, str]]:
        """The pending ``(agent, aggregation)`` keys, parsed from the
        entry filenames (no payload deserialization)."""
        out = []
        for path in sorted(self.dir.glob("*.json")):
            if path.name.startswith("."):
                continue
            agent, _, aggregation = path.stem.partition("--")
            out.append((agent, aggregation))
        return out

    def __len__(self) -> int:
        return len(self.keys())
