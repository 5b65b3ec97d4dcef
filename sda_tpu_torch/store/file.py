"""File-based client store: JSON-per-object with alias indirection.

Reference: client-store/src/{store,file}.rs — a directory of JSON files keyed
by id, plus aliases (e.g. ``"agent"`` -> the agent resource) so a CLI
identity directory is self-contained; doubles as the Keystore for both
keypair types (file.rs:55-73).
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, Optional

from ..crypto.core import EncryptionKeypair, Keystore, SignatureKeypair
from ..protocol import EncryptionKeyId, VerificationKeyId


def _atomic_write(path: Path, text: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=".tmp-")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class Filebased(Keystore):
    """JSON-file store with aliases; implements the Keystore interface."""

    def __init__(self, directory):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        safe = key.replace("/", "_")
        return self.dir / f"{safe}.json"

    # -- generic JSON-object storage (store.rs:3-41) -----------------------
    def put(self, key: str, obj: Any) -> None:
        _atomic_write(self._path(key), json.dumps(obj))

    def get(self, key: str) -> Optional[Any]:
        p = self._path(key)
        if not p.exists():
            return None
        return json.loads(p.read_text())

    def put_alias(self, alias: str, target: str) -> None:
        self.put(f"alias-{alias}", {"alias": target})

    def resolve_alias(self, alias: str) -> Optional[str]:
        obj = self.get(f"alias-{alias}")
        return None if obj is None else obj["alias"]

    def get_aliased(self, alias: str) -> Optional[Any]:
        target = self.resolve_alias(alias)
        return None if target is None else self.get(target)

    # -- Keystore (file.rs:55-73) -----------------------------------------
    def put_encryption_keypair(self, id: EncryptionKeyId, kp: EncryptionKeypair) -> None:
        self.put(f"enc-{id}", kp.to_obj())

    def get_encryption_keypair(self, id: EncryptionKeyId) -> Optional[EncryptionKeypair]:
        obj = self.get(f"enc-{id}")
        return None if obj is None else EncryptionKeypair.from_obj(obj)

    def put_signature_keypair(self, id: VerificationKeyId, kp: SignatureKeypair) -> None:
        self.put(f"sig-{id}", kp.to_obj())

    def get_signature_keypair(self, id: VerificationKeyId) -> Optional[SignatureKeypair]:
        obj = self.get(f"sig-{id}")
        return None if obj is None else SignatureKeypair.from_obj(obj)
