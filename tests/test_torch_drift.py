"""The modules the port copies verbatim from the JAX package stay copies:
each equals its reference after the rewrite ``sda_tpu`` -> ``sda_tpu_torch``
of the package's name (dotted names, logger names, paths in docstrings),
and after the comment edits listed in ``EDITS``. A module that needs any
other change is a rewrite, not a copy, and is held to the reference by its
own parity test instead; the functions a rewrite copies whole are pinned
one by one (``FUNCTION_COPIES``)."""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

COPIES = [
    "chaos/__init__.py",
    "chaos/poison.py",
    "client/journal.py",
    "client/relay.py",
    "crypto/batch.py",
    "crypto/paillier.py",
    "crypto/signing.py",
    "crypto/sodium.py",
    "crypto/varint.py",
    "fields/chacha.py",
    "http/__init__.py",
    "http/admission.py",
    "http/aserver.py",
    "http/base.py",
    "http/client.py",
    "http/server.py",
    "native/__init__.py",
    "native/src/sda_native.cpp",
    "obs/recorder.py",
    "obs/timeline.py",
    "obs/trace.py",
    "protocol/__init__.py",
    "protocol/bincodec.py",
    "protocol/crypto.py",
    "protocol/errors.py",
    "protocol/helpers.py",
    "protocol/methods.py",
    "protocol/resources.py",
    "server/__init__.py",
    "server/core.py",
    "server/jsonfs.py",
    "server/lifecycle.py",
    "server/memory.py",
    "server/mongo.py",
    "server/routing.py",
    "server/snapshot.py",
    "server/sqlite.py",
    "server/stores.py",
    "server/wakeup.py",
    "store/__init__.py",
    "store/file.py",
    "utils/env.py",
    "utils/logsetup.py",
    "utils/metrics.py",
]

#: functions that a rewritten module copies verbatim from its reference
FUNCTION_COPIES = [
    ("mesh/simpod.py", "_dim_grain"),
    ("mesh/streaming.py", "array_block_provider"),
    ("mesh/streaming.py", "synthetic_block_provider"),
    ("mesh/streaming.py", "_atomic_npz"),
    ("mesh/streaming.py", "_read_snapshot"),
    ("mesh/streaming.py", "_checkpoint_load"),
]

#: docstring lines a copy words otherwise, by line number (1-based): the
#: reference's line there names a step of its own history
EDITS = {
    "server/lifecycle.py": {
        37: "(``transition_round_state`` on all four backends — the fleet's "
            "single-winner",
    },
}


def _ported(rel: str, text: str) -> str:
    lines = text.split("\n")
    for number, line in EDITS.get(rel, {}).items():
        lines[number - 1] = line
    return re.sub(r"\bsda_tpu\b", "sda_tpu_torch", "\n".join(lines))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_reference(rel):
    want = _ported(rel, (ROOT / "sda_tpu" / rel).read_text())
    got = (ROOT / "sda_tpu_torch" / rel).read_text()
    assert got == want, f"sda_tpu_torch/{rel} drifted from sda_tpu/{rel}"


def test_every_copy_is_listed_once():
    assert len(set(COPIES)) == len(COPIES)
    for rel in COPIES:
        assert (ROOT / "sda_tpu_torch" / rel).is_file(), rel


def _function_source(path: Path, name: str) -> str:
    text = path.read_text()
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return ast.get_source_segment(text, node)
    raise LookupError(f"{name} not in {path}")


@pytest.mark.parametrize("rel,name", FUNCTION_COPIES)
def test_function_copy_matches_reference(rel, name):
    ref = _function_source(ROOT / "sda_tpu" / rel, name)
    port = _function_source(ROOT / "sda_tpu_torch" / rel, name)
    assert port == re.sub(r"\bsda_tpu\b", "sda_tpu_torch", ref)
