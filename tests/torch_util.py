"""Helpers shared by the port's twins of the reference tests:
``tests/util.py`` rebuilt on the port's protocol (the reference's helpers
with the package name rewritten), the port's service backends, and the
reference's view of a port resource for wire comparisons."""

from __future__ import annotations

import re
import types
from pathlib import Path


def port_of(name):
    """``tests/<name>.py`` with the package name rewritten to the port's:
    the reference's shared test helpers, building the port's objects."""
    path = Path(__file__).with_name(f"{name}.py")
    module = types.ModuleType(f"torch_{name}")
    code = re.sub(r"\bsda_tpu\b", "sda_tpu_torch", path.read_text())
    exec(compile(code, str(path), "exec"), module.__dict__)
    return module


_util = port_of("util")
mock_encryption = _util.mock_encryption
new_agent = _util.new_agent
new_full_agent = _util.new_full_agent
new_key_for_agent = _util.new_key_for_agent


def open_service(backend, tmp_path, name="sda"):
    """One of the port's services over ``backend``: memory, sqlite, jsonfs
    or fake mongo (``mongo``/``fakemongo``)."""
    from sda_tpu_torch.server import (new_jsonfs_server, new_memory_server,
                                      new_mongo_server, new_sqlite_server)

    if backend == "memory":
        return new_memory_server()
    if backend == "sqlite":
        return new_sqlite_server(tmp_path / f"{name}.db")
    if backend == "jsonfs":
        return new_jsonfs_server(tmp_path / f"{name}-jfs")
    from fake_mongo import FakeDatabase

    return new_mongo_server(FakeDatabase())


def to_reference(resource):
    """The reference's resource parsed from the port's wire object (a
    ``Signed`` one is a signed encryption key)."""
    import sda_tpu.protocol as ref_protocol
    from sda_tpu.protocol.resources import signed_encryption_key_from_obj

    name = type(resource).__name__
    parse = signed_encryption_key_from_obj if name == "Signed" else \
        getattr(ref_protocol, name).from_obj
    return parse(resource.to_obj())
