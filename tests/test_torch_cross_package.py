"""Rounds in which the two packages meet: each speaks the other's wire and
opens the other's on-disk stores.

- Over HTTP, both ways: the JAX package's server with the port's roles,
  the port's server with the JAX package's roles, and a mixed round (JAX
  participants, port clerks and recipient).
- A jsonfs handover: the JAX package's roles begin a round in a jsonfs
  directory and its participants take part; the port's clerks and
  recipient finish it on the same directory, each with its ``Filebased``
  keystore directory carried across.

The port's roles run on ``device="cpu"`` with ``HOST_PATH_MAX`` at 0, so
their scheme algebra takes the torch path. Every reveal is exact.
"""

import numpy as np
import pytest

import sda_tpu.client as ref_client
import sda_tpu.http as ref_http
import sda_tpu.protocol as ref_protocol
import sda_tpu.server as ref_server
import sda_tpu.store as ref_store

import sda_tpu_torch.client as port_client
import sda_tpu_torch.http as port_http
import sda_tpu_torch.server as port_server
import sda_tpu_torch.store as port_store
from sda_tpu_torch import protocol as port_protocol
from sda_tpu_torch.convert import resource_from_reference
from sda_tpu_torch.crypto import sharing
from sda_tpu.crypto import sodium as ref_sodium

pytestmark = pytest.mark.skipif(
    not ref_sodium.available(), reason="the reference's libsodium not present")

DIM = 10
INPUTS = np.random.default_rng(7).integers(0, 433, size=(3, DIM))


@pytest.fixture(autouse=True)
def torch_path(monkeypatch):
    monkeypatch.setattr(sharing, "HOST_PATH_MAX", 0)


def _aggregation(protocol):
    return protocol.Aggregation(
        id=protocol.AggregationId.random(),
        title="cross",
        vector_dimension=DIM,
        modulus=433,
        recipient=protocol.AgentId.random(),
        recipient_key=protocol.EncryptionKeyId.random(),
        masking_scheme=protocol.FullMasking(433),
        committee_sharing_scheme=protocol.PackedShamirSharing(
            3, 8, 4, 433, 354, 150),
        recipient_encryption_scheme=protocol.SodiumEncryption(),
        committee_encryption_scheme=protocol.SodiumEncryption(),
    )


class Side:
    """One package's roles: how to make a client and its aggregation."""

    def __init__(self, name, service, keystore_dir=None):
        self.name = name
        self.service = service
        self.keystore_dir = keystore_dir
        self._n = 0

    @property
    def port(self):
        return self.name == "port"

    def keystore(self):
        store = port_store if self.port else ref_store
        self._n += 1
        return store.Filebased(self.keystore_dir / f"{self.name}-{self._n}")

    def client(self, keystore=None, agent=None):
        keystore = keystore or self.keystore()
        if self.port:
            agent = agent or port_client.SdaClient.new_agent(keystore)
            return port_client.SdaClient(agent, keystore, self.service,
                                         device="cpu")
        agent = agent or ref_client.SdaClient.new_agent(keystore)
        return ref_client.SdaClient(agent, keystore, self.service)

    def aggregation(self):
        return _aggregation(port_protocol if self.port else ref_protocol)


def _begin(recipients: Side, clerks: Side):
    """Recipient with its aggregation, 8 clerks with keys, committee."""
    recipient = recipients.client()
    key = recipient.new_encryption_key()
    recipient.upload_agent()
    recipient.upload_encryption_key(key)
    aggregation = recipients.aggregation().replace(
        recipient=recipient.agent.id, recipient_key=key)
    recipient.upload_aggregation(aggregation)
    workers = [clerks.client() for _ in range(8)]
    for clerk in workers:
        clerk_key = clerk.new_encryption_key()
        clerk.upload_agent()
        clerk.upload_encryption_key(clerk_key)
    recipient.begin_aggregation(aggregation.id)
    return recipient, aggregation, workers


def _participate(participants: Side, aggregation_id):
    for x in INPUTS:
        p = participants.client()
        p.upload_agent()
        p.participate([int(v) for v in x], aggregation_id)


def _finish(recipient, aggregation_id, workers):
    recipient.end_aggregation(aggregation_id)
    for worker in [recipient] + workers:
        worker.run_chores(-1)
    output = recipient.reveal_aggregation(aggregation_id)
    np.testing.assert_array_equal(output.positive().values,
                                  INPUTS.sum(axis=0) % 433)


def _http(server_pkg, tmp_path):
    """Start ``server_pkg``'s HTTP server over a memory store; returns it
    and a factory of either package's proxy to it."""
    server_mod = port_server if server_pkg == "port" else ref_server
    http_mod = port_http if server_pkg == "port" else ref_http
    server = http_mod.SdaHttpServer(server_mod.new_memory_server(),
                                    bind="127.0.0.1:0")
    server.start_background()

    def proxy(pkg):
        mod = port_http if pkg == "port" else ref_http
        store = port_store if pkg == "port" else ref_store
        return mod.SdaHttpClient(server.address,
                                 store=store.Filebased(tmp_path / f"tok-{pkg}"))
    return server, proxy


@pytest.mark.parametrize("server_pkg,roles", [
    ("jax", {"recipient": "port", "clerks": "port", "participants": "port"}),
    ("port", {"recipient": "jax", "clerks": "jax", "participants": "jax"}),
    ("port", {"recipient": "port", "clerks": "port", "participants": "jax"}),
], ids=["jax-server-port-roles", "port-server-jax-roles",
        "jax-participants-port-clerks"])
def test_http_round_across_packages(server_pkg, roles, tmp_path):
    server, proxy = _http(server_pkg, tmp_path)
    try:
        sides = {role: Side(pkg, proxy(pkg), tmp_path)
                 for role, pkg in roles.items()}
        recipient, aggregation, workers = _begin(sides["recipient"],
                                                 sides["clerks"])
        _participate(sides["participants"], aggregation.id)
        _finish(recipient, aggregation.id, workers)
    finally:
        server.shutdown()


def test_jsonfs_handover(tmp_path):
    """The JAX package begins the round and its participants take part;
    the port's clerks and recipient finish it in the same directory."""
    jax_side = Side("jax", ref_server.new_jsonfs_server(tmp_path / "jfs"),
                    tmp_path)
    recipient, aggregation, workers = _begin(jax_side, jax_side)
    _participate(jax_side, aggregation.id)
    # each identity crosses as its keystore directory, the agent in it
    for client in [recipient] + workers:
        client.crypto.keystore.put("agent", client.agent.to_obj())
    dirs = [c.crypto.keystore.dir for c in [recipient] + workers]
    del recipient, workers

    port_side = Side("port", port_server.new_jsonfs_server(tmp_path / "jfs"))
    ported = []
    for d in dirs:
        keystore = port_store.Filebased(d)
        agent = resource_from_reference("Agent", keystore.get("agent"))
        ported.append(port_side.client(keystore=keystore, agent=agent))
    recipient, workers = ported[0], ported[1:]
    _finish(recipient, resource_from_reference(
        "AggregationId", str(aggregation.id)), workers)
