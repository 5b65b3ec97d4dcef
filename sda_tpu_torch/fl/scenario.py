"""The FL scenario driver: R rounds of secure FedAvg over the full
substrate — the executable proof behind ``sda-sim --fl``.

One run composes every plane the repo has built (docs/federated.md):

- **devices** are simulated sporadic phones: each round, a seeded churn
  plan (:func:`sda_tpu_torch.chaos.churn_schedule`, per-round epoch key)
  decides who crashes pre-upload (its contribution misses the round —
  that IS dropout) or mid-upload (the server has the bytes, the ack is
  lost); every departure seals + journals first and REJOINS next round
  via :meth:`SdaClient.resume` — exactly-once ingestion makes the replay
  idempotent and the late pre-upload bundle land outside the frozen set;
- **rounds** are epochs of a :class:`ScheduleSpec`: aggregation
  ids are ``uuid5(schedule, epoch)``, so device journals stay
  exactly-once ACROSS rounds by construction and any scheduler handle
  mints/closes each epoch exactly once;
- **training** is real: every available device runs
  :class:`~sda_tpu_torch.models.LocalTrainer` (one registry entry for
  the whole population) on its seeded shard, quantizes its delta through
  :class:`~sda_tpu_torch.models.FixedPointCodec`, and ships the int64 residue
  vector straight into ``participate`` (no per-element Python loop);
- **aggregation** runs through the real server stack — in-process store,
  single HTTP server, or a real ``sda-fleet`` of ``sdad`` OS processes
  over one shared sqlite/jsonfs store — and the reveal goes through the
  lifecycle plane: a committee losing ``dead_clerks`` members degrades
  (packed Shamir) and still reveals bit-exactly from the surviving
  quorum, surfaced as typed verdicts instead of hangs;
- **the verdict per round is bit-exactness**: the revealed aggregate
  must equal the plaintext sum of the quantized deltas of exactly the
  frozen participant set — secure FedAvg == plaintext quantized FedAvg;
- the recipient applies the **dropout-weighted** global update (mean
  over the revealed summand count, not the nominal population),
  optionally adding seeded central-DP Gaussian noise (``fl/dp.py``);
- at population scale, ``tree_group_size > 0`` runs each round's
  aggregation through :mod:`sda_tpu_torch.tree` instead (recursive leaf
  committees, relays, root reveal).

The report is BENCH-style: the headline is **rounds to target accuracy**
(direction ``lower``) with the full accuracy-vs-rounds curve, per-round
bit-exact verdicts, churn/dropout accounting, lifecycle states, DP
accounting and devprof compile totals attached.

Port of ``sda_tpu/fl/scenario.py``: everything but the model plane is the
reference's. The families, the trainer, the evaluation and the attack
probe are torch on ``FLProfile.device`` (CUDA unless ``"cpu"``): the
``linear`` family is a zero-initialised ``{"w", "b"}`` softmax regression,
the others ``models/families.py`` modules driven through
``torch.func.functional_call`` over their ``state_dict``; the loss is
``F.cross_entropy`` (the mean of optax's
``softmax_cross_entropy_with_integer_labels``) and the optimizer
``models.sgd`` (optax.sgd's plain form). Every client, tree round
included, runs its field arithmetic on the same device.
"""

from __future__ import annotations

import math
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .. import chaos, obs
from ..utils import metrics, timed_phase

__all__ = ["FLProfile", "run_fl"]


@dataclass
class FLProfile:
    """Everything one FL scenario run needs; defaults match the tier-1
    smoke (a tiny linear family over an in-process memory store)."""

    family: str = "linear"          # linear | lenet | mobilelite | lora
    participants: int = 6           # device population
    rounds: int = 3                 # FedAvg rounds (schedule epochs)
    local_steps: int = 4            # optimizer steps per device per round
    batch_size: int = 16
    shard_size: int = 64            # training examples per device
    eval_size: int = 256
    lr: float = 0.1
    target_accuracy: float = 0.8
    churn: float = 0.0              # per-round device availability churn
    dead_clerks: int = 0            # permanently dead committee members
    dp_sigma: float = 0.0           # central-DP noise multiplier (0 = off)
    dp_delta: float = 1e-5
    seed: int = 0
    store: str = "memory"           # memory | sqlite | jsonfs
    store_path: Optional[str] = None
    http: bool = False              # single real HTTP server
    async_http: bool = False        # serve HTTP on the asyncio plane
    fleet: int = 0                  # N sdad workers over the shared store
    chaos_rate: float = 0.0         # fraction of HTTP requests to 500
    tree_group_size: int = 0        # >0: aggregate via sda_tpu_torch/tree
    poison: float = 0.0             # attacker fraction per round (chaos/poison)
    poison_kind: str = "boost:-8"   # boost:FACTOR | signflip | backdoor:DIM
    norm_clip: Optional[float] = None  # codec-enforced L2 bound (defense)
    tree_robust: bool = False       # trimmed-mean over leaf subtotals
    dataset: str = "synthetic"      # synthetic | mnist
    mnist_dir: Optional[str] = None
    clip: float = 1.0               # per-coordinate delta clip
    fractional_bits: Optional[int] = None  # None = widest exact grid
    modulus_bits: int = 28          # packed-Shamir prime size
    period_s: float = 0.01          # schedule cadence floor
    lease_seconds: float = 2.0
    clerking_deadline_s: float = 2.0
    sweep_interval_s: float = 0.25
    timeout_s: float = 900.0
    device: Optional[str] = None    # CUDA unless "cpu"


# ---------------------------------------------------------------------------
# model families

def _build_family(profile: FLProfile, seed: int):
    """Returns ``(init_params, apply_fn, image_shape)`` for the family:
    ``init_params()`` is a dict of tensors on the profile's device and
    ``apply_fn(params, x)`` the logits of NHWC inputs ``x``.

    ``linear`` is a plain softmax regression (fast, module-free — the
    tier-1 smoke family); the rest are the benchmark families from
    ``models/families.py`` at drill-friendly widths, their initial values
    drawn from a generator seeded with ``seed``.
    """
    import torch

    from ..device import resolve_device

    dev = resolve_device(profile.device)
    name = profile.family
    if name == "linear":
        image_shape = (8, 8, 1)
        features = int(np.prod(image_shape))

        def init_params():
            return {"w": torch.zeros((features, 10), dtype=torch.float32,
                                     device=dev),
                    "b": torch.zeros((10,), dtype=torch.float32,
                                     device=dev)}

        def apply_fn(params, x):
            flat = x.reshape((x.shape[0], -1))
            return flat @ params["w"] + params["b"]

        return init_params, apply_fn, image_shape

    generator = torch.Generator().manual_seed(seed)
    if name == "lenet":
        from ..models.families import LeNet

        image_shape = (28, 28, 1)
        model = LeNet(width=1, device=dev, generator=generator)
    elif name == "mobilelite":
        from ..models.families import MobileLite

        image_shape = (32, 32, 3)
        model = MobileLite(width=8, block_channels=(16, 24), device=dev,
                           generator=generator)
    elif name == "lora":
        from ..models.families import LoRAMLP

        image_shape = (4, 4, 1)
        model = LoRAMLP(features=64, layers=2, rank=4,
                        in_features=int(np.prod(image_shape)), device=dev,
                        generator=generator)
    else:
        raise ValueError(f"unknown family {profile.family!r} "
                         "(linear | lenet | mobilelite | lora)")

    def init_params():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    def apply_fn(params, x):
        return torch.func.functional_call(model, params, (x,))

    return init_params, apply_fn, image_shape


def _make_codec(profile: FLProfile, prime: Optional[int]):
    """Size the fixed-point codec to the aggregation headroom.

    Packed-Shamir rounds share Z_m values in Z_p, so exactness needs
    ``participants * m < p`` (the wrap algebra of
    tests/test_models.py::test_federated_session_packed_shamir_semantics);
    tree/additive rounds take the full int64-safe Mersenne modulus. The
    fractional grid defaults to the widest one the capacity allows for
    the configured clip (capped at 16 bits — beyond that quantization is
    far below optimizer noise).
    """
    from ..models import FixedPointCodec

    if prime is not None:
        m_bits = min(24, (prime // max(2, profile.participants)
                          ).bit_length() - 1)
        if m_bits < 8:
            raise ValueError(
                f"{profile.participants} participants leave no modulus "
                f"headroom under the {profile.modulus_bits}-bit sharing "
                "prime; raise --fl-modulus-bits or use the tree mode")
        modulus = 1 << m_bits
    else:
        modulus = (1 << 31) - 1
    q_cap = (modulus // 2 - 1) // profile.participants
    fractional_bits = profile.fractional_bits
    if fractional_bits is None:
        if q_cap < 2 * profile.clip:
            raise ValueError(
                f"no quantization headroom: capacity {q_cap} under clip "
                f"{profile.clip} for {profile.participants} summands")
        fractional_bits = min(
            16, int(math.floor(math.log2(q_cap / profile.clip))))
    return FixedPointCodec(modulus, fractional_bits,
                           profile.participants, clip=profile.clip,
                           norm_clip=profile.norm_clip)


def _accuracy_fn(apply_fn, eval_x, eval_y, device):
    import torch

    from ..obs import devprof

    ex = torch.as_tensor(eval_x, device=device)
    ey = torch.as_tensor(eval_y, device=device)

    def accuracy(params):
        with torch.no_grad():
            logits = apply_fn(params, ex)
            return (torch.argmax(logits, dim=-1) == ey).to(
                torch.float32).mean()

    return devprof.instrument("fl.eval", accuracy)


def _load_dataset(profile: FLProfile, image_shape):
    from .data import load_mnist_idx, shard_dataset, synthetic_classification

    if profile.dataset == "mnist":
        if not profile.mnist_dir:
            raise ValueError("dataset='mnist' needs mnist_dir "
                             "(--fl-mnist DIR)")
        if tuple(image_shape) != (28, 28, 1):
            raise ValueError(
                f"family {profile.family!r} expects inputs {image_shape}, "
                "not MNIST 28x28x1 (use --fl-family lenet)")
        train_x, train_y, eval_x, eval_y = load_mnist_idx(
            profile.mnist_dir,
            limit=profile.participants * profile.shard_size,
            eval_limit=profile.eval_size)
    elif profile.dataset == "synthetic":
        train_x, train_y, eval_x, eval_y = synthetic_classification(
            profile.participants * profile.shard_size, profile.eval_size,
            image_shape=tuple(image_shape), seed=profile.seed)
    else:
        raise ValueError(f"unknown dataset {profile.dataset!r}")
    shards = shard_dataset(train_x, train_y, profile.participants,
                           seed=profile.seed)
    return shards, eval_x, eval_y


def run_fl(profile: FLProfile) -> dict:
    """Run the scenario; returns the BENCH-style report. Requires
    libsodium for the protocol modes (tree mode included — every mode
    runs real sealed-box crypto)."""
    from ..crypto import sodium

    if not sodium.available():
        raise RuntimeError("the FL scenario needs libsodium "
                           "(real-crypto rounds)")
    if profile.participants < 2:
        raise ValueError("the FL scenario needs >= 2 devices")
    if profile.rounds < 1:
        raise ValueError("rounds must be >= 1")
    if profile.tree_group_size and profile.dead_clerks:
        raise ValueError(
            "tree_group_size and dead_clerks cannot compose: tree mode "
            "aggregates through additive leaf committees, which tolerate "
            "no dead clerks; drop --fl-dead-clerks or the tree")
    if profile.tree_group_size and profile.fleet:
        raise ValueError(
            "tree_group_size and fleet cannot compose: tree mode drives "
            "its own service; drop --fl-fleet")
    if profile.chaos_rate and profile.tree_group_size and not profile.http:
        # LIFTED where safe: chaos_rate + tree now composes over HTTP
        # (the tree drill serves real requests there); only the
        # in-process tree path still has no dispatch to inject into
        raise ValueError(
            "chaos_rate and tree_group_size compose only over HTTP: add "
            "--fl-http (the chaos knob arms the HTTP dispatch failpoint, "
            "and the in-process tree path has no dispatch to inject into)")
    if not 0.0 <= profile.poison <= 1.0:
        raise ValueError(
            f"poison rate {profile.poison} outside [0, 1]")
    if profile.tree_robust and not profile.tree_group_size:
        raise ValueError(
            "tree_robust and tree_group_size=0 cannot compose: the robust "
            "(trimmed-mean) estimator runs over leaf subtotals, which only "
            "tree mode (--fl-tree N) produces")
    if profile.async_http and not (profile.http or profile.fleet):
        # a silently ignored plane flag would mislabel every benchmark
        # collected with it — refuse instead
        raise ValueError("async_http selects the HTTP serving plane; add "
                         "--fl-http or --fl-fleet (in-process mode has "
                         "no HTTP plane to select)")
    if profile.chaos_rate and not (profile.http or profile.fleet):
        # the chaos knob arms the HTTP dispatch failpoint: without an
        # HTTP layer in the path nothing evaluates it, and a "survived
        # chaos" verdict that injected zero faults would be a lie
        raise ValueError("chaos_rate needs the HTTP path (--fl-http or "
                         "--fl-fleet); in-process mode has no dispatch "
                         "to inject into")

    obs.reset_all()
    chaos.reset()
    from ..obs import devprof

    devprof.install_monitoring()

    import torch
    import torch.nn.functional as F

    from ..device import resolve_device
    from ..models import LocalTrainer, ravel_pytree, sgd

    dev = resolve_device(profile.device)
    init_params, apply_fn, image_shape = _build_family(profile, profile.seed)
    shards, eval_x, eval_y = _load_dataset(profile, image_shape)
    accuracy_of = _accuracy_fn(apply_fn, eval_x, eval_y, dev)

    def loss_fn(params, batch):
        x, y = batch
        logits = apply_fn(params, x)
        return F.cross_entropy(logits, y.long())

    trainer = LocalTrainer(loss_fn, sgd(profile.lr), device=dev)
    params0 = init_params()
    gvec, unravel = ravel_pytree(params0)
    gvec = gvec.cpu().numpy()
    dim = int(gvec.size)

    def local_fit(global_vec, device_ix: int, round_ix: int,
                  backdoor_dim: Optional[int] = None):
        """One device's local epoch: k seeded minibatch steps from its
        shard; returns (trained vector, mean loss). Shapes are identical
        across devices and rounds, so the whole population shares ONE
        signature (``models.local_fit`` in the devprof registry).

        ``backdoor_dim`` turns this device into a backdoor attacker: it
        trains on trigger-stamped inputs relabeled to the attack's
        target class — same shapes, same signature, genuinely
        malicious delta (``chaos/poison.py``)."""
        shard_x, shard_y = shards[device_ix]
        if backdoor_dim is not None:
            from .data import BACKDOOR_TARGET_CLASS, apply_backdoor_trigger

            shard_x = apply_backdoor_trigger(shard_x, backdoor_dim)
            shard_y = np.full_like(shard_y, BACKDOOR_TARGET_CLASS)
        rng = np.random.default_rng(
            [profile.seed, 0x7A, round_ix, device_ix])
        idx = rng.integers(0, len(shard_x),
                           size=(profile.local_steps,
                                 min(profile.batch_size, len(shard_x))))
        batches = (torch.as_tensor(shard_x[idx], device=dev),
                   torch.as_tensor(shard_y[idx], device=dev))
        params = unravel(global_vec)
        state = trainer.init_state(params)
        params, state, loss = trainer.fit(params, state, batches)
        vec, _ = ravel_pytree(params)
        return vec.cpu().numpy(), float(loss)

    # adversarial-input plan: parse the attack kind ONCE (typed errors
    # fire before any service spins up) and build the backdoor success
    # probe when the attack is targeted
    attack = (chaos.parse_poison_kind(profile.poison_kind)
              if profile.poison else None)
    asr_of = None
    if attack and attack["kind"] == "backdoor":
        from .data import backdoor_success_rate

        def asr_of(vec):
            params = unravel(vec)

            def predict(x):
                with torch.no_grad():
                    logits = apply_fn(params, torch.as_tensor(x, device=dev))
                return torch.argmax(logits, dim=-1).cpu().numpy()

            return backdoor_success_rate(predict, eval_x, eval_y,
                                         attack["trigger_dim"])

    if profile.tree_group_size:
        return _run_tree_mode(profile, gvec, dim, local_fit, accuracy_of,
                              unravel, attack=attack, asr_of=asr_of)
    return _run_protocol_mode(profile, gvec, dim, local_fit, accuracy_of,
                              unravel, attack=attack, asr_of=asr_of)


# ---------------------------------------------------------------------------
# the protocol mode: scheduler-minted epochs over the real stack

def _run_protocol_mode(profile: FLProfile, gvec, dim, local_fit,
                       accuracy_of, unravel, attack=None,
                       asr_of=None) -> dict:
    from ..client import SdaClient
    from ..client.journal import ParticipationJournal
    from ..crypto import MemoryKeystore
    from ..fields import numtheory
    from ..http import SdaHttpClient, server_class
    from ..protocol import (
        Aggregation,
        AggregationId,
        FullMasking,
        PackedShamirSharing,
        RoundFailed,
        ServerError,
        SodiumEncryption,
    )
    from ..server import lifecycle, new_jsonfs_server, new_memory_server, \
        new_sqlite_server
    from ..service.scheduler import (
        RoundScheduler,
        ScheduleSpec,
        epoch_aggregation_id,
    )

    t, p, w2, w3 = numtheory.generate_packed_params(
        3, 8, profile.modulus_bits)
    scheme = PackedShamirSharing(3, 8, t, p, w2, w3)
    codec = _make_codec(profile, p)
    modulus = codec.modulus

    # -- service plane ------------------------------------------------------
    fleet = None
    ring = None
    http_server = None
    if profile.fleet:
        from ..server.fleet import Fleet

        if profile.store not in ("sqlite", "jsonfs"):
            raise ValueError("fleet mode needs a cross-process store "
                             "(store='sqlite' or 'jsonfs')")
        if not profile.store_path:
            raise ValueError("fleet mode needs store_path")
        backend = (["--sqlite", profile.store_path]
                   if profile.store == "sqlite"
                   else ["--jfs", profile.store_path])
        extra = ["--job-lease", str(profile.lease_seconds), "--statusz"]
        if profile.async_http:
            extra += ["--async"]
        if profile.chaos_rate > 0.0:
            extra += ["--chaos-spec",
                      f"http.server.request=error,rate={profile.chaos_rate}",
                      "--chaos-seed", str(profile.seed)]
        fleet = Fleet(profile.fleet, backend, extra_args=extra,
                      node_prefix="fl-w")
        fleet.start()
        ring = fleet.ring()
        server = (new_sqlite_server(profile.store_path)
                  if profile.store == "sqlite"
                  else new_jsonfs_server(profile.store_path)).server
    else:
        if profile.store == "memory":
            service_impl = new_memory_server()
        elif profile.store == "sqlite":
            service_impl = new_sqlite_server(profile.store_path or ":memory:")
        elif profile.store == "jsonfs":
            if profile.store_path is None:
                raise ValueError("store='jsonfs' needs store_path")
            service_impl = new_jsonfs_server(profile.store_path)
        else:
            raise ValueError(f"unknown store {profile.store!r}")
        service_impl.server.clerking_lease_seconds = profile.lease_seconds
        server = service_impl.server
        if profile.http:
            http_server = server_class(profile.async_http)(
                service_impl, bind="127.0.0.1:0")
            http_server.start_background()

    if profile.dead_clerks:
        # the lifecycle plane needs a clock to diagnose dead clerks
        server.round_deadlines = lifecycle.RoundDeadlines(
            clerking_s=profile.clerking_deadline_s)
    sweeper = lifecycle.RoundSweeper(server,
                                     interval_s=profile.sweep_interval_s)

    proxies: Dict[object, object] = {}

    def client_service(agent_key):
        if fleet is None and http_server is None:
            return service_impl
        node = ring.node_for(str(agent_key)) if ring is not None else None
        proxy = proxies.get(node)
        if proxy is None:
            address = (fleet.addresses[node] if fleet is not None
                       else http_server.address)
            proxy = SdaHttpClient(address, token="fl-drill-token",
                                  max_retries=16, backoff_base=0.01,
                                  backoff_cap=0.25,
                                  deadline=profile.timeout_s)
            proxies[node] = proxy
        return proxy

    def new_client():
        keystore = MemoryKeystore()
        agent = SdaClient.new_agent(keystore)
        client = SdaClient(agent, keystore, client_service(agent.id),
                           device=profile.device)
        client.upload_agent()
        return client

    journal_dir = tempfile.TemporaryDirectory(prefix="sda-fl-journal-")
    journal = ParticipationJournal(journal_dir.name)
    deadline = time.monotonic() + profile.timeout_s

    def remaining() -> float:
        return max(1.0, deadline - time.monotonic())

    failures: List[str] = []
    per_round: List[dict] = []
    accuracy_by_round: List[float] = []
    churn_totals = {"churned": 0, "resumed": 0, "dropped": 0}
    leaks = 0
    degraded_rounds = 0
    exact_rounds = 0
    failure: Optional[dict] = None
    attackers_by_round: List[int] = []
    backdoor_asr: List[float] = []

    try:
        with obs.span("fl.run", attributes={
                "family": profile.family, "participants":
                profile.participants, "rounds": profile.rounds,
                "seed": profile.seed}):
            # -- identities + schedule (clean setup, like every drill) ----
            recipient = new_client()
            recipient_key = recipient.new_encryption_key()
            recipient.upload_encryption_key(recipient_key)
            clerks = []
            committee_policy = []
            for _ in range(scheme.share_count):
                clerk = new_client()
                key_id = clerk.new_encryption_key()
                clerk.upload_encryption_key(key_id)
                clerks.append(clerk)
                committee_policy.append([str(clerk.agent.id), str(key_id)])
            dead_ids = []
            for clerk in clerks[:profile.dead_clerks]:
                # permanent death, the lifecycle plane's failure model:
                # the clerk never polls again; the sweeper diagnoses it
                # and the round degrades to the surviving quorum
                clerk._dead = True
                dead_ids.append(str(clerk.agent.id))

            devices = [new_client() for _ in range(profile.participants)]

            template = Aggregation(
                id=AggregationId.random(),  # replaced per epoch
                title="fl", vector_dimension=dim, modulus=modulus,
                recipient=recipient.agent.id,
                recipient_key=recipient_key,
                masking_scheme=FullMasking(modulus),
                committee_sharing_scheme=scheme,
                recipient_encryption_scheme=SodiumEncryption(),
                committee_encryption_scheme=SodiumEncryption(),
            ).to_obj()
            spec = ScheduleSpec(
                name=f"fl-{profile.seed}", period_s=profile.period_s,
                template=template, committee=committee_policy,
                max_pipelined=2)
            scheduler = RoundScheduler(server, [spec])
            scheduler.tick_once()  # install epoch 0: aggregation + committee

            if fleet is None and profile.chaos_rate > 0.0:
                chaos.configure("http.server.request", error=True,
                                rate=profile.chaos_rate, seed=profile.seed)

            accuracy_by_round.append(float(accuracy_of(unravel(gvec))))
            resume_queue: List = []  # agents offline since last round
            reached_at: Optional[int] = None

            for round_ix in range(profile.rounds):
                aggregation_id = epoch_aggregation_id(spec.name, round_ix)
                round_t0 = time.perf_counter()
                with obs.span("fl.round", attributes={
                        "round": round_ix,
                        "aggregation": str(aggregation_id)}):
                    # -- departed devices come back online: a FRESH client
                    # process resumes the journal — the mid-upload bundle
                    # replays byte-identically into last round, the
                    # pre-upload bundle lands late (outside the frozen set)
                    for agent in resume_queue:
                        rejoined = SdaClient(agent, MemoryKeystore(),
                                             client_service(agent.id),
                                             device=profile.device)
                        churn_totals["resumed"] += rejoined.resume(journal)
                    resume_queue = []

                    plan = (chaos.churn_schedule(
                        profile.participants, profile.churn,
                        seed=profile.seed, epoch=round_ix)
                        if profile.churn else None)
                    # attacker selection keeps churn_schedule's exact
                    # (seed, epoch) discipline on a DISJOINT RNG key, so
                    # churn + poison compose from one seed uncorrelated
                    poison_plan = (chaos.poison_schedule(
                        profile.participants, profile.poison,
                        seed=profile.seed, epoch=round_ix)
                        if profile.poison else None)

                    expected_q = np.zeros(dim, dtype=np.int64)
                    frozen = 0
                    dropped = 0
                    attackers = 0
                    losses = []
                    train_s = encode_s = 0.0
                    for ix, device in enumerate(devices):
                        attacker = bool(poison_plan
                                        and poison_plan[ix]["attacker"])
                        backdoor_dim = (attack["trigger_dim"]
                                        if attacker
                                        and attack["kind"] == "backdoor"
                                        else None)
                        t0 = time.perf_counter()
                        with timed_phase("fl.train"):
                            local_vec, loss = local_fit(
                                gvec, ix, round_ix,
                                backdoor_dim=backdoor_dim)
                        train_s += time.perf_counter() - t0
                        losses.append(loss)
                        delta = np.asarray(local_vec, np.float64) - gvec
                        if attacker:
                            attackers += 1
                            # boost/signflip corrupt the float delta
                            # BEFORE the codec — the attacker then runs
                            # the standard stack, so every round stays
                            # bit-exact over what was actually submitted
                            delta = chaos.corrupt_delta(delta, attack)
                        t0 = time.perf_counter()
                        with timed_phase("fl.encode"):
                            quantized = codec.quantize(delta)
                            encoded = np.mod(quantized, modulus) \
                                .astype(np.int64)
                        encode_s += time.perf_counter() - t0
                        entry = plan[ix] if plan else None
                        if attacker:
                            # the attacker also taints its SHARE upload
                            # (out-of-field values, sum unchanged): the
                            # clerk-side range check must see something
                            # to count — armed around exactly this call
                            chaos.configure("participant.taint_shares",
                                            taint=True)
                        try:
                            if entry and entry["departs"]:
                                # the sporadic device: seal + journal, then
                                # crash at the seeded point; it rejoins at
                                # the START of next round
                                bundle = device.new_participation(
                                    encoded, aggregation_id)
                                journal.record(bundle)
                                churn_totals["churned"] += 1
                                resume_queue.append(device.agent)
                                if entry["phase"] == "mid-upload":
                                    # lost-ack window: the server durably
                                    # stored it — it IS in this round
                                    device.upload_participation(bundle)
                                    expected_q += quantized
                                    frozen += 1
                                else:
                                    # pre-upload crash: this round loses
                                    # the device — the dropout the update
                                    # below must weight for
                                    dropped += 1
                                    churn_totals["dropped"] += 1
                                continue
                            # the int64 residue array goes straight through
                            # (no per-element Python conversion)
                            device.participate(encoded, aggregation_id,
                                               journal=journal)
                            expected_q += quantized
                            frozen += 1
                        except ServerError as e:
                            failures.append(
                                f"round {round_ix} device {ix}: {e}")
                        finally:
                            if attacker:
                                chaos.clear("participant.taint_shares")
                    attackers_by_round.append(attackers)

                    # -- close the epoch: mint round r+1 (which freezes
                    # round r's participation set and fans out the jobs);
                    # the final round closes without minting a successor
                    with timed_phase("fl.aggregate"):
                        if round_ix + 1 < profile.rounds:
                            # the mint (which closes this epoch) is gated
                            # on the schedule cadence: a round that
                            # finished within period_s of the previous
                            # mint skips one tick — keep ticking until
                            # this epoch actually left `collecting`
                            # instead of assuming one tick advanced it
                            scheduler.tick_once()
                            while time.monotonic() < deadline:
                                doc = server.aggregation_store \
                                    .get_round_state(aggregation_id)
                                if doc is None \
                                        or doc.get("state") != "collecting":
                                    break
                                time.sleep(profile.period_s)
                                scheduler.tick_once()
                        else:
                            # the final epoch closes unconditionally (no
                            # cadence gate, no dangling successor)
                            scheduler.close_epoch(spec, round_ix)

                        # -- clerking pump (the chaos-drill loop): full
                        # committee when healthy, surviving quorum +
                        # degraded verdict with dead clerks
                        threshold = scheme.reconstruction_threshold
                        ready = False
                        while time.monotonic() < deadline:
                            for clerk in clerks:
                                try:
                                    clerk.run_chores(-1)
                                except ServerError:
                                    metrics.count("fl.clerk.transient")
                            if profile.dead_clerks:
                                sweeper.sweep_once()
                            try:
                                status = \
                                    recipient.service.get_aggregation_status(
                                        recipient.agent, aggregation_id)
                            except ServerError:
                                metrics.count("fl.status.transient")
                                status = None
                            results = 0
                            if status is not None and status.snapshots:
                                results = (status.snapshots[0]
                                           .number_of_clerking_results)
                            if not profile.dead_clerks \
                                    and results >= scheme.share_count:
                                ready = True
                                break
                            if profile.dead_clerks:
                                state = None
                                try:
                                    state = recipient.service \
                                        .get_round_status(recipient.agent,
                                                          aggregation_id)
                                except ServerError:
                                    pass
                                if state is not None:
                                    if state.state == "failed":
                                        break
                                    if state.state == "degraded" \
                                            and results >= threshold:
                                        ready = True
                                        break
                            time.sleep(0.02)

                        # -- lifecycle-aware reveal: typed verdicts, never
                        # a silent partial sum
                        t_reveal = time.perf_counter()
                        try:
                            output = recipient.await_result(
                                aggregation_id, deadline=remaining(),
                                poll_interval=0.05)
                        except RoundFailed as e:  # RoundExpired subclasses
                            failure = {
                                "type": type(e).__name__, "round": round_ix,
                                "state": e.state, "reason": e.reason,
                                "dead_clerks": [str(c)
                                                for c in e.dead_clerks],
                            }
                            failures.append(
                                f"round {round_ix}: {type(e).__name__}: "
                                f"{e.reason}")
                            break
                        reveal_s = time.perf_counter() - t_reveal

                    values = output.positive().values
                    expected_mod = np.mod(expected_q, modulus)
                    exact = bool((values == expected_mod).all())
                    exact_rounds += int(exact)
                    if not exact:
                        failures.append(f"round {round_ix}: inexact reveal")
                    # None = pre-lifecycle server (fall back to our own
                    # count); 0 is a REAL answer and must fail the audit,
                    # not silently alias the client-side tally
                    summands = (output.participations
                                if output.participations is not None
                                else frozen)
                    if summands != frozen:
                        # a surplus is a double count, a deficit a lost
                        # admitted participation — both are leaks the
                        # exactly-once plane exists to prevent
                        leaks += 1
                        failures.append(
                            f"round {round_ix}: {summands} frozen "
                            f"participations (expected {frozen})")

                    round_state = None
                    state = None
                    try:
                        state = recipient.service.get_round_status(
                            recipient.agent, aggregation_id)
                        round_state = state.state if state else None
                    except ServerError:
                        pass
                    if round_state == "degraded" or (
                            round_state == "revealed" and state is not None
                            and any(s == "degraded" for s, _ in
                                    (state.history or []))):
                        degraded_rounds += 1

                    # -- dropout-weighted global update (+ optional DP);
                    # an empty frozen set has nothing to decode — the
                    # global model holds, and the audit above already
                    # recorded the failure when the server disagreed
                    if summands > 0:
                        sum_delta = codec.decode_sum(values, summands)
                        if profile.dp_sigma:
                            from .dp import apply_gaussian_noise

                            sum_delta = apply_gaussian_noise(
                                sum_delta, sigma=profile.dp_sigma,
                                clip=profile.clip, seed=profile.seed,
                                round_index=round_ix)
                        gvec = gvec + sum_delta / summands

                    with timed_phase("fl.eval"):
                        accuracy = float(accuracy_of(unravel(gvec)))
                    accuracy_by_round.append(accuracy)
                    if asr_of is not None:
                        backdoor_asr.append(round(float(asr_of(gvec)), 4))
                    if reached_at is None \
                            and accuracy >= profile.target_accuracy:
                        reached_at = round_ix + 1

                    per_round.append({
                        "round": round_ix,
                        "aggregation": str(aggregation_id),
                        "accuracy": round(accuracy, 4),
                        "mean_local_loss": round(float(np.mean(losses)), 4)
                        if losses else None,
                        "exact": exact,
                        "participations": summands,
                        "dropped": dropped,
                        "state": round_state,
                        "train_s": round(train_s, 4),
                        "encode_s": round(encode_s, 4),
                        "reveal_s": round(reveal_s, 4),
                        "wall_s": round(time.perf_counter() - round_t0, 4),
                    })

            # the last round's departures come back online after the run:
            # drain their journals so every crash resolved exactly-once
            # (mid-upload bundles replay byte-identically into the closed
            # round, pre-upload bundles land as late arrivals outside it)
            for agent in resume_queue:
                rejoined = SdaClient(agent, MemoryKeystore(),
                                     client_service(agent.id),
                                     device=profile.device)
                churn_totals["resumed"] += rejoined.resume(journal)
            resume_queue = []
    finally:
        failpoint_report = chaos.report()
        chaos.reset()
        participation_counters: dict = {}
        drain_summaries = None
        if fleet is not None:
            # exactly-once tallies are stamped server-side, i.e. in the
            # worker processes: scrape each /statusz BEFORE the drain
            from ..server.fleet import merge_statusz_block

            participation_counters = merge_statusz_block(
                fleet.scrape_statusz().values(), "participation")
            drain_summaries = fleet.stop()
        if http_server is not None:
            http_server.shutdown()
        for proxy in proxies.values():
            proxy.close()
        journal_dir.cleanup()

    counters = metrics.counter_report()
    if not participation_counters:
        participation_counters = metrics.counter_report(
            "server.participation.") or {}
    report = _base_report(profile, dim, codec, accuracy_by_round, per_round,
                          reached_at, exact_rounds, failures)
    report.update({
        "mode": ("fl over "
                 + (f"fleet x{profile.fleet}" if fleet is not None
                    else "HTTP" if http_server is not None else "in-process")
                 + f" ({profile.store} store)"),
        "sharing": "packed-shamir 8",
        "dead_clerks": dead_ids or None,
        "degraded_rounds": degraded_rounds,
        "failure": failure,
        "leaks": leaks,
        "churn_rate": profile.churn or None,
        "churn": ({
            "participants_churned": churn_totals["churned"],
            "participants_resumed": churn_totals["resumed"],
            "dropped_from_rounds": churn_totals["dropped"],
            "participations_replayed": participation_counters.get(
                "server.participation.replayed", 0),
            "equivocations": participation_counters.get(
                "server.participation.equivocation", 0),
        } if profile.churn else None),
        "failpoints": failpoint_report or None,
        "attack": _attack_block(profile, attack, attackers_by_round,
                                backdoor_asr, counters),
        "counters": {
            k: v for k, v in counters.items()
            if k.startswith(("fl.", "chaos.", "service.schedule.",
                             "server.round.", "server.participation.",
                             "participant.", "clerk.", "http.retry."))
        } or None,
    })
    from ..obs import devprof as _devprof

    report["xla"] = _devprof.compile_totals()
    if fleet is not None:
        report["fleet_nodes"] = profile.fleet
        report["fleet"] = {
            "drain": drain_summaries,
            "leaked": sum(int(s.get("leaked", 0) or 0)
                          for s in drain_summaries or []),
        }
    return report


def _attack_block(profile: FLProfile, attack, attackers_by_round,
                  backdoor_asr, counters) -> Optional[dict]:
    """The FL record's ``attack`` block: what was attacked, what was
    detected, what defended. Accuracy DELTAS (undefended vs. defended
    vs. clean) are cross-run quantities — the ci.sh A/B drill assembles
    them into the BENCH attack record; this block carries everything one
    run knows about itself."""
    if not profile.poison:
        return None
    return {
        "rate": profile.poison,
        "kind": profile.poison_kind,
        "parsed": attack,
        "attackers_by_round": attackers_by_round,
        "attackers_total": int(sum(attackers_by_round)),
        # protocol-compliant-but-malicious fingerprints: shares the
        # attackers lifted out of the field, and how many of those
        # uploads the clerks' range sanity actually caught
        "shares_tainted": counters.get("participant.shares_tainted", 0),
        "out_of_range_detections": counters.get(
            "clerk.share.out_of_range", 0),
        "backdoor_success_by_round": backdoor_asr or None,
        "backdoor_success_final": (backdoor_asr[-1] if backdoor_asr
                                   else None),
        "defended": bool(profile.norm_clip is not None
                         or profile.tree_robust),
        "norm_clip": profile.norm_clip,
        "tree_robust": profile.tree_robust,
    }


# ---------------------------------------------------------------------------
# the tree mode: population-scale rounds through sda_tpu_torch/tree

def _run_tree_mode(profile: FLProfile, gvec, dim, local_fit, accuracy_of,
                   unravel, attack=None, asr_of=None) -> dict:
    from ..tree import run_tree_round

    codec = _make_codec(profile, None)
    modulus = codec.modulus

    failures: List[str] = []
    per_round: List[dict] = []
    accuracy_by_round: List[float] = []
    exact_rounds = 0
    reached_at: Optional[int] = None
    dropped_total = 0
    attackers_by_round: List[int] = []
    backdoor_asr: List[float] = []

    with obs.span("fl.run", attributes={
            "family": profile.family, "participants": profile.participants,
            "rounds": profile.rounds, "mode": "tree",
            "seed": profile.seed}):
        accuracy_by_round.append(float(accuracy_of(unravel(gvec))))
        for round_ix in range(profile.rounds):
            round_t0 = time.perf_counter()
            with obs.span("fl.round", attributes={"round": round_ix,
                                                  "mode": "tree"}):
                poison_plan = (chaos.poison_schedule(
                    profile.participants, profile.poison,
                    seed=profile.seed, epoch=round_ix)
                    if profile.poison else None)
                attacker_ixs = [e["index"] for e in (poison_plan or ())
                                if e["attacker"]]
                attackers_by_round.append(len(attacker_ixs))
                encoded = np.zeros((profile.participants, dim), np.int64)
                losses = []
                train_s = 0.0
                for ix in range(profile.participants):
                    attacker = ix in attacker_ixs
                    backdoor_dim = (attack["trigger_dim"]
                                    if attacker
                                    and attack["kind"] == "backdoor"
                                    else None)
                    t0 = time.perf_counter()
                    with timed_phase("fl.train"):
                        local_vec, loss = local_fit(
                            gvec, ix, round_ix, backdoor_dim=backdoor_dim)
                    train_s += time.perf_counter() - t0
                    losses.append(loss)
                    delta = np.asarray(local_vec, np.float64) - gvec
                    if attacker:
                        delta = chaos.corrupt_delta(delta, attack)
                    with timed_phase("fl.encode"):
                        encoded[ix] = codec.encode(delta)
                if profile.chaos_rate:
                    # the lifted composition: tree rounds over HTTP take
                    # real dispatch chaos. Re-armed per round — the tree
                    # driver resets failpoints after leaf participation,
                    # so the injection window is each round's upload path
                    chaos.configure("http.server.request", error=True,
                                    rate=profile.chaos_rate,
                                    seed=profile.seed)
                with timed_phase("fl.aggregate"):
                    rep = run_tree_round(
                        encoded,
                        group_size=profile.tree_group_size,
                        modulus=modulus,
                        sharing="additive",
                        masking="full",
                        store=profile.store,
                        store_path=profile.store_path,
                        http=profile.http,
                        seed=profile.seed * 1009 + round_ix,
                        dropout_rate=profile.churn,
                        flat_reference=False,
                        device=profile.device,
                        timeout_s=profile.timeout_s,
                        reset_obs=False,
                        return_output=True,
                        taint_participants=attacker_ixs or None,
                        collect_leaf_subtotals=profile.tree_robust,
                    )
                exact = bool(rep.get("exact"))
                exact_rounds += int(exact)
                if not exact:
                    failures.append(
                        f"round {round_ix}: tree reveal inexact "
                        f"(root {rep.get('root_state')}: "
                        f"{rep.get('root_reason')})")
                dropped = int(rep.get("participants_dropped") or 0)
                dropped_total += dropped
                summands = profile.participants - dropped
                values = rep.get("output_values")
                robust_delta = None
                if profile.tree_robust:
                    robust_delta = _robust_tree_update(
                        codec, rep.get("leaf_subtotals") or [])
                if robust_delta is not None:
                    # robust recipient post-processing: the trimmed mean
                    # over per-leaf mean deltas REPLACES the population
                    # mean in the model update — the protocol reveal and
                    # its bit-exactness verdict above are untouched
                    if profile.dp_sigma:
                        from .dp import apply_gaussian_noise

                        robust_delta = apply_gaussian_noise(
                            robust_delta, sigma=profile.dp_sigma,
                            clip=profile.clip, seed=profile.seed,
                            round_index=round_ix)
                    gvec = gvec + robust_delta
                elif values is not None and summands > 0:
                    sum_delta = codec.decode_sum(values, summands)
                    if profile.dp_sigma:
                        from .dp import apply_gaussian_noise

                        sum_delta = apply_gaussian_noise(
                            sum_delta, sigma=profile.dp_sigma,
                            clip=profile.clip, seed=profile.seed,
                            round_index=round_ix)
                    gvec = gvec + sum_delta / summands
                with timed_phase("fl.eval"):
                    accuracy = float(accuracy_of(unravel(gvec)))
                accuracy_by_round.append(accuracy)
                if asr_of is not None:
                    backdoor_asr.append(round(float(asr_of(gvec)), 4))
                if reached_at is None \
                        and accuracy >= profile.target_accuracy:
                    reached_at = round_ix + 1
                per_round.append({
                    "round": round_ix,
                    "accuracy": round(accuracy, 4),
                    "mean_local_loss": round(float(np.mean(losses)), 4),
                    "exact": exact,
                    "participations": summands,
                    "dropped": dropped,
                    "attackers": len(attacker_ixs) or None,
                    "robust_leaves": (len(rep.get("leaf_subtotals") or [])
                                      if profile.tree_robust else None),
                    "groups": rep.get("groups"),
                    "depth": rep.get("depth"),
                    "root_state": rep.get("root_state"),
                    "train_s": round(train_s, 4),
                    "wall_s": round(time.perf_counter() - round_t0, 4),
                })

    from ..obs import devprof

    counters = metrics.counter_report()
    report = _base_report(profile, dim, codec, accuracy_by_round, per_round,
                          reached_at, exact_rounds, failures)
    report.update({
        "mode": (f"fl over tree (group size {profile.tree_group_size}, "
                 f"{profile.store} store"
                 + (", robust" if profile.tree_robust else "")
                 + (", HTTP" if profile.http else "") + ")"),
        "sharing": "tree-additive 3",
        "churn_rate": profile.churn or None,
        "dropout_total": dropped_total,
        "tree_robust": profile.tree_robust or None,
        "attack": _attack_block(profile, attack, attackers_by_round,
                                backdoor_asr, counters),
        "counters": {
            k: v for k, v in counters.items()
            if k.startswith(("fl.", "chaos.", "participant.",
                             "clerk.share.", "relay.", "tree."))
        } or None,
        "xla": devprof.compile_totals(),
    })
    return report


def _robust_tree_update(codec, leaf_subtotals) -> Optional[np.ndarray]:
    """Per-coordinate trimmed mean over the per-leaf MEAN deltas.

    Each leaf subtotal decodes (centered lift / scale) and normalizes by
    its own participation count, so leaves of unequal size vote with
    comparable magnitudes. With >= 3 leaves, the per-coordinate max and
    min are dropped and the rest averaged (the classic trimmed mean —
    one fully-captured leaf cannot move the estimate past the honest
    envelope); with fewer, the median. Returns the robust mean delta to
    ADD to the global vector (already a mean, not a sum), or None when
    no leaf has participants — the caller falls back to the standard
    population-mean update."""
    means = []
    for entry in leaf_subtotals:
        participations = int(entry.get("participations") or 0)
        if participations < 1:
            continue
        means.append(codec.decode_sum(entry["values"], participations)
                     / participations)
    if not means:
        return None
    stacked = np.stack(means)
    if len(means) >= 3:
        ordered = np.sort(stacked, axis=0)
        return ordered[1:-1].mean(axis=0)
    return np.median(stacked, axis=0)


# ---------------------------------------------------------------------------
# shared report assembly

def _base_report(profile: FLProfile, dim, codec, accuracy_by_round,
                 per_round, reached_at, exact_rounds, failures) -> dict:
    from ..utils import phase_report

    from .dp import gaussian_accounting

    reached = reached_at is not None
    rounds_run = len(per_round)
    phases = phase_report()
    report = {
        "metric": (f"rounds to target accuracy {profile.target_accuracy} "
                   f"(secure FedAvg, {profile.family}, "
                   f"{profile.participants} devices, dim {dim}, "
                   f"churn {profile.churn}, "
                   f"{profile.dead_clerks} dead clerk(s))"),
        # direction is part of the record: LOWER is better here, and the
        # regress gate honors the tag (sda_tpu_torch/obs/regress.py). A run
        # that NEVER reached the target scores one worse than using
        # every round — "did not converge within R" must read as a
        # regression against any converged-in-R history, not alias it
        "value": reached_at if reached else rounds_run + 1,
        "direction": "lower",
        "unit": "rounds",
        # the device the families trained on (the reference's is "cpu")
        "platform": str(profile.device or "cuda").split(":")[0],
        # which serving transport carried the rounds (None: in-process,
        # no HTTP plane in the path) — benchmark evidence must say
        "http_plane": (("async" if profile.async_http else "threaded")
                       if (profile.http or profile.fleet) else None),
        "seed": profile.seed,
        "family": profile.family,
        "dataset": profile.dataset,
        "participants": profile.participants,
        "rounds": profile.rounds,
        "rounds_run": rounds_run,
        "dim": dim,
        "local_steps": profile.local_steps,
        "batch_size": profile.batch_size,
        "lr": profile.lr,
        "target_accuracy": profile.target_accuracy,
        "reached_target": reached,
        "rounds_to_target": reached_at,
        "initial_accuracy": round(accuracy_by_round[0], 4),
        "final_accuracy": round(accuracy_by_round[-1], 4),
        "accuracy_by_round": [round(a, 4) for a in accuracy_by_round],
        # the full codec contract, so poisoned and clean runs are
        # comparable by the regression gate: effective per-coordinate
        # clip, the L2 defense bound (None = undefended), the field
        # modulus, and how much of the field's headroom the worst-case
        # sum leaves unused (>= 0 by the constructor's capacity rule)
        "quantizer": {
            "modulus": codec.modulus,
            "fractional_bits": codec.fractional_bits,
            "clip": codec.clip,
            "norm_clip": codec.norm_clip,
            "q_max": codec.q_max,
            "headroom_margin": (codec.modulus // 2 - 1
                                - codec.q_max * codec.max_summands),
            "max_summands": codec.max_summands,
        },
        "rounds_exact": exact_rounds,
        "exact": exact_rounds == rounds_run and rounds_run > 0,
        "dp": (gaussian_accounting(
            profile.dp_sigma, max(1, rounds_run), clip=profile.clip,
            dim=dim, delta=profile.dp_delta)
            if profile.dp_sigma else None),
        "per_round": per_round,
        "phases_s": {name: round(stat["total_s"], 4)
                     for name, stat in phases.items()
                     if name.startswith("fl.")} or None,
        "client_failures": len(failures),
        "failure_samples": failures[:5] or None,
    }
    return report
