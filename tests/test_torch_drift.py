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
    "analytics/__init__.py",
    "analytics/encoders.py",
    "analytics/scenario.py",
    "chaos/__init__.py",
    "chaos/drill.py",
    "chaos/poison.py",
    "cli/__init__.py",
    "cli/fleetd.py",
    "cli/main.py",
    "cli/serverd.py",
    "cli/tracecli.py",
    "client/embed.py",
    "client/journal.py",
    "client/relay.py",
    "crypto/batch.py",
    "crypto/paillier.py",
    "crypto/signing.py",
    "crypto/varint.py",
    "fields/chacha.py",
    "fl/__init__.py",
    "fl/data.py",
    "fl/dp.py",
    "http/__init__.py",
    "http/admission.py",
    "http/aserver.py",
    "http/base.py",
    "http/client.py",
    "http/server.py",
    "loadgen/__init__.py",
    "loadgen/connstorm.py",
    "loadgen/driver.py",
    "loadgen/inputbench.py",
    "loadgen/pickup.py",
    "loadgen/recorderbench.py",
    "obs/forensics.py",
    "obs/recorder.py",
    "obs/slo.py",
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
    "server/breaker.py",
    "server/core.py",
    "server/fleet.py",
    "server/health.py",
    "server/jsonfs.py",
    "server/lifecycle.py",
    "server/memory.py",
    "server/mongo.py",
    "server/routing.py",
    "server/snapshot.py",
    "server/sqlite.py",
    "server/stores.py",
    "server/wakeup.py",
    "service/__init__.py",
    "service/retention.py",
    "service/scheduler.py",
    "service/soak.py",
    "store/__init__.py",
    "store/file.py",
    "tree/__init__.py",
    "tree/plan.py",
    "tree/round.py",
    "tree/sim.py",
    "utils/env.py",
    "utils/logsetup.py",
    "utils/metrics.py",
]

#: functions that a rewritten module copies verbatim from its reference
FUNCTION_COPIES = [
    ("mesh/simpod.py", "_dim_grain"),
    ("mesh/simpod.py", "_scheme_modulus"),
    ("mesh/simpod.py", "_check_mask_modulus"),
    ("mesh/simpod.py", "_check_masking_supported"),
    ("mesh/simpod.py", "_build_matrices"),
    ("mesh/simpod.py", "default_mesh_shape"),
    ("mesh/multihost.py", "_MultihostCheckpointer._local_candidates"),
    ("mesh/multihost.py", "_MultihostCheckpointer.finish"),
    ("loadgen/devscale.py", "DevScaleProfile.validate"),
    ("loadgen/devscale.py", "_oracle_check"),
    ("mesh/streaming.py", "array_block_provider"),
    ("mesh/streaming.py", "synthetic_block_provider"),
    ("mesh/streaming.py", "_atomic_npz"),
    ("mesh/streaming.py", "_read_snapshot"),
    ("mesh/streaming.py", "_checkpoint_load"),
    ("models/encoding.py", "FieldSizingError"),
    ("models/encoding.py", "field_capacity"),
    ("models/encoding.py", "field_headroom_check"),
    ("models/encoding.py", "FixedPointCodec.__init__"),
    ("models/encoding.py", "FixedPointCodec.q_max"),
    ("models/encoding.py", "FixedPointCodec.quantize"),
    ("models/encoding.py", "FixedPointCodec.encode"),
    ("models/encoding.py", "FixedPointCodec.decode_sum"),
    ("models/encoding.py", "FixedPointCodec.decode_mean"),
    ("models/encoding.py", "FixedPointCodec.__repr__"),
    # obs/regress.py is a copy but for _comparable (the framework key);
    # cli/bench.py but for _run_bench and main (--run passes the bench's
    # own arguments through)
    *[("obs/regress.py", name) for name in (
        "MalformedRecord", "repo_root", "_parse_file", "load_records",
        "chain_rel_uncertainty", "_window_stats", "check", "format_table",
        "default_paths", "build_parser", "run", "main")],
    ("cli/bench.py", "build_parser"),
    ("models/federated.py", "FederatedSession"),
    ("models/federated.py", "LocalTrainer.init_state"),
    ("fl/flagship.py", "flagship_dims"),
    *[("fl/scenario.py", name) for name in (
        "_make_codec", "_load_dataset", "_attack_block",
        "_robust_tree_update")],
    # cli/sim.py rewrites the mesh modes, the multihost coordinator and
    # the FL and devscale profiles (no backend selection)
    ("cli/sim.py", "_export_trace"),
    ("cli/sim.py", "_run_connstorm"),
    # native/__init__.py rewrites the library's build and load (the port's
    # own host crypto is linked in) and embed_participate's return codes;
    # the bindings of the field kernels stay copies
    *[("native/__init__.py", name) for name in (
        "available", "_i64", "modmatmul", "modsum_axis0",
        "chacha_expand_mask", "chacha_combine_masks", "_u64", "_limbs",
        "powmod", "powmod_batch")],
]

#: functions that a rewritten module copies but for the ``device=``
#: keyword arguments it adds to calls (the clients' and the tree round's
#: device)
DEVICE_KEYWORD_COPIES = [
    ("fl/scenario.py", "_run_protocol_mode"),
    ("fl/scenario.py", "_run_tree_mode"),
    *[("cli/sim.py", name) for name in (
        "_run_load", "_run_tree", "_run_soak", "_run_analytics",
        "_run_pickup", "_run_chaos")],
]

#: lines a copy words otherwise, by line number (1-based), each replaced
#: by the text given (which may span lines): docstring lines of
#: ``lifecycle.py``, ``health.py``, ``scheduler.py``, ``fl/__init__.py``
#: and ``analytics/scenario.py`` name steps of the reference's own history; the CLI's device lines are
#: the port's counterpart of ``JAX_PLATFORMS`` (``sda --device``: the
#: agent's field arithmetic; ``sdad --device``: the Paillier premix); the
#: drills' and benches' client lines pass the clients' ``device`` (a
#: profile field, or a keyword), CUDA unless ``"cpu"``
_DEVICE_FIELD = ("    device: Optional[str] = None  # the clients' device: "
                 "CUDA unless \"cpu\"")
EDITS = {
    "chaos/drill.py": {
        68: "    async_http: bool = False,\n    device=None,",
        122: "    crypto, as in production rounds). ``device`` is the "
             "clients' device\n    (CUDA unless ``\"cpu\"``).",
        229: "                return SdaClient(agent, keystore, new_proxy(),\n"
             "                                 device=device)",
        332: "                rejoined = SdaClient(agent, MemoryKeystore(), "
             "new_proxy(),\n                                     "
             "device=device)",
        341: "                probe = SdaClient(agent, MemoryKeystore(), "
             "new_proxy(),\n                                  device=device)",
    },
    "loadgen/driver.py": {
        106: "    async_http: bool = False\n" + _DEVICE_FIELD,
        300: "                return SdaClient(agent, keystore, "
             "_proxy_for(agent.id),\n"
             "                                 device=profile.device)",
        391: "                                     "
             "_proxy_for(participant.agent.id),\n"
             "                                     device=profile.device)",
    },
    "loadgen/pickup.py": {
        51: "    timeout_s: float = 120.0\n" + _DEVICE_FIELD,
        86: "                             SdaHttpClient(http_server.address, "
            "token=\"t\"),\n"
            "                             device=profile.device)",
    },
    "loadgen/inputbench.py": {
        49: "                    seed: int = 0, device=None) -> dict:",
        50: "    \"\"\"Run both rungs at ``dim``; returns the JSON-able "
            "report. ``device``:\n    the participant's device (CUDA unless "
            "``\"cpu\"``).\"\"\"",
        71: "        client = SdaClient(SdaClient.new_agent(keystore), "
            "keystore, service,\n                           device=device)",
        118: "        \"platform\": participant.crypto.device.type,",
        136: "    parser.add_argument(\"--seed\", type=int, default=0)\n"
             "    parser.add_argument(\"--device\", default=\"cuda\",\n"
             "                        help=\"the participant's device \"\n"
             "                             \"(cuda, or cpu for the host)\")",
        138: "    print(json.dumps(run_input_bench(args.dim, args.repeats, "
             "args.seed,\n                                     "
             "args.device)))",
    },
    "service/soak.py": {
        72: "    timeout_s: float = 600.0\n" + _DEVICE_FIELD,
        223: "                         _proxy(key if key is not None else "
             "agent.id, tenant),\n"
             "                         device=profile.device)",
        399: "                                _proxy(device.agent.id, "
             "tenant[\"id\"]),\n"
             "                                device=profile.device)",
    },
    "analytics/scenario.py": {
        8: "one clerk committee. Epochs are minted/closed by the round "
           "scheduler",
        112: "    timeout_s: float = 600.0\n" + _DEVICE_FIELD,
        451: "        client = SdaClient(agent, keystore, "
             "client_service(agent.id),\n"
             "                           device=profile.device)",
    },
    "fl/__init__.py": {
        4: "servers over one store (``server/fleet.py``), deterministic round",
        5: "termination (``server/lifecycle.py``), gray-failure survival, "
           "exactly-once\nsporadic devices (``client/journal.py``),",
        6: "hierarchical trees (``tree/``) and recurring multi-tenant rounds"
           "\n(``service/scheduler.py``).",
        11: "stack — availability churn modeled by the churn schedule +",
        12: "journal/resume, round ids minted by the scheduler so device",
    },
    "tree/round.py": {
        103: "    collect_leaf_subtotals: bool = False,\n    device=None,",
        117: "    otherwise one is built from ``store``/``http``. ``device`` is "
             "the\n    clients' device (CUDA unless ``\"cpu\"``).",
        205: "        client = SdaClient(agent, keystore, client_service(),\n"
             "                           device=device)",
    },
    "server/lifecycle.py": {
        37: "(``transition_round_state`` on all four backends — the fleet's "
            "single-winner",
    },
    "server/health.py": {
        3: "The fleet once recovered held clerking-job leases only through "
           "GRACEFUL",
        4: "drain (SIGTERM → ``release_held_leases``), and the round "
           "supervisor only",
        27: "  as the round-state ``rounds`` table), so N sweeping workers "
            "recall a dead",
    },
    "service/scheduler.py": {
        14: "  ingest key is ``(aggregation, participant)``);",
        338: "        scenario runner uses this for its final round). "
             "Idempotent and",
    },
    "cli/main.py": {
        6: "directory (``-i``), server selection via ``-s``, the device of "
           "the\nagent's field arithmetic via ``--device`` (``cuda``, or "
           "``cpu`` for the host).",
        46: '    parser.add_argument("-v", "--verbose", action="count", '
            'default=0)\n'
            '    parser.add_argument("--device", default="cuda",\n'
            '                        help="device of this agent\'s field '
            'arithmetic "\n'
            '                             "(cuda, or cpu for the host)")',
        206: "    return SdaClient(agent, store, service, device=args.device)",
    },
    "cli/serverd.py": {
        6: "or in-memory (--memory). ``--device`` (``cuda``, or ``cpu`` for "
           "the host)\nis the device of the Paillier premix "
           "(``--premix-paillier`` with\n``SDA_PREMIX_DEVICE=1``).",
        205: '    parser.add_argument("--device", default="cuda",\n'
             '                        help="device of the Paillier premix '
             '(--premix-paillier "\n'
             '                             "with SDA_PREMIX_DEVICE=1): cuda, '
             'or cpu for the "\n'
             '                             "host")\n'
             '    parser.add_argument("-v", "--verbose", action="count", '
             'default=0)',
        244: "        service.server.premix_paillier = True\n"
             "    from ..crypto import encryption\n\n"
             "    encryption.PREMIX_DEVICE = args.device",
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
    """The source of a top-level function or class ``name``, or of a
    method ``Class.name``."""
    text = path.read_text()
    body = ast.parse(text).body
    *outer, name = name.split(".")
    for cls in outer:
        body = next(node.body for node in body
                    if isinstance(node, ast.ClassDef) and node.name == cls)
    for node in body:
        if (isinstance(node, (ast.FunctionDef, ast.ClassDef))
                and node.name == name):
            return ast.get_source_segment(text, node)
    raise LookupError(f"{name} not in {path}")


@pytest.mark.parametrize("rel,name", FUNCTION_COPIES)
def test_function_copy_matches_reference(rel, name):
    ref = _function_source(ROOT / "sda_tpu" / rel, name)
    port = _function_source(ROOT / "sda_tpu_torch" / rel, name)
    assert port == re.sub(r"\bsda_tpu\b", "sda_tpu_torch", ref)


def _without_device_keywords(source: str) -> str:
    """``ast.dump`` of ``source`` with every call's ``device=`` keyword
    argument dropped."""
    tree = ast.parse(source)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            node.keywords = [k for k in node.keywords if k.arg != "device"]
    return ast.dump(tree)


@pytest.mark.parametrize("rel,name", DEVICE_KEYWORD_COPIES)
def test_function_copy_matches_reference_but_for_device(rel, name):
    ref = re.sub(r"\bsda_tpu\b", "sda_tpu_torch",
                 _function_source(ROOT / "sda_tpu" / rel, name))
    port = _function_source(ROOT / "sda_tpu_torch" / rel, name)
    assert port != ref, "an exact copy: list it in FUNCTION_COPIES"
    assert _without_device_keywords(port) == _without_device_keywords(ref)
