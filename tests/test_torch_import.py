"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points run on CUDA unless asked for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "sda_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "sda_tpu")


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_leaves_jax_and_reference_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_source_imports_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


def _entry_points():
    from sda_tpu_torch.benchmarks import kernel_probe
    from sda_tpu_torch.client import SdaClient
    from sda_tpu_torch.crypto import CryptoModule, MemoryKeystore
    from sda_tpu_torch.server import new_memory_server
    from sda_tpu_torch.convert import matrices_from_numpy
    from sda_tpu_torch.device import resolve_device
    from sda_tpu_torch.fields.fastfield import SolinasPrime
    from sda_tpu_torch.fields import numtheory
    from sda_tpu_torch.fields.fused_round import single_chip_round_pallas
    from sda_tpu_torch.mesh import single_chip_round
    from sda_tpu_torch.protocol import FullMasking, PackedShamirSharing

    t, p, w2, w3 = numtheory.generate_packed_params(3, 8, 28)
    s = PackedShamirSharing(3, 8, t, p, w2, w3)
    m = numtheory.share_matrix_for(s)
    keystore = MemoryKeystore()
    l_ = numtheory.reconstruct_matrix_for(s, tuple(range(8)))
    def probe_call(device=None):
        x = torch.zeros((2, 3, 8), dtype=torch.int32,
                        device=resolve_device(device))
        return kernel_probe.probe_call(
            x, 0, SolinasPrime.try_from(p), m, t, do_x=True, do_prng=True,
            do_matmul=True)

    def probe_main(**kw):
        argv = ["--participants", "4", "--dim", "300"]
        if "device" in kw:
            argv += ["--device", kw["device"]]
        return kernel_probe.main(argv, emit=lambda *a, **k: None)

    from sda_tpu_torch.fields import chacha_device
    from sda_tpu_torch.mesh import (DeviceTileCombiner, DeviceTileSink,
                                    StreamingAggregator,
                                    synthetic_device_block_provider32)
    from sda_tpu_torch.obs import devprof

    import tempfile

    from sda_tpu_torch.cli.main import build_parser as sda_parser
    from sda_tpu_torch.cli.main import load_client
    from sda_tpu_torch.crypto.paillier_tpu import MontgomeryContext
    from sda_tpu_torch.models import FixedPointCodec

    def sda_device(**kw):
        """The device of an ``sda`` process's field arithmetic, read where
        its first device command reads it (``agent show`` needs none)."""
        device = ["--device", kw["device"]] if "device" in kw else []
        args = sda_parser().parse_args(["-i", tempfile.mkdtemp(), *device,
                                        "agent", "show"])
        return load_client(args).crypto.device

    from sda_tpu_torch.benchmarks import bench

    def bench_main(**kw):
        device = ["--device", kw["device"]] if "device" in kw else []
        return bench.main(["--participants", "4", "--dim", "300",
                           "--seconds", "0.001", "--lanes", "monolithic",
                           *device])

    from sda_tpu_torch.loadgen import DevScaleProfile, run_devscale
    from sda_tpu_torch.mesh import (ModelScaleRound, SimulatedPod,
                                    StreamedPod, make_mesh,
                                    make_multislice_mesh)

    def on(kw):
        """The mesh an entry point gets: the CUDA devices by default, or
        one device named by ``device``."""
        return None if "device" not in kw else make_mesh(
            1, 1, devices=[kw["device"]])

    from sda_tpu_torch.fl import FLProfile, run_fl
    from sda_tpu_torch.models import (LeNet, LocalTrainer, LoRAMLP,
                                      MobileLite, pod_fedavg_round, sgd)

    from sda_tpu_torch.chaos.drill import run_chaos_drill
    from sda_tpu_torch.cli import sim
    from sda_tpu_torch.loadgen import LoadProfile, run_load

    def sim_main(**kw):
        device = ["--device", kw["device"]] if "device" in kw else []
        return sim.main(["--participants", "4", "--dim", "24", *device])

    v1 = "sda-tpu/chacha20-prg/v1"
    return {
        "sim": sim_main,
        "run_chaos_drill": lambda **kw: run_chaos_drill(3, 4, rate=0.0,
                                                        **kw),
        "run_load": lambda **kw: run_load(LoadProfile(
            participants=3, dim=4, arrivals="closed", concurrency=2, **kw)),
        "run_fl": lambda **kw: run_fl(FLProfile(participants=2, rounds=1,
                                                **kw)),
        "pod_fedavg_round": lambda **kw: pod_fedavg_round(
            SimulatedPod(s, FullMasking(p), mesh=on(kw)),
            FixedPointCodec(p, 16, 2, clip=1.0), np.zeros(6),
            np.zeros((2, 6))),
        "LocalTrainer": lambda **kw: LocalTrainer(
            lambda params, batch: params["w"].sum(), sgd(0.1), **kw),
        "LeNet": lambda **kw: LeNet(**kw),
        "MobileLite": lambda **kw: MobileLite(width=8,
                                              block_channels=(16, 24), **kw),
        "LoRAMLP": lambda **kw: LoRAMLP(64, 2, 4, in_features=16, **kw),
        "make_mesh": lambda **kw: make_mesh(
            1, 1, devices=[kw["device"]] if kw else None),
        "make_multislice_mesh": lambda **kw: make_multislice_mesh(
            1, 1, 1, devices=[kw["device"]] if kw else None),
        "SimulatedPod": lambda **kw: SimulatedPod(s, FullMasking(p),
                                                  mesh=on(kw)),
        "StreamedPod": lambda **kw: StreamedPod(s, FullMasking(p),
                                                mesh=on(kw)),
        "ModelScaleRound": lambda **kw: ModelScaleRound(
            s, FullMasking(p), mesh=on(kw)),
        "run_devscale": lambda **kw: run_devscale(DevScaleProfile(
            dim=48, rounds=2, p_shards=1, d_shards=1, **kw)),
        "bench": bench_main,
        "watermark_report": lambda **kw: devprof.watermark_report(**kw),
        "MontgomeryContext.premix": lambda **kw: MontgomeryContext(
            p).premix([[1, 2], [3, 4]], **kw),
        "FixedPointCodec.encode_device": lambda **kw: FixedPointCodec(
            433, 2, 4).encode_device([0.5, -1.0], **kw),
        "sda": sda_device,
        "chacha_device.expand_mask": lambda **kw: chacha_device.expand_mask(
            [1, 2], 16, p, prg=v1, **kw),
        "chacha_device.combine_masks":
            lambda **kw: chacha_device.combine_masks(
                [[1, 2]], 16, p, prg=v1, **kw),
        "StreamingAggregator": lambda **kw: StreamingAggregator(
            s, FullMasking(p), **kw),
        "synthetic_device_block_provider32":
            lambda **kw: synthetic_device_block_provider32(p, **kw),
        "DeviceTileCombiner": lambda **kw: DeviceTileCombiner(p, **kw),
        "DeviceTileSink": lambda **kw: DeviceTileSink(
            lambda *c: np.zeros((2, 3)), 2, 3, 2, 3, **kw),
        "hbm_watermark": lambda **kw: devprof.hbm_watermark(**kw),
        "kernel_probe.main": probe_main,
        "kernel_probe.probe_call": probe_call,
        "single_chip_round": lambda **kw: single_chip_round(
            s, FullMasking(p), **kw),
        "single_chip_round_pallas": lambda **kw: single_chip_round_pallas(
            s, FullMasking(p), **kw),
        "matrices_from_numpy": lambda **kw: matrices_from_numpy(
            m, l_, scheme=s, **kw),
        # the first device use: construction and key work need none
        "CryptoModule": lambda **kw: CryptoModule(
            MemoryKeystore(), **kw).new_share_generator(s),
        "SdaClient": lambda **kw: SdaClient(
            SdaClient.new_agent(keystore), keystore, new_memory_server(),
            **kw).crypto.new_secret_masker(FullMasking(p)),
    }


@pytest.mark.parametrize("name", ["single_chip_round",
                                  "single_chip_round_pallas",
                                  "chacha_device.expand_mask",
                                  "chacha_device.combine_masks",
                                  "StreamingAggregator",
                                  "synthetic_device_block_provider32",
                                  "DeviceTileCombiner",
                                  "DeviceTileSink",
                                  "hbm_watermark",
                                  "matrices_from_numpy",
                                  "kernel_probe.main",
                                  "kernel_probe.probe_call",
                                  "CryptoModule",
                                  "SdaClient",
                                  "MontgomeryContext.premix",
                                  "FixedPointCodec.encode_device",
                                  "sda", "bench", "watermark_report",
                                  "make_mesh", "make_multislice_mesh",
                                  "SimulatedPod", "StreamedPod",
                                  "ModelScaleRound", "run_devscale",
                                  "run_fl", "pod_fedavg_round",
                                  "LocalTrainer", "LeNet", "MobileLite",
                                  "LoRAMLP", "sim", "run_chaos_drill",
                                  "run_load"])
def test_entry_points_default_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    entry = _entry_points()[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(device="cuda")
    assert entry(device="cpu") is not None



@pytest.mark.parametrize("module", ["sda_tpu_torch.mesh.multihost",
                                    "sda_tpu_torch.loadgen.devscale"])
def test_multi_device_modules_leave_jax_out(module):
    """The multi-device modes and the model-scale bench import without
    jax or the JAX package (their workers and the card's script run
    where neither is installed)."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


#: relative imports in the port whose targets it does not have yet, each
#: with the ROADMAP item that ports the target: (importing module, target
#: module, name or None) -> item
PENDING_IMPORTS = {}


def _top_level_names(path: Path) -> set:
    """Names a module binds at its top level (definitions, assignments and
    imports, also inside top-level if/try blocks)."""
    names = set()
    todo = list(ast.parse(path.read_text()).body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for target in targets:
                names.update(n.id for n in ast.walk(target)
                             if isinstance(n, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, (ast.If, ast.Try)):
            todo += node.body + node.orelse + getattr(node, "finalbody", [])
            for handler in getattr(node, "handlers", []):
                todo += handler.body
    return names


def _module_path(dotted: str):
    """The file of a port module, or None when the port lacks it."""
    base = ROOT.joinpath(*dotted.split("."))
    for path in (base.with_suffix(".py"), base / "__init__.py"):
        if path.is_file():
            return path
    return None


def _relative_imports():
    """(importing module, target module, imported name or None) for every
    relative import in the port, including those inside functions."""
    found = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        package = parts[:-1]  # a module's package; an __init__'s own
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.ImportFrom) or node.level == 0:
                continue
            base = package[:len(package) - (node.level - 1)]
            target = ".".join(base + ((node.module,) if node.module else ()))
            for alias in node.names:
                found.append((".".join(parts), target, alias.name))
    return found


def test_every_relative_import_resolves():
    """Each relative import names a port module, and each imported name is
    a submodule or a top-level name of its module, unless it is listed in
    ``PENDING_IMPORTS`` with the ROADMAP item that will port it."""
    missing = []
    for module, target, name in _relative_imports():
        path = _module_path(target)
        ok = path is not None and (
            _module_path(f"{target}.{name}") is not None
            or name in _top_level_names(path))
        if not ok and (module, target, name) not in PENDING_IMPORTS:
            missing.append(f"{module}: from {target} import {name}")
    assert not missing, "\n".join(missing)
    for key, item in PENDING_IMPORTS.items():
        assert item.startswith("item "), key


def test_relative_import_scan_sees_function_level_imports():
    found = set(_relative_imports())
    assert ("sda_tpu_torch.server.lifecycle", "sda_tpu_torch.server",
            "health") in found
    assert ("sda_tpu_torch.cli.main", "sda_tpu_torch.client.embed",
            "participate_embedded") in found


@pytest.mark.parametrize("module", [
    "sda_tpu_torch.cli.main", "sda_tpu_torch.cli.serverd",
    "sda_tpu_torch.crypto.paillier_tpu", "sda_tpu_torch.service",
    "sda_tpu_torch.models", "sda_tpu_torch.benchmarks.bench",
    "sda_tpu_torch.cli.bench", "sda_tpu_torch.obs.regress",
    "sda_tpu_torch.utils.traceparse", "sda_tpu_torch.fl",
    "sda_tpu_torch.tree", "sda_tpu_torch.server.fleet",
    "sda_tpu_torch.cli.fleetd", "sda_tpu_torch.models.families",
    "sda_tpu_torch.cli.sim", "sda_tpu_torch.cli.tracecli",
    "sda_tpu_torch.loadgen", "sda_tpu_torch.loadgen.inputbench",
    "sda_tpu_torch.loadgen.recorderbench", "sda_tpu_torch.analytics",
    "sda_tpu_torch.obs.forensics", "sda_tpu_torch.obs.slo"])
def test_entry_module_leaves_jax_out(module):
    code = (f"import importlib, sys\nimportlib.import_module({module!r})\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\nprint(bad)\nsys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_examples_import_runs_nothing():
    """Importing every module of ``sda_tpu_torch.examples`` pulls in no
    jax and starts nothing: no torch, no thread, no process, no output
    (the scripts they port run at module level; the modules run in
    ``main``)."""
    code = (
        "import importlib, multiprocessing, sys, threading\n"
        "from sda_tpu_torch import examples\n"
        "for name in examples.EXAMPLES:\n"
        "    importlib.import_module(f'sda_tpu_torch.examples.{name}')\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('torch',)!r}]\n"
        "assert not bad, bad\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "assert not multiprocessing.active_children()\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout == "" and res.stderr == ""
    from sda_tpu_torch.examples import EXAMPLES

    assert sorted(p.stem for p in (PORT / "examples").glob("*.py")
                  if p.stem != "__init__") == sorted(EXAMPLES)


# -- no torch where no device is used ----------------------------------------

#: a server over ``backend`` (memory or sqlite, threaded or async plane) in
#: this process, then ``sda`` commands that do no device work through
#: ``cli/main.py``; torch must stay out of ``sys.modules`` throughout
_HOST_ROLES = r"""
import contextlib, io, os, sys, tempfile
from sda_tpu_torch.cli import main as sda, serverd  # noqa: F401
from sda_tpu_torch.http import server_class
from sda_tpu_torch.server import new_memory_server, new_sqlite_server

backend, async_http = sys.argv[1], sys.argv[2] == "async"
tmp = tempfile.mkdtemp()
service = (new_memory_server() if backend == "memory"
           else new_sqlite_server(os.path.join(tmp, "sda.db")))
server = server_class(async_http)(service, bind="127.0.0.1:0")
server.start_background()

def run(who, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = sda.main(["-s", server.address, "-i", os.path.join(tmp, who),
                       *map(str, argv)])
    assert rc == 0, (argv, rc)
    assert "torch" not in sys.modules, argv
    return out.getvalue().split()[-1] if out.getvalue().split() else ""

ids = {who: run(who, "agent", "create") for who in ["r", "c0", "c1", "c2"]}
for who in ids:
    run(who, "agent", "keys", "create")
agg = run("r", "aggregations", "create", "t", "--dimension", 4,
          "--modulus", 433, "--shares", 3)
run("r", "aggregations", "begin", agg,
    *[x for c in ("c0", "c1", "c2") for x in ("--clerk", ids[c])])
run("r", "aggregations", "end", agg)
run("r", "ping")
server.shutdown()
print("torch" in sys.modules)
"""


@pytest.mark.parametrize("backend,plane", [("memory", "threaded"),
                                           ("sqlite", "threaded"),
                                           ("sqlite", "async")])
def test_host_roles_never_import_torch(backend, plane):
    """``sdad``'s server and ``sda``'s identity, create, begin, end and ping
    commands do no device work, and never import torch."""
    res = subprocess.run([sys.executable, "-c", _HOST_ROLES, backend, plane],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split()[-1] == "False"


def test_sdad_process_never_loads_torch(tmp_path):
    """The ``sdad`` process serves requests without loading torch's
    library (the connection storm holds its memory to 1024 MiB)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "sda_tpu_torch.cli.serverd", "--sqlite",
         str(tmp_path / "sda.db"), "--async", "--statusz", "httpd",
         "--bind", "127.0.0.1:0"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert "listening on" in line, line
        address = line.rsplit(" ", 1)[-1].strip()
        import urllib.request

        for path in ("/v1/ping", "/statusz"):
            with urllib.request.urlopen(address + path, timeout=60) as r:
                assert r.status == 200
        maps = Path(f"/proc/{proc.pid}/maps").read_text()
        assert "libtorch" not in maps
    finally:
        proc.terminate()
        proc.wait(timeout=60)


_DEVICE_ROLE = r"""
import os, sys, tempfile
from sda_tpu_torch.cli import main as sda
from sda_tpu_torch.http import server_class
from sda_tpu_torch.server import new_memory_server

server = server_class(False)(new_memory_server(), bind="127.0.0.1:0")
server.start_background()
tmp = tempfile.mkdtemp()
device = sys.argv[1:]

def run(who, *argv):
    return sda.main(["-s", server.address, "-i", os.path.join(tmp, who),
                     *device, *map(str, argv)])

import contextlib, io
ids = {}
for who in ["r", "c0", "c1", "c2"]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run(who, "agent", "create") == 0
        assert run(who, "agent", "keys", "create") == 0
    ids[who] = out.getvalue().split()[0]
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert run("r", "aggregations", "create", "t", "--dimension", 4,
               "--modulus", 433, "--shares", 3) == 0
agg = out.getvalue().split()[-1]
assert run("r", "aggregations", "begin", agg, *[
    x for c in ("c0", "c1", "c2") for x in ("--clerk", ids[c])]) == 0
assert "torch" not in sys.modules
try:
    rc = run("p", "participate", agg, 1, 2, 3, 4)
except RuntimeError as e:
    print("raised:", e)
    rc = None
print("rc", rc, "torch", "torch" in sys.modules)
server.shutdown()
"""


@pytest.mark.parametrize("device", ["cpu", None])
def test_device_role_still_runs_on_its_device(device):
    """``participate`` does device work: on ``--device cpu`` it runs there
    (and imports torch); without CUDA the default raises, with no CPU
    fallback."""
    if device is None and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default does not raise")
    argv = ["--device", device] if device else []
    res = subprocess.run([sys.executable, "-c", _DEVICE_ROLE, *argv],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    if device == "cpu":
        assert res.stdout.split()[-4:] == ["rc", "0", "torch", "True"]
    else:
        assert "raised: CUDA is not available" in res.stdout
        assert res.stdout.split()[-2:] == ["torch", "True"]
