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

    from sda_tpu_torch.cli.main import main as sda_main
    from sda_tpu_torch.crypto.paillier_tpu import MontgomeryContext
    from sda_tpu_torch.models import FixedPointCodec

    def sda_show(**kw):
        device = ["--device", kw["device"]] if "device" in kw else []
        return sda_main(["-i", tempfile.mkdtemp(), *device, "agent", "show"])

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
        "sda": sda_show,
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
        "CryptoModule": lambda **kw: CryptoModule(MemoryKeystore(), **kw),
        "SdaClient": lambda **kw: SdaClient(
            SdaClient.new_agent(keystore), keystore, new_memory_server(), **kw),
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
