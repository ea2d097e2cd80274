"""Guards around the PyTorch port.

- The port and the ``chip_*.py`` scripts import neither JAX nor the
  JAX package (``repro``): a subprocess imports every module of
  ``repro_torch``; an AST scan reads the scripts.
- The copied control-plane modules stay verbatim copies of the JAX
  package's (only their import lines differ), so a change to
  ``repro/core`` that the port misses fails here instead of diverging.
  ``serving/cluster.py`` and ``serving/disagg.py`` are near-copies:
  they differ only in import lines, lines that mention ``device`` and
  the cluster's mesh check, which counts devices each its own way.
- Every config and its ``.reduced()`` form equal the JAX package's.
- Entry points called without ``device=`` run on the GPU or raise;
  they never fall back to the CPU.
"""
import ast
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on one
# machine, and torch's default of one thread per core oversubscribes it.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT, REF = SRC / "repro_torch", SRC / "repro"

COPIED = ([f"core/{n}.py" for n in (
    "__init__", "request", "sampling", "lora", "memory_pool",
    "adapter_cache", "predictor", "prefetcher", "prefix_cache",
    "scheduler", "baselines", "wrs", "kmeans", "quotas")]
    + [f"serving/{n}.py" for n in (
        "handles", "metrics", "trace", "cost_model", "simulator",
        "gateway")]
    + ["models/base.py", "training/data.py", "training/fault_tolerance.py"]
    + sorted(f"configs/{p.name}" for p in (REF / "configs").glob("*.py")))

# Import statements and ``importlib.import_module`` calls.
IMPORT_LINE = re.compile(r"^\s*(from|import)\s|import_module\(")


def _normalised(path: Path, package: str) -> list[str]:
    """Source lines with the package name in import lines replaced."""
    out = []
    for line in path.read_text().splitlines():
        if IMPORT_LINE.search(line):
            line = re.sub(rf"\b{package}\b", "PKG", line)
        out.append(line)
    return out


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_jax_package(rel):
    assert (PORT / rel).is_file(), f"port lacks its copy of {rel}"
    assert _normalised(PORT / rel, "repro_torch") == \
        _normalised(REF / rel, "repro"), (
        f"src/repro_torch/{rel} drifted from src/repro/{rel}: copy the "
        f"change over (only import lines may differ)")


#: ``EngineCluster``'s check of replicas × mesh size against the device
#: count: JAX counts ``jax.devices()``, the port ``launch.mesh``'s
#: positions.
MESH_CHECK = ("        if self.ecfg.mesh_shape is not None:",
              'f"devices, only {have} available")')
#: A ``device=`` argument the port adds to a line of the JAX file.
DEVICE_ARG = re.compile(r",? ?device=(device|None)")


def _without_mesh_check(lines: list[str]) -> list[str]:
    start = lines.index(MESH_CHECK[0])
    end = next(i for i in range(start, len(lines))
               if lines[i].strip() == MESH_CHECK[1])
    return lines[:start] + lines[end + 1:]


@pytest.mark.parametrize("rel", ["serving/cluster.py", "serving/disagg.py"])
def test_near_copy_differs_only_in_imports_and_device(rel):
    import difflib
    ref = _normalised(REF / rel, "repro")
    port = _normalised(PORT / rel, "repro_torch")
    if rel == "serving/cluster.py":
        ref, port = _without_mesh_check(ref), _without_mesh_check(port)
    sm = difflib.SequenceMatcher(a=ref, b=port, autojunk=False)
    bad = []
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "equal":
            continue
        # Port lines: imports, or lines that mention the device. JAX
        # lines: imports, or a port line of the block without its
        # ``device=`` argument.
        bad += [ln for ln in port[j1:j2]
                if not (IMPORT_LINE.search(ln) or "device" in ln)]
        stripped = {DEVICE_ARG.sub("", ln) for ln in port[j1:j2]}
        bad += [ln for ln in ref[i1:i2]
                if not (IMPORT_LINE.search(ln) or ln in stripped)]
    assert not bad, (f"src/repro_torch/{rel} differs from src/repro/{rel} "
                     f"beyond imports and device lines: {bad}")


def test_port_imports_no_jax_and_no_reference_package():
    code = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "repro"
             or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [], f"the port pulled in {res['bad']}"
    for must in ("repro_torch.serving.engine", "repro_torch.kernels.bgmv",
                 "repro_torch.kernels.sgmv",
                 "repro_torch.kernels.paged_attention",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.models.lm", "repro_torch.models.ssm",
                 "repro_torch.models.ssm_lm", "repro_torch.models.hybrid",
                 "repro_torch.models.encdec", "repro_torch.bridge",
                 "repro_torch.serving.cluster", "repro_torch.serving.disagg",
                 "repro_torch.serving.gateway",
                 "repro_torch.serving.simulator",
                 "repro_torch.distributed.elastic",
                 "repro_torch.distributed.sharding",
                 "repro_torch.distributed.act_sharding",
                 "repro_torch.serving.shard_plan",
                 "repro_torch.launch.mesh",
                 "repro_torch.launch.serve", "repro_torch.launch.train",
                 "repro_torch.training", "repro_torch.training.optimizer",
                 "repro_torch.training.train_step",
                 "repro_torch.training.checkpoint",
                 "repro_torch.training.compression",
                 "repro_torch.training.data",
                 "repro_torch.training.fault_tolerance"):
        assert must in res["modules"]


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", [
    "chip_smoke.py", "chip_profile.py", "chip_prefill.py",
    "chip_f32_agreement.py", "chip_mesh.py", "chip_flash_bwd.py",
    "chip_flash_fwd.py", "examples/torch_long_context_ssm.py",
    "examples/torch_train_with_recovery.py", "examples/torch_quickstart.py",
    "examples/torch_serve_manyadapter.py",
    "examples/torch_disagg_cluster.py",
    "examples/torch_gateway_multitenant.py",
    *sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))])
def test_no_jax_or_reference_import_in_source(path):
    names = list(_imported_names(ast.parse((ROOT / path).read_text())))
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_chip_smoke_fails_without_a_gpu(monkeypatch, tmp_path):
    """Without a card the smoke test exits non-zero and prints no
    result line, both in the checkout and copied alone."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run(
            [sys.executable, str(script)], capture_output=True, text=True,
            timeout=120, cwd=script.parent,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def test_chip_flash_fwd_fails_without_a_gpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_flash_fwd.py")],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "err_vs_f64" not in out.stdout


def test_chip_prefill_fails_without_a_gpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_prefill.py")], capture_output=True,
        text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "prefill_ms" not in out.stdout


def test_chip_f32_agreement_fails_without_a_gpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_f32_agreement.py")],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"agreement"' not in out.stdout


def test_chip_mesh_fails_without_a_gpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_mesh.py")], capture_output=True,
        text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"mesh_engine"' not in out.stdout


def test_configs_equal_the_jax_package():
    pytest.importorskip("jax")
    from repro.configs import ARCH_IDS as JIDS
    from repro.configs import get_config as jget
    from repro_torch.configs import ARCH_IDS, get_config
    assert tuple(ARCH_IDS) == tuple(JIDS)
    for name in ARCH_IDS:
        for port, ref in ((get_config(name), jget(name)),
                          (get_config(name).reduced(),
                           jget(name).reduced())):
            p, r = dataclasses.asdict(port), dataclasses.asdict(ref)
            p["family"], r["family"] = port.family.name, ref.family.name
            assert p == r, name


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _entry_points():
    import numpy as np
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import api, lm
    from repro_torch.models.lora_apply import init_lora_slots
    from repro_torch.launch import serve, train
    from repro_torch.serving import cluster, disagg, engine, systems
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      restore_checkpoint)
    cfg = get_config("chameleon-llama-7b").reduced()
    params = lm.init_params(cfg, 0, torch.float32, device="cpu")
    return {
        "init_params": lambda: api.init_params(cfg, 0),
        "make_paged_kv": lambda: lm.make_paged_kv(cfg, 4, 16),
        "make_kv_caches": lambda: lm.make_kv_caches(cfg, 2, 16),
        "init_serve_state": lambda: api.init_serve_state(cfg, 2, 16),
        "init_paged_serve_state": lambda: api.init_paged_serve_state(
            cfg, 4, 16),
        "init_lora_slots": lambda: init_lora_slots(2, 1, 8, 8, 8, 4),
        "AdapterCatalog": lambda: engine.AdapterCatalog(cfg, 2, 8),
        "ChameleonEngine": lambda: engine.ChameleonEngine(
            cfg, params, engine.EngineConfig(n_adapters=2)),
        "ChameleonEngine paged=False": lambda: engine.ChameleonEngine(
            cfg, params, engine.EngineConfig(n_adapters=2, paged=False)),
        "build_engine": lambda: systems.build_engine(
            "chameleon", cfg, params, engine.EngineConfig(n_adapters=2)),
        "build_system": lambda: systems.build_system("chameleon"),
        "build_system cluster": lambda: systems.build_system(
            "chameleon", "cluster"),
        "build_system disagg": lambda: systems.build_system(
            "chameleon", "disagg"),
        "EngineCluster": lambda: cluster.EngineCluster(
            cfg, params, engine.EngineConfig(n_adapters=2)),
        "DisaggCluster": lambda: disagg.DisaggCluster(
            cfg, params, engine.EngineConfig(n_adapters=2)),
        "launch.serve engine": lambda: serve.main(["--backend", "engine"]),
        "init_train_state": lambda: init_train_state(cfg, AdamWConfig()),
        "launch.train": lambda: train.main(["--reduced", "--steps", "1"]),
        "restore_checkpoint": lambda: restore_checkpoint(str(ROOT)),
        "bridge.to_torch": lambda: bridge.to_torch(np.zeros(2)),
        "bridge.params_to_torch": lambda: bridge.params_to_torch(
            {"w": np.zeros(2)}),
        "explicit cuda": lambda: api.init_params(cfg, 0, device="cuda"),
        **{f"init_serve_state {name}": (
            lambda name=name: api.init_serve_state(
                get_config(name).reduced(), 2, 16))
           for name in FAMILY_CONFIGS},
    }


#: The families served by model functions only (SSM, hybrid, enc-dec).
FAMILY_CONFIGS = ("falcon-mamba-7b", "zamba2-1.2b", "whisper-base")
ENTRY_POINTS = ("init_params", "make_paged_kv", "make_kv_caches",
                "init_serve_state", "init_paged_serve_state",
                "init_lora_slots", "AdapterCatalog", "ChameleonEngine",
                "ChameleonEngine paged=False",
                "build_engine", "build_system", "build_system cluster",
                "build_system disagg", "EngineCluster", "DisaggCluster",
                "launch.serve engine", "init_train_state", "launch.train",
                "restore_checkpoint", "bridge.to_torch",
                "bridge.params_to_torch", "explicit cuda",
                *(f"init_serve_state {n}" for n in FAMILY_CONFIGS))


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_without_device_needs_the_gpu(no_cuda, name):
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[name]()


@pytest.mark.parametrize("tier", ["engine", "cluster", "disagg"])
def test_mesh_shape_raises_naming_the_mesh(tier, monkeypatch):
    """A mesh larger than the host raises naming the mesh on every
    real-engine tier — never a smaller mesh or ``mesh_shape=None`` —
    and the sim tier rejects a mesh."""
    from repro_torch.serving import systems
    monkeypatch.delenv("XLA_FLAGS", raising=False)
    with pytest.raises(ValueError, match="mesh"):
        systems.build_system("chameleon", tier, mesh_shape=(2, 1),
                             device="cpu")
    with pytest.raises(ValueError, match="mesh_shape"):
        systems.build_system("chameleon", "sim", mesh_shape=(1, 1))


@pytest.mark.parametrize("devices", ["production", "production-multipod"])
def test_launch_train_production_raises_naming_the_mesh(devices):
    """The production meshes need 256 (512) devices: on fewer the
    launcher raises ``make_mesh``'s device-count error, naming the mesh,
    before it builds anything (as ``jax.make_mesh`` does)."""
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="mesh of shape .* devices"):
        train.main(["--devices", devices, "--device", "cpu"])
