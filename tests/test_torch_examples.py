"""The port's serving examples against the JAX examples, on the CPU.

- The DES examples (``torch_gateway_multitenant.py`` and
  ``torch_serve_manyadapter.py`` at its default ``--rps 12``) print what
  the JAX examples print, line for line: the DES modules are verbatim
  copies (``tests/test_torch_guards.py``), so the equality is exact.
- Without ``--device`` every example runs on the card, and raises
  where there is none: it never falls back to the CPU.
- ``counted_launches``, the examples' card contract, raises unless the
  kernels of the path launched with no plain version and no einsum LoRA.

The engine examples' own runs on the CPU, and quickstart's tokens
against the JAX engine's, are in ``tests/test_torch_examples_engine.py``.
"""
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from _port_examples import EXAMPLES, load

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on one
# machine, and torch's default of one thread per core oversubscribes it.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def run_script(script: str, *args: str) -> str:
    """The script's stdout, run from the repo root in a fresh process
    (request ids count from 0 there), on the CPU."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, str(EXAMPLES / script), *args],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("jax_script,port_script,args", [
    ("gateway_multitenant.py", "torch_gateway_multitenant.py", ()),
    ("serve_manyadapter.py", "torch_serve_manyadapter.py", ()),
])
def test_des_example_prints_what_the_jax_example_prints(jax_script,
                                                        port_script, args):
    want = run_script(jax_script, *args)
    got = run_script(port_script, *args, "--device", "cpu")
    assert got.splitlines() == want.splitlines()
    assert len(want.splitlines()) >= 5


@pytest.mark.parametrize("script,args", [
    ("torch_quickstart.py", []),
    ("torch_serve_manyadapter.py", []),
    ("torch_serve_manyadapter.py", ["--engine"]),
    ("torch_serve_manyadapter.py", ["--cluster"]),
    ("torch_disagg_cluster.py", []),
    ("torch_gateway_multitenant.py", []),
])
def test_example_defaults_to_the_card(monkeypatch, script, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = load(script)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(args)


def _launch(**kernels):
    for name, n in kernels.items():
        st = importlib.import_module(f"repro_torch.kernels.{name}").STATS
        for _ in range(n):
            st.launched("cuda_cores")


@pytest.fixture
def zeroed_counts():
    """Leave the kernels' and the einsum LoRA's counts at zero."""
    from repro_torch.models.lora_apply import EINSUM
    from repro_torch.serving.example_support import KERNELS
    yield
    for name in KERNELS:
        importlib.import_module(f"repro_torch.kernels.{name}").STATS.reset()
    EINSUM.reset()


@pytest.mark.parametrize("case", ["all_launched", "one_missing", "plain",
                                  "einsum", "cpu"])
def test_counted_launches_contract(zeroed_counts, case):
    from repro_torch.models.lora_apply import EINSUM
    from repro_torch.serving.example_support import counted_launches
    dev = torch.device("cpu" if case == "cpu" else "cuda")

    def body(counts):
        if case == "cpu":
            return
        _launch(bgmv=3, sgmv=2,
                paged_attention=0 if case == "one_missing" else 4)
        if case == "plain":
            importlib.import_module("repro_torch.kernels.bgmv").STATS \
                .plain += 1
        if case == "einsum":
            EINSUM.calls += 1

    if case in ("all_launched", "cpu"):
        with counted_launches(dev) as counts:
            body(counts)
        if case == "cpu":
            assert counts == {}
        else:
            assert counts == dict(launches=dict(bgmv=3, sgmv=2,
                                                paged_attention=4,
                                                flash_attention=0),
                                  plain=0, einsum=0)
        return
    with pytest.raises(RuntimeError, match="did not go through"):
        with counted_launches(dev):
            body(None)


def test_example_model_follows_the_device():
    from repro_torch.serving.example_support import example_model
    assert example_model(torch.device("cpu")) == (None, None)
    cfg, params = object(), {"w": np.zeros(1)}
    assert example_model(torch.device("cuda"), cfg, params) == (cfg, params)
    with pytest.raises(ValueError):
        example_model(torch.device("cpu"), cfg, None)
