"""The port's checkpoints against the JAX package's, on the CPU.

Both packages write ``step_<N>/manifest.json`` and one md5-named
``.npy`` per leaf (format_version 1). For the same values in bf16, f32
and int32 the port writes byte-identical files (bf16 as raw 2-byte
records under the ``'<V2'`` descr JAX's ``np.save`` gives them, the
manifest saying ``"bfloat16"``), and reads JAX's checkpoints back bit
for bit. JAX's ``restore_checkpoint`` reads the port's f32 and int32
leaves; for bf16 it raises on the port's files exactly as on its own
(``jnp.asarray`` refuses the ``|V2`` records ``np.load`` returns), so
the bf16 leaf is read there as a JAX user must, ``np.load`` viewed as
``ml_dtypes.bfloat16``. Then the port's own contracts: ``latest_step``,
``prune_checkpoints``, the elastic ``shardings=`` that is not ported,
and ``AsyncCheckpointer.save`` copying every leaf before it returns,
so an in-place update right after it cannot reach the checkpoint.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.training import checkpoint as jck  # noqa: E402
from repro_torch.training import checkpoint as tck  # noqa: E402


def trees_np(seed=0):
    """{tree: {path: (numpy values, dtype name)}}: bf16 (as f32 values
    that bf16 holds exactly), f32 and int32 leaves, and the int32 step
    scalar of an optimizer state."""
    rng = np.random.default_rng(seed)
    bf = rng.standard_normal((3, 5)).astype(np.float32)
    bf = np.asarray(jnp.asarray(bf, jnp.bfloat16).astype(jnp.float32))
    return {"params": {"layers/w": (bf, "bfloat16"),
                       "embed/tok": (rng.standard_normal((4, 2)).astype(
                           np.float32), "float32"),
                       "layers/idx": (np.arange(6, dtype=np.int32)
                                      .reshape(2, 3), "int32")},
            "opt": {"step": (np.asarray(7, np.int32), "int32"),
                    "m/layers/w": (bf * 0.5, "bfloat16")}}


def as_jax(trees):
    return {t: {k: jnp.asarray(v, jnp.bfloat16 if dt == "bfloat16"
                                else v.dtype)
                for k, (v, dt) in tree.items()} for t, tree in trees.items()}


def as_torch(trees):
    return {t: {k: torch.from_numpy(v.copy()).to(
        torch.bfloat16 if dt == "bfloat16" else torch.from_numpy(v).dtype)
        for k, (v, dt) in tree.items()} for t, tree in trees.items()}


def bits(t):
    """A leaf's raw bits, whichever package holds it."""
    if isinstance(t, torch.Tensor):
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return t.numpy().tobytes()
    return np.asarray(t).tobytes()


def test_port_writes_the_jax_files(tmp_path):
    trees = trees_np()
    jck.save_checkpoint(str(tmp_path / "jax"), 3, as_jax(trees),
                        extra={"mesh": [1, 1]})
    tck.save_checkpoint(str(tmp_path / "port"), 3, as_torch(trees),
                        extra={"mesh": [1, 1]})
    a, b = tmp_path / "jax" / "step_00000003", tmp_path / "port" / \
        "step_00000003"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        if name == "manifest.json":
            assert json.loads((a / name).read_text()) == \
                json.loads((b / name).read_text())
        else:
            assert (a / name).read_bytes() == (b / name).read_bytes(), name
    manifest = json.loads((b / "manifest.json").read_text())
    assert manifest["format_version"] == 1
    assert manifest["index"]["params/layers/w"]["dtype"] == "bfloat16"


def test_port_restores_jax_checkpoints_bit_exact(tmp_path):
    trees = trees_np(1)
    jt = as_jax(trees)
    jck.save_checkpoint(str(tmp_path), 5, jt)
    step, out = tck.restore_checkpoint(str(tmp_path), device="cpu")
    assert step == 5
    for t, tree in jt.items():
        for k, v in tree.items():
            got = out[t][k]
            assert got.dtype == {"bfloat16": torch.bfloat16,
                                 "float32": torch.float32,
                                 "int32": torch.int32}[str(v.dtype)]
            assert tuple(got.shape) == v.shape and bits(got) == bits(v), k


def test_jax_restores_port_checkpoints(tmp_path):
    import ml_dtypes
    trees = trees_np(2)
    tt = as_torch(trees)
    tck.save_checkpoint(str(tmp_path / "port"), 9, tt)
    jck.save_checkpoint(str(tmp_path / "jax"), 9, as_jax(trees))
    # The JAX restore refuses bf16 leaves, its own and the port's alike.
    for d in ("port", "jax"):
        with pytest.raises(TypeError, match="V2"):
            jck.restore_checkpoint(str(tmp_path / d))
    no_bf16 = {"params": {k: v for k, v in tt["params"].items()
                          if v.dtype != torch.bfloat16},
               "opt": {"step": tt["opt"]["step"]}}
    tck.save_checkpoint(str(tmp_path / "plain"), 9, no_bf16)
    step, out = jck.restore_checkpoint(str(tmp_path / "plain"))
    assert step == 9
    for t, tree in no_bf16.items():
        for k, v in tree.items():
            assert bits(out[t][k]) == bits(v) and \
                str(out[t][k].dtype) == str(v.dtype).removeprefix("torch.")
    src = tmp_path / "port" / "step_00000009"
    index = json.loads((src / "manifest.json").read_text())["index"]
    for key in ("params/layers/w", "opt/m/layers/w"):
        arr = np.load(src / index[key]["file"]).view(ml_dtypes.bfloat16)
        t, k = key.split("/", 1)
        assert arr.tobytes() == bits(tt[t][k])


def test_latest_step_and_prune(tmp_path):
    for s in (1, 2, 3, 4):
        tck.save_checkpoint(str(tmp_path), s,
                            {"params": {"w": torch.zeros(2)}})
    (tmp_path / "step_00000009.tmp").mkdir()      # unpublished: ignored
    assert tck.latest_step(str(tmp_path)) == 4
    assert tck.latest_step(str(tmp_path / "none")) is None
    tck.prune_checkpoints(str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000003", "step_00000004", "step_00000009.tmp"]
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(str(tmp_path / "none"), device="cpu")


def test_restore_onto_a_mesh_raises_naming_the_mesh(tmp_path):
    """Elastic restore places a leaf onto its sharding's mesh
    (``tests/test_torch_train_mesh.py``); a leaf the mesh cannot split
    evenly raises naming the mesh."""
    import numpy as np

    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.launch.mesh import Mesh
    tck.save_checkpoint(str(tmp_path), 1, {"params": {"w": torch.ones(3)}})
    grid = np.empty(2, dtype=object)
    grid[:] = [torch.device("cpu")] * 2
    mesh = Mesh(grid, ("data",))
    with pytest.raises(ValueError, match="Mesh"):
        tck.restore_checkpoint(
            str(tmp_path),
            shardings={"params": {"w": NamedSharding(mesh, P("data"))}})


def test_async_save_snapshots_before_an_in_place_update(tmp_path):
    """The port updates params in place; the checkpoint holds the values
    at ``save()``, whatever the step after it writes. A real train step
    (in-place AdamW) runs while the worker thread writes."""
    from repro_torch.configs import get_config
    from repro_torch.training import (AdamWConfig, DataConfig, SyntheticLM,
                                      init_train_state, make_train_step)
    cfg = get_config("internlm2-1.8b").reduced(n_layers=2, d_model=64,
                                               vocab_size=256, d_ff=128)
    ocfg = AdamWConfig(lr=1e-2, warmup_steps=0)
    params, opt = init_train_state(cfg, ocfg, 0, torch.float32,
                                   device="cpu")
    before = {k: v.clone() for k, v in params.items()}
    ck = tck.AsyncCheckpointer(str(tmp_path), keep=1)
    ck.save(1, {"params": params, "opt": opt})
    data = SyntheticLM(DataConfig(vocab_size=256, seq_len=16,
                                  global_batch=2))
    b = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
    make_train_step(cfg, ocfg)(params, opt, b)
    for v in params.values():          # and one more in-place write
        v.add_(1.0)
    ck.wait()
    _, out = tck.restore_checkpoint(str(tmp_path), device="cpu")
    assert int(out["opt"]["step"]) == 0
    for k, v in before.items():
        assert torch.equal(out["params"][k], v), k
        assert not torch.equal(params[k], v)


def test_async_save_reports_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    ck = tck.AsyncCheckpointer(str(blocker / "sub"))
    ck.save(1, {"params": {"w": torch.ones(2)}})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                           # reported once
