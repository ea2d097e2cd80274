"""The port's train step on a device mesh against its unsharded step and
the JAX package, on the CPU.

Meshes are repeated ``cpu`` positions (one process drives every
position, as on the card). Reduced configs in f32, two steps from the
port's seeded params:

- the sharded step (FSDP over the batch axes, q/k/v/gate/up column- and
  o/down row-parallel over "model", vocab-split logits, sharded AdamW)
  equals the unsharded port step within ``tests/_port_training.py``'s
  tolerances at (1, 1), (2, 1), (1, 2), (2, 2) and a ("pod", "data",
  "model") mesh, for internlm2-1.8b, granite-34b (MQA: its one KV head
  split mid-head over "model" in storage) and qwen2.5-32b (q/k/v bias);
  (1, 1) bit for bit. The (1, 1) step equals JAX's jitted step on the
  same (bridged) weights;
- every placed leaf's per-position block equals the JAX rule table's
  ``NamedSharding`` index for that position (the MoE and VLM configs'
  too: their steps are ``tests/test_torch_train_mesh_moe.py``'s);
- ``microbatches=2`` on (2, 1) equals ``microbatches=1``; the forward
  on a mesh equals the unsharded logits;
- a checkpoint saved on (2, 1) is byte-identical to an unsharded save,
  and restores with ``shardings=`` onto (1, 2) and onto one device to
  continue equal to the uninterrupted run (the counterpart of
  ``tests/test_training.py``'s elastic restore);
- ``launch.train.train(mesh=make_host_mesh("cpu"))`` over a forced host
  count of 2 trains the losses of one device;
- the collectives and the row-parallel anchors on their own, and the
  refusals: heads the "model" axis does not divide (no family is
  refused for want of a sharded path), a batch that does not split over
  the batch axes.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on one
# machine, and torch's default of one thread per core oversubscribes it.
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
# JAX reads XLA_FLAGS once, when its backend starts: start it now, so
# the XLA_FLAGS a test sets for the port never reaches JAX.
jax.devices()
from jax._src import op_shardings  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import act_sharding as acts  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.training import (init_opt_state,  # noqa: E402
                                  make_train_step, restore_checkpoint,
                                  save_checkpoint)
from repro_torch.training.optimizer import global_norm  # noqa: E402

from _port_train_mesh import (MESHES, OPT, STEPS,  # noqa: E402
                              assert_runs_close, cpu_mesh, jax_run, place,
                              run, unsharded)
from _port_training import TOL, batch_np, to_tensors  # noqa: E402

fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")

NAMES = ("internlm2-1.8b", "granite-34b", "qwen2.5-32b")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_equals_unsharded(name, mesh):
    cfg = get_config(name).reduced()
    params, ref = unsharded(cfg)
    m = cpu_mesh(mesh)
    fa_mod.STATS.reset()
    got = run(cfg, *place(cfg, params, m))
    assert_runs_close(ref, got)
    if mesh == "1x1":
        assert got[0] == ref[0]
        for a, b in zip(ref[2], got[2]):
            assert all(np.array_equal(a[k], b[k]) for k in a)
    # Each position runs its shard's attention (on the CPU the plain
    # version, differentiated by autograd).
    assert fa_mod.STATS.plain == m.size * cfg.n_layers * STEPS


def test_unit_mesh_step_matches_jax():
    """(1, 1) against JAX's jitted step from JAX's weights."""
    name = "internlm2-1.8b"
    params, ref = jax_run(name)
    cfg = get_config(name).reduced()
    assert_runs_close(ref, run(cfg, *place(cfg, params, cpu_mesh("1x1"))))


@pytest.mark.parametrize("mesh", ["2x2", "pod2x1x2"])
@pytest.mark.parametrize("name", ["internlm2-1.8b", "granite-34b",
                                  "qwen3-moe-235b-a22b",
                                  "llama4-maverick-400b-a17b", "qwen2-vl-7b"])
def test_placed_blocks_are_the_jax_rule_tables(name, mesh):
    """Each position's block of every param and moment is the JAX
    ``NamedSharding``'s index for that position (over the mesh's
    positions in order), the MoE stacks' ``moe/*`` (experts over
    "data", their hidden over "model", D over "pod"), ``shared_*`` and
    ``dense_mlp/*`` leaves included."""
    cfg, jcfg = get_config(name).reduced(), jget_config(name).reduced()
    shape, axes = MESHES[mesh]
    n = int(np.prod(shape))
    jm = JMesh(np.asarray(jax.devices()[:1] * n).reshape(shape), axes)
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    jp = jsh.param_shardings(jcfg, shapes, jm, "train")
    p, opt = place(cfg, params, cpu_mesh(mesh))
    jo = jsh.opt_shardings(jp, jm)
    for tree, jtree, full in ((p, jp, params), (opt, jo, None)):
        for k, st in tree.items():
            ref = full[k] if full is not None else torch.zeros(
                st.shape, dtype=st.dtype)
            hlo = jtree[k]._to_xla_hlo_sharding(len(st.shape))
            idx = op_shardings.op_sharding_to_indices(hlo, st.shape, n)
            for pos, i in enumerate(idx):
                assert torch.equal(st.shards.flat[pos], ref[i]), (k, pos)


@pytest.mark.parametrize("name", ["internlm2-1.8b", "qwen2-vl-7b"])
def test_microbatches_on_a_data_split_equal_one(name):
    """Two microbatches on (2, 1) equal one (qwen2-vl: its M-RoPE
    positions split on their dimension 1)."""
    cfg = get_config(name).reduced()
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    m = cpu_mesh("2x1")
    ref = run(cfg, *place(cfg, params, m))
    assert_runs_close(ref, run(cfg, *place(cfg, params, m), microbatches=2))


def test_forward_on_a_mesh_equals_unsharded():
    cfg = get_config("qwen2.5-32b").reduced()
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    tokens = to_tensors(batch_np(cfg, 0), "cpu")["tokens"]
    want = api.forward(cfg, params, tokens)
    got = api.forward(cfg, place(cfg, params, cpu_mesh("2x2"))[0], tokens)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_elastic_restore(tmp_path):
    """Save on (2, 1) after one step; restore onto (1, 2) and onto one
    device and take the second step: each equals two steps on (2, 1),
    and the files equal an unsharded save of the same values byte for
    byte."""
    cfg = get_config("internlm2-1.8b").reduced()
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    p, o = place(cfg, params, cpu_mesh("2x1"))
    run(cfg, p, o, steps=1)
    save_checkpoint(str(tmp_path / "mesh"), 1, {"params": p, "opt": o})
    save_checkpoint(str(tmp_path / "flat"), 1,
                    {"params": {k: v.cpu() for k, v in p.items()},
                     "opt": {k: v.cpu() for k, v in o.items()}})
    for f in sorted((tmp_path / "flat" / "step_00000001").iterdir()):
        assert (tmp_path / "mesh" / "step_00000001" / f.name
                ).read_bytes() == f.read_bytes(), f.name
    ref = run(cfg, p, o, steps=1, first=1)

    m = cpu_mesh("1x2")
    p_sh = tsh.param_shardings(cfg, params, m, "train")
    step, trees = restore_checkpoint(
        str(tmp_path / "mesh"),
        shardings={"params": p_sh, "opt": tsh.opt_shardings(p_sh, m)})
    assert step == 1
    for k, st in trees["params"].items():
        assert isinstance(st, tsh.ShardedTensor) and st.mesh is m
        assert tuple(st.sharding.spec) == tuple(p_sh[k].spec)
    assert_runs_close(ref, run(cfg, trees["params"], trees["opt"], steps=1,
                               first=1))
    _, flat = restore_checkpoint(str(tmp_path / "mesh"), device="cpu")
    assert all(isinstance(v, torch.Tensor) for v in flat["params"].values())
    assert_runs_close(ref, run(cfg, flat["params"], flat["opt"], steps=1,
                               first=1))


def test_launcher_trains_over_the_host_mesh(monkeypatch):
    from repro_torch.launch.train import train
    cfg = get_config("internlm2-1.8b").reduced()
    kw = dict(steps=3, batch=4, seq=16, device="cpu", log=lambda s: None)
    ref = train(cfg, **kw)
    monkeypatch.setenv("XLA_FLAGS",
                       "--xla_force_host_platform_device_count=2")
    mesh = make_host_mesh("cpu")
    assert dict(mesh.shape) == {"data": 2, "model": 1}
    got = train(cfg, mesh=mesh, **kw)
    assert all(isinstance(v, tsh.ShardedTensor) and v.mesh is mesh
               for v in got["params"].values())
    for a, b in zip(ref["history"], got["history"]):
        for k in ("loss", "grad_norm"):
            assert abs(b[k] - a[k]) <= TOL * max(abs(a[k]), 1.0), (k, a, b)


def test_collectives_gather_and_reduce_scatter_in_position_order():
    """``all_gather`` assembles any block from the shards that hold it
    (a view when one shard holds it); ``reduce_scatter`` adds each
    position's gradient into the blocks it covers, every copy alike."""
    m = cpu_mesh("2x2")
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    st = tsh.NamedSharding(m, tsh.P(None, "data", "model")).shard(x)
    assert torch.equal(tsh.all_gather(st, (1, slice(None), slice(2, 6)),
                                      torch.device("cpu")), x[1, :, 2:6])
    own = tsh.all_gather(st, (2, slice(0, 3), slice(0, 4)),
                         torch.device("cpu"))
    assert own.data_ptr() == st.local((0, 0))[2].data_ptr()
    rep = tsh.NamedSharding(m, tsh.P()).zeros((4, 6, 8), torch.float32)
    out = tsh.NamedSharding(m, tsh.P(None, "data")).zeros((4, 6, 8),
                                                          torch.float32)
    parts = [((1, slice(None), slice(0, 4)), torch.ones(6, 4)),
             ((1, slice(None), slice(2, 8)), torch.full((6, 6), 2.0))]
    want = torch.zeros(4, 6, 8)
    want[1, :, 0:4] += 1
    want[1, :, 2:8] += 2
    for o in (rep, out):
        tsh.reduce_scatter(o, parts)
        assert torch.equal(o.cpu(), want)
        assert all(torch.equal(t, want[s]) for s, t in o.unique())
    g = {"w": out, "r": rep}
    # A replicated leaf counts once, not once a position.
    assert torch.equal(global_norm(g), global_norm(
        {"w": want, "r": want.clone()}))


def test_row_parallel_anchors_split_rows_and_sum_columns():
    m = cpu_mesh("2x2")
    x = torch.randn(4, 3, 8)
    with acts.activation_sharding(("data",), mesh=m):
        for f in (acts.constrain_btd, acts.constrain_bd,
                  acts.constrain_boundary):
            rows = f(x)
            assert [[t.shape for t in r] for r in rows] == [[(2, 3, 8)] * 2] * 2
            assert torch.equal(torch.cat([r[0] for r in rows]), x)
            assert f(rows) is rows
        parts = [torch.randn(2, 3, 8, requires_grad=True) for _ in range(2)]
        sums = acts.psum_columns(parts)
        assert all(torch.equal(s, parts[0] + parts[1]) for s in sums)
        (sums[0] * 2 + sums[1] * 3).sum().backward()
        assert all(torch.equal(p.grad, torch.full((2, 3, 8), 5.0))
                   for p in parts)
        for f in (acts.constrain_attn_merged, acts.constrain_ffn_hidden,
                  acts.constrain_residual, acts.constrain_logits):
            assert f(parts) is parts             # split over the columns
        with pytest.raises(ValueError, match="3 rows"):
            acts.batch_shards(torch.zeros(3, 2))


def test_other_families_refuse_a_split_mesh():
    """No family is refused for want of a sharded path any more: every
    published config's reduced form trains on (2, 1) and (1, 2) with
    nothing refused, the SSM, hybrid and enc-dec families included (their
    steps are ``tests/test_torch_train_mesh_families.py``'s), and on one
    position the mesh step equals the unsharded one; heads the "model"
    axis does not divide are still refused, naming the dimension."""
    from repro_torch.configs import ARCH_IDS
    for name in ARCH_IDS:
        cfg = get_config(name).reduced()
        for mesh in ("2x1", "1x2"):
            assert tsh.train_unsupported(cfg, cpu_mesh(mesh)) == [], name
    for name in ("falcon-mamba-7b", "zamba2-1.2b", "whisper-base"):
        cfg = get_config(name).reduced()
        params = api.init_params(cfg, 0, torch.float32, device="cpu")
        step = make_train_step(cfg, OPT)
        b = to_tensors(batch_np(cfg, 0), "cpu")
        p, o = place(cfg, params, cpu_mesh("1x1"))
        got = step(p, o, b)[2]
        want = step(params, init_opt_state(params, OPT), b)[2]
        assert float(got["loss"]) == float(want["loss"])
        assert torch.equal(p["final_norm"].cpu(), params["final_norm"])
    grid = np.empty(8, dtype=object)
    grid[:] = [torch.device("cpu")] * 8
    m8 = tsh.Mesh(grid.reshape(1, 8), ("data", "model"))
    cfg = get_config("whisper-base").reduced()
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    p, o = place(cfg, params, m8)
    with pytest.raises(NotImplementedError,
                       match="n_heads=4 on a 8-way model axis"):
        make_train_step(cfg, OPT)(p, o, to_tensors(batch_np(cfg, 0), "cpu"))


def test_a_batch_must_split_over_the_batch_axes():
    cfg = get_config("internlm2-1.8b").reduced()
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    p, o = place(cfg, params, cpu_mesh("2x2"))
    b = to_tensors(batch_np(cfg, 0, B=3), "cpu")
    with pytest.raises(ValueError, match="3 rows does not split over the 2"):
        make_train_step(cfg, OPT)(p, o, b)
