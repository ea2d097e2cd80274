"""The port's SSM, hybrid and enc-dec train steps on a device mesh
against the unsharded port step and the JAX package, on the CPU.

Meshes are repeated ``cpu`` positions (one process drives every
position). Reduced configs in f32, two steps from the port's seeded
params, held with ``tests/_port_training.py``'s tolerances:

- the sharded step equals the unsharded port step at (1, 1) (bit for
  bit), (2, 1), (1, 2), (2, 2) and a ("pod", "data", "model") mesh, for
  falcon-mamba (Mamba1: channels over "model", x_proj and out_proj
  row-parallel), zamba2 (Mamba2 heads over "model" with B and C whole,
  the split gate norm, the shared attention block at two sites) and
  whisper (encoder full and decoder causal attention per shard, cross
  attention split by heads from replicated leaves); the (1, 1) step
  equals JAX's jitted step on bridged weights;
- each placed leaf's per-position block is the JAX rule table's, and a
  Mamba2 column's view of the packed ``in_proj`` and conv is its z, x
  and dt blocks with B and C whole, though storage splits the packed
  dimension evenly;
- the mixers over columns against the whole mixers, the split gate norm
  against ``rms_norm``, the SSM anchors;
- zamba2's shared-block gradient over two sites equal to the unsharded
  one, reduced once a leaf, after the first site's backward;
- whisper at (1, 2) with its published vocabulary of 51865, which
  "model" does not divide, so the embedding and head stay whole;
- ``microbatches=2``, an elastic restore from (2, 1) onto (1, 2), the
  forward on a mesh, and ``launch.train.train`` for falcon-mamba over a
  forced host count of 2.
"""
import functools
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
from repro_torch.launch.mesh import Mesh, make_host_mesh  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.hybrid import attn_sites  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.models.ssm_lm import _SSM_LEAVES  # noqa: E402
from repro_torch.training import (make_train_step,  # noqa: E402
                                  restore_checkpoint, save_checkpoint)

from _port_train_mesh import (MESHES, OPT, STEPS,  # noqa: E402
                              assert_runs_close, cpu_mesh, jax_run, place,
                              run, unsharded)
from _port_training import (TOL, attention_layers, batch_np,  # noqa: E402
                            to_tensors)

fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")

FALCON, ZAMBA, WHISPER = "falcon-mamba-7b", "zamba2-1.2b", "whisper-base"
NAMES = (FALCON, ZAMBA, WHISPER)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """Reduced ``name``, its seeded f32 params and the unsharded run."""
    cfg = get_config(name).reduced()
    return (cfg,) + unsharded(cfg)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", NAMES)
def test_sharded_step_equals_unsharded(name, mesh):
    cfg, params, ref = _reference(name)
    m = cpu_mesh(mesh)
    fa_mod.STATS.reset()
    got = run(cfg, *place(cfg, params, m))
    assert_runs_close(ref, got)
    if mesh == "1x1":
        assert got[0] == ref[0]
        for a, b in zip(ref[2], got[2]):
            assert all(np.array_equal(a[k], b[k]) for k in a)
    # Each position runs its shard's attention layers (on the CPU the
    # plain version, differentiated by autograd); falcon-mamba has none.
    assert fa_mod.STATS.plain == m.size * attention_layers(cfg) * STEPS


@pytest.mark.parametrize("name", NAMES)
def test_unit_mesh_step_matches_jax(name):
    """(1, 1) against JAX's jitted step from JAX's weights."""
    params, ref = jax_run(name)
    cfg = get_config(name).reduced()
    assert_runs_close(ref, run(cfg, *place(cfg, params, cpu_mesh("1x1"))))


@pytest.mark.parametrize("mesh", ["2x2", "pod2x1x2"])
@pytest.mark.parametrize("name", NAMES)
def test_placed_blocks_are_the_jax_rule_tables(name, mesh):
    """Each position's block of every param is the JAX ``NamedSharding``'s
    index for that position: the SSM leaves over "model" (the packed
    ``in_proj`` and conv split evenly, across their segments), the
    cross-attention leaves replicated."""
    cfg, jcfg = get_config(name).reduced(), jget_config(name).reduced()
    shape, axes = MESHES[mesh]
    n = int(np.prod(shape))
    jm = JMesh(np.asarray(jax.devices()[:1] * n).reshape(shape), axes)
    params = _reference(name)[1]
    jp = jsh.param_shardings(
        jcfg, {k: tuple(v.shape) for k, v in params.items()}, jm, "train")
    p, _ = place(cfg, params, cpu_mesh(mesh))
    for k, st in p.items():
        hlo = jp[k]._to_xla_hlo_sharding(len(st.shape))
        idx = op_shardings.op_sharding_to_indices(hlo, st.shape, n)
        for pos, i in enumerate(idx):
            assert torch.equal(st.shards.flat[pos], params[k][i]), (k, pos)
    if cfg.family.name == "ENCDEC":
        assert all(p[k].sharding.spec == tsh.P() for k in p
                   if k.startswith("dec/x"))


@pytest.mark.parametrize("mesh", ["1x1", "1x2", "2x2"])
@pytest.mark.parametrize("name", [FALCON, ZAMBA])
def test_column_views_of_the_packed_ssm_leaves(name, mesh):
    """Column m computes with its own blocks of each segment: Mamba1's
    in_proj [x | z], Mamba2's in_proj [z | x | B | C | dt] (B and C
    whole) and conv [x | B | C], though the rule table splits the packed
    dimension evenly (a column's stored block straddles segments). One
    column views each leaf whole, in one gather."""
    cfg, params = _reference(name)[:2]
    p, _ = place(cfg, params, cpu_mesh(mesh))
    tv = tsh.TrainView(cfg, p)
    M, Di, N, H = tv.M, cfg.d_inner, cfg.d_state, cfg.n_ssm_heads
    di = Di // M
    for m in range(M):
        for b in range(tv.n_batch):
            w = tv.view("layers/in_proj", b, m, 1)
            whole = params["layers/in_proj"][1]
            assert len(tv.boxes("layers/in_proj", m, 1)) == (
                1 if M == 1 else 2 if cfg.ssm_version == 1 else 3)
            if cfg.ssm_version == 1:
                want = [whole[:, m * di:(m + 1) * di],
                        whole[:, Di + m * di:Di + (m + 1) * di]]
                assert torch.equal(w, torch.cat(want, -1))
                continue
            h = H // M
            z, x, B, C, dt = ssm._mamba2_split(w, di, N, h)
            assert torch.equal(z, whole[:, m * di:(m + 1) * di])
            assert torch.equal(x, whole[:, Di + m * di:Di + (m + 1) * di])
            assert torch.equal(B, whole[:, 2 * Di:2 * Di + N])
            assert torch.equal(C, whole[:, 2 * Di + N:2 * Di + 2 * N])
            assert torch.equal(dt, whole[:, 2 * Di + 2 * N + m * h:
                                         2 * Di + 2 * N + (m + 1) * h])
            for leaf in ("conv_w", "conv_b"):
                c = tv.view("layers/" + leaf, b, m, 1)
                cw = params["layers/" + leaf][1]
                assert torch.equal(c, torch.cat(
                    [cw[..., m * di:(m + 1) * di], cw[..., Di:]], -1))
    if M > 1 and cfg.ssm_version == 2:
        # Storage's block of column 0 is not its segments.
        stored = p["layers/in_proj"].local((0, 0))
        assert stored.shape[-1] == (2 * Di + 2 * N + H) // M
        assert not torch.equal(stored[1], tv.view("layers/in_proj", 0, 0,
                                                  1))


@pytest.mark.parametrize("name", [FALCON, ZAMBA])
def test_mixer_columns_equal_the_whole_mixer(name):
    """``mamba1_seq_columns``/``mamba2_seq_columns`` over two columns'
    views, their partial products summed, against the whole mixer."""
    cfg, params = _reference(name)[:2]
    p, _ = place(cfg, params, cpu_mesh("1x2"))
    tv = tsh.TrainView(cfg, p)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    whole = {k[len("layers/"):]: v[0] for k, v in params.items()
             if k.startswith("layers/")}
    cols = [tv.layer(0, 0, m, _SSM_LEAVES) for m in range(2)]
    if cfg.ssm_version == 1:
        want = ssm.mamba1_seq(x, whole, cfg.d_state, cfg.dt_rank, 16)[0]
        parts = ssm.mamba1_seq_columns([x, x], cols, cfg.d_state,
                                       cfg.dt_rank, 16)
    else:
        want = ssm.mamba2_seq(x, whole, cfg.d_state, cfg.ssm_head_dim,
                              16)[0]
        parts = ssm.mamba2_seq_columns([x, x], cols, cfg.d_state,
                                       cfg.ssm_head_dim, 16)
    torch.testing.assert_close(parts[0] + parts[1], want, rtol=1e-5,
                               atol=1e-5)


def test_split_gate_norm_equals_the_whole_norm():
    """The gate norm over columns sums their sums of squares first: the
    values and the gradients of ``rms_norm`` over all of d_inner (each
    column's own RMS would differ); one column is ``rms_norm``."""
    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.standard_normal((2, 7, 64)).astype(np.float32))
    y[..., 32:] *= 3.0
    w = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((2, 7, 64)).astype(np.float32))

    def grads(fn):
        yy = y.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        out = fn(yy, ww)
        (gy, gw) = torch.autograd.grad((out * r).sum(), (yy, ww))
        return out.detach(), gy, gw

    want = grads(rms_norm)
    got = grads(lambda a, b: torch.cat(ssm.gate_norm_columns(
        list(a.chunk(2, -1)), list(b.chunk(2, -1)), 64), -1))
    for g, v in zip(got, want):
        torch.testing.assert_close(g, v, rtol=1e-5, atol=1e-6)
    own = torch.cat([rms_norm(a, b) for a, b in zip(y.chunk(2, -1),
                                                    w.chunk(2, -1))], -1)
    assert (own - want[0]).abs().max() > 0.1
    one = ssm.gate_norm_columns([y], [w], 64)[0]
    assert torch.equal(one, rms_norm(y, w))


def test_grad_norm_does_not_depend_on_the_gradient_layout():
    """whisper's cross K/V weight gradients come out of autograd
    transposed (``dec/xk``, ``dec/xv``); the grad norm sums every
    gradient in row-major order, so the unsharded step's norm equals the
    placed step's, whose gradients are contiguous blocks, bit for bit."""
    from repro_torch.training.optimizer import global_norm
    cfg, params = _reference(WHISPER)[:2]
    b = to_tensors(batch_np(cfg, 0), "cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = api.train_loss(cfg, leaves, b["tokens"], b["labels"],
                          frames=b["frames"])
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    assert not grads["dec/xk"].is_contiguous()
    for seed in range(8):
        for shape, perm in (((6, 128, 256), (0, 2, 1)),
                            ((1000, 37), (1, 0))):
            g = torch.randn(*shape,
                            generator=torch.Generator().manual_seed(seed))
            t = g.permute(*perm).contiguous().permute(*perm)
            assert torch.equal(global_norm({"g": t}), global_norm({"g": g}))


def test_ssm_anchors_split_channels_and_heads():
    m = cpu_mesh("1x2")
    x = torch.randn(2, 5, 8, 3)
    assert acts.constrain_ssm_channels(x) is x          # no mesh
    with acts.activation_sharding(("data",), mesh=m):
        for f, t, dim in ((acts.constrain_ssm_channels, x[..., 0], -1),
                          (acts.constrain_ssm_bthp, x, 2),
                          (acts.constrain_ssm_bth, x[..., 0], 2)):
            cols = f(t)
            assert len(cols) == 2
            assert torch.equal(torch.cat(cols, dim), t)
            assert f(cols) is cols                  # already per column


def test_shared_block_gradient_over_two_sites(monkeypatch):
    """zamba2's shared attention and MLP run at two sites; on (2, 2) each
    ``shared/*`` leaf's gradient is the unsharded one, and it is reduced
    once, after every site's gathers delivered theirs (the first site's,
    gathered first, arrive last)."""
    cfg, params = _reference(ZAMBA)[:2]
    assert len(attn_sites(cfg)) == 2
    b = to_tensors(batch_np(cfg, 0), "cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = api.train_loss(cfg, leaves, b["tokens"], b["labels"])
    want = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    p, _ = place(cfg, params, cpu_mesh("2x2"))
    grads = {k: st.sharding.zeros(st.shape, torch.float32)
             for k, st in p.items()}
    fs = tsh.FsdpStep(p, grads)
    reduced = []
    orig = tsh.FsdpStep._reduce

    def record(self, key):
        got = self._got[key]
        reduced.append((key, [s for s, _, _ in got], got[-1][0]))
        orig(self, key)

    monkeypatch.setattr(tsh.FsdpStep, "_reduce", record)
    with torch.enable_grad():
        with fs.recording():
            loss_m = api.train_loss(cfg, p, b["tokens"], b["labels"])
        torch.autograd.grad(loss_m, [fs.anchor])
    fs.finish()
    assert abs(float(loss_m.detach()) - float(loss.detach())) <= TOL * float(
        loss.detach())
    shared = [r for r in reduced if r[0][0].startswith("shared/")]
    assert sorted(r[0][0] for r in shared) == sorted(
        k for k in p if k.startswith("shared/"))
    for (path, _), seqs, last in shared:
        assert len(seqs) == 2 * 4                # two sites, 4 positions
        assert last in sorted(seqs)[:4]          # the first site's, last
    for k in p:
        if k.startswith("shared/"):
            torch.testing.assert_close(grads[k].cpu(), want[k], rtol=1e-4,
                                       atol=1e-6)


def test_whisper_with_its_published_vocabulary():
    """V = 51865 on (1, 2): the rule table leaves ``embed/tok`` and
    ``lm_head`` unsplit, so each column looks up whole rows and the
    first column takes the logits; the step equals the unsharded one."""
    cfg = get_config(WHISPER).reduced(vocab_size=51865)
    params, ref = unsharded(cfg)
    m = cpu_mesh("1x2")
    with pytest.warns(UserWarning, match="drops non-dividing"):
        p, o = place(cfg, params, m)
    assert "model" not in str(p["embed/tok"].sharding.spec)
    assert "model" not in str(p["lm_head"].sharding.spec)
    assert tsh.TrainView(cfg, p).whole_vocab
    assert_runs_close(ref, run(cfg, p, o))


def test_microbatches_on_a_data_split_equal_one():
    cfg, params = _reference(ZAMBA)[:2]
    m = cpu_mesh("2x1")
    ref = run(cfg, *place(cfg, params, m))
    assert_runs_close(ref, run(cfg, *place(cfg, params, m), microbatches=2))


@pytest.mark.parametrize("name", NAMES)
def test_forward_on_a_mesh_equals_unsharded(name):
    cfg, params = _reference(name)[:2]
    b = to_tensors(batch_np(cfg, 0), "cpu")
    kw = {"frames": b["frames"]} if "frames" in b else {}
    want = api.forward(cfg, params, b["tokens"], **kw)
    got = api.forward(cfg, place(cfg, params, cpu_mesh("2x2"))[0],
                      b["tokens"], **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_elastic_restore(tmp_path):
    """Save reduced zamba2 on (2, 1) after one step; restore onto (1, 2)
    and take the second step: equal to two steps on (2, 1)."""
    cfg, params = _reference(ZAMBA)[:2]
    p, o = place(cfg, params, cpu_mesh("2x1"))
    run(cfg, p, o, steps=1)
    save_checkpoint(str(tmp_path), 1, {"params": p, "opt": o})
    ref = run(cfg, p, o, steps=1, first=1)
    m = cpu_mesh("1x2")
    p_sh = tsh.param_shardings(cfg, params, m, "train")
    step, trees = restore_checkpoint(
        str(tmp_path),
        shardings={"params": p_sh, "opt": tsh.opt_shardings(p_sh, m)})
    assert step == 1
    for k, st in trees["params"].items():
        assert st.mesh is m and st.sharding.spec == p_sh[k].spec, k
    assert_runs_close(ref, run(cfg, trees["params"], trees["opt"], steps=1,
                               first=1))


def test_launcher_trains_over_the_host_mesh(monkeypatch):
    from repro_torch.launch.train import train
    cfg = get_config(FALCON).reduced()
    kw = dict(steps=3, batch=4, seq=16, device="cpu", log=lambda s: None)
    ref = train(cfg, **kw)
    monkeypatch.setenv("XLA_FLAGS",
                       "--xla_force_host_platform_device_count=2")
    mesh = make_host_mesh("cpu")
    assert dict(mesh.shape) == {"data": 2, "model": 1}
    got = train(cfg, mesh=mesh, **kw)
    assert got["params"]["layers/in_proj"].mesh is mesh
    for a, b in zip(ref["history"], got["history"]):
        for k in ("loss", "grad_norm"):
            assert abs(b[k] - a[k]) <= TOL * max(abs(a[k]), 1.0), (k, a, b)


def test_uneven_ssm_dims_refuse():
    """d_inner or the Mamba2 heads that "model" does not divide: the step
    raises naming the dimension."""
    grid = np.empty(3, dtype=object)
    grid[:] = [torch.device("cpu")] * 3
    m3 = Mesh(grid.reshape(1, 3), ("data", "model"))
    for name, what in ((FALCON, "d_inner=256 on a 3-way model"),
                       (ZAMBA, "n_ssm_heads=8 on a 3-way model")):
        cfg = get_config(name).reduced()
        assert any(r.startswith(what.split(" on")[0])
                   for r in tsh.train_unsupported(cfg, m3)), name
        with pytest.warns(UserWarning, match="drops non-dividing"):
            p, o = place(cfg, _reference(name)[1], m3)
        b = to_tensors(batch_np(cfg, 0), "cpu")
        with pytest.raises(NotImplementedError, match=what):
            make_train_step(cfg, OPT)(p, o, b)
