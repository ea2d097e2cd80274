"""The port's MoE and VLM train steps on a device mesh against the
unsharded port step and the JAX package, on the CPU.

Meshes are repeated ``cpu`` positions (one process drives every
position). Reduced configs in f32, two steps from the port's seeded
params, held with ``tests/_port_training.py``'s tolerances:

- the sharded step (experts over "data" with their hidden over "model",
  the shared expert and the dense MLP column/row-parallel, M-RoPE
  positions split with the batch rows) equals the unsharded port step,
  MoE capacity drops included, at (1, 1), (2, 1), (1, 2), (2, 2) and a
  ("pod", "data", "model") mesh, for qwen3-moe (top-8 scaled to top-2),
  llama4 (dense layers between MoE layers, top-1, shared expert) and
  qwen2-vl; the (1, 1) step equals JAX's jitted step on bridged weights;
- capacity groups of the global batch: groups that straddle batch
  shards ((4, 16): one group of 64 tokens over two shards) and groups
  aligned with them ((4, 1024): two groups of 2048), the block against
  ``moe_block`` and the step against the unsharded step;
- the aux loss of a split batch is the global-batch one, not the mean
  of per-shard aux terms; ``train_loss(aux_weight=)`` on a placed state;
- ``microbatches=2`` on (2, 1) against the unsharded step with two
  (qwen2-vl's two against one: ``tests/test_torch_train_mesh.py``), an
  elastic restore from (2, 1) onto (1, 2), and ``launch.train.train``
  over a forced host count of 2;
- the refusal of expert dimensions the mesh axes do not divide.
"""
import importlib

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on one
# machine, and torch's default of one thread per core oversubscribes it.
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
# JAX reads XLA_FLAGS once, when its backend starts: start it now, so
# the XLA_FLAGS a test sets for the port never reaches JAX.
jax.devices()

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import act_sharding as acts  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.training import (make_train_step,  # noqa: E402
                                  restore_checkpoint, save_checkpoint)

from _port_train_mesh import (MESHES, STEPS, OPT,  # noqa: E402
                              assert_runs_close, cpu_mesh, jax_run, place,
                              run, unsharded)
from _port_training import TOL, batch_np, to_tensors  # noqa: E402

fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")

QWEN3 = "qwen3-moe-235b-a22b"
LLAMA4 = "llama4-maverick-400b-a17b"
VLM = "qwen2-vl-7b"


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", [QWEN3, LLAMA4, VLM])
def test_sharded_step_equals_unsharded(name, mesh):
    cfg = get_config(name).reduced()
    params, ref = unsharded(cfg)
    m = cpu_mesh(mesh)
    fa_mod.STATS.reset()
    got = run(cfg, *place(cfg, params, m))
    assert_runs_close(ref, got)
    if cfg.n_experts:
        assert all(r["dropped"] > 0 for r in ref[0])   # drops happen
    # Each position runs its shard's attention (on the CPU the plain
    # version, differentiated by autograd).
    assert fa_mod.STATS.plain == m.size * cfg.n_layers * STEPS


@pytest.mark.parametrize("name", [QWEN3, VLM])
def test_unit_mesh_step_matches_jax(name):
    """(1, 1) against JAX's jitted step from JAX's weights."""
    params, ref = jax_run(name)
    cfg = get_config(name).reduced()
    assert_runs_close(ref, run(cfg, *place(cfg, params, cpu_mesh("1x1"))))


def _split_block(x, router, w_gate, w_up, w_down, top_k, n_batch, M,
                 n_data):
    """``moe_block_train`` over ``n_batch`` row shards and ``M`` columns
    of ``x`` (the experts' hidden split into M blocks, their experts
    into ``n_data``), the columns' outputs summed."""
    rows = torch.chunk(x, n_batch)
    E, F = w_gate.shape[0], w_gate.shape[-1]
    Ed, Fm = E // n_data, F // M
    experts = [[(w_gate[b % n_data * Ed:(b % n_data + 1) * Ed, :,
                        m * Fm:(m + 1) * Fm],
                 w_up[b % n_data * Ed:(b % n_data + 1) * Ed, :,
                      m * Fm:(m + 1) * Fm],
                 w_down[b % n_data * Ed:(b % n_data + 1) * Ed,
                        m * Fm:(m + 1) * Fm])
                for m in range(M)] for b in range(n_batch)]
    ys, aux = moe_mod.moe_block_train([[r] * M for r in rows],
                                      [router] * n_batch, experts, top_k,
                                      n_data=n_data)
    return torch.cat([sum(row[1:], row[0]) for row in ys]), aux


@pytest.mark.parametrize("shape", [(4, 16), (4, 1024)])
@pytest.mark.parametrize("split", [(2, 1, 2), (2, 2, 2), (4, 2, 2),
                                   (4, 1, 4)])
def test_block_groups_of_the_global_batch(shape, split):
    """``moe_block_train`` equals ``moe_block`` of the whole batch (rows,
    drops and aux) for groups that straddle the batch shards ((4, 16):
    G = 1) and groups aligned with them ((4, 1024): G = 2); ``split`` =
    (batch shards, columns, expert blocks; batch shards over expert
    blocks are pods)."""
    n_batch, M, n_data = split
    B, S = shape
    cfg = get_config(QWEN3).reduced()
    g = torch.Generator().manual_seed(B * S)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    # A direction shared by every token skews the routing: some experts
    # overflow their capacity.
    x = torch.randn(B, S, D, generator=g) + 2 * torch.randn(D, generator=g)
    router = torch.randn(D, E, generator=g) * D ** -0.5
    w_gate, w_up = (torch.randn(E, D, F, generator=g) * D ** -0.5
                    for _ in range(2))
    w_down = torch.randn(E, F, D, generator=g) * F ** -0.5
    moe_mod.STATS.reset()
    want, want_aux = moe_mod.moe_block(x, router, w_gate, w_up, w_down,
                                       cfg.top_k)
    want_drops = moe_mod.STATS.dropped
    moe_mod.STATS.reset()
    got, aux = _split_block(x, router, w_gate, w_up, w_down, cfg.top_k,
                            n_batch, M, n_data)
    assert moe_mod.STATS.dropped == want_drops > 0
    assert moe_mod.STATS.capacity_calls == 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux, want_aux, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(4, 16), (4, 1024)])
def test_groups_straddling_or_aligned_with_the_shards(shape):
    """The step on (2, 1) with the batch's one group of 64 tokens over
    both shards, and with two groups of 2048, one a shard: the
    unsharded step's losses, drops and states."""
    cfg = get_config(QWEN3).reduced(max_seq_len=max(256, shape[1]))
    params, ref = unsharded(cfg, batch=shape)
    got = run(cfg, *place(cfg, params, cpu_mesh("2x1")), batch=shape)
    assert_runs_close(ref, got)


def test_aux_loss_is_the_global_batch_one():
    """The aux term of a batch split over two data shards equals the
    unsharded one (``train_loss`` with ``aux_weight`` 1 less with 0)
    and differs from the mean of the two halves' own aux terms; the
    placed ``train_loss`` honours ``aux_weight``."""
    cfg = get_config(QWEN3).reduced(n_layers=1)
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    b = to_tensors(batch_np(cfg, 0), "cpu")
    # Rows of the second half from the top of the vocabulary only: its
    # routing statistics differ from the first half's.
    b["tokens"][2:] = b["tokens"][2:] % 16 + cfg.vocab_size - 16

    def aux(p, tokens, labels):
        return (api.train_loss(cfg, p, tokens, labels, aux_weight=1.0)
                - api.train_loss(cfg, p, tokens, labels, aux_weight=0.0))

    want = aux(params, b["tokens"], b["labels"])
    halves = (aux(params, b["tokens"][:2], b["labels"][:2])
              + aux(params, b["tokens"][2:], b["labels"][2:])) / 2
    p, _ = place(cfg, params, cpu_mesh("2x1"))
    got = aux(p, b["tokens"], b["labels"])
    assert abs(float(got) - float(want)) <= 1e-5 * float(want)
    assert abs(float(halves) - float(want)) > 100 * TOL * float(want)
    for w in (0.0, 0.5, 3.0):
        loss = api.train_loss(cfg, p, b["tokens"], b["labels"],
                              aux_weight=w)
        base = api.train_loss(cfg, params, b["tokens"], b["labels"],
                              aux_weight=w)
        assert abs(float(loss) - float(base)) <= 1e-5 * float(base), w


def test_microbatched_moe_step_equals_microbatched_unsharded():
    """MoE on (2, 1) with two microbatches equals the unsharded step
    with two (not one: each microbatch's aux loss and capacity groups
    are its own, as in JAX's ``lax.scan`` over microbatches, so drops
    and losses differ from one batch's)."""
    cfg = get_config(QWEN3).reduced()
    params, ref = unsharded(cfg, microbatches=2)
    one = unsharded(cfg)[1]
    assert ref[0][0]["loss"] != one[0][0]["loss"]
    got = run(cfg, *place(cfg, params, cpu_mesh("2x1")), microbatches=2)
    assert_runs_close(ref, got)


def test_elastic_restore(tmp_path):
    """Save reduced qwen3-moe on (2, 1) after one step; restore onto
    (1, 2) and take the second step: equal to two steps on (2, 1)."""
    cfg = get_config(QWEN3).reduced()
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
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
    cfg = get_config(QWEN3).reduced()
    kw = dict(steps=3, batch=4, seq=16, device="cpu", log=lambda s: None)
    ref = train(cfg, **kw)
    monkeypatch.setenv("XLA_FLAGS",
                       "--xla_force_host_platform_device_count=2")
    mesh = make_host_mesh("cpu")
    assert dict(mesh.shape) == {"data": 2, "model": 1}
    got = train(cfg, mesh=mesh, **kw)
    assert got["params"]["moe/w_up"].mesh is mesh
    for a, b in zip(ref["history"], got["history"]):
        for k in ("loss", "grad_norm"):
            assert abs(b[k] - a[k]) <= TOL * max(abs(a[k]), 1.0), (k, a, b)


def test_undivided_expert_dims_refuse():
    """n_experts the "data" size does not divide, or d_ff_expert the
    "model" size does not divide: the rule table would replicate them,
    so the step and the forward raise naming the dimension."""
    for over, mesh, what in (
            ({"n_experts": 5}, "2x1", "n_experts=5 on a 2-way data"),
            ({"d_ff_expert": 33}, "1x2", "d_ff_expert=33 on a 2-way model")):
        cfg = get_config(QWEN3).reduced(**over)
        params = api.init_params(cfg, 0, torch.float32, device="cpu")
        b = to_tensors(batch_np(cfg, 0), "cpu")
        with pytest.warns(UserWarning, match="drops non-dividing"):
            p, o = place(cfg, params, cpu_mesh(mesh))
        with pytest.raises(NotImplementedError,
                           match=what + ".*ROADMAP Queue 1"):
            make_train_step(cfg, OPT)(p, o, b)
        with pytest.raises(NotImplementedError, match=what):
            api.forward(cfg, p, b["tokens"])


def test_all_to_all_sums_straddled_groups():
    """The TP-mode exchange on its own: each expert block gets its
    experts' buckets of every group of its pod, a straddled group the
    sum of its shards' blocks; the way back gives each shard its groups'
    rows of every block in expert order."""
    E, C, D = 4, 3, 2
    dev = torch.device("cpu")
    # Shard 0 touches groups [0, 2), shard 1 groups [1, 2): group 1
    # straddles them.
    b0 = torch.arange(2 * E * C * D, dtype=torch.float32).view(2, E, C, D)
    b1 = torch.full((1, E, C, D), 100.0)
    spans = [(0, 2), (1, 2)]
    ins = acts.moe_all_to_all([b0, b1], spans, n_data=2)
    for d, x in enumerate(ins):
        want = torch.stack([b0[0, 2 * d:2 * d + 2],
                            b0[1, 2 * d:2 * d + 2] + 100.0], dim=1)
        assert torch.equal(x, want.reshape(2, 2 * C, D))
    back = acts.moe_all_to_all_back(ins, spans, 2, C, [dev, dev])
    assert torch.equal(back[0], torch.stack(
        [b0[0], b0[1] + 100.0]).reshape(2, E * C, D))
    assert torch.equal(back[1], (b0[1:] + 100.0).reshape(1, E * C, D))
    # Two pods of one shard each: a shard's block never reaches the
    # other pod.
    ins = acts.moe_all_to_all([b0, b1], spans, n_data=1)
    assert torch.equal(ins[0], b0.transpose(0, 1).reshape(E, 2 * C, D))
    assert torch.equal(ins[1], b1.transpose(0, 1).reshape(E, C, D))


def test_vlm_forward_on_a_mesh_equals_unsharded():
    cfg = get_config(VLM).reduced()
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    b = to_tensors(batch_np(cfg, 0), "cpu")
    want = api.forward(cfg, params, b["tokens"], mrope_pos=b["mrope_pos"])
    got = api.forward(cfg, place(cfg, params, cpu_mesh("2x2"))[0],
                      b["tokens"], mrope_pos=b["mrope_pos"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # Each shard takes its own rows' M-RoPE positions: rows 2-3 with
    # their h positions moved mid-row differ from rows 0-1.
    pos = b["mrope_pos"].clone()
    pos[1, 2:, 8:] += 3
    moved = api.forward(cfg, params, b["tokens"], mrope_pos=pos)
    assert not torch.allclose(moved[2:], want[2:])
    torch.testing.assert_close(moved[:2], want[:2], rtol=0, atol=0)
    torch.testing.assert_close(
        api.forward(cfg, place(cfg, params, cpu_mesh("2x1"))[0],
                    b["tokens"], mrope_pos=pos), moved,
        rtol=1e-5, atol=1e-5)
