"""The port's training substrate on the CPU against the JAX package.

- ``make_train_step`` against JAX's (jitted) over 3 steps from the same
  params (JAX's ``init_params``, carried across by ``bridge``) and the
  same numpy batches, for one reduced config of each family: dense,
  MoE (the aux term), SSM, hybrid, enc-dec (``frames``) and VLM
  (``mrope_pos`` with distinct t/h/w axes), with ``microbatches`` 1
  (f32 moments) and 2 (bf16 moments), clipping active (clip_norm 0.5,
  grad norms 5-16). Within ``_port_training``'s tolerances: loss,
  grad norm and lr of every step 1e-4 relative; params after the first
  step 1e-4 where f32 resolves the gradient element (Adam scales an
  unresolved one to about +-lr whatever its value); after the last
  step params within lr a step and moments within 1e-4.
- The optimizer cases of ``tests/test_training.py`` (update, clipping,
  decay mask, bf16 moments, schedule) on both packages.
- The flash_attention backward's plain version against ``jax.vjp`` of
  the JAX package's attention (``layers.gqa_attention``, what JAX
  trains through): causal and full, GQA, ragged S, the query-chunked
  S = 2048; 1e-5 in f32.
- ``run_with_recovery`` with injected failures driving the port's step
  and checkpoints: the recovered run ends bit-equal to an uninterrupted
  one. The launcher trains, checkpoints and resumes.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on one
# machine, and torch's default of one thread per core oversubscribes it.
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jtrain  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as ttrain  # noqa: E402

from _port_training import (TOL, batch_np, final_close,  # noqa: E402
                            first_step_close, states_ok, to_tensors)

# The kernels package re-exports ``flash_attention`` (the function), so
# the module is fetched by path.
fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")

FAMILIES = ("internlm2-1.8b", "qwen3-moe-235b-a22b", "falcon-mamba-7b",
            "zamba2-1.2b", "whisper-base", "qwen2-vl-7b")
STEPS = 3


def host(tree):
    """Leaves of either package as numpy copies (bf16 widened to f32;
    the port's step updates its tensors in place)."""
    def one(v):
        if isinstance(v, torch.Tensor):
            return bridge.to_numpy(v).copy()
        return np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                          else v)
    return {k: one(v) for k, v in tree.items()}


def run_both(name, opt_kw, microbatches):
    """STEPS steps of JAX's jitted step and the port's from the same
    params and batches. Returns ([(jax metrics, port metrics)], JAX
    (params, opt), port (params, opt), the AdamWConfig, and after the
    first step JAX's params, the port's and JAX's first moments)."""
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = bridge.params_to_torch(jparams, "cpu")
    jcfg_opt, tcfg_opt = jopt.AdamWConfig(**opt_kw), topt.AdamWConfig(**opt_kw)
    jstate = jopt.init_opt_state(jparams, jcfg_opt)
    tstate = topt.init_opt_state(tparams, tcfg_opt)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jcfg_opt, microbatches))
    tstep = ttrain.make_train_step(cfg, tcfg_opt, microbatches)
    metrics = []
    for i in range(STEPS):
        b = batch_np(cfg, i)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in b.items()})
        tparams, tstate, tm = tstep(tparams, tstate, to_tensors(b, "cpu"))
        metrics.append((jm, tm))
        if i == 0:
            first = (host(jparams), host(tparams),
                     {k[2:]: v for k, v in host(jstate).items()
                      if k.startswith("m/")})
    return (metrics, (host(jparams), host(jstate)),
            (host(tparams), host(tstate)), tcfg_opt, first)


@pytest.mark.parametrize("microbatches,moments", [(1, "float32"),
                                                  (2, "bfloat16")])
@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_jax(name, microbatches, moments):
    opt_kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, clip_norm=0.5,
                  moment_dtype=moments)
    metrics, ref, got, ocfg, first = run_both(name, opt_kw, microbatches)
    for jm, tm in metrics:
        assert float(jm["grad_norm"]) > ocfg.clip_norm     # clipping on
        for k in ("loss", "grad_norm", "lr"):
            want = float(jm[k])
            assert abs(float(tm[k]) - want) <= TOL * max(abs(want), 1.0), k
    first = first_step_close(first[0], first[1], ocfg, first[2])
    final = final_close(ref, got, ocfg, STEPS)
    assert states_ok(first, final), (first, final)
    assert got[1]["step"] == ref[1]["step"] == STEPS


# ------------------------------------------- the optimizer's JAX cases
def _pair(tree_np):
    return ({k: jnp.asarray(v) for k, v in tree_np.items()},
            {k: torch.from_numpy(v.copy()) for k, v in tree_np.items()})


PARAMS = {"layers/w": np.ones((4, 4), np.float32),
          "layers/norm": np.ones((4,), np.float32)}


@pytest.mark.parametrize("case", ["ones", "clipped", "decay_mask",
                                  "bf16_moments"])
def test_adamw_update_matches_jax(case):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=100)
    grad_scale = 1.0
    if case == "clipped":
        grad_scale = 1e6
    if case == "decay_mask":
        kw = dict(lr=1e-2, weight_decay=10.0, warmup_steps=0)
        grad_scale = 0.0
    if case == "bf16_moments":
        kw["moment_dtype"] = "bfloat16"
    jp, tp = _pair(PARAMS)
    jg, tg = _pair({k: grad_scale * np.ones_like(v)
                    for k, v in PARAMS.items()})
    jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    js, ts = jopt.init_opt_state(jp, jc), topt.init_opt_state(tp, tc)
    assert ts["m/layers/w"].dtype == (torch.bfloat16 if case == "bf16_moments"
                                      else torch.float32)
    for _ in range(2):
        jp, js, jm = jopt.adamw_update(jp, jg, js, jc)
        tp, ts, tm = topt.adamw_update(tp, tg, ts, tc)
    for k in PARAMS:
        np.testing.assert_allclose(bridge.to_numpy(tp[k]), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        for m in ("m", "v"):
            np.testing.assert_allclose(
                bridge.to_numpy(ts[f"{m}/{k}"]),
                np.asarray(js[f"{m}/{k}"], np.float32), rtol=1e-6)
    for k in ("grad_norm", "lr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 2
    if case == "decay_mask":     # norms untouched, matrices decayed
        np.testing.assert_array_equal(tp["layers/norm"].numpy(), np.ones(4))
        assert float(tp["layers/w"].max()) < 1.0


def test_bridge_carries_a_jax_opt_state():
    """``bridge.params_to_torch`` takes a JAX optimizer state as it is:
    the int32 step and bf16 moments keep their dtypes, and the port's
    update continues from it as JAX's does."""
    jp, _ = _pair(PARAMS)
    jc = jopt.AdamWConfig(moment_dtype="bfloat16", lr=1e-2, warmup_steps=0)
    js = jopt.init_opt_state(jp, jc)
    jg = {k: jnp.full_like(v, 0.3) for k, v in jp.items()}
    jp, js, _ = jopt.adamw_update(jp, jg, js, jc)
    tp = bridge.params_to_torch(jp, "cpu")
    ts = bridge.params_to_torch(js, "cpu")
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    assert ts["m/layers/w"].dtype == torch.bfloat16
    tg = bridge.params_to_torch(jg, "cpu")
    jp, js, _ = jopt.adamw_update(jp, jg, js, jc)
    topt.adamw_update(tp, tg, ts, topt.AdamWConfig(**vars(jc)))
    assert int(ts["step"]) == 2
    for k in PARAMS:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6)


def test_update_is_in_place():
    """The port's counterpart of JAX's donated buffers: the step writes
    into the given tensors and returns the same dicts."""
    tp = {k: torch.from_numpy(v.copy()) for k, v in PARAMS.items()}
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=0)
    ts = topt.init_opt_state(tp, cfg)
    before = {k: v.data_ptr() for k, v in {**tp, **ts}.items()}
    grads = {k: torch.ones_like(v) for k, v in tp.items()}
    p2, s2, _ = topt.adamw_update(tp, grads, ts, cfg)
    assert p2 is tp and s2 is ts
    assert {k: v.data_ptr() for k, v in {**tp, **ts}.items()} == before
    assert float(tp["layers/w"].max()) < 1.0 and int(ts["step"]) == 1


@pytest.mark.parametrize("warmup,total,min_frac", [
    (10, 100, 0.1), (0, 50, 0.0), (5, 5, 0.3), (20, 10_000, 0.1)])
def test_schedule_matches_jax(warmup, total, min_frac):
    kw = dict(lr=1.0, warmup_steps=warmup, total_steps=total,
              min_lr_frac=min_frac)
    jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    steps = np.array([0, 1, 3, 5, 10, 11, 50, 99, 100, 150], np.int32)
    want = np.asarray(jopt.schedule(jc, jnp.asarray(steps)))
    got = topt.schedule(tc, torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if (warmup, total, min_frac) == (10, 100, 0.1):   # the JAX test's
        assert float(topt.schedule(tc, 5)) == pytest.approx(0.5)
        assert float(topt.schedule(tc, 100)) == pytest.approx(0.1)


@pytest.mark.parametrize("path,shape", [
    ("layers/w", (4, 4)), ("layers/norm", (4,)), ("layers/attn_norm", (2, 4)),
    ("layers/q_bias", (2, 4)), ("embed/tok", (8, 4)), ("layers/A_log", (2, 4)),
    ("final_norm", (4,)), ("layers/conv_b", (2, 4))])
def test_decay_mask_matches_jax(path, shape):
    assert topt._decay_mask(path, torch.zeros(shape)) == \
        jopt._decay_mask(path, jnp.zeros(shape))


# -------------------------------------------- the flash backward's plain
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Kh,dh", [
    (2, 37, 4, 2, 16), (1, 64, 4, 4, 32), (2, 21, 6, 1, 8),
    (1, 2048, 2, 1, 16)])
def test_flash_bwd_plain_matches_jax_grad(B, S, H, Kh, dh, causal):
    """``flash_attention_bwd`` on CPU tensors (its plain version) against
    ``jax.vjp`` of ``layers.gqa_attention`` on the same f32 values."""
    rng = np.random.default_rng(S + H)
    q, k, v = (rng.standard_normal((B, S, h, dh)).astype(np.float32)
               for h in (H, Kh, Kh))
    dout = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: jlayers.gqa_attention(
        a, b, c, causal=causal), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    fa_mod.BWD_STATS.reset()
    got = fa_mod.flash_attention_bwd(
        *(torch.from_numpy(np.array(t)) for t in (q, k, v, out, dout)),
        causal)
    assert (fa_mod.BWD_STATS.plain, fa_mod.BWD_STATS.launches) == (1, 0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_flash_bwd_checks_its_operands():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="dout must match"):
        fa_mod.flash_attention_bwd(q, q, q, q, torch.zeros((1, 8, 2, 8)))
    with pytest.raises(ValueError, match="out must match"):
        fa_mod.flash_attention_bwd(q, q, q, q.bfloat16(), q)


# ------------------------------------------------- recovery, launcher
def _small():
    return get_config("internlm2-1.8b").reduced(
        n_layers=2, d_model=64, vocab_size=256, d_ff=128)


def test_recovery_ends_equal_to_an_uninterrupted_run(tmp_path):
    """``run_with_recovery`` over the port's step with two injected node
    failures: it restores the last checkpoint, replays the same
    deterministic batches and ends bit-equal to a run without
    failures."""
    from repro_torch.training import (AdamWConfig, AsyncCheckpointer,
                                      DataConfig, NodeFailure, SyntheticLM,
                                      init_train_state, latest_step,
                                      make_train_step, restore_checkpoint,
                                      run_with_recovery)
    cfg = _small()
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=4))
    step_fn = make_train_step(cfg, ocfg)

    def run(fail_at, directory):
        params, opt = init_train_state(cfg, ocfg, 0, torch.float32,
                                       device="cpu")
        state = {"params": params, "opt": opt}
        ck = AsyncCheckpointer(str(directory), keep=2)
        fails = set(fail_at)
        restores = []

        def train_one(step):
            if step in fails:
                fails.discard(step)
                raise NodeFailure(host=1)
            b = {k: torch.from_numpy(v) for k, v in data.batch(step).items()}
            state["params"], state["opt"], m = step_fn(
                state["params"], state["opt"], b)
            return {"loss": float(m["loss"])}

        def save(step):
            ck.save(step, {"params": state["params"], "opt": state["opt"]})

        def restore():
            ck.wait()
            if latest_step(str(directory)) is None:
                return 0
            step, trees = restore_checkpoint(str(directory), device="cpu")
            state["params"], state["opt"] = trees["params"], trees["opt"]
            restores.append(step)
            return step

        out = run_with_recovery(train_one, save, restore, n_steps=12,
                                checkpoint_every=4)
        ck.wait()
        return out, state, restores

    clean, s0, _ = run([], tmp_path / "clean")
    out, s1, restores = run([6, 9], tmp_path / "failing")
    assert clean["steps_done"] == out["steps_done"] == 12
    assert (clean["recoveries"], out["recoveries"]) == (0, 2)
    assert restores == [4, 8]
    for tree in ("params", "opt"):
        for k, v in s0[tree].items():
            assert torch.equal(v, s1[tree][k]), (tree, k)


def test_launcher_trains_checkpoints_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train
    args = ["--reduced", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"]
    train.main(args + ["--steps", "3"])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000003"]
    train.main(args + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 3" in out
    assert out.count("done") == 2
    assert sorted(p.name for p in tmp_path.iterdir())[-1] == "step_00000005"


def test_launcher_loop_losses_are_finite():
    from repro_torch.launch import train
    res = train.train(get_config("internlm2-1.8b").reduced(), steps=3,
                      batch=2, seq=16, device="cpu", log=lambda s: None)
    assert [r["step"] for r in res["history"]] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and r["seconds"] > 0
               for r in res["history"])
    assert res["opt_cfg"].warmup_steps == 0 and int(res["opt"]["step"]) == 3
