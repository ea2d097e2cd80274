"""Rematerialisation (``cfg.remat``) in the port's training, on the CPU.

The reference checkpoints each layer body (``jax.checkpoint``) when
``cfg.remat`` is set, and always the Mamba1 chunk step and the
query-chunk attention body; the port runs the same bodies under
``torch.utils.checkpoint`` (``models/remat.py``). Reduced configs in
f32, one of each family (dense, MoE with its aux loss, llama4's dense
layers between MoE layers, SSM, hybrid, enc-dec, VLM) with
``remat=True`` set on both sides:

- the port's train step against JAX's jitted step with remat, over two
  steps, within ``tests/_port_training.py``'s tolerances;
- remat on against remat off: loss, grad norm, MoE drops, params and
  moments after a step bit-identical, on one device and placed on a
  (2, 2) mesh of repeated ``cpu`` positions (the recompute's FSDP
  gathers are replays: each leaf is still reduce-scattered once);
- the bodies really recompute: the flash forward runs twice a layer
  (its plain version here, which autograd differentiates once), the
  mesh gathers do not fall and the reduce-scatters stay as they were,
  fewer bytes are saved for the backward, and neither the
  Mamba1 chunk tensors nor a query chunk's probabilities are saved;
  serving (no grad) runs each body once.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jax.devices()
import jax.numpy as jnp  # noqa: E402

from _port_train_mesh import OPT, cpu_mesh, place, run  # noqa: E402
from _port_training import (TOL, attention_layers, batch_np,  # noqa: E402
                            final_close, first_step_close, states_ok,
                            to_tensors)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ops import COLLECTIVE_METER  # noqa: E402
from repro_torch.models import api, layers, ssm  # noqa: E402
from repro_torch.training import init_opt_state  # noqa: E402

fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")

FAMILIES = ("internlm2-1.8b", "qwen3-moe-235b-a22b",
            "llama4-maverick-400b-a17b", "falcon-mamba-7b", "zamba2-1.2b",
            "whisper-base", "qwen2-vl-7b")
STEPS = 2


def config(name, remat=True):
    return dataclasses.replace(get_config(name).reduced(), remat=remat)


# ---------------------------------------------------- against the JAX step
@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_jax_with_remat(name):
    from repro.configs import get_config as jget_config
    from repro.models import api as japi
    from repro.training import optimizer as jopt
    from repro.training import train_step as jtrain
    from repro_torch import bridge
    from repro_torch.training import make_train_step
    jcfg = dataclasses.replace(jget_config(name).reduced(), remat=True)
    cfg = config(name)
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = bridge.params_to_torch(jparams, "cpu")
    jocfg = jopt.AdamWConfig(lr=OPT.lr, warmup_steps=OPT.warmup_steps,
                             total_steps=OPT.total_steps,
                             clip_norm=OPT.clip_norm)
    jstate = jopt.init_opt_state(jparams, jocfg)
    opt = init_opt_state(params, OPT)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jocfg))
    step = make_train_step(cfg, OPT)
    for i in range(STEPS):
        b = batch_np(cfg, i)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v) for k, v in b.items()})
        _, _, tm = step(params, opt, to_tensors(b, "cpu"))
        for k in ("loss", "grad_norm", "lr"):
            want = float(jm[k])
            assert abs(float(tm[k]) - want) <= TOL * max(abs(want), 1.0), k
        if i == 0:
            first = first_step_close(
                {k: np.asarray(v) for k, v in jparams.items()},
                {k: v.numpy().copy() for k, v in params.items()}, OPT,
                {k[2:]: np.asarray(v) for k, v in jstate.items()
                 if k.startswith("m/")})
    final = final_close(
        ({k: np.asarray(v) for k, v in jparams.items()},
         {k: np.asarray(v, np.float32) for k, v in jstate.items()}),
        ({k: v.numpy() for k, v in params.items()},
         {k: v.float().numpy() for k, v in opt.items()}), OPT, STEPS)
    assert states_ok(first, final), (first, final)


# ------------------------------------------------------- on against off
def one_step(name, remat, mesh):
    """One step of reduced ``name`` from the port's seeded f32 params,
    unsharded (``mesh`` None) or placed on ``mesh``: (``run``'s
    metrics, end state), with the flash launches and the gathers and
    reduce-scatters it made."""
    cfg = config(name, remat)
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    if mesh is None:
        state = ({k: v.clone() for k, v in params.items()},
                 init_opt_state(params, OPT))
    else:
        state = place(cfg, params, cpu_mesh(mesh))
    fa_mod.STATS.reset()
    fa_mod.BWD_STATS.reset()
    COLLECTIVE_METER.reset()
    ms, _, end = run(cfg, *state, steps=1)
    return ms, end, dict(fwd=fa_mod.STATS.plain, bwd=fa_mod.BWD_STATS.plain,
                         gathers=COLLECTIVE_METER.gathers,
                         reduces=COLLECTIVE_METER.reduces)


@pytest.mark.filterwarnings("ignore:fit_spec")
@pytest.mark.parametrize("mesh", [None, "2x2"], ids=["one_device", "2x2"])
@pytest.mark.parametrize("name", FAMILIES)
def test_remat_is_bit_identical(name, mesh):
    off_m, off_end, off_n = one_step(name, False, mesh)
    on_m, on_end, on_n = one_step(name, True, mesh)
    assert on_m == off_m           # loss, grad norm, lr, MoE drops
    for a, b in zip(off_end, on_end):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    cfg = config(name)
    n = attention_layers(cfg) * (4 if mesh else 1)
    assert off_n["fwd"] == n and on_n["fwd"] == 2 * n      # recomputed
    assert off_n["bwd"] == on_n["bwd"]     # autograd's on the CPU: 0
    assert on_n["reduces"] == off_n["reduces"]
    # FSDP already gathers a saved weight again in the backward; under
    # remat the recompute's replays gather it instead (and the packed
    # SSM leaves, which the backward would have kept).
    assert on_n["gathers"] >= off_n["gathers"]


def saved_bytes(fn) -> int:
    """Bytes autograd saves for the backward while ``fn`` runs."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return total[0]


@pytest.mark.parametrize("name", ["internlm2-1.8b", "whisper-base"])
def test_remat_saves_less(name):
    def loss(remat):
        cfg = config(name, remat)
        params = {k: v.requires_grad_(True) for k, v in api.init_params(
            cfg, 0, torch.float32, device="cpu").items()}
        b = to_tensors(batch_np(cfg, 0), "cpu")
        kw = {k: b[k] for k in ("frames", "mrope_pos") if k in b}
        return lambda: api.train_loss(cfg, params, b["tokens"],
                                      b["labels"], **kw)
    assert saved_bytes(loss(True)) < saved_bytes(loss(False)) / 2


def test_serving_runs_each_body_once():
    cfg = config("internlm2-1.8b")
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    fa_mod.STATS.reset()
    toks = torch.zeros((2, 8), dtype=torch.int32)
    with torch.no_grad():
        api.forward(cfg, params, toks)
    api.prefill(cfg, params, toks)
    assert fa_mod.STATS.plain == 2 * cfg.n_layers


def test_mamba1_chunk_tensors_are_not_saved():
    """The (B, Q, Di, N) decay and state tensors of each chunk are
    recomputed in the backward, whatever ``cfg.remat`` says; the
    gradient equals a step-by-step recurrence's."""
    g = torch.Generator().manual_seed(0)
    B, T, Di, N, Q = 2, 12, 8, 4, 4
    dt = torch.rand(B, T, Di, generator=g).requires_grad_(True)
    xc = torch.randn(B, T, Di, generator=g).requires_grad_(True)
    A = -torch.rand(Di, N, generator=g) - 0.5
    Bs = torch.randn(B, T, N, generator=g)
    Cs = torch.randn(B, T, N, generator=g)
    h0 = torch.zeros(B, Di, N)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, _ = ssm._mamba1_fused_scan(dt, A, xc, Bs, Cs, h0, Q)
    assert (B, Q, Di, N) not in shapes
    got = torch.autograd.grad(y.square().sum(), (dt, xc))
    h, ys = h0, []
    for t in range(T):
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * xc[:, t])[..., None] * Bs[:, t, None, :]
        ys.append(torch.einsum("bin,bn->bi", h, Cs[:, t]))
    want = torch.autograd.grad(torch.stack(ys, 1).square().sum(), (dt, xc))
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5)


def test_query_chunk_probs_are_not_saved():
    """``gqa_attention`` above its chunk threshold: no chunk's (Q_CHUNK,
    Sk) probabilities are kept for the backward, and the gradient is
    the unchunked block's."""
    g = torch.Generator().manual_seed(1)
    Sq = layers.Q_CHUNK_THRESHOLD
    q = torch.randn(1, Sq, 2, 8, generator=g).requires_grad_(True)
    k = torch.randn(1, Sq, 1, 8, generator=g).requires_grad_(True)
    v = torch.randn(1, Sq, 1, 8, generator=g).requires_grad_(True)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = layers.gqa_attention(q, k, v, causal=True)
    assert not any(len(s) == 5 and s[-2:] == (layers.Q_CHUNK, Sq)
                   for s in shapes)
    got = torch.autograd.grad(out.square().sum(), (q, k, v))
    ref = layers._attn_block(q.reshape(1, Sq, 1, 2, 8), k, v, 0, None,
                             True, 8 ** -0.5).reshape(1, Sq, 2, 8)
    want = torch.autograd.grad(ref.square().sum(), (q, k, v))
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-5)
