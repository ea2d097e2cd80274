"""The port's state-space mixers (``repro_torch.models.ssm``) on the CPU
vs the JAX functions of ``repro.models.ssm``.

Same inputs on both sides (numpy, seeded), f32, tolerance 1e-4. Layer
weights are layer 0 of the JAX package's ``init_params`` for reduced
falcon-mamba-7b (Mamba1) and zamba2-1.2b (Mamba2), bridged to tensors.
Sequence lengths: S = 16 (one padded chunk of 32) and S = 70 (three
chunks, the last padded). The sequential oracle is the chunk = 1
recurrence, stepped here one time step at a time.

One difference from JAX is pinned: its ``ssd_chunked`` multiplies the
overflowed ``exp`` above the chunk's diagonal by the causal mask and
returns NaN once a chunk's log-decay spread passes 88 (reduced zamba2
at S = 70 with its own initial weights); the port masks the exponent,
and there equals the sequential oracle.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
LENGTHS = (16, 70)


def close(port, ref, **kw):
    np.testing.assert_allclose(bridge.to_numpy(port),
                               np.asarray(ref, np.float32), **(kw or TOL))


def pair(a, dtype=np.float32):
    a = np.asarray(a, dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def layer0(name):
    """(cfg, JAX layer-0 params, port layer-0 params) of a reduced
    config, f32."""
    cfg = jget_config(name).reduced()
    params = japi.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    jp = {k.split("/", 1)[1]: v[0] for k, v in params.items()
          if k.startswith("layers/")}
    return cfg, jp, {k: bridge.to_torch(v, "cpu") for k, v in jp.items()}


@pytest.fixture(scope="module")
def mamba1():
    return layer0("falcon-mamba-7b")


@pytest.fixture(scope="module")
def mamba2():
    return layer0("zamba2-1.2b")


def sequential(decay, u, h0):
    """The chunk = 1 oracle: h_t = decay_t * h_{t-1} + u_t, one step at
    a time (numpy, f64)."""
    h = np.asarray(h0, np.float64)
    out = []
    for t in range(u.shape[1]):
        h = decay[:, t] * h + u[:, t]
        out.append(h)
    return np.stack(out, 1), h


# --------------------------------------------------------- recurrence
def test_softplus_is_logaddexp_beyond_torch_threshold():
    xj, xt = pair(np.array([-30.0, -3.0, 0.0, 3.0, 19.0, 21.0, 60.0]))
    close(ssm.softplus(xt), jax.nn.softplus(xj), rtol=1e-6, atol=1e-6)


def test_assoc_combine():
    rng = np.random.default_rng(0)
    a = [pair(rng.standard_normal((3, 4))) for _ in range(2)]
    b = [pair(rng.standard_normal((3, 4))) for _ in range(2)]
    want = jssm._assoc_combine((a[0][0], a[1][0]), (b[0][0], b[1][0]))
    got = ssm._assoc_combine((a[0][1], a[1][1]), (b[0][1], b[1][1]))
    for g, w in zip(got, want):
        close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("chunk", [1, 32, "T"])
def test_chunked_linear_recurrence(T, chunk):
    """Against JAX and the sequential oracle, for chunk 1, 32 and T (one
    chunk): the result does not depend on the chunk size."""
    chunk = T if chunk == "T" else chunk
    rng = np.random.default_rng(T)
    decay = rng.uniform(0.5, 1.0, (2, T, 3, 4))
    u = rng.standard_normal((2, T, 3, 4))
    h0 = rng.standard_normal((2, 3, 4))
    (dj, dt), (uj, ut), (hj, ht) = pair(decay), pair(u), pair(h0)
    h_seq, h_last = ssm.chunked_linear_recurrence(dt, ut, ht, chunk)
    j_seq, j_last = jssm.chunked_linear_recurrence(dj, uj, hj, chunk)
    o_seq, o_last = sequential(decay, u, h0)
    assert h_seq.shape == (2, T, 3, 4) and h_last.shape == (2, 3, 4)
    close(h_seq, j_seq)
    close(h_last, j_last)
    close(h_seq, o_seq)
    close(h_last, o_last)


@pytest.mark.parametrize("T", LENGTHS)
def test_mamba1_fused_scan(T, mamba1):
    cfg, jp, _ = mamba1
    Di, N = cfg.d_inner, cfg.d_state
    rng = np.random.default_rng(1)
    dt = pair(rng.uniform(0.01, 0.5, (2, T, Di)))
    xc = pair(rng.standard_normal((2, T, Di)))
    B_ = pair(rng.standard_normal((2, T, N)))
    C_ = pair(rng.standard_normal((2, T, N)))
    h0 = pair(rng.standard_normal((2, Di, N)))
    A = -np.exp(np.asarray(jp["A_log"], np.float32))
    Aj, At = pair(A)
    yj, hj = jssm._mamba1_fused_scan(dt[0], Aj, xc[0], B_[0], C_[0], h0[0],
                                     cfg.ssm_chunk)
    yt, ht = ssm._mamba1_fused_scan(dt[1], At, xc[1], B_[1], C_[1], h0[1],
                                    cfg.ssm_chunk)
    close(yt, yj)
    close(ht, hj)
    # The sequential oracle over the (B, T, Di, N) state.
    d = np.exp(np.asarray(dt[0])[..., None] * A)
    u = (np.asarray(dt[0]) * np.asarray(xc[0]))[..., None] \
        * np.asarray(B_[0])[:, :, None, :]
    hs, h_last = sequential(d, u, np.asarray(h0[0]))
    close(yt, np.einsum("btin,btn->bti", hs, np.asarray(C_[0])))
    close(ht, h_last)


# ------------------------------------------------------------- conv1d
@pytest.mark.parametrize("S", [1, 2, 16])
def test_causal_conv1d(S):
    rng = np.random.default_rng(S)
    x, w, b = (pair(rng.standard_normal(s)) for s in
               ((2, S, 6), (4, 6), (6,)))
    close(ssm.causal_conv1d(x[1], w[1], b[1]),
          jssm.causal_conv1d(x[0], w[0], b[0]))


def test_conv1d_step():
    rng = np.random.default_rng(3)
    x, st, w, b = (pair(rng.standard_normal(s)) for s in
                   ((2, 6), (2, 3, 6), (4, 6), (6,)))
    yj, sj = jssm.conv1d_step(x[0], st[0], w[0], b[0])
    yt, stt = ssm.conv1d_step(x[1], st[1], w[1], b[1])
    close(yt, yj)
    close(stt, sj)


# ------------------------------------------------------------- mamba1
@pytest.mark.parametrize("S", LENGTHS)
def test_mamba1_seq(S, mamba1):
    cfg, jp, tp = mamba1
    x = pair(np.random.default_rng(S).standard_normal((2, S, cfg.d_model)))
    yj, hj, cj = jssm.mamba1_seq(x[0], jp, cfg.d_state, cfg.dt_rank,
                                 cfg.ssm_chunk)
    yt, ht, ct = ssm.mamba1_seq(x[1], tp, cfg.d_state, cfg.dt_rank,
                                cfg.ssm_chunk)
    close(yt, yj)
    close(ht, hj)
    close(ct, cj)


def test_mamba1_seq_continuation(mamba1):
    """The ``h0``/``conv_state`` branch: a second segment continued from
    the first equals JAX's, and equals the unsplit sequence."""
    cfg, jp, tp = mamba1
    x = np.random.default_rng(9).standard_normal((2, 70, cfg.d_model))
    a, b = pair(x[:, :40]), pair(x[:, 40:])
    _, hj, cj = jssm.mamba1_seq(a[0], jp, cfg.d_state, cfg.dt_rank,
                                cfg.ssm_chunk)
    _, ht, ct = ssm.mamba1_seq(a[1], tp, cfg.d_state, cfg.dt_rank,
                               cfg.ssm_chunk)
    yj, hj2, cj2 = jssm.mamba1_seq(b[0], jp, cfg.d_state, cfg.dt_rank,
                                   cfg.ssm_chunk, h0=hj, conv_state=cj)
    yt, ht2, ct2 = ssm.mamba1_seq(b[1], tp, cfg.d_state, cfg.dt_rank,
                                  cfg.ssm_chunk, h0=ht, conv_state=ct)
    close(yt, yj)
    close(ht2, hj2)
    close(ct2, cj2)
    y_all, h_all, _ = ssm.mamba1_seq(torch.from_numpy(x).float(), tp,
                                     cfg.d_state, cfg.dt_rank,
                                     cfg.ssm_chunk)
    close(yt, bridge.to_numpy(y_all)[:, 40:])
    close(ht2, bridge.to_numpy(h_all))


def test_mamba1_step(mamba1):
    cfg, jp, tp = mamba1
    rng = np.random.default_rng(4)
    x = pair(rng.standard_normal((2, cfg.d_model)))
    h = pair(rng.standard_normal((2, cfg.d_inner, cfg.d_state)))
    c = pair(rng.standard_normal((2, cfg.d_conv - 1, cfg.d_inner)))
    want = jssm.mamba1_step(x[0], jp, cfg.d_state, cfg.dt_rank, h[0], c[0])
    got = ssm.mamba1_step(x[1], tp, cfg.d_state, cfg.dt_rank, h[1], c[1])
    for g, w in zip(got, want):
        close(g, w)


# ------------------------------------------------------------- mamba2
def test_mamba2_split(mamba2):
    cfg, _, _ = mamba2
    H = cfg.n_ssm_heads
    width = 2 * cfg.d_inner + 2 * cfg.d_state + H
    z = pair(np.random.default_rng(5).standard_normal((2, 3, width)))
    want = jssm._mamba2_split(z[0], cfg.d_inner, cfg.d_state, H)
    got = ssm._mamba2_split(z[1], cfg.d_inner, cfg.d_state, H)
    for g, w in zip(got, want):
        close(g, w, rtol=0, atol=0)


def ssd_inputs(cfg, T, seed, dt_hi):
    rng = np.random.default_rng(seed)
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.d_state
    return dict(xh=rng.standard_normal((2, T, H, P)),
                dt=rng.uniform(0.01, dt_hi, (2, T, H)),
                A=-rng.uniform(1.0, 16.0, H),
                B=rng.standard_normal((2, T, N)),
                C=rng.standard_normal((2, T, N)),
                h0=rng.standard_normal((2, H, P, N)))


def ssd_oracle(v):
    """Sequential Mamba2: h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t."""
    decay = np.exp(v["dt"] * v["A"])[..., None, None]
    u = (v["dt"][..., None] * v["xh"])[..., None] \
        * v["B"][:, :, None, None, :]
    hs, h_last = sequential(np.broadcast_to(decay, u.shape), u, v["h0"])
    return np.einsum("bthpn,btn->bthp", hs, v["C"]), h_last


@pytest.mark.parametrize("T", LENGTHS)
@pytest.mark.parametrize("chunk", [1, 32, "T"])
def test_ssd_chunked(T, chunk, mamba2):
    """Small decays (JAX finite): against JAX and the sequential oracle,
    chunk-size invariant."""
    cfg, _, _ = mamba2
    chunk = T if chunk == "T" else chunk
    v = ssd_inputs(cfg, T, T, dt_hi=0.05)
    j = {k: jnp.asarray(np.asarray(a, np.float32)) for k, a in v.items()}
    t = {k: torch.from_numpy(np.asarray(a, np.float32)) for k, a in
         v.items()}
    yj, hj = jssm.ssd_chunked(j["xh"], j["dt"], j["A"], j["B"], j["C"],
                              chunk, j["h0"])
    yt, ht = ssm.ssd_chunked(t["xh"], t["dt"], t["A"], t["B"], t["C"],
                             chunk, t["h0"])
    close(yt, yj)
    close(ht, hj)
    yo, ho = ssd_oracle(v)
    close(yt, yo)
    close(ht, ho)


def test_ssd_chunked_overflow_pinned(mamba2):
    """Large decays over a 32-step chunk: JAX's exp overflows above the
    diagonal and its output is NaN; the port's is finite and equals the
    sequential oracle."""
    cfg, _, _ = mamba2
    v = ssd_inputs(cfg, 70, 7, dt_hi=2.0)
    j = {k: jnp.asarray(np.asarray(a, np.float32)) for k, a in v.items()}
    t = {k: torch.from_numpy(np.asarray(a, np.float32)) for k, a in
         v.items()}
    yj, _ = jssm.ssd_chunked(j["xh"], j["dt"], j["A"], j["B"], j["C"],
                             32, j["h0"])
    yt, ht = ssm.ssd_chunked(t["xh"], t["dt"], t["A"], t["B"], t["C"],
                             32, t["h0"])
    assert np.isnan(np.asarray(yj)).any()
    assert torch.isfinite(yt).all() and torch.isfinite(ht).all()
    yo, ho = ssd_oracle(v)
    close(yt, yo)
    close(ht, ho)


@pytest.mark.parametrize("S", LENGTHS)
def test_mamba2_seq(S, mamba2):
    """S = 70 with the layer's own weights overflows JAX's SSD (NaN,
    pinned above); the parity holds with A_log scaled down so both
    sides are finite, and the port is finite either way."""
    cfg, jp, tp = mamba2
    x = pair(np.random.default_rng(S).standard_normal((2, S, cfg.d_model)))
    yt, ht = ssm.mamba2_seq(x[1], tp, cfg.d_state, cfg.ssm_head_dim,
                            cfg.ssm_chunk)
    assert torch.isfinite(yt).all() and torch.isfinite(ht).all()
    small = jnp.log(jnp.full_like(jp["A_log"], 0.05))
    jp2, tp2 = dict(jp, A_log=small), dict(tp, A_log=bridge.to_torch(
        small, "cpu"))
    yj, hj = jssm.mamba2_seq(x[0], jp2, cfg.d_state, cfg.ssm_head_dim,
                             cfg.ssm_chunk)
    yt, ht = ssm.mamba2_seq(x[1], tp2, cfg.d_state, cfg.ssm_head_dim,
                            cfg.ssm_chunk)
    close(yt, yj)
    close(ht, hj)


def test_mamba2_seq_own_weights_short(mamba2):
    """S = 16 with the layer's own weights: both sides finite and equal."""
    cfg, jp, tp = mamba2
    x = pair(np.random.default_rng(2).standard_normal((2, 16, cfg.d_model)))
    yj, hj = jssm.mamba2_seq(x[0], jp, cfg.d_state, cfg.ssm_head_dim,
                             cfg.ssm_chunk)
    yt, ht = ssm.mamba2_seq(x[1], tp, cfg.d_state, cfg.ssm_head_dim,
                            cfg.ssm_chunk)
    close(yt, yj)
    close(ht, hj)


def test_mamba2_step(mamba2):
    cfg, jp, tp = mamba2
    rng = np.random.default_rng(6)
    x = pair(rng.standard_normal((2, cfg.d_model)))
    h = pair(rng.standard_normal((2, cfg.n_ssm_heads, cfg.ssm_head_dim,
                                  cfg.d_state)))
    c = pair(rng.standard_normal((2, cfg.d_conv - 1,
                                  cfg.d_inner + 2 * cfg.d_state)))
    want = jssm.mamba2_step(x[0], jp, cfg.d_state, cfg.ssm_head_dim, h[0],
                            c[0])
    got = ssm.mamba2_step(x[1], tp, cfg.d_state, cfg.ssm_head_dim, h[1],
                          c[1])
    for g, w in zip(got, want):
        close(g, w)
