"""State-space mixers: Mamba1 (falcon-mamba) and Mamba2 (zamba2)
(PyTorch).

Port of ``src/repro/models/ssm.py``. Both reduce to an elementwise
linear recurrence over time:

    h_t = decay_t * h_{t-1} + u_t

computed with a *chunked* scan: a loop over chunks of ``chunk`` steps
carrying the state, with a log-depth scan inside each chunk. This
bounds the materialised (B, chunk, *state) tensors: Mamba1's decay and
input exist only per chunk, never at (B, S, Di, N).

PyTorch has no ``associative_scan``, so the in-chunk scan is the
log-depth (Hillis-Steele) form: ceil(log2(chunk)) rounds, round j
combining every element with the one 2**j steps before it under
``_assoc_combine``. The pairs combine in another order than
``jax.lax.associative_scan``'s odd/even recursion, so the results
agree with JAX to the rounding of f32 products, not bit for bit. The
fully sequential form is the chunk = 1 case of
``chunked_linear_recurrence``.

Mamba2's SSD form (``ssd_chunked``) is a masked (Q x Q) matmul within
each chunk and a loop over chunk-boundary states, as in JAX, with one
difference: the causal mask is applied in the exponent of the decay
matrix, where JAX multiplies the overflowed exponential by it and gets
NaN (see ``ssd_chunked``).

Decode is the O(1) single-step update (``mamba1_step``,
``mamba2_step``).

The train step on a device mesh runs each mixer over "model" columns
(``mamba1_seq_columns``, ``mamba2_seq_columns``): column m holds its
block of d_inner (Mamba1 channels, Mamba2 heads) and runs the scan over
it. Mamba1's ``x_proj`` is row-parallel, so its dt/B/C are the
columns' partial products summed (``psum_columns``) before
``dt_proj``; Mamba2 computes B and C whole on every column (one group),
and its gate norm, an RMS over all of d_inner, sums the columns' sums
of squares before it scales (``gate_norm_columns``). Both return each
column's partial ``out_proj`` product (row-parallel) for the caller to
sum. The activation-sharding anchors of the JAX module mark the
columns' lists at the same points; one column computes exactly what
``mamba1_seq``/``mamba2_seq`` compute.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import on_device
from repro_torch.distributed.act_sharding import (constrain_ssm_bth,
                                                  constrain_ssm_bthp,
                                                  constrain_ssm_channels,
                                                  exact_reductions,
                                                  gather_columns,
                                                  psum_columns, replicate)
from repro_torch.models.layers import einsum, promoted, rms_norm
from repro_torch.models.remat import remat


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` for every x
    (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# ------------------------------------------------------- linear recurrence
def _assoc_combine(a, b):
    """(d, u) elements; b is later in time."""
    return a[0] * b[0], a[1] * b[0] + b[1]


def _scan_chunk(d: torch.Tensor, u: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of (d, u) pairs over axis 1 under
    ``_assoc_combine``, in ceil(log2(Q)) rounds of whole-tensor ops.
    Returns (cumulative decay, h with a zero initial state)."""
    Q = d.shape[1]
    off = 1
    while off < Q:
        dd, uu = _assoc_combine((d[:, :-off], u[:, :-off]),
                                (d[:, off:], u[:, off:]))
        d = torch.cat([d[:, :off], dd], dim=1)
        u = torch.cat([u[:, :off], uu], dim=1)
        off *= 2
    return d, u


def _pad_time(a: torch.Tensor, pad: int, value: float = 0.0
              ) -> torch.Tensor:
    """``a`` (B, T, ...) padded with ``pad`` steps of ``value`` at the
    end of axis 1."""
    if not pad:
        return a
    fill = torch.full((a.shape[0], pad) + tuple(a.shape[2:]), value,
                      dtype=a.dtype, device=a.device)
    return torch.cat([a, fill], dim=1)


def _last(a: torch.Tensor) -> torch.Tensor:
    """``a[:, -1]`` as a tensor of its own: a view would keep all of
    ``a`` alive for as long as the state is held (a serve state holds
    one a layer)."""
    return a[:, -1].clone(memory_format=torch.contiguous_format)


def chunked_linear_recurrence(decay: torch.Tensor, u: torch.Tensor,
                              h0: torch.Tensor, chunk: int,
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = decay_t * h_{t-1} + u_t for t in [0, T).

    decay, u: (B, T, *S); h0: (B, *S). Returns (h (B,T,*S), h_T).
    T is padded up to a multiple of ``chunk`` internally (decay 1,
    input 0, so the padded steps carry h_T unchanged).
    """
    T = u.shape[1]
    pad = (-T) % chunk
    decay = _pad_time(decay, pad, 1.0)
    u = _pad_time(u, pad)
    h = h0
    outs = []
    for c in range(0, T + pad, chunk):
        dd, uu = _scan_chunk(decay[:, c:c + chunk], u[:, c:c + chunk])
        h_all = dd * h[:, None] + uu                     # (B, chunk, *S)
        outs.append(h_all)
        h = _last(h_all)
    return torch.cat(outs, dim=1)[:, :T], h


def _mamba1_fused_scan(dt, A, xc, B_ssm, C_ssm, h0, chunk):
    """Selective scan with chunk-local materialisation.

    dt/xc: (B,T,Di); A: (Di,N); B/C: (B,T,N); h0: (B,Di,N).
    Returns (y (B,T,Di), h_T). decay/u exist only at (B,chunk,Di,N).
    """
    T = dt.shape[1]
    pad = (-T) % chunk
    dt, xc, B_ssm, C_ssm = (_pad_time(a, pad) for a in (dt, xc, B_ssm,
                                                          C_ssm))

    def step(h, dt_c, x_c, b_c, c_c):
        decay = torch.exp(dt_c[..., None] * A)               # (B,Q,Di,N)
        u = (dt_c * x_c)[..., None] * b_c[:, :, None, :]
        dd, uu = _scan_chunk(decay, u)
        del decay, u
        h_all = dd * h[:, None] + uu
        del dd, uu
        return torch.einsum("bqin,bqn->bqi", h_all, c_c), _last(h_all)

    h = h0
    ys = []
    for c in range(0, T + pad, chunk):
        # Always rematerialised, as the reference's chunk step: the
        # backward recomputes the chunk's (B, Q, Di, N) tensors.
        y, h = remat(step, h, dt[:, c:c + chunk], xc[:, c:c + chunk],
                     B_ssm[:, c:c + chunk], C_ssm[:, c:c + chunk])
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :T], h


# ------------------------------------------------------------- conv1d
def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,C); w: (K,C); b: (C,). The K
    shifted products are summed left to right from 0, as JAX's
    ``sum``."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = sum(xp[:, k:k + S, :] * w[k] for k in range(K))
    return y + b


def conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                w: torch.Tensor, b: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode-time conv. x_t: (B,C); conv_state: (B,K-1,C). The window
    takes the promoted dtype of the state and the input, as
    ``jnp.concatenate`` does."""
    window = torch.cat(promoted(conv_state, x_t[:, None, :]), dim=1)
    y = einsum("bkc,kc->bc", window, w) + b
    return y, window[:, 1:, :]


# ------------------------------------------------------------- mamba1
def _mamba1_dt(dbc, p, d_state, dt_rank, eq_dt):
    """dt, B and C of Mamba1 from the x_proj product ``dbc``: (dt f32,
    B f32, C f32)."""
    dt_raw = dbc[..., :dt_rank]
    B_ssm = dbc[..., dt_rank:dt_rank + d_state].float()
    C_ssm = dbc[..., dt_rank + d_state:].float()
    dt = softplus(einsum(eq_dt, dt_raw, p["dt_proj"])
                  + p["dt_bias"]).float()
    return dt, B_ssm, C_ssm


def _mamba1_dbc(x_conv, p, d_state, dt_rank, eq_x, eq_dt):
    """x_proj / dt_proj of Mamba1: (dt f32, B f32, C f32)."""
    return _mamba1_dt(einsum(eq_x, x_conv, p["x_proj"]), p, d_state,
                      dt_rank, eq_dt)


def _mamba1_front(x, p, conv_state=None):
    """in_proj, the causal conv and SiLU: (x_conv, z, conv_tail)."""
    xz = einsum("bsd,de->bse", x, p["in_proj"])
    x_in, z = xz.chunk(2, dim=-1)                         # (B,S,Di)
    if conv_state is not None:
        x_cat = torch.cat(promoted(conv_state, x_in), dim=1)
        x_conv = causal_conv1d(x_cat, p["conv_w"], p["conv_b"])[
            :, conv_state.shape[1]:]
    else:
        x_conv = causal_conv1d(x_in, p["conv_w"], p["conv_b"])
    x_conv = F.silu(x_conv)
    conv_tail = x_in[:, -(p["conv_w"].shape[0] - 1):, :].clone(
        memory_format=torch.contiguous_format)
    return x_conv, z, conv_tail


def _mamba1_gated(x, p, x_conv, z, dt, B_ssm, C_ssm, d_state, chunk, h0):
    """The selective scan, the skip and the z gate: (y (B,S,Di) in x's
    dtype, h_T)."""
    A = -torch.exp(p["A_log"].float())                    # (Di,N)
    if h0 is None:
        h0 = torch.zeros((x.shape[0], A.shape[0], d_state),
                         dtype=torch.float32, device=x.device)
    xc32 = x_conv.float()
    y, h_last = _mamba1_fused_scan(dt, A, xc32, B_ssm, C_ssm, h0, chunk)
    y = y + xc32 * p["ssm_D"]
    return (y * F.silu(z.float())).to(x.dtype), h_last


def mamba1_seq(x: torch.Tensor, p: dict, d_state: int, dt_rank: int,
               chunk: int = 128,
               h0: torch.Tensor | None = None,
               conv_state: torch.Tensor | None = None,
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba1 mixer.

    x: (B,S,D), already normed. ``h0`` (B,Di,N) and ``conv_state``
    (B,K-1,Di) continue from an earlier segment. Returns (y (B,S,D),
    h_T, conv_tail): the tail is the last K-1 raw conv inputs (fewer
    when S < K-1, as in JAX), decode's conv state.
    """
    x_conv, z, conv_tail = _mamba1_front(x, p, conv_state)
    dt, B_ssm, C_ssm = _mamba1_dbc(x_conv, p, d_state, dt_rank,
                                   "bsi,ie->bse", "bsr,ri->bsi")
    y, h_last = _mamba1_gated(x, p, x_conv, z, dt, B_ssm, C_ssm, d_state,
                              chunk, h0)
    out = einsum("bsi,id->bsd", y, p["out_proj"])
    return out, h_last, conv_tail


def mamba1_seq_columns(xs: list, ps: list, d_state: int, dt_rank: int,
                       chunk: int = 128) -> list:
    """Mamba1 over "model" columns (the mesh train step). ``xs[m]``: the
    normed input (B,S,D), column m's copy on its device; ``ps[m]``: its
    blocks (``in_proj`` [x_m | z_m], the conv, ``x_proj`` rows,
    ``dt_proj`` columns, ``dt_bias``/``A_log``/``ssm_D`` of its
    channels, ``out_proj`` rows). Returns each column's partial
    ``out_proj`` product (B,S,D), to be summed over the columns."""
    convs, zs, dbcs = [], [], []
    for x, p in zip(xs, ps):
        with on_device(x.device):
            x_conv, z, _ = _mamba1_front(x, p)
            convs.append(x_conv)
            zs.append(z)
    for x_conv, p in zip(constrain_ssm_channels(convs), ps):
        with on_device(x_conv.device):
            dbcs.append(einsum("bsi,ie->bse", x_conv, p["x_proj"]))
    ys = []
    for x, p, x_conv, z, dbc in zip(xs, ps, convs, zs, psum_columns(dbcs)):
        with on_device(x.device):
            dt, B_ssm, C_ssm = _mamba1_dt(dbc, p, d_state, dt_rank,
                                          "bsr,ri->bsi")
            ys.append(_mamba1_gated(x, p, x_conv, z, dt, B_ssm, C_ssm,
                                    d_state, chunk, None)[0])
    return [einsum("bsi,id->bsd", y, p["out_proj"])
            for y, p in zip(constrain_ssm_channels(ys), ps)]


def _mamba1_step_front(x_t, p, conv_state):
    """Decode in_proj, the conv step and SiLU: (x_conv, z, conv_state)."""
    xz = einsum("bd,de->be", x_t, p["in_proj"])
    x_in, z = xz.chunk(2, dim=-1)
    x_conv, conv_state = conv1d_step(x_in, conv_state, p["conv_w"],
                                     p["conv_b"])
    return F.silu(x_conv), z, conv_state


def _mamba1_step_scan(p, x_conv, z, dbc, h, d_state, dt_rank, dtype):
    """One step of the recurrence from the x_proj product ``dbc``, the
    skip and the z gate: (y (B,Di) in ``dtype``, h)."""
    dt, B_ssm, C_ssm = _mamba1_dt(dbc, p, d_state, dt_rank, "br,ri->bi")
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt[..., None] * A)                  # (B,Di,N)
    xc32 = x_conv.float()
    u = (dt * xc32)[..., None] * B_ssm[:, None, :]
    h = decay * h + u
    y = torch.einsum("bin,bn->bi", h, C_ssm)
    y = y + xc32 * p["ssm_D"]
    return (y * F.silu(z.float())).to(dtype), h


def mamba1_step(x_t: torch.Tensor, p: dict, d_state: int, dt_rank: int,
                h: torch.Tensor, conv_state: torch.Tensor,
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode step. x_t: (B,D); h: (B,Di,N); conv_state: (B,K-1,Di)."""
    x_conv, z, conv_state = _mamba1_step_front(x_t, p, conv_state)
    dbc = einsum("bi,ie->be", x_conv, p["x_proj"])
    y, h = _mamba1_step_scan(p, x_conv, z, dbc, h, d_state, dt_rank,
                             x_t.dtype)
    return einsum("bi,id->bd", y, p["out_proj"]), h, conv_state


# The serving mesh (exact mode): column m computes its channels (Mamba1)
# or heads (Mamba2) from its serving view (``MeshParams``: in_proj and
# the Mamba2 conv by segments, ``out_proj`` by output columns, x_proj
# and gate_norm whole). No contraction or norm runs over the split
# d_inner: x_proj's input and the gated outputs are gathered whole
# first, and out_proj's output columns are gathered to the residual.
def _exact_contract(xs: list, w: torch.Tensor, eq: str) -> list:
    """The columns' blocks ``xs`` of d_inner gathered whole on the first
    column's device, contracted there with the whole weight ``w``; the
    product a copy on each column (one column: the mixer whole)."""
    x = gather_columns(xs)
    with on_device(x.device):
        y = einsum(eq, x, w)
    return replicate(y) if len(xs) > 1 else [y]


def _out_columns(yr: list, ps: list, eq: str,
                 whole_out: bool = False) -> torch.Tensor:
    """``out_proj`` column-parallel: column m's output columns of the
    whole gated output ``yr[m]`` (its copy), gathered to (..., D) on the
    first column's device. ``whole_out`` (a D the columns do not
    divide): the first column's whole ``out_proj`` alone."""
    if whole_out:
        yr, ps = yr[:1], ps[:1]
    outs = []
    for y, p in zip(yr, ps):
        with on_device(y.device):
            outs.append(einsum(eq, y, p["out_proj"]))
    return gather_columns(outs)


def _whole_in(ys: list, whole_out: bool) -> list:
    """The columns' gated outputs gathered whole: a copy on each column,
    or on the first column alone for a whole ``out_proj``."""
    y = gather_columns(ys)
    return [y] if whole_out or len(ys) == 1 else replicate(y)


def mamba1_seq_mesh(xs: list, ps: list, d_state: int, dt_rank: int,
                    chunk: int = 128, whole_out: bool = False) -> tuple:
    """Mamba1 prefill over the serving mesh's columns. ``xs[m]``: the
    normed input (B,S,D), column m's copy; ``ps[m]``: its view (one
    column: the mixer whole). ``whole_out``: out_proj whole on the
    first column (``_out_columns``). Returns (y (B,S,D) on the first
    column's device, [(h_T, conv_tail)] of each column's channels)."""
    fronts = []
    for x, p in zip(xs, ps):
        with on_device(x.device):
            fronts.append(_mamba1_front(x, p))
    dbcs = _exact_contract([f[0] for f in fronts], ps[0]["x_proj"],
                           "bsi,ie->bse")
    ys, states = [], []
    for x, p, (x_conv, z, tail), dbc in zip(xs, ps, fronts, dbcs):
        with on_device(x.device):
            dt, B_ssm, C_ssm = _mamba1_dt(dbc, p, d_state, dt_rank,
                                          "bsr,ri->bsi")
            y, h = _mamba1_gated(x, p, x_conv, z, dt, B_ssm, C_ssm,
                                 d_state, chunk, None)
        ys.append(y)
        states.append((h, tail))
    return (_out_columns(_whole_in(ys, whole_out), ps, "bsi,id->bsd",
                         whole_out), states)


def mamba1_step_mesh(xs: list, ps: list, d_state: int, dt_rank: int,
                     hs: list, convs: list, whole_out: bool = False
                     ) -> tuple:
    """``mamba1_step`` over the serving mesh's columns: ``hs[m]``
    (B,Di/M,N) and ``convs[m]`` (B,K-1,Di/M) column m's state. Returns
    (y (B,D) on the first column's device, [(h, conv)] a column)."""
    fronts = []
    for x, p, c in zip(xs, ps, convs):
        with on_device(x.device):
            fronts.append(_mamba1_step_front(x, p, c))
    dbcs = _exact_contract([f[0] for f in fronts], ps[0]["x_proj"],
                           "bi,ie->be")
    ys, states = [], []
    for x, p, (x_conv, z, conv), dbc, h in zip(xs, ps, fronts, dbcs, hs):
        with on_device(x.device):
            y, h = _mamba1_step_scan(p, x_conv, z, dbc, h, d_state,
                                     dt_rank, x.dtype)
        ys.append(y)
        states.append((h, conv))
    return (_out_columns(_whole_in(ys, whole_out), ps, "bi,id->bd",
                         whole_out), states)


# ------------------------------------------------------------- mamba2
def _mamba2_split(zxbcdt: torch.Tensor, d_inner: int, d_state: int,
                  n_heads: int):
    z = zxbcdt[..., :d_inner]
    x = zxbcdt[..., d_inner:2 * d_inner]
    B_ssm = zxbcdt[..., 2 * d_inner:2 * d_inner + d_state]
    C_ssm = zxbcdt[..., 2 * d_inner + d_state:2 * d_inner + 2 * d_state]
    dt = zxbcdt[..., 2 * d_inner + 2 * d_state:]
    return z, x, B_ssm, C_ssm, dt


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B_ssm: torch.Tensor, C_ssm: torch.Tensor, chunk: int,
                h0: torch.Tensor | None = None,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD algorithm (matmul/chunked form).

    xh: (B,T,H,P); dt: (B,T,H); A: (H,) negative; B/C: (B,T,N).
    Returns (y (B,T,H,P), h_T (B,H,P,N)).

    Within each chunk of Q steps the output is a masked (Q x Q)
    matmul; across chunks only the (B,H,P,N) boundary states flow,
    through a loop.
    """
    Bb, T, H, Pd = xh.shape
    N = B_ssm.shape[-1]
    pad = (-T) % chunk
    xh, dt, B_ssm, C_ssm = (_pad_time(a, pad) for a in (xh, dt, B_ssm,
                                                          C_ssm))
    Tp = T + pad
    nc, Q = Tp // chunk, chunk

    def c(a, tail):
        return a.reshape((Bb, nc, Q) + tail)

    xc = c(xh, (H, Pd))
    dtc = c(dt, (H,))
    Bc = c(B_ssm, (N,))
    Cc = c(C_ssm, (N,))
    dA = dtc * A                                   # (B,nc,Q,H), negative
    L = torch.cumsum(dA, dim=2)                    # log-decay from start

    # Intra-chunk: Y[t] = sum_{s<=t} exp(L_t-L_s)·(C_t·B_s)·dt_s·x_s
    # The mask goes into the exponent: JAX multiplies exp(L_t - L_s) by
    # it, and above the diagonal the exponent is positive, so once a
    # chunk's log-decay spread passes 88 exp overflows f32 and inf * 0
    # makes the output NaN. Where JAX is finite the two are equal.
    CB = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)
    ar = torch.arange(Q, device=xh.device)
    mask = (ar[:, None] >= ar[None, :])[None, None, :, :, None]
    ddecay = torch.exp(torch.where(
        mask, L[:, :, :, None, :] - L[:, :, None, :, :],
        torch.full((), float("-inf"), device=xh.device)))
    W = CB[..., None] * ddecay
    del ddecay
    xdt = xc * dtc[..., None]                      # (B,nc,Q,H,P)
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", W, xdt)
    del W

    # Chunk-boundary states.
    decay_to_end = torch.exp(L[:, :, -1:, :] - L)  # (B,nc,Q,H)
    S_c = torch.einsum("bcsn,bcsh,bcshp->bchpn", Bc, decay_to_end, xdt)
    chunk_decay = torch.exp(L[:, :, -1, :])        # (B,nc,H)

    h = (torch.zeros((Bb, H, Pd, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0)
    h_starts = []
    for ci in range(nc):
        h_starts.append(h)
        h = chunk_decay[:, ci][..., None, None] * h + S_c[:, ci]
    h_starts = torch.stack(h_starts, dim=1)        # (B,nc,H,P,N)

    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp",
                           Cc, torch.exp(L), h_starts)
    y = (y_intra + y_inter).reshape(Bb, Tp, H, Pd)
    return y[:, :T], h


def _mamba2_xbc(xbc: torch.Tensor, d_inner: int, d_state: int):
    xs = xbc[..., :d_inner]
    B_ssm = xbc[..., d_inner:d_inner + d_state].float()
    C_ssm = xbc[..., d_inner + d_state:].float()
    return xs, B_ssm, C_ssm


def _mamba2_inputs(x, p, d_state, head_dim, d_inner=None):
    """in_proj, the conv over [x | B | C] and dt: (z, xh (B,S,H,P) f32,
    dt (B,S,H) f32, B f32, C f32). ``d_inner``: the width of z and x in
    ``p``'s in_proj (``out_proj``'s rows by default)."""
    B, S, _ = x.shape
    zxbcdt = einsum("bsd,de->bse", x, p["in_proj"])
    d_inner = d_inner or p["out_proj"].shape[0]
    H = d_inner // head_dim
    z, xs, B_ssm, C_ssm, dt = _mamba2_split(zxbcdt, d_inner, d_state, H)
    xbc = torch.cat([xs, B_ssm, C_ssm], dim=-1)
    xbc = F.silu(causal_conv1d(xbc, p["conv_w"], p["conv_b"]))
    xs, B_ssm, C_ssm = _mamba2_xbc(xbc, d_inner, d_state)
    dt = softplus(dt.float() + p["dt_bias"])                   # (B,S,H)
    xh = xs.reshape(B, S, H, head_dim).float()
    return z, xh, dt, B_ssm, C_ssm


def _mamba2_gated(p, z, xh, dt, B_ssm, C_ssm, chunk, h0):
    """The SSD scan, the skip and the z gate: (y (B,S,Di) f32, h_T)."""
    A = -torch.exp(p["A_log"].float())                         # (H,)
    y, h_last = ssd_chunked(xh, dt, A, B_ssm, C_ssm, chunk, h0)
    y = y + xh * p["ssm_D"][:, None]
    y = y.reshape(z.shape)
    return y * F.silu(z.float()), h_last


def mamba2_seq(x: torch.Tensor, p: dict, d_state: int, head_dim: int,
               chunk: int = 128, h0: torch.Tensor | None = None,
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba2 mixer (SSD chunked form).

    x: (B,S,D). Returns (y (B,S,D), h_T (B,H,P,N)). The gate norm takes
    the default eps 1e-5, as in JAX (not ``cfg.norm_eps``).
    """
    z, xh, dt, B_ssm, C_ssm = _mamba2_inputs(x, p, d_state, head_dim)
    y, h_last = _mamba2_gated(p, z, xh, dt, B_ssm, C_ssm, chunk, h0)
    y = rms_norm(y.to(x.dtype), p["gate_norm"])
    return einsum("bsi,id->bsd", y, p["out_proj"]), h_last


def gate_norm_columns(ys: list, ws: list, width: int,
                      eps: float = 1e-5) -> list:
    """``rms_norm`` over a dimension of ``width`` split over the
    columns: ``ys[m]`` column m's block on its device, ``ws[m]`` its
    block of the weight. The columns' sums of squares are summed
    (``psum_columns``) before each block is scaled; one column is
    ``rms_norm`` itself. In exact mode (the serving mesh, ``ws[m]``
    whole) the blocks are gathered and normed whole, so the reduction
    keeps the single-device order, and each column gets a copy of the
    whole normed output."""
    if len(ys) == 1:
        return [rms_norm(ys[0], ws[0], eps)]
    if exact_reductions():
        y = gather_columns(ys)
        with on_device(y.device):
            return replicate(rms_norm(y, ws[0], eps))
    sq = []
    for y in ys:
        with on_device(y.device):
            y32 = y.float()
            sq.append((y32 * y32).sum(dim=-1, keepdim=True))
    out = []
    for y, w, s in zip(ys, ws, psum_columns(sq)):
        with on_device(y.device):
            y32 = y.float() * torch.rsqrt(s / width + eps)
            out.append((y32 * w.float()).to(y.dtype))
    return out


def mamba2_seq_columns(xs: list, ps: list, d_state: int, head_dim: int,
                       chunk: int = 128) -> list:
    """Mamba2 over "model" columns (the mesh train step). ``xs[m]``: the
    normed input (B,S,D), column m's copy on its device; ``ps[m]``: its
    blocks (``in_proj`` [z_m | x_m | B | C | dt_m], the conv over
    [x_m | B | C], its heads' ``dt_bias``/``A_log``/``ssm_D``, its
    block of ``gate_norm``, ``out_proj`` rows). Each column runs the
    SSD scan over its heads with B and C whole. Returns each column's
    partial ``out_proj`` product (B,S,D), to be summed over the
    columns."""
    ins = []
    for x, p in zip(xs, ps):
        with on_device(x.device):
            ins.append(_mamba2_inputs(x, p, d_state, head_dim))
    dts = constrain_ssm_bth([i[2] for i in ins])
    xhs = constrain_ssm_bthp([i[1] for i in ins])
    ys = []
    for x, p, (z, _, _, B_ssm, C_ssm), xh, dt in zip(xs, ps, ins, xhs,
                                                      dts):
        with on_device(x.device):
            y, _ = _mamba2_gated(p, z, xh, dt, B_ssm, C_ssm, chunk, None)
            ys.append(y.to(x.dtype))
    width = sum(y.shape[-1] for y in ys)
    ys = gate_norm_columns(constrain_ssm_channels(ys),
                           [p["gate_norm"] for p in ps], width)
    return [einsum("bsi,id->bsd", y, p["out_proj"])
            for y, p in zip(ys, ps)]


def _mamba2_step_core(x_t, p, d_state, head_dim, h, conv_state,
                      d_inner=None):
    """One step of Mamba2 up to the gate norm: (y * silu(z) (B,Di) f32,
    h, conv_state). ``d_inner`` as in ``_mamba2_inputs``."""
    B = x_t.shape[0]
    zxbcdt = einsum("bd,de->be", x_t, p["in_proj"])
    d_inner = d_inner or p["out_proj"].shape[0]
    H = d_inner // head_dim
    z, xs, B_ssm, C_ssm, dt = _mamba2_split(zxbcdt, d_inner, d_state, H)
    xbc = torch.cat([xs, B_ssm, C_ssm], dim=-1)
    xbc, conv_state = conv1d_step(xbc, conv_state, p["conv_w"],
                                  p["conv_b"])
    xbc = F.silu(xbc)
    xs, B_ssm, C_ssm = _mamba2_xbc(xbc, d_inner, d_state)
    dt = softplus(dt.float() + p["dt_bias"])                   # (B,H)
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A)                                  # (B,H)
    xh = xs.reshape(B, H, head_dim).float()
    u = (dt[..., None] * xh)[..., None] * B_ssm[:, None, None, :]
    h = decay[..., None, None] * h + u
    y = torch.einsum("bhpn,bn->bhp", h, C_ssm)
    y = y + xh * p["ssm_D"][:, None]
    y = y.reshape(B, d_inner)
    return y * F.silu(z.float()), h, conv_state


def mamba2_step(x_t: torch.Tensor, p: dict, d_state: int, head_dim: int,
                h: torch.Tensor, conv_state: torch.Tensor,
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode step. x_t: (B,D); h: (B,H,P,N); conv_state: (B,K-1,Ci)."""
    y, h, conv_state = _mamba2_step_core(x_t, p, d_state, head_dim, h,
                                         conv_state)
    y = rms_norm(y.to(x_t.dtype), p["gate_norm"])
    return einsum("bi,id->bd", y, p["out_proj"]), h, conv_state


def _column_inner(p: dict, head_dim: int) -> int:
    """A Mamba2 column's share of d_inner: its heads times their width."""
    return p["dt_bias"].shape[-1] * head_dim


def mamba2_seq_mesh(xs: list, ps: list, d_state: int, head_dim: int,
                    chunk: int, d_conv: int, whole_out: bool = False
                    ) -> tuple:
    """Mamba2 prefill over the serving mesh's columns (``xs``/``ps`` as
    in ``mamba1_seq_mesh``): each column's heads through SSD with B and
    C whole, the gate norm over the gathered d_inner
    (``gate_norm_columns``). Returns (y (B,S,D) on the first column's
    device, [(h_T (B,H/M,P,N), conv_tail [x_m | B | C] of the last K-1
    raw inputs)] a column)."""
    ys, states = [], []
    for x, p in zip(xs, ps):
        with on_device(x.device):
            di = _column_inner(p, head_dim)
            z, xh, dt, B_ssm, C_ssm = _mamba2_inputs(x, p, d_state,
                                                     head_dim, di)
            y, h = _mamba2_gated(p, z, xh, dt, B_ssm, C_ssm, chunk, None)
            zx = einsum("bsd,de->bse", x[:, -(d_conv - 1):], p["in_proj"])
        ys.append(y.to(x.dtype))
        states.append((h, zx[..., di:2 * di + 2 * d_state]))
    width = sum(y.shape[-1] for y in ys)
    yr = gate_norm_columns(ys, [p["gate_norm"] for p in ps], width)
    return _out_columns(yr, ps, "bsi,id->bsd", whole_out), states


def mamba2_step_mesh(xs: list, ps: list, d_state: int, head_dim: int,
                     hs: list, convs: list, whole_out: bool = False
                     ) -> tuple:
    """``mamba2_step`` over the serving mesh's columns: ``hs[m]``
    (B,H/M,P,N) and ``convs[m]`` (B,K-1,[x_m | B | C]) column m's state.
    Returns (y (B,D) on the first column's device, [(h, conv)] a
    column)."""
    ys, states = [], []
    for x, p, h, c in zip(xs, ps, hs, convs):
        with on_device(x.device):
            y, h, c = _mamba2_step_core(x, p, d_state, head_dim, h, c,
                                        _column_inner(p, head_dim))
        ys.append(y.to(x.dtype))
        states.append((h, c))
    width = sum(y.shape[-1] for y in ys)
    yr = gate_norm_columns(ys, [p["gate_norm"] for p in ps], width)
    return _out_columns(yr, ps, "bi,id->bd", whole_out), states
