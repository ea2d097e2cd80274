"""Falcon-Mamba-style attention-free LM: a Mamba1 stack (PyTorch).

Port of ``src/repro/models/ssm_lm.py``; the JAX scan over the layer
stack is a loop over the layer index. The serve state is O(1) in
sequence length: per layer (ssm_state (B,Di,N) f32, conv_state
(B,K-1,Di)), stacked on a leading layer axis. ``decode_step`` returns
new state stacks; the state it is given is left as it was.

On a placed train state (``sharding.device_put`` with the train rule
table) ``forward`` and ``train_loss`` run sharded, as ``lm``'s mesh
train path does: each layer's mixer over the "model" columns
(``ssm.mamba1_seq_columns``; ``_mixer_train``, which the hybrid's
Mamba2 layers share), its output row-parallel.

On serving ``MeshParams`` ``prefill`` and ``decode_step`` run each
layer's mixer over the "model" columns in exact mode
(``ssm.mamba1_seq_mesh``, ``mamba1_step_mesh``: x_proj after the
channels' gather, out_proj column-parallel), each batch row of
positions on its rows (``act_sharding.row_spans``); the state comes
back placed, ssm over ``ssm_state_spec`` and conv over
``conv_state_spec`` (batch over the batch axes, channels over
"model").
"""
from __future__ import annotations

import torch

from repro_torch.device import on_device, resolve_device
from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed.sharding import (MeshParams, NamedSharding,
                                              TrainView, all_gather,
                                              assemble, conv_state_spec,
                                              ssm_state_spec)
from repro_torch.models.base import ModelConfig
from repro_torch.models.layers import cross_entropy, embed, rms_norm
from repro_torch.models.lm import (_embed_mesh, _embed_train,
                                   _head, _head_train, _heads, _logits,
                                   _mesh_calls, _mesh_scope, _placed,
                                   _slice_group, mesh_forward,
                                   mesh_train_loss, remat_rows, row_box)
from repro_torch.models.ssm import (mamba1_seq, mamba1_seq_columns,
                                    mamba1_seq_mesh, mamba1_step,
                                    mamba1_step_mesh, mamba2_seq_columns)
from repro_torch.models.remat import remat

_SSM_LEAVES = ("ssm_norm", "in_proj", "conv_w", "conv_b", "x_proj",
               "dt_proj", "dt_bias", "A_log", "ssm_D", "gate_norm",
               "out_proj")


def _layers(cfg: ModelConfig, params: dict):
    stack = _slice_group(params, "layers/")
    for i in range(cfg.n_layers):
        yield {k: v[i] for k, v in stack.items()}


def _seq(cfg: ModelConfig, params: dict, tokens, need_state: bool):
    """The layer stack over a whole sequence: (hidden, (ssm, conv)
    stacks or None)."""
    x = embed(tokens, params["embed/tok"])
    ssm, conv = [], []
    for p in _layers(cfg, params):

        def layer(x, p=p):
            y, h_last, conv_tail = mamba1_seq(
                rms_norm(x, p["ssm_norm"], cfg.norm_eps), p, cfg.d_state,
                cfg.dt_rank, cfg.ssm_chunk)
            return x + y, h_last, conv_tail

        x, h_last, conv_tail = remat(layer, x, on=cfg.remat)
        if need_state:
            ssm.append(h_last)
            conv.append(conv_tail)
    return x, ((torch.stack(ssm), torch.stack(conv)) if need_state
               else None)


def forward(cfg: ModelConfig, params: dict, tokens,
            mrope_pos=None) -> torch.Tensor:
    """Full-sequence logits (B, S, V) f32."""
    if _placed(params):
        tv = TrainView(cfg, params)
        return mesh_forward(tv, lambda: _logits_mesh(cfg, tv, tokens))
    x, _ = _seq(cfg, params, tokens, need_state=False)
    return _logits(cfg, params, x)


def train_loss(cfg, params, tokens, labels, mrope_pos=None,
               aux_weight=0.0) -> torch.Tensor:
    if _placed(params):
        tv = TrainView(cfg, params)
        return mesh_train_loss(tv, lambda: _logits_mesh(cfg, tv, tokens),
                               labels)
    return cross_entropy(forward(cfg, params, tokens), labels)


def _mixer_train(cfg: ModelConfig, tv: TrainView, hb: list, b: int,
                 i: int) -> list:
    """SSM layer ``i`` (norm, mixer, residual) of batch shard ``b``:
    ``hb`` its residual stream (``act_sharding.residual_in``); a whole
    mixer on the first column alone."""
    xs, ps = [], []
    for m, x in enumerate(acts.columns_in(hb,
                                          tv.rows[b][:tv.n_cols("mixer")])):
        with on_device(x.device):
            p = tv.layer(i, b, m, _SSM_LEAVES)
            xs.append(rms_norm(x, p["ssm_norm"], cfg.norm_eps))
            ps.append(p)
    if cfg.ssm_version == 1:
        parts = mamba1_seq_columns(xs, ps, cfg.d_state, cfg.dt_rank,
                                   cfg.ssm_chunk)
    else:
        parts = mamba2_seq_columns(xs, ps, cfg.d_state, cfg.ssm_head_dim,
                                   cfg.ssm_chunk)
    return acts.residual_add(hb, parts, tv.rows[b])


def _logits_mesh(cfg: ModelConfig, tv: TrainView, tokens):
    """([batch shard][column] f32 logits, None) on a placed state."""
    h = _embed_train(tv, acts.batch_shards(tokens))
    for i in range(cfg.n_layers):
        h, _ = remat_rows(lambda h, i=i: (
            [_mixer_train(cfg, tv, hb, b, i) for b, hb in enumerate(h)],
            None), h, cfg.remat)
    return _head_train(cfg, tv, h), None


def init_serve_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device: torch.device | str | None = None):
    """(ssm (L,B,Di,N) f32, conv (L,B,K-1,Di) in ``dtype``), zeroed."""
    dev = resolve_device(device)
    L = cfg.n_layers
    ssm = torch.zeros((L, batch, cfg.d_inner, cfg.d_state),
                      dtype=torch.float32, device=dev)
    conv = torch.zeros((L, batch, cfg.d_conv - 1, cfg.d_inner),
                       dtype=dtype, device=dev)
    return ssm, conv


def prefill(cfg: ModelConfig, params: dict, tokens, lora=None,
            adapter_idx=None, lora_backend: str = "einsum"):
    """Returns (last logits (B,V), (ssm_states, conv_states)). The
    family has no attention projections, so ``lora`` is ignored, as in
    JAX."""
    if isinstance(params, MeshParams):
        return _serve_mesh(cfg, params, tokens)
    x, state = _seq(cfg, params, tokens, need_state=True)
    return _head(cfg, params, x[:, -1:]), state


def decode_step(cfg: ModelConfig, params: dict, tokens, state,
                cache_len=None, lora=None, adapter_idx=None,
                lora_backend: str = "einsum"):
    """tokens (B,1); state = (ssm (L,B,Di,N), conv (L,B,K-1,Di)).
    ``cache_len`` is ignored: the state carries the position. Returns
    (logits (B,V) f32, new (ssm, conv) stacks)."""
    if isinstance(params, MeshParams):
        return _serve_mesh(cfg, params, tokens, state)
    ssm, conv = state
    x = embed(tokens, params["embed/tok"])[:, 0]          # (B,D)
    new_ssm, new_conv = [], []
    for i, p in enumerate(_layers(cfg, params)):
        y, s, c = mamba1_step(rms_norm(x, p["ssm_norm"], cfg.norm_eps), p,
                              cfg.d_state, cfg.dt_rank, ssm[i], conv[i])
        x = x + y
        new_ssm.append(s)
        new_conv.append(c)
    logits = _head(cfg, params, x[:, None])
    return logits, (torch.stack(new_ssm), torch.stack(new_conv))


# ------------------------------------------------- serving on a mesh
def mixer_columns(cfg: ModelConfig, call, h, ps: list, state=None):
    """One SSM layer's mixer and residual for a batch row on its columns
    (``ps[m]``: column m's layer view; one column, the first, when the
    mixer is whole): the whole-sequence mixer, or with ``state`` (the
    columns' (ssm, conv) of this layer) one decode step. Returns
    (h + y, [(ssm, conv)] a computing column)."""
    xs = [rms_norm(x, p["ssm_norm"], cfg.norm_eps)
          for x, p in zip(call.ins(h, "mixer"), ps)]
    ps = ps[:len(xs)]
    out = "out" in call.mp.whole
    if cfg.ssm_version == 1 and state is None:
        y, st = mamba1_seq_mesh(xs, ps, cfg.d_state, cfg.dt_rank,
                                cfg.ssm_chunk, out)
    elif cfg.ssm_version == 1:
        y, st = mamba1_step_mesh(xs, ps, cfg.d_state, cfg.dt_rank,
                                 *zip(*state), out)
    else:
        from repro_torch.models import ssm
        if state is None:
            y, st = ssm.mamba2_seq_mesh(xs, ps, cfg.d_state,
                                        cfg.ssm_head_dim, cfg.ssm_chunk,
                                        cfg.d_conv, out)
        else:
            y, st = ssm.mamba2_step_mesh(xs, ps, cfg.d_state,
                                         cfg.ssm_head_dim, *zip(*state),
                                         out)
    return h + y, st


def _serve_mesh(cfg: ModelConfig, mp: MeshParams, tokens, state=None):
    """``prefill`` (``state`` None) or ``decode_step`` on the mesh: each
    batch row's rows through every layer's mixer on its columns (column
    m: channels [m Di/M, (m+1) Di/M); the first column alone, every
    channel, when the mixer is whole); the state read from and returned
    as placed stacks."""
    with _mesh_scope(mp):
        B = tokens.shape[0]
        calls = _mesh_calls(mp, None, B)
        M = mp.n_cols("mixer")
        w = cfg.d_inner // M
        hs, reads = [], []
        for call in calls:
            with call.scope():
                x = _embed_mesh(call, call.rows(tokens))
            hs.append(x if state is None else x[:, 0])
            if state is not None:
                ssm, conv = state
                reads.append([(
                    all_gather(ssm, (slice(None), slice(call.lo, call.hi),
                                      slice(m * w, (m + 1) * w)), dev),
                    all_gather(conv, (slice(None), slice(call.lo, call.hi),
                                       slice(None),
                                       slice(m * w, (m + 1) * w)), dev))
                    for m, dev in enumerate(call.devices[:M])])
        new = [[[] for _ in range(M)] for _ in calls]
        for i in range(cfg.n_layers):
            for r, call in enumerate(calls):
                with call.scope():
                    ps = [{k: v[i] for k, v in st.items()}
                          for st in call.stacks]
                    hs[r], st = mixer_columns(
                        cfg, call, hs[r], ps,
                        None if state is None else
                        [(s_[i], c_[i]) for s_, c_ in reads[r]])
                for m, pair in enumerate(st):
                    new[r][m].append(pair)
        logits = _heads(mp, calls, [h[:, -1:] if state is None
                                    else h[:, None] for h in hs])
        return logits, place_ssm_state(cfg, mp, calls, new, B)


def place_ssm_state(cfg: ModelConfig, mp: MeshParams, calls: list,
                    new: list, B: int, dims=None) -> tuple:
    """The rows' columns' (ssm, conv) of every layer (``new[r][m]``: a
    list a layer) as placed stacks: ssm (L, B, Di, N) — Mamba2 (L, B,
    H, P, N) — over ``ssm_state_spec``, conv (L, B, K-1, C) over
    ``conv_state_spec``; column m holds its block of channels or heads,
    a Mamba2 conv its segments' ranges (``sharding.column_segments``);
    a whole mixer's first column holds all of them."""
    from repro_torch.distributed.sharding import (column_segments,
                                                  ssm_segments)
    M = mp.n_cols("mixer")
    ssm = [[torch.stack([p[0] for p in col]) for col in row] for row in new]
    conv = [[torch.stack([p[1] for p in col]) for col in row] for row in new]
    one = ssm[0][0].shape
    sshape = (one[0], B, one[2] * M) + tuple(one[3:])
    cshape = (conv[0][0].shape[0], B, conv[0][0].shape[2],
              cfg.d_inner + (2 * cfg.d_state if cfg.ssm_version == 2
                             else 0))
    w = sshape[2] // M
    spieces, cpieces = [], []
    segs = ssm_segments(cfg, "conv_w") or [(0, cfg.d_inner, True)]
    for r, call in enumerate(calls):
        for m in range(M):
            spieces.append((row_box(sshape, call, 2, m * w, (m + 1) * w),
                            ssm[r][m]))
            off = 0
            for lo, hi in column_segments(segs, m, M):
                cpieces.append((row_box(cshape, call, 3, lo, hi),
                                conv[r][m][..., off:off + hi - lo]))
                off += hi - lo
    return (assemble(NamedSharding(mp.mesh, ssm_state_spec(mp.mesh, sshape)),
                     sshape, spieces),
            assemble(NamedSharding(mp.mesh, conv_state_spec(mp.mesh,
                                                            cshape)),
                     cshape, cpieces))
