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
"""
from __future__ import annotations

import torch

from repro_torch.device import on_device, resolve_device
from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed.sharding import TrainView
from repro_torch.models.base import ModelConfig
from repro_torch.models.layers import cross_entropy, embed, rms_norm
from repro_torch.models.lm import (_embed_train, _head, _head_train,
                                   _logits, _placed, _slice_group,
                                   mesh_forward, mesh_train_loss)
from repro_torch.models.ssm import (mamba1_seq, mamba1_seq_columns,
                                    mamba1_step, mamba2_seq_columns)

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
        y, h_last, conv_tail = mamba1_seq(
            rms_norm(x, p["ssm_norm"], cfg.norm_eps), p, cfg.d_state,
            cfg.dt_rank, cfg.ssm_chunk)
        x = x + y
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
    ``hb`` its residual stream, a copy on each column's device."""
    xs, ps = [], []
    for m, x in enumerate(hb):
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
    return [x + y for x, y in zip(hb, acts.psum_columns(parts))]


def _logits_mesh(cfg: ModelConfig, tv: TrainView, tokens):
    """([batch shard][column] f32 logits, None) on a placed state."""
    h = _embed_train(tv, acts.batch_shards(tokens))
    for i in range(cfg.n_layers):
        h = [_mixer_train(cfg, tv, hb, b, i) for b, hb in enumerate(h)]
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
    x, state = _seq(cfg, params, tokens, need_state=True)
    return _head(cfg, params, x[:, -1:]), state


def decode_step(cfg: ModelConfig, params: dict, tokens, state,
                cache_len=None, lora=None, adapter_idx=None,
                lora_backend: str = "einsum"):
    """tokens (B,1); state = (ssm (L,B,Di,N), conv (L,B,K-1,Di)).
    ``cache_len`` is ignored: the state carries the position. Returns
    (logits (B,V) f32, new (ssm, conv) stacks)."""
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
