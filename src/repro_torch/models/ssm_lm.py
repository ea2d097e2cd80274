"""Falcon-Mamba-style attention-free LM: a Mamba1 stack (PyTorch).

Port of ``src/repro/models/ssm_lm.py``; the JAX scan over the layer
stack is a loop over the layer index. The serve state is O(1) in
sequence length: per layer (ssm_state (B,Di,N) f32, conv_state
(B,K-1,Di)), stacked on a leading layer axis. ``decode_step`` returns
new state stacks; the state it is given is left as it was.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.base import ModelConfig
from repro_torch.models.layers import cross_entropy, embed, rms_norm
from repro_torch.models.lm import _head, _logits, _slice_group
from repro_torch.models.ssm import mamba1_seq, mamba1_step


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
    x, _ = _seq(cfg, params, tokens, need_state=False)
    return _logits(cfg, params, x)


def train_loss(cfg, params, tokens, labels, mrope_pos=None,
               aux_weight=0.0) -> torch.Tensor:
    return cross_entropy(forward(cfg, params, tokens), labels)


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
