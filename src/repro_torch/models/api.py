"""Family dispatcher: the paged serving surface of the port.

Port of the paged subset of ``src/repro/models/api.py`` with the same
gates: fused decode covers the dense and MoE families, paged KV the
dense family; the port implements the dense family (the MoE superstep
path is not ported yet, so its fused entry points raise).
"""
from __future__ import annotations

import torch

from . import lm
from .base import Family, ModelConfig
from .lm import init_params  # shared: param_shapes covers every family
from .lm import sample_tokens  # family-agnostic: operates on logits


def supports_fused(cfg: ModelConfig) -> bool:
    """Families servable by the fused decode+sample horizon loop
    (the JAX gate: dense decoder LMs and MoE)."""
    return cfg.family in (Family.DENSE, Family.MOE)


def supports_paged(cfg: ModelConfig) -> bool:
    """Families whose decode can run over a paged KV pool: dense
    decoder LMs (the JAX gate)."""
    return cfg.family == Family.DENSE


def decode_fused_paged(cfg, params, tokens, kv_pages, page_table,
                       cache_len, active, positions, budget, stop_ids,
                       temperature, top_k, top_p, seeds, **kw):
    """K fused decode+sample steps over paged KV, state on device."""
    if not (supports_fused(cfg) and supports_paged(cfg)):
        raise NotImplementedError(
            f"fused paged decode unsupported for family {cfg.family}")
    return lm.decode_fused_paged(cfg, params, tokens, kv_pages,
                                 page_table, cache_len, active,
                                 positions, budget, stop_ids,
                                 temperature, top_k, top_p, seeds, **kw)


def init_paged_serve_state(cfg: ModelConfig, n_pages: int, page_size: int,
                           dtype=torch.bfloat16,
                           device: torch.device | str | None = None):
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"paged KV unsupported for family {cfg.family}")
    return lm.make_paged_kv(cfg, n_pages, page_size, dtype, device)


def decode_step_paged(cfg, params, tokens, kv_pages, page_table,
                      cache_len, **kw):
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"paged KV unsupported for family {cfg.family}")
    return lm.decode_step_paged(cfg, params, tokens, kv_pages,
                                page_table, cache_len, **kw)


def prefill_paged(cfg, params, tokens, kv_pages, page_table, start,
                  seq_len, **kw):
    """Suffix prefill into paged KV (prefix-cache hits skip the cached
    prefix; see lm.prefill_paged). Paged families only."""
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"paged KV unsupported for family {cfg.family}")
    return lm.prefill_paged(cfg, params, tokens, kv_pages, page_table,
                            start, seq_len, **kw)


__all__ = ["supports_fused", "supports_paged", "init_params",
           "sample_tokens", "decode_fused_paged", "init_paged_serve_state",
           "decode_step_paged", "prefill_paged"]
