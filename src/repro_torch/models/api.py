"""Family dispatcher: the model surface of the port.

Port of ``src/repro/models/api.py``. ``forward``, ``train_loss``,
``prefill``, ``decode_step`` and ``init_serve_state`` take every family
with the JAX signatures: the decoder-only families (dense, MoE, VLM)
through ``lm``, SSM through ``ssm_lm`` (``decode_step`` ignores
``cache_len``), hybrid through ``hybrid`` and enc-dec through
``encdec``. The gates are JAX's: fused decode covers the dense and MoE
families, paged KV the dense family. ``verify`` and the speculative
scans raise ``NotImplementedError`` for MoE: the reference's
``lm.verify`` runs the dense MLP on every layer and fails on an MoE
model, so the port ports it for the dense family only.
"""
from __future__ import annotations

import torch

from . import encdec, hybrid, lm, ssm_lm
from .base import Family, ModelConfig
from .lm import init_params  # shared: param_shapes covers every family
from .lm import sample_tokens  # family-agnostic: operates on logits


def _mod(cfg: ModelConfig):
    if cfg.family == Family.SSM:
        return ssm_lm
    if cfg.family == Family.HYBRID:
        return hybrid
    if cfg.family == Family.ENCDEC:
        return encdec
    return lm


def _dense_only(cfg: ModelConfig, what: str) -> None:
    if cfg.family != Family.DENSE:
        raise NotImplementedError(
            f"{what} is ported for the DENSE family only, not family "
            f"{cfg.family.name}" + (
                " (no MoE verify: the reference's lm.verify runs the "
                "dense MLP on every layer)" if cfg.family == Family.MOE
                else ""))


def forward(cfg, params, tokens, **kw):
    """Full-sequence logits (B, S, V) f32 (enc-dec: ``frames=``)."""
    return _mod(cfg).forward(cfg, params, tokens, **kw)


def train_loss(cfg, params, tokens, labels, **kw):
    """Mean next-token NLL (+ the MoE aux term for ``lm``)."""
    return _mod(cfg).train_loss(cfg, params, tokens, labels, **kw)


def prefill(cfg, params, tokens, **kw):
    """Whole-prompt prefill: (last-position logits, the family's serve
    state)."""
    return _mod(cfg).prefill(cfg, params, tokens, **kw)


def decode_step(cfg, params, tokens, state, cache_len=None, **kw):
    """One decode step over the family's serve state. KV slabs (every
    family but SSM) are written in place."""
    m = _mod(cfg)
    if cfg.family == Family.SSM:
        return m.decode_step(cfg, params, tokens, state, **kw)
    return m.decode_step(cfg, params, tokens, state, cache_len, **kw)


def init_serve_state(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16,
                     device: torch.device | str | None = None):
    """The family's zeroed serve state: the dense KV slab
    (L, batch, max_len, Kh, Dh) ×2 for the decoder-only families; SSM
    (ssm, conv); hybrid (ssm, conv, (k, v)); enc-dec ((k, v), (kx, vx))
    with cross K/V over ``enc_ctx`` frames. Where JAX returns one zero
    array twice (enc-dec), the port returns two tensors, since decode
    writes them in place."""
    if cfg.family == Family.SSM:
        return ssm_lm.init_serve_state(cfg, batch, dtype, device)
    if cfg.family == Family.HYBRID:
        return hybrid.init_serve_state(cfg, batch, max_len, dtype, device)
    if cfg.family == Family.ENCDEC:
        kv = lm.make_kv_caches(cfg, batch, max_len, dtype, device)
        shape = (cfg.n_layers, batch, cfg.enc_ctx, cfg.n_kv_heads,
                 cfg.head_dim)
        dev = kv[0].device
        return (kv, (torch.zeros(shape, dtype=dtype, device=dev),
                     torch.zeros(shape, dtype=dtype, device=dev)))
    return lm.make_kv_caches(cfg, batch, max_len, dtype, device)


def supports_fused(cfg: ModelConfig) -> bool:
    """Families servable by the fused decode+sample horizon loop
    (the JAX gate: dense decoder LMs and MoE)."""
    return cfg.family in (Family.DENSE, Family.MOE)


def supports_paged(cfg: ModelConfig) -> bool:
    """Families whose decode can run over a paged KV pool: dense
    decoder LMs (the JAX gate)."""
    return cfg.family == Family.DENSE


def decode_fused(cfg, params, tokens, kv_caches, cache_len, active,
                 positions, budget, stop_ids, temperature, top_k, top_p,
                 seeds, **kw):
    """K fused decode+sample steps over the dense KV slab, state on
    device (``lm.decode_fused``)."""
    if not supports_fused(cfg):
        raise NotImplementedError(
            f"fused decode unsupported for family {cfg.family}")
    return lm.decode_fused(cfg, params, tokens, kv_caches, cache_len,
                           active, positions, budget, stop_ids,
                           temperature, top_k, top_p, seeds, **kw)


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


# --------------------------------------------- speculative draft–verify
def supports_spec_draft(cfg: ModelConfig) -> bool:
    """Families usable as the *draft* model of speculative decoding:
    the draft runs chained ``lm.decode_step``s on a dense KV slab, so
    dense decoder LMs only (the JAX gate). The target also needs
    ``supports_fused``."""
    return cfg.family == Family.DENSE


def verify(cfg, params, tokens, kv_caches, cache_len, **kw):
    """Multi-token target pass over dense KV returning all-position
    logits (B, S, V): the verify half of speculative decoding."""
    if not supports_fused(cfg):
        raise NotImplementedError(
            f"verify forward unsupported for family {cfg.family}")
    _dense_only(cfg, "verify")
    return lm.verify(cfg, params, tokens, kv_caches, cache_len, **kw)


def verify_paged(cfg, params, tokens, kv_pages, page_table, cache_len,
                 **kw):
    """Multi-token target pass over paged KV (all-position logits)."""
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"paged verify unsupported for family {cfg.family}")
    return lm.verify_paged(cfg, params, tokens, kv_pages, page_table,
                           cache_len, **kw)


def _spec_gate(cfg: ModelConfig, draft_cfg: ModelConfig,
               paged: bool) -> None:
    if not supports_fused(cfg) or (paged and not supports_paged(cfg)):
        raise NotImplementedError(
            f"speculative {'paged ' if paged else ''}decode unsupported "
            f"for target family {cfg.family}")
    if not supports_spec_draft(draft_cfg):
        raise NotImplementedError(
            f"speculative draft unsupported for family {draft_cfg.family}")
    _dense_only(cfg, "speculative decode")


def decode_spec_fused(cfg, params, draft_cfg, draft_params, tokens,
                      kv_caches, draft_kv, cache_len, active, positions,
                      budget, stop_ids, temperature, top_k, top_p, seeds,
                      **kw):
    """Fused speculative decode over dense KV: draft–verify rounds with
    on-device acceptance (``lm._spec_decode_scan``)."""
    _spec_gate(cfg, draft_cfg, paged=False)
    return lm.decode_spec_fused(cfg, params, draft_cfg, draft_params,
                                tokens, kv_caches, draft_kv, cache_len,
                                active, positions, budget, stop_ids,
                                temperature, top_k, top_p, seeds, **kw)


def decode_spec_fused_paged(cfg, params, draft_cfg, draft_params, tokens,
                            kv_pages, page_table, draft_kv, cache_len,
                            active, positions, budget, stop_ids,
                            temperature, top_k, top_p, seeds, **kw):
    """Fused speculative decode with the target on paged KV."""
    _spec_gate(cfg, draft_cfg, paged=True)
    return lm.decode_spec_fused_paged(cfg, params, draft_cfg,
                                      draft_params, tokens, kv_pages,
                                      page_table, draft_kv, cache_len,
                                      active, positions, budget, stop_ids,
                                      temperature, top_k, top_p, seeds,
                                      **kw)


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
           "sample_tokens", "forward", "train_loss", "prefill",
           "decode_step",
           "decode_fused", "init_serve_state", "decode_fused_paged",
           "init_paged_serve_state", "decode_step_paged", "prefill_paged",
           "supports_spec_draft", "verify", "verify_paged",
           "decode_spec_fused", "decode_spec_fused_paged"]
