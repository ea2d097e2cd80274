"""Decoder-only LM: dense, MoE and VLM families (PyTorch).

Port of the serving subset of ``src/repro/models/lm.py`` and its
``train_loss`` (cross-entropy plus the MoE aux term): the
whole-sequence ``forward`` and ``prefill`` (attention through the
flash_attention kernel) and decode over the dense slab
(``decode_step``, ``decode_fused``) for the dense, MoE (supersteps of
``moe_every`` layers, the last one MoE; ``models/moe.py``) and VLM
(M-RoPE positions) families; for the dense family also decode over the
paged pool (``prefill_paged``, ``decode_step_paged``,
``decode_fused_paged``) and speculative draft–verify decoding on either
(``verify``, ``verify_paged``, ``decode_spec_fused``,
``decode_spec_fused_paged``), seeded rows on JAX's own threefry
streams. Parameters are a *flat*
dict {path: tensor} (see base.param_shapes) with per-layer tensors
stacked on axis 0; the JAX ``lax.scan`` over that stack becomes a
Python loop over the layer index, and the K-step decode scan a loop
whose state stays on the device.

Unlike the JAX functions, which return fresh KV arrays, the port writes
the new K/V into the given slab or page tensors *in place* (the JAX
engine donates them, so the effect is the same) and returns those
tensors.

Out-of-range gathers: JAX clamps ``x[i, j]`` and fills
``take_along_axis`` where PyTorch raises, so page-table lookups clamp
their block index to the table before gathering, then mask exactly as
the JAX code does.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.sampling import (SPEC_ACCEPT_FOLD, SPEC_DRAFT_FOLD,
                                       SPEC_RESIDUAL_FOLD)
from repro_torch.device import on_device, resolve_device
from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed.sharding import (MeshParams, ShardedTensor,
                                              TrainView)
from repro_torch.kernels.ops import flash_attention, paged_attention
from repro_torch.models.base import Family, ModelConfig, param_shapes
from repro_torch.models.layers import (apply_rope, cross_entropy,
                                       cross_entropy_columns,
                                       decode_attention, einsum, embed,
                                       embed_rows, embed_sharded, gelu_mlp,
                                       head_rms_norm,
                                       mrope_cos_sin, rms_norm, rope_cos_sin,
                                       suffix_attention, swiglu, unembed)
from repro_torch.models.lora_apply import lora_delta
from repro_torch.models.moe import (moe_block, moe_block_gather,
                                    moe_block_train)
from repro_torch.models.moe_shard_map import moe_block_a2a


# ----------------------------------------------------------------- init
def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device: torch.device | str | None = None
                ) -> dict[str, torch.Tensor]:
    """Random weights from a seeded ``torch.Generator`` on ``device``.

    Same leaf rules as the JAX ``init_params`` (norms one, biases zero,
    matrices N(0, 1/fan_in)); the numbers differ, since the generators
    do. Stacked tensors are drawn one layer at a time, so the f32 draw
    never holds more than one layer.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params: dict[str, torch.Tensor] = {}

    def draw(shape, fn):
        out = torch.empty(shape, dtype=dtype, device=dev)
        if len(shape) >= 3:
            for i in range(shape[0]):
                out[i] = fn(shape[1:])
        else:
            out.copy_(fn(shape))
        return out

    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    for path, shape in sorted(param_shapes(cfg).items()):
        leaf = path.split("/")[-1]
        if "norm" in leaf:
            params[path] = torch.ones(shape, dtype=dtype, device=dev)
        elif leaf in ("A_log",):
            params[path] = torch.log(uniform(shape, 1.0, 16.0))
        elif leaf in ("ssm_D",):
            params[path] = torch.ones(shape, dtype=torch.float32, device=dev)
        elif leaf in ("dt_bias",):
            params[path] = torch.log(torch.expm1(uniform(shape, 1e-3, 1e-1)))
        elif leaf.endswith("_bias") or leaf in ("conv_b",):
            params[path] = torch.zeros(shape, dtype=dtype, device=dev)
        elif leaf in ("enc_pos", "dec_pos"):
            params[path] = draw(shape, lambda s: 0.02 * normal(s))
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            std = fan_in ** -0.5
            params[path] = draw(shape, lambda s, std=std: std * normal(s))
    return params


# ------------------------------------------------------------ attention
def _qkv_proj(cfg: ModelConfig, x: torch.Tensor, p: dict, cos, sin,
              lora=None, adapter_idx=None, prefix: str = "",
              lora_backend: str = "einsum"):
    """Normed q/k/v projections (+bias, +LoRA, +qk-norm, +RoPE unless
    ``cos`` is None: learned positions).

    Returns (h, q, k, v) with q (B,S,H,Dh), k/v (B,S,Kh,Dh); ``h`` is the
    post-norm hidden.
    """
    B, S, _ = x.shape
    h = rms_norm(x, p[prefix + "attn_norm"], cfg.norm_eps)

    def proj(name):
        y = einsum("bsd,de->bse", h, p[prefix + name])
        if cfg.qkv_bias and prefix + name + "_bias" in p:
            y = y + p[prefix + name + "_bias"]
        if lora is not None and name in lora:
            y = y + lora_delta(h, lora[name], adapter_idx,
                               backend=lora_backend)
        return y

    q = proj("q").reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = proj("k").reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = proj("v").reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = head_rms_norm(q, p[prefix + "q_norm"], cfg.norm_eps)
        k = head_rms_norm(k, p[prefix + "k_norm"], cfg.norm_eps)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return h, q, k, v


def _o_proj(cfg: ModelConfig, x: torch.Tensor, out: torch.Tensor, p: dict,
            lora=None, adapter_idx=None, prefix: str = "",
            lora_backend: str = "einsum") -> torch.Tensor:
    """Output projection + LoRA + residual. out: (B, S, q_dim)."""
    o = einsum("bse,ed->bsd", out, p[prefix + "o"])
    if lora is not None and "o" in lora:
        o = o + lora_delta(out, lora["o"], adapter_idx,
                           backend=lora_backend)
    return x + o


def _slab_write(kv_cache, new_kv, pos: torch.Tensor,
                keep: torch.Tensor) -> None:
    """Write (k, v) (B, S, Kh, Dh) into the slabs (B, Smax, Kh, Dh) at
    positions ``pos`` (B, S) where ``keep``; elsewhere the slot keeps its
    old value, as JAX's ``.at[].set(mode="drop")`` drops the write. A
    dropped position past the slab wraps to ``pos % Smax``: a row's
    kept positions are one run below Smax and its dropped ones lie
    after it, so no two writes of a call share a slot (S <= Smax) and
    the result does not depend on the order of the writes."""
    Smax = kv_cache[0].shape[1]
    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    idx = pos % Smax
    keep = keep[:, :, None, None]
    for cache, new in zip(kv_cache, new_kv):
        cache[rows, idx] = torch.where(keep, new.to(cache.dtype),
                                       cache[rows, idx])


def _attn(cfg: ModelConfig, x: torch.Tensor, p: dict, cos, sin,
          kv_cache=None, cache_len=None, lora=None, adapter_idx=None,
          lora_backend: str = "einsum"):
    """Attention block over the whole sequence or the dense KV slab.

    Without a cache (prefill, forward) the fresh q/k/v go through
    ``kernels.ops.flash_attention`` with the causal mask (the CUDA
    kernel on the card, its plain version on the CPU) and the fresh
    (k, v) are returned. With ``kv_cache`` = this layer's (k, v) slabs
    (B, Smax, Kh, Dh) the decode token's K/V are written in place at
    ``cache_len`` and attention runs over the slab up to
    ``cache_len + S``. A write past the slab's end is dropped, as JAX's
    ``.at[].set`` drops it: the slot keeps its old value.
    Returns (x + attention output, new_kv).
    """
    B, S, _ = x.shape
    _, q, k, v = _qkv_proj(cfg, x, p, cos, sin, lora, adapter_idx,
                           lora_backend=lora_backend)
    if kv_cache is None:
        out = flash_attention(q, k, v, causal=True)
        new_kv = (k, v)
    else:
        k_cache, v_cache = kv_cache
        pos = (cache_len.long()[:, None]
               + torch.arange(S, device=x.device)[None, :])
        _slab_write(kv_cache, (k, v), pos, pos < k_cache.shape[1])
        # An f32 slab promotes the attention output; keep the activation
        # dtype, as the paged path does (a no-op for f32 weights).
        out = decode_attention(q, k_cache, v_cache,
                               cache_len + S).to(q.dtype)
        new_kv = (k_cache, v_cache)
    out = out.reshape(B, S, cfg.q_dim)
    return _o_proj(cfg, x, out, p, lora, adapter_idx,
                   lora_backend=lora_backend), new_kv


def _attn_paged(cfg: ModelConfig, x: torch.Tensor, p: dict, cos, sin,
                k_pages: torch.Tensor, v_pages: torch.Tensor,
                page_table: torch.Tensor, cache_len: torch.Tensor,
                page_idx: torch.Tensor, page_off: torch.Tensor,
                lora=None, adapter_idx=None,
                lora_backend: str = "einsum") -> torch.Tensor:
    """Decode attention over paged KV (one layer; S == 1).

    k/v_pages: (n_pages, page, Kh, Dh) of this layer; page_idx/page_off:
    (B,) write position of the new token. The fresh K/V is written into
    the pages in place, then attention runs over the request's page
    list through ``kernels.ops.paged_attention`` (the CUDA kernel on the
    card, its plain PyTorch version on the CPU). Requests never share a written
    page; inactive slots all write the reserved trash page 0.
    """
    B, S, _ = x.shape
    _, q, k, v = _qkv_proj(cfg, x, p, cos, sin, lora, adapter_idx,
                           lora_backend=lora_backend)
    k_pages[page_idx, page_off] = k[:, 0].to(k_pages.dtype)
    v_pages[page_idx, page_off] = v[:, 0].to(v_pages.dtype)
    Kh, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    qh = q[:, 0].reshape(B, Kh, G, cfg.head_dim)
    out = paged_attention(qh, k_pages, v_pages, page_table, cache_len + 1)
    out = out.reshape(B, S, cfg.q_dim)
    return _o_proj(cfg, x, out, p, lora, adapter_idx,
                   lora_backend=lora_backend)


def _mlp(cfg, x, p, prefix=""):
    h = rms_norm(x, p[prefix + "mlp_norm"], cfg.norm_eps)
    if not cfg.gated_mlp:
        return x + gelu_mlp(h, p[prefix + "up"], p[prefix + "down"])
    return x + swiglu(h, p[prefix + "gate"], p[prefix + "up"],
                      p[prefix + "down"])


def _moe(cfg: ModelConfig, x: torch.Tensor, p: dict):
    """MoE feed-forward + residual: the dropless expert gather for
    decode (S == 1), the capacity buckets otherwise; a shared expert
    (llama4) runs densely for every token. Returns (x + y, aux)."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    experts = (p["router"], p["w_gate"], p["w_up"], p["w_down"])
    if x.shape[1] == 1:
        y, aux = moe_block_gather(h, *experts, cfg.top_k)
    else:
        y, aux = moe_block(h, *experts, cfg.top_k, cfg.capacity_factor)
    if cfg.shared_expert_ff:
        y = y + swiglu(h, p["shared_gate"], p["shared_up"],
                       p["shared_down"])
    return x + y, aux


# ----------------------------------------------------- stacked param views
def _slice_group(params: dict, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def _layers(cfg: ModelConfig, params: dict, lora):
    """Per-layer (params, lora) views of the stacked tensors — the
    ``xs`` of the JAX scan, one layer at a time."""
    stack = _slice_group(params, "layers/")
    for i in range(cfg.n_layers):
        p = {k: v[i] for k, v in stack.items()}
        lr = ({n: (a[i], b[i]) for n, (a, b) in lora.items()}
              if lora is not None else None)
        yield i, p, lr


def _positions(cfg: ModelConfig, tokens: torch.Tensor, offset,
               mrope_pos=None):
    """RoPE cos/sin for ``tokens`` (B, S) starting at ``offset`` (an int
    or a (B,) tensor of per-row offsets). M-RoPE configs (VLM) take
    their angles from ``mrope_pos`` (3, B, S) instead and ignore
    ``offset``."""
    B, S = tokens.shape
    if cfg.mrope:
        if mrope_pos is None:
            # The reference's assert, raised under -O as well.
            raise AssertionError("VLM needs (3,B,S) M-RoPE positions")
        return mrope_cos_sin(mrope_pos, cfg.head_dim, cfg.rope_theta,
                             cfg.mrope_sections)
    offset = torch.as_tensor(offset, device=tokens.device)
    pos = (torch.arange(S, device=tokens.device)[None, :]
           + offset.reshape(-1, 1).long())
    return rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)


def _logits(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """Final norm + unembedding: (B, S, D) -> f32 logits (B, S, V)."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    table = (params["embed/tok"].T if cfg.tie_embeddings
             else params["lm_head"])
    return unembed(h, table)


def _head(cfg: ModelConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """Logits of a one-position hidden (B, 1, D) -> (B, V)."""
    return _logits(cfg, params, h)[:, 0]


def _backbone(cfg: ModelConfig, params: dict, x: torch.Tensor, cos, sin,
              kv_caches=None, cache_len=None, lora=None, adapter_idx=None,
              collect_kv: bool = False, lora_backend: str = "einsum"):
    """The dense layer stack (the JAX ``_backbone`` scan as a loop).

    With ``kv_caches`` = (k, v) slabs (L, B, Smax, Kh, Dh) each layer
    decodes against its slab, written in place, and the slabs are
    returned; with ``collect_kv`` the fresh per-layer K/V are stacked
    to (L, B, S, Kh, Dh) (prefill). Returns (hidden, kv or None, aux):
    MoE configs run ``_backbone_moe``, whose aux is the load-balance
    loss summed over the MoE layers; the other families' aux is None
    (JAX's 0).
    """
    if cfg.family == Family.MOE:
        return _backbone_moe(cfg, params, x, cos, sin, kv_caches,
                             cache_len, lora, adapter_idx, collect_kv,
                             lora_backend)
    ks, vs = [], []
    h = x
    for i, p, lr in _layers(cfg, params, lora):
        kv = ((kv_caches[0][i], kv_caches[1][i])
              if kv_caches is not None else None)
        h, new_kv = _attn(cfg, h, p, cos, sin, kv, cache_len, lr,
                          adapter_idx, lora_backend)
        h = _mlp(cfg, h, p)
        if kv_caches is None and collect_kv:
            ks.append(new_kv[0])
            vs.append(new_kv[1])
    if kv_caches is not None:
        return h, kv_caches, None
    return (h, (torch.stack(ks), torch.stack(vs)) if collect_kv else None,
            None)


def _backbone_moe(cfg: ModelConfig, params: dict, x: torch.Tensor, cos,
                  sin, kv_caches=None, cache_len=None, lora=None,
                  adapter_idx=None, collect_kv: bool = False,
                  lora_backend: str = "einsum"):
    """The MoE layer stack: supersteps of ``moe_every`` layers, the last
    of each an MoE layer (``moe/`` stack, one entry a superstep), the
    others dense (``dense_mlp/`` stack, ``moe_every - 1`` entries a
    superstep). Attention, K/V and LoRA are indexed by global layer, as
    in ``_backbone``. Returns (hidden, kv or None, summed aux loss)."""
    E = cfg.moe_every
    moe_stack = _slice_group(params, "moe/")
    dense_stack = _slice_group(params, "dense_mlp/")
    ks, vs = [], []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = x
    for i, p, lr in _layers(cfg, params, lora):
        s, e = divmod(i, E)                    # superstep, layer in it
        kv = ((kv_caches[0][i], kv_caches[1][i])
              if kv_caches is not None else None)
        h, new_kv = _attn(cfg, h, p, cos, sin, kv, cache_len, lr,
                          adapter_idx, lora_backend)
        if kv_caches is None and collect_kv:
            ks.append(new_kv[0])
            vs.append(new_kv[1])
        if e == E - 1:
            h, a = _moe(cfg, h, {k: v[s] for k, v in moe_stack.items()})
            aux = aux + a
        else:
            j = s * (E - 1) + e
            h = _mlp(cfg, h, {k: v[j] for k, v in dense_stack.items()})
    if kv_caches is not None:
        return h, kv_caches, aux
    return (h, (torch.stack(ks), torch.stack(vs)) if collect_kv else None,
            aux)


def make_kv_caches(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16,
                   device: torch.device | str | None = None):
    """Dense KV slab: (L, batch, max_len, Kh, Dh) ×2, zeroed."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def make_paged_kv(cfg: ModelConfig, n_pages: int, page_size: int,
                  dtype=torch.bfloat16,
                  device: torch.device | str | None = None):
    """Paged KV pool: (L, n_pages, page, Kh, Dh) ×2.

    Page 0 is reserved as the trash page inactive batch slots write
    into; allocators hand out pages 1..n_pages-1 (engine convention).
    """
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads,
             cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


# ------------------------------------------------------------- sampling
def _filter_logits(logits: torch.Tensor, temperature: torch.Tensor,
                   top_k: torch.Tensor, top_p: torch.Tensor
                   ) -> torch.Tensor:
    """The sampler's masking: logits (..., V) scaled by the temperature,
    entries outside the top-k or the top-p nucleus set to -inf; the
    parameters have the leading shape (...). Ranks break ties like
    JAX's reversed stable ascending argsort."""
    V = logits.shape[-1]
    scaled = logits / torch.clamp(temperature, min=1e-6)[..., None]
    # Rank every vocab entry within its row (0 = best).
    order = torch.argsort(scaled, dim=-1, stable=True).flip(-1)
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(V, device=logits.device).expand_as(order))
    k_eff = torch.where(top_k > 0, top_k, torch.full_like(top_k, V))
    keep_k = ranks < k_eff[..., None]
    # Nucleus: keep entries whose *preceding* cumulative mass < top_p.
    probs = torch.softmax(scaled, dim=-1)
    sorted_p = torch.gather(probs, -1, order)
    cum = torch.cumsum(sorted_p, dim=-1)
    keep_p_sorted = (cum - sorted_p) < top_p[..., None]
    keep_p = torch.gather(keep_p_sorted, -1, ranks)
    return torch.where(keep_k & keep_p, scaled,
                       torch.full_like(scaled, float("-inf")))


def sample_tokens_core(logits: torch.Tensor, temperature: torch.Tensor,
                       top_k: torch.Tensor, top_p: torch.Tensor,
                       gumbel: torch.Tensor) -> torch.Tensor:
    """The noise-free half of ``sample_tokens``: temperature, top-k and
    top-p masking (``_filter_logits``), then argmax of masked +
    ``gumbel`` (B, V). Rows with ``temperature <= 0`` are greedy
    argmax."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    masked = _filter_logits(logits, temperature, top_k, top_p)
    sampled = torch.argmax(masked + gumbel, dim=-1).to(torch.int32)
    return torch.where(temperature > 0.0, sampled, greedy)


_M32 = 0xFFFFFFFF
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_THREEFRY_PARITY = 0x1BD11BDA
_F32_TINY = 1.1754943508222875e-38       # finfo(float32).tiny


def _threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                  x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's threefry2x32 hash (``jax/_src/prng.py``,
    ``_threefry2x32_lowering``): 20 rounds on uint32 words held in int64
    lanes. Keys and counts broadcast together; every input lies in
    [0, 2**32). ``x1`` is kept exact after each step (the rotation reads
    its high bits), ``x0`` only modulo 2**32 until the end: its bits
    above 32 never reach ``x1`` through the masked xor."""
    ks = (k0, k1, k0 ^ k1 ^ _THREEFRY_PARITY)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & _M32
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + (ks[(i + 2) % 3] + (i + 1))) & _M32
    return x0 & _M32, x1


def threefry_bits(seeds: torch.Tensor, positions: torch.Tensor, V: int,
                  fold: int | None = None) -> torch.Tensor:
    """(..., V) int64 lanes holding ``jax.random.bits(key, (V,))`` for
    ``key = fold_in(PRNGKey(s), p)``, or ``fold_in(key, fold)`` when a
    stream tag ``fold`` is given (the speculative streams), bit for bit.
    seeds (B,); positions (B,) or (B, S), giving (B, V) or (B, S, V).
    Seeds and positions wrap to uint32 as ``astype(jnp.uint32)`` does.

    ``PRNGKey(s)`` is the key (0, s); ``fold_in(key, d)`` hashes the
    count pair (0, d) under it; the bits of element i are ``out0 ^
    out1`` of the hash of (0, i) under the folded key (the partitionable
    path, ``jax_threefry_partitionable=True``, JAX's default). A
    shape-() draw hashes the count (0, 0): element 0 of a (V,) draw."""
    p = positions.long() & _M32
    s = (seeds.long() & _M32).reshape((-1,) + (1,) * (p.dim() - 1))
    k0, k1 = _threefry2x32(torch.zeros_like(s), s, torch.zeros_like(p), p)
    if fold is not None:
        k0, k1 = _threefry2x32(k0, k1, torch.zeros_like(k0),
                               torch.full_like(k0, fold))
    i = torch.arange(V, device=seeds.device, dtype=torch.long)
    b0, b1 = _threefry2x32(k0[..., None], k1[..., None],
                           torch.zeros_like(i), i)
    return b0 ^ b1


def _unit_uniform(bits: torch.Tensor) -> torch.Tensor:
    """``random.uniform``'s f32 on [0, 1): the top 23 bits as a mantissa
    in [1, 2), minus 1."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return mant - 1.0


def uniform_noise(seeds: torch.Tensor, positions: torch.Tensor,
                  fold: int | None = None) -> torch.Tensor:
    """``jax.random.uniform(key)``, one f32 scalar per (seed, position)
    with ``threefry_bits``' key: positions' shape, on [0, 1)."""
    return _unit_uniform(threefry_bits(seeds, positions, 1, fold)[..., 0])


def gumbel_noise(seeds: torch.Tensor, positions: torch.Tensor, V: int,
                 fold: int | None = None) -> torch.Tensor:
    """(B, V) (or (B, S, V)) f32 Gumbel noise equal to
    ``jax.random.gumbel(key, (V,))`` with ``threefry_bits``' key: a
    token's randomness depends only on (seed, position[, stream]), so it
    is the same across batch compositions and re-executions, and it is
    computed on the tensors' own device with no host round-trip (the
    fused loop draws it inside the horizon). The uniform is
    ``random.uniform``'s on [tiny, 1): ``_unit_uniform`` plus tiny
    (JAX's scale by 1 - tiny is 1 in f32, and its floor at tiny cannot
    bind)."""
    u = _unit_uniform(threefry_bits(seeds, positions, V, fold)) + _F32_TINY
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  seeds: torch.Tensor, positions: torch.Tensor
                  ) -> torch.Tensor:
    """Batched next-token sampler, one row per batch slot.

    logits (B, V) float; temperature/top_p (B,) float; top_k (B,) int
    (0 = disabled); seeds (B,) int; positions (B,) token index being
    sampled. Greedy rows (``temperature <= 0``) are argmax; stochastic
    rows draw ``gumbel_noise(seed, position)``.
    """
    gumbel = gumbel_noise(seeds, positions, logits.shape[-1])
    return sample_tokens_core(logits, temperature, top_k, top_p, gumbel)


# ------------------------------------------------- fused decode hot loop
def _fused_decode_scan(decode_one, tokens, cache_len, active, positions,
                       kv, budget, stop_ids, temperature, top_k, top_p,
                       seeds, max_ctx: int, n_steps: int,
                       all_greedy: bool):
    """Run ``n_steps`` decode+sample+advance iterations on the device.

    The JAX scan body as a loop: decode one token for every batch slot,
    pick the next token (argmax when the whole batch is greedy, else the
    seeded sampler), advance ``cache_len``/``positions`` for active
    rows, and fold the per-row finish conditions (budget, stop id,
    context bound) into an on-device done mask, so a row that finishes
    inside the horizon stops emitting there. Nothing is read back to the
    host: the caller syncs the (n_steps, B) token block and emit mask.

    decode_one: (tokens (B,1), kv, cache_len) -> (logits (B,V), kv').
    Returns ((tokens', kv', cache_len', active', positions'),
             toks (n_steps, B) int32, emits (n_steps, B) bool).
    """
    toks, emits = [], []
    for _ in range(n_steps):
        logits, kv = decode_one(tokens, kv, cache_len)
        if all_greedy:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            nxt = sample_tokens(logits, temperature, top_k, top_p, seeds,
                                positions)
        emit = active
        step = active.to(torch.int32)
        new_len = cache_len + step
        new_pos = positions + step
        hit_stop = (nxt[:, None] == stop_ids).any(dim=-1)
        done_now = emit & ((new_pos >= budget) | hit_stop
                           | (new_len + 1 >= max_ctx - 1))
        tokens, cache_len = nxt[:, None], new_len
        active, positions = emit & ~done_now, new_pos
        toks.append(nxt)
        emits.append(emit)
    return ((tokens, kv, cache_len, active, positions),
            torch.stack(toks), torch.stack(emits))


def decode_fused(cfg: ModelConfig, params: dict, tokens, kv_caches,
                 cache_len, active, positions, budget, stop_ids,
                 temperature, top_k, top_p, seeds, *, n_steps: int,
                 all_greedy: bool, max_ctx: int, lora=None,
                 adapter_idx=None, lora_backend: str = "einsum"):
    """Fused multi-step decode over the dense KV slab (see
    ``_fused_decode_scan``). Done rows keep writing at their
    ``cache_len``, which the context bound keeps inside the slab for
    every row that decoded up to it; a row placed with a prompt that
    already fills the slab writes past its end, and that write is
    dropped (see ``_attn``)."""

    def decode_one(tok, kv, clen):
        return decode_step(cfg, params, tok, kv, clen, lora=lora,
                           adapter_idx=adapter_idx,
                           lora_backend=lora_backend)

    return _fused_decode_scan(decode_one, tokens, cache_len, active,
                              positions, kv_caches, budget, stop_ids,
                              temperature, top_k, top_p, seeds, max_ctx,
                              n_steps, all_greedy)


def decode_fused_paged(cfg: ModelConfig, params: dict, tokens, kv_pages,
                       page_table, cache_len, active, positions, budget,
                       stop_ids, temperature, top_k, top_p, seeds, *,
                       n_steps: int, all_greedy: bool, max_ctx: int,
                       lora=None, adapter_idx=None,
                       lora_backend: str = "einsum"):
    """Fused multi-step decode over the paged KV pool. The page table
    is read-only across the horizon: the engine pre-allocates pages
    covering every write the loop can make."""

    def decode_one(tok, kv, clen):
        return decode_step_paged(cfg, params, tok, kv, page_table, clen,
                                 lora=lora, adapter_idx=adapter_idx,
                                 lora_backend=lora_backend)

    return _fused_decode_scan(decode_one, tokens, cache_len, active,
                              positions, kv_pages, budget, stop_ids,
                              temperature, top_k, top_p, seeds, max_ctx,
                              n_steps, all_greedy)


# ------------------------------------------------- dense entry points
def forward(cfg: ModelConfig, params: dict, tokens,
            mrope_pos=None) -> torch.Tensor:
    """Full-sequence logits (B, S, V) f32, causal attention through
    flash_attention. ``mrope_pos`` (3, B, S): M-RoPE positions (VLM).
    On a placed train state it runs sharded, the logits gathered onto
    the mesh's first position."""
    _refuse_mesh(params, "forward")
    if _placed(params):
        return _forward_train_mesh(cfg, params, tokens, mrope_pos)
    x = embed(tokens, params["embed/tok"])
    cos, sin = _positions(cfg, tokens, 0, mrope_pos)
    h, _, _ = _backbone(cfg, params, x, cos, sin)
    return _logits(cfg, params, h)


def train_loss(cfg: ModelConfig, params: dict, tokens, labels,
               mrope_pos=None, aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token NLL of ``labels`` (B, S) plus ``aux_weight`` times
    the MoE load-balance loss (0 for the dense and VLM families). On a
    placed train state ({path: ShardedTensor}, the train rule table) it
    runs sharded (``_train_loss_mesh``)."""
    _refuse_mesh(params, "train_loss")
    if _placed(params):
        return _train_loss_mesh(cfg, params, tokens, labels, mrope_pos,
                                aux_weight)
    x = embed(tokens, params["embed/tok"])
    cos, sin = _positions(cfg, tokens, 0, mrope_pos)
    h, _, aux = _backbone(cfg, params, x, cos, sin)
    loss = cross_entropy(_logits(cfg, params, h), labels)
    return loss if aux is None else loss + aux_weight * aux


def prefill(cfg: ModelConfig, params: dict, tokens, mrope_pos=None,
            lora=None, adapter_idx=None, last_pos=None,
            lora_backend: str = "einsum"):
    """Whole-prompt prefill. Returns (logits (B, V) f32 of position
    ``last_pos`` (B,) — S-1 when None; right-padded batches pass each
    row's last prompt position — , (k, v) each (L, B, S, Kh, Dh) in the
    activation dtype). ``lora_backend="kernel"`` routes the LoRA deltas
    through the sgmv kernel (each row is one contiguous token run).
    ``mrope_pos`` (3, B, S): M-RoPE positions (VLM)."""
    if isinstance(params, MeshParams):
        return _prefill_mesh(cfg, params, tokens, lora, adapter_idx,
                             last_pos, lora_backend)
    B, _ = tokens.shape
    x = embed(tokens, params["embed/tok"])
    cos, sin = _positions(cfg, tokens, 0, mrope_pos)
    h, kv, _ = _backbone(cfg, params, x, cos, sin, lora=lora,
                         adapter_idx=adapter_idx, collect_kv=True,
                         lora_backend=lora_backend)
    if last_pos is None:
        h_last = h[:, -1:]
    else:
        rows = torch.arange(B, device=h.device)
        h_last = h[rows, last_pos.long()][:, None]
    return _head(cfg, params, h_last), kv


def decode_step(cfg: ModelConfig, params: dict, tokens, kv_caches,
                cache_len, mrope_pos=None, lora=None, adapter_idx=None,
                lora_backend: str = "einsum"):
    """One decode step over the dense KV slab.

    tokens: (B, 1); kv_caches: (k, v) each (L, B, Smax, Kh, Dh), updated
    in place; cache_len: (B,) valid lengths; ``mrope_pos`` (3, B, 1):
    the token's M-RoPE positions (VLM). Returns (logits (B, V) f32,
    kv_caches). ``lora_backend="kernel"`` routes the per-token LoRA
    deltas through the bgmv kernel.
    """
    if isinstance(params, MeshParams):
        return _decode_step_mesh(cfg, params, tokens, kv_caches, cache_len,
                                 lora, adapter_idx, lora_backend)
    x = embed(tokens, params["embed/tok"])
    cos, sin = _positions(cfg, tokens, cache_len, mrope_pos)
    h, kv, _ = _backbone(cfg, params, x, cos, sin, kv_caches=kv_caches,
                         cache_len=cache_len, lora=lora,
                         adapter_idx=adapter_idx,
                         lora_backend=lora_backend)
    return _head(cfg, params, h), kv


def decode_step_paged(cfg: ModelConfig, params: dict, tokens, kv_pages,
                      page_table, cache_len, lora=None, adapter_idx=None,
                      lora_backend: str = "einsum"):
    """One decode step over a paged KV pool.

    tokens: (B, 1); kv_pages: (k_pages, v_pages) each (L, n_pages,
    page, Kh, Dh), updated in place; page_table: (B, P) physical page
    ids per request; cache_len: (B,) valid lengths. Returns
    (logits (B, V) f32, kv_pages).
    """
    if isinstance(params, MeshParams):
        return _decode_step_paged_mesh(cfg, params, tokens, kv_pages,
                                       page_table, cache_len, lora,
                                       adapter_idx, lora_backend)
    x = embed(tokens, params["embed/tok"])
    cos, sin = _positions(cfg, tokens, cache_len)
    k_pages, v_pages = kv_pages
    page = k_pages.shape[2]
    B, P = page_table.shape
    # Write position of the new token, shared across layers (the block
    # index clamps to the table as JAX's gather does).
    blk = torch.clamp(cache_len.long() // page, max=P - 1)
    page_idx = page_table.long()[torch.arange(B, device=blk.device), blk]
    page_off = cache_len.long() % page
    h = x
    for i, p, lr in _layers(cfg, params, lora):
        h = _attn_paged(cfg, h, p, cos, sin, k_pages[i], v_pages[i],
                        page_table, cache_len, page_idx, page_off, lr,
                        adapter_idx, lora_backend)
        h = _mlp(cfg, h, p)
    return _head(cfg, params, h), (k_pages, v_pages)


def _paged_layers(cfg: ModelConfig, params: dict, tokens, kv_pages,
                  page_table, start, valid, lora=None, adapter_idx=None,
                  lora_backend: str = "einsum"):
    """The layer stack of a multi-token pass over paged KV, shared by
    ``prefill_paged`` and ``verify_paged``. Row b's tokens sit at
    absolute positions ``start[b] ..``; per layer their K/V is written
    into the pages in place (positions not ``valid`` (B, S) go to trash
    page 0; the block index clamps to the table as JAX's gather does),
    the row's whole page list is gathered back to (B, P*page, Kh, Dh)
    and offset-causal attention runs over it. Returns the hidden
    (B, S, D)."""
    B, S = tokens.shape
    dev = tokens.device
    x = embed(tokens, params["embed/tok"])
    cos, sin = _positions(cfg, tokens, start)
    k_pages, v_pages = kv_pages
    page = k_pages.shape[2]
    P = page_table.shape[1]
    pt = page_table.long()
    pos = start.long()[:, None] + torch.arange(S, device=dev)[None, :]
    blk = torch.clamp(pos // page, max=P - 1)
    page_idx = torch.where(valid, torch.gather(pt, 1, blk),
                           torch.zeros_like(blk))        # pad → trash
    page_off = pos % page
    h = x
    for i, p, lr in _layers(cfg, params, lora):
        _, q, k, v = _qkv_proj(cfg, h, p, cos, sin, lr, adapter_idx,
                               lora_backend=lora_backend)
        kp, vp = k_pages[i], v_pages[i]
        kp[page_idx, page_off] = k.to(kp.dtype)
        vp[page_idx, page_off] = v.to(vp.dtype)
        kf = kp[pt].reshape(B, P * page, cfg.n_kv_heads, cfg.head_dim)
        vf = vp[pt].reshape(B, P * page, cfg.n_kv_heads, cfg.head_dim)
        # f32 pages promote the attention output; keep the activation
        # dtype, as the decode kernel does (a no-op for f32 weights; the
        # JAX scan would reject the promoted carry for bf16 weights).
        out = suffix_attention(q, kf, vf, pos).to(q.dtype)
        out = out.reshape(B, S, cfg.q_dim)
        h = _o_proj(cfg, h, out, p, lr, adapter_idx,
                    lora_backend=lora_backend)
        h = _mlp(cfg, h, p)
    return h


def prefill_paged(cfg: ModelConfig, params: dict, tokens, kv_pages,
                  page_table, start, seq_len, lora=None, adapter_idx=None,
                  lora_backend: str = "einsum"):
    """Suffix prefill straight into paged KV (prefix-cache data plane).

    tokens: (B, S) right-padded *suffix* token ids; start: (B,) absolute
    position of tokens[:, 0] (the cached prefix length, 0 on a miss);
    seq_len: (B,) valid suffix lengths (>= 1); page_table: (B, P)
    physical pages covering positions 0..start+S-1.

    Per layer (``_paged_layers``): project the suffix q/k/v (RoPE at the
    absolute offset), write K/V into the pages at positions
    start..start+seq_len-1 (padding redirected to trash page 0), gather
    the request's whole page list back and run offset-causal attention
    over it. Returns (last-valid-position logits (B, V) f32, kv_pages
    updated in place).
    """
    if isinstance(params, MeshParams):
        return _prefill_paged_mesh(cfg, params, tokens, kv_pages,
                                   page_table, start, seq_len, lora,
                                   adapter_idx, lora_backend)
    B, S = tokens.shape
    dev = tokens.device
    valid = torch.arange(S, device=dev)[None, :] < seq_len.long()[:, None]
    h = _paged_layers(cfg, params, tokens, kv_pages, page_table, start,
                      valid, lora, adapter_idx, lora_backend)
    last = (seq_len.long() - 1).clamp(min=0)
    h_last = h[torch.arange(B, device=dev), last][:, None]
    return _head(cfg, params, h_last), kv_pages


# ---------------------------------- speculative decoding (draft–verify)
def verify(cfg: ModelConfig, params: dict, tokens, kv_caches, cache_len,
           seq_len=None, lora=None, adapter_idx=None,
           lora_backend: str = "einsum"):
    """Multi-token target pass over the dense KV slab: the verify half
    of speculative decoding, logits of *every* position.

    tokens: (B, S) at absolute positions ``cache_len[b] ..
    cache_len[b]+S-1``; kv_caches: (k, v) each (L, B, Smax, Kh, Dh),
    written in place at those positions; a write past the slab or at a
    position >= ``seq_len`` (B,) (right padding, the draft catch-up) is
    dropped (``_slab_write``). Attention is offset-causal over the whole
    slab, so position j sees exactly the keys one ``decode_step`` would.
    Returns (logits (B, S, V) f32, kv_caches).
    """
    _refuse_mesh(params, "verify")
    B, S = tokens.shape
    dev = tokens.device
    x = embed(tokens, params["embed/tok"])
    cos, sin = _positions(cfg, tokens, cache_len)
    ar = torch.arange(S, device=dev)[None, :]
    pos = cache_len.long()[:, None] + ar
    keep = pos < kv_caches[0].shape[2]
    if seq_len is not None:
        keep = keep & (ar < seq_len.long()[:, None])
    h = x
    for i, p, lr in _layers(cfg, params, lora):
        _, q, k, v = _qkv_proj(cfg, h, p, cos, sin, lr, adapter_idx,
                               lora_backend=lora_backend)
        kc, vc = kv_caches[0][i], kv_caches[1][i]
        _slab_write((kc, vc), (k, v), pos, keep)
        out = suffix_attention(q, kc, vc, pos).to(q.dtype)
        out = out.reshape(B, S, cfg.q_dim)
        h = _o_proj(cfg, h, out, p, lr, adapter_idx,
                    lora_backend=lora_backend)
        h = _mlp(cfg, h, p)
    return _logits(cfg, params, h), kv_caches


def verify_paged(cfg: ModelConfig, params: dict, tokens, kv_pages,
                 page_table, cache_len, seq_len=None, lora=None,
                 adapter_idx=None, lora_backend: str = "einsum"):
    """``verify`` over paged KV: K/V lands in the request's pages at
    positions ``cache_len .. cache_len+S-1`` (positions past the table
    or past ``seq_len`` go to trash page 0), the page list is gathered
    back and attention is offset-causal (``_paged_layers``). Returns
    (logits (B, S, V) f32, kv_pages updated in place)."""
    _refuse_mesh(params, "verify_paged")
    S = tokens.shape[1]
    dev = tokens.device
    ar = torch.arange(S, device=dev)[None, :]
    page = kv_pages[0].shape[2]
    valid = cache_len.long()[:, None] + ar < page_table.shape[1] * page
    if seq_len is not None:
        valid = valid & (ar < seq_len.long()[:, None])
    h = _paged_layers(cfg, params, tokens, kv_pages, page_table, cache_len,
                      valid, lora, adapter_idx, lora_backend)
    return _logits(cfg, params, h), kv_pages


def _spec_filtered(logits: torch.Tensor, temperature: torch.Tensor,
                   top_k: torch.Tensor, top_p: torch.Tensor):
    """Temperature, top-k and top-p masking identical to
    ``sample_tokens``, plus the renormalised probabilities of the kept
    set (the rejection rule's p and q). logits (..., V); the parameters
    have the leading shape (...). Returns (masked scaled logits,
    filtered probabilities)."""
    masked = _filter_logits(logits, temperature, top_k, top_p)
    return masked, torch.softmax(masked, dim=-1)


def _spec_residual(pprobs: torch.Tensor, qprobs: torch.Tensor
                   ) -> torch.Tensor:
    """The rejection rule's resample distribution: max(p - q, 0)
    renormalised, or p itself where that mass is 0 (p == q)."""
    resid = torch.clamp(pprobs - qprobs, min=0.0)
    rsum = resid.sum(dim=-1, keepdim=True)
    return torch.where(rsum > 0, resid / torch.clamp(rsum, min=1e-30),
                       pprobs)


def _draft_propose(logits, temperature, top_k, top_p, seeds, positions):
    """One chained draft step's proposal: greedy rows take the draft
    argmax, sampled rows draw from the filtered draft distribution with
    the SPEC_DRAFT stream. Returns (tokens (B,) int32, filtered draft
    probabilities (B, V): the rejection rule's q)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    masked, qprobs = _spec_filtered(logits, temperature, top_k, top_p)
    gumbel = gumbel_noise(seeds, positions, logits.shape[-1],
                          SPEC_DRAFT_FOLD)
    sampled = torch.argmax(masked + gumbel, dim=-1).to(torch.int32)
    return torch.where(temperature > 0.0, sampled, greedy), qprobs


def _spec_decode_scan(draft_one, verify_multi, tokens, cache_len, active,
                      positions, kv, draft_kv, budget, stop_ids,
                      temperature, top_k, top_p, seeds, max_ctx: int,
                      n_rounds: int, spec_k: int, all_greedy: bool):
    """Fused draft–verify decode: ``n_rounds`` speculative rounds, up to
    ``spec_k + 1`` tokens a row a round, as a loop of device launches
    with no host sync (the JAX ``lax.scan`` over rounds and draft steps).

    Each round: the draft runs ``spec_k + 1`` chained single-token steps
    on its own KV (one past the last proposal, so its cache holds every
    accepted token's entry when all drafts land), proposing
    ``d_1..d_spec_k``; the target scores ``[t0, d_1..d_spec_k]`` in one
    ``verify_multi`` pass; acceptance, the correction or bonus token
    and the per-row rollback stay on the device. Greedy rows accept
    ``d_j`` iff it equals the target argmax, so their tokens equal the
    non-speculative loop's; sampled rows use rejection sampling
    (accept with probability min(1, p/q), else resample the residual
    max(p - q, 0)) on (seed, position) spec streams. Both caches
    advance by the emitted count only: entries past it are overwritten
    by the next round before attention reads them. The per-emission
    finish conditions (budget, stop id, context bound) are
    ``_fused_decode_scan``'s, replayed emission by emission.

    draft_one: (tokens (B,1), draft_kv, clen) -> (logits (B,V), kv').
    verify_multi: (tokens (B,S), kv, clen) -> (logits (B,S,V), kv').
    Returns ((tokens', kv', draft_kv', cache_len', active', positions'),
             toks (n_rounds*(spec_k+1), B) int32, emits (same) bool,
             accepted drafts (n_rounds, B) int32).
    """
    K = spec_k
    B = tokens.shape[0]
    dev = tokens.device
    rows = torch.arange(B, device=dev)
    jj = torch.arange(K + 1, device=dev, dtype=torch.int32)
    sampled_rows = temperature > 0.0
    toks, emits, accs = [], [], []
    for _ in range(n_rounds):
        tok, drafts, qps = tokens, [], []
        for j in range(K + 1):
            dlogits, draft_kv = draft_one(tok, draft_kv, cache_len + j)
            if all_greedy:
                nxt = torch.argmax(dlogits, dim=-1).to(torch.int32)
            else:
                nxt, qp = _draft_propose(dlogits, temperature, top_k,
                                         top_p, seeds, positions + j)
                qps.append(qp)
            drafts.append(nxt)
            tok = nxt[:, None]
        d_check = torch.stack(drafts[:K], dim=1)             # (B, K)
        vlogits, kv = verify_multi(torch.cat([tokens, d_check], dim=1),
                                   kv, cache_len)            # (B, K+1, V)
        tgt = torch.argmax(vlogits, dim=-1).to(torch.int32)
        acc = d_check == tgt[:, :K]
        if not all_greedy:
            qprobs = torch.stack(qps[:K], dim=1)             # (B, K, V)
            _, pprobs = _spec_filtered(
                vlogits[:, :K], temperature[:, None].expand(B, K),
                top_k[:, None].expand(B, K), top_p[:, None].expand(B, K))
            dl = d_check.long()[..., None]
            p_d = torch.gather(pprobs, -1, dl)[..., 0]
            q_d = torch.gather(qprobs, -1, dl)[..., 0]
            pos_mat = positions[:, None] + jj[None, :K]
            u = uniform_noise(seeds, pos_mat, SPEC_ACCEPT_FOLD)
            # u < min(1, p/q)  <=>  u*q < p (q > 0 on the proposal's support)
            acc_s = u * torch.clamp(q_d, min=1e-30) < p_d
            acc = torch.where(sampled_rows[:, None], acc_s, acc)
        n_acc = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1) \
            .to(torch.int32)
        corr = tgt[rows, n_acc.long()]           # argmax(L_n)
        if not all_greedy:
            V = vlogits.shape[-1]
            resid = _spec_residual(pprobs, qprobs)
            rg = gumbel_noise(seeds, pos_mat, V, SPEC_RESIDUAL_FOLD)
            resid_tok = torch.argmax(
                torch.log(torch.clamp(resid, min=1e-38)) + rg,
                dim=-1).to(torch.int32)                      # (B, K)
            bonus = sample_tokens(vlogits[:, K], temperature, top_k, top_p,
                                  seeds, positions + K)
            corr_s = torch.where(
                n_acc < K,
                resid_tok[rows, torch.clamp(n_acc, max=K - 1).long()],
                bonus)
            corr = torch.where(sampled_rows, corr_s, corr)
        # Emission slot j holds d_{j+1} while accepted, else the
        # correction or bonus at slot n_acc (slots past it are masked).
        padded = torch.cat([d_check, torch.zeros_like(d_check[:, :1])],
                           dim=1)
        e = torch.where(jj[None, :] < n_acc[:, None], padded,
                        corr[:, None])
        m = active
        for j in range(K + 1):
            ej = e[:, j]
            emit_j = m & (j <= n_acc)
            new_pos = positions + (j + 1)
            new_len = cache_len + (j + 1)
            hit_stop = (ej[:, None] == stop_ids).any(dim=-1)
            done_j = emit_j & ((new_pos >= budget) | hit_stop
                               | (new_len + 1 >= max_ctx - 1))
            m = m & ~done_j
            toks.append(ej)
            emits.append(emit_j)
        cnt = torch.stack(emits[-(K + 1):]).to(torch.int32).sum(dim=0) \
            .to(torch.int32)
        new_tok = e[rows, torch.clamp(cnt - 1, min=0).long()]
        tokens = torch.where(cnt > 0, new_tok, tokens[:, 0])[:, None]
        accs.append(torch.where(active, n_acc, torch.zeros_like(n_acc)))
        cache_len, active, positions = (cache_len + cnt, m,
                                        positions + cnt)
    return ((tokens, kv, draft_kv, cache_len, active, positions),
            torch.stack(toks), torch.stack(emits), torch.stack(accs))


def decode_spec_fused(cfg: ModelConfig, params: dict,
                      draft_cfg: ModelConfig, draft_params: dict, tokens,
                      kv_caches, draft_kv, cache_len, active, positions,
                      budget, stop_ids, temperature, top_k, top_p, seeds,
                      *, spec_k: int, n_rounds: int, all_greedy: bool,
                      max_ctx: int, lora=None, adapter_idx=None,
                      lora_backend: str = "einsum"):
    """Speculative fused decode over the dense KV slab: the draft runs
    ``decode_step`` on its own dense slab with base weights only (the
    adapters ride along at verify time), the target ``verify``."""

    def draft_one(tok, dkv, clen):
        return decode_step(draft_cfg, draft_params, tok, dkv, clen)

    def verify_multi(toks, kv, clen):
        return verify(cfg, params, toks, kv, clen, lora=lora,
                      adapter_idx=adapter_idx, lora_backend=lora_backend)

    return _spec_decode_scan(draft_one, verify_multi, tokens, cache_len,
                             active, positions, kv_caches, draft_kv,
                             budget, stop_ids, temperature, top_k, top_p,
                             seeds, max_ctx, n_rounds, spec_k, all_greedy)


def decode_spec_fused_paged(cfg: ModelConfig, params: dict,
                            draft_cfg: ModelConfig, draft_params: dict,
                            tokens, kv_pages, page_table, draft_kv,
                            cache_len, active, positions, budget,
                            stop_ids, temperature, top_k, top_p, seeds, *,
                            spec_k: int, n_rounds: int, all_greedy: bool,
                            max_ctx: int, lora=None, adapter_idx=None,
                            lora_backend: str = "einsum"):
    """Speculative fused decode with the target on paged KV (the draft
    keeps its dense slab). The engine allocates pages covering every
    write a round can make (``cache_len + spec_k + 1``) beforehand and
    shrinks back after readback."""

    def draft_one(tok, dkv, clen):
        return decode_step(draft_cfg, draft_params, tok, dkv, clen)

    def verify_multi(toks, kv, clen):
        return verify_paged(cfg, params, toks, kv, page_table, clen,
                            lora=lora, adapter_idx=adapter_idx,
                            lora_backend=lora_backend)

    return _spec_decode_scan(draft_one, verify_multi, tokens, cache_len,
                             active, positions, kv_pages, draft_kv,
                             budget, stop_ids, temperature, top_k, top_p,
                             seeds, max_ctx, n_rounds, spec_k, all_greedy)


# ------------------------------------------------------ mesh data plane
# The dense and MoE families' step functions on a device mesh
# (``MeshParams``): the counterpart of the JAX engine's sharded jits in
# exact-reductions mode. Each "model" column computes its block of
# query heads with the KV heads they read (the column config
# ``col_cfg``), its attention and its output columns of o, gate/up (the
# shared expert's too) and the vocabulary, on its own device; the
# ``act_sharding.constrain_*`` points gather the merged heads before o,
# the residual before each norm, the FFN hidden before the replicated
# down projection and whole vocab rows before sampling, so no
# contraction runs over a sharded dimension. An MoE layer routes on the
# home device and each "data" shard runs its own experts on its device
# (``models/moe.py``; the all-to-all of ``models/moe_shard_map.py``
# under ``moe_token_parallel``). Compute runs at full batch: KV pages
# (or slab rows) and batch state are split over "data" for storage, and
# KV heads over "model" where they divide; where they do not, each
# shard holds every KV head (pages, or a slab without a sequence split)
# or a block of positions of every head (the slab split over "model"
# along the sequence, ``kv_cache_spec``). A layer's writes go to every
# shard that holds the written entry, and its reads gather the shards
# onto the column's device. The page table stays global.


def _mesh_scope(mp: MeshParams):
    """The gather points' scope for ``mp`` (entered by the serving
    engine around every dispatch; entered here for direct callers)."""
    if acts.installed_mesh() is mp.mesh:
        return contextlib.nullcontext()
    return acts.activation_sharding((), mesh=mp.mesh,
                                    exact_reductions=True)


def _refuse_mesh(params, what: str) -> None:
    if isinstance(params, MeshParams):
        raise NotImplementedError(
            f"{what} on serving MeshParams: they run the serving step "
            f"functions (prefill, prefill_paged, decode_step[_paged], "
            f"decode_fused[_paged]); speculative passes are not sharded, "
            f"and forward/train_loss take a train state placed with "
            f"sharding.device_put")


class _MeshCall:
    """One step function's per-column views: each column's layer
    stacks (attention, llama4's dense MLP layers, the MoE layers'
    whole and column-parallel weights), LoRA slots and replicated
    inputs."""

    def __init__(self, mp: MeshParams, lora):
        self.mp, self.M, self.ccfg = mp, mp.model_size, mp.col_cfg
        self.stacks = [_slice_group(c, "layers/") for c in mp.cols]
        self.dense = [_slice_group(c, "dense_mlp/") for c in mp.cols]
        self.moe = [_slice_group(c, "moe/") for c in mp.cols]
        self.lora = (mp.lora_cols(lora) if lora is not None
                     else [None] * self.M)

    def rep(self, *ts) -> list:
        """Per column: the tuple of ``ts`` as that column's copies."""
        cols = [acts.replicate(t) if t is not None else [None] * self.M
                for t in ts]
        return [tuple(c[m] for c in cols) for m in range(self.M)]

    def layer(self, i: int):
        ps = [{k: v[i] for k, v in st.items()} for st in self.stacks]
        lrs = [({n: (a[i], b[i]) for n, (a, b) in lr.items()}
                if lr is not None else None) for lr in self.lora]
        return ps, lrs


def _embed_mesh(mp: MeshParams, tokens: torch.Tensor) -> torch.Tensor:
    """Token rows of the vocab-sharded table, on the first column's
    device."""
    return embed_sharded(tokens, [c["embed/tok"] for c in mp.cols])


def _o_proj_mesh(call: _MeshCall, x, outs: list, ps, lrs, aidx,
                 backend: str):
    """Merged-head gather, column-parallel o (+ its LoRA columns), then
    the residual gather: ``_o_proj`` with D over "model"."""
    out = acts.constrain_attn_merged(outs)
    outr = acts.replicate(out)
    cols = []
    for m in range(call.M):
        with on_device(outr[m].device):
            o = einsum("bse,ed->bsd", outr[m], ps[m]["o"])
            if lrs[m] is not None and "o" in lrs[m]:
                o = o + lora_delta(outr[m], lrs[m]["o"], aidx[m][0],
                                   backend=backend)
        cols.append(o)
    return x + acts.constrain_residual(cols)


def _ffn_mesh(call: _MeshCall, hr: list, gates: list, ups: list, down,
              gated: bool = True):
    """``swiglu`` (``gelu_mlp`` without ``gated``) of each column's
    normed input ``hr[m]``: gate/up column-parallel, the hidden
    gathered and the down projection replicated (on the first
    column's device)."""
    hid = []
    for m in range(call.M):
        if gated:
            hid.append(F.silu(einsum("bsd,df->bsf", hr[m], gates[m]))
                       * einsum("bsd,df->bsf", hr[m], ups[m]))
        else:
            hid.append(F.gelu(einsum("bsd,df->bsf", hr[m], ups[m]),
                              approximate="tanh"))
    return einsum("bsf,fd->bsd", acts.constrain_ffn_hidden(hid), down)


def _mlp_mesh(call: _MeshCall, x, ps):
    """``_mlp`` on the mesh (``_ffn_mesh`` after each column's norm)."""
    cfg = call.ccfg
    hr = [rms_norm(xm, ps[m]["mlp_norm"], cfg.norm_eps)
          for m, xm in enumerate(acts.replicate(x))]
    return x + _ffn_mesh(call, hr, [p.get("gate") for p in ps],
                         [p["up"] for p in ps], ps[0]["down"],
                         cfg.gated_mlp)


def _moe_mesh(call: _MeshCall, x, s: int):
    """``_moe`` of MoE superstep ``s`` on the mesh: the norm and the
    routing on the home device, each data shard's experts on its device
    (``MeshParams.experts``) through the all-to-all when
    ``moe_a2a_mesh()`` is set and E and B divide its axis, else the
    decode gather (S == 1) or the capacity buckets; the shared expert
    column-parallel."""
    cfg, mp = call.mp.cfg, call.mp
    p = [{k: v[s] for k, v in st.items()} for st in call.moe]
    h = rms_norm(x, p[0]["norm"], cfg.norm_eps)
    blocks = mp.experts
    ws = [[b[leaf][s] for b in blocks]
          for leaf in ("w_gate", "w_up", "w_down")]
    B, S, _ = x.shape
    a2a = acts.moe_a2a_mesh()
    ns = a2a[0].shape[a2a[1]] if a2a is not None else 0
    if a2a is not None and cfg.n_experts % ns == 0 and B % ns == 0 \
            and len(blocks) == ns:
        # Decode: dropless capacity (cf = E/k makes cap == Tg).
        cf = cfg.n_experts / cfg.top_k if S == 1 else cfg.capacity_factor
        y, _ = moe_block_a2a(h, [b["router"][s] for b in blocks], *ws,
                             cfg.top_k, cf, a2a[0], expert_axis=a2a[1])
    elif S == 1:
        y, _ = moe_block_gather(h, p[0]["router"], *ws, cfg.top_k)
    else:
        y, _ = moe_block(h, p[0]["router"], *ws, cfg.top_k,
                         cfg.capacity_factor)
    if cfg.shared_expert_ff:
        y = y + _ffn_mesh(call, acts.replicate(h),
                          [q["shared_gate"] for q in p],
                          [q["shared_up"] for q in p], p[0]["shared_down"])
    return x + y


def _head_mesh(call: _MeshCall, h) -> torch.Tensor:
    """``_logits`` with the vocabulary column-parallel, gathered to
    whole rows."""
    cfg, cols = call.mp.cfg, call.mp.cols
    hr = acts.replicate(h)
    out = []
    for m in range(call.M):
        hm = rms_norm(hr[m], cols[m]["final_norm"], cfg.norm_eps)
        table = (cols[m]["embed/tok"].T if cfg.tie_embeddings
                 else cols[m]["lm_head"])
        out.append(unembed(hm, table))
    return acts.constrain_logits(out)


# KV on the mesh: a stack (L, N, T, Kh, Dh) — N slab rows or pages over
# "data", T positions (the slab's over "model" when its KV heads do not
# divide), Kh heads over "model" or whole. Column m computes KV heads
# ``mp.kv_heads[m]``.
def _kv_targets(mp: MeshParams, st, m: int) -> list:
    """The shards column ``m`` writes: (shard with its write sink, the
    shard, rows/pages slice, positions slice, head offset). A shard
    takes the heads it holds of the column's block; where several
    columns compute one KV head, shard (., m') takes it from the
    column with m' = m modulo ``kv_share``, so every replica holds
    every head. The same for every layer: computed once a step."""
    mi = st.mesh.axis_names.index("model")
    a, b = mp.kv_heads[m]
    out, seen = [], set()
    for coords in np.ndindex(*st.shards.shape):
        if (coords[mi] - m) % mp.kv_share:
            continue
        slc = st.sharding.index(coords, st.shape)
        t = st.shards[coords]
        if id(t) in seen or not (slc[3].start <= a and b <= slc[3].stop):
            continue
        seen.add(id(t))
        out.append((st.raw(t), t, slc[1], slc[2], a - slc[3].start))
    return out


def _sink(raw, t, i, lo: int, hi: int):
    """Local index ``i - lo`` of a shard ``t`` holding [lo, hi) of a
    split dimension, out-of-block entries sent to its write sink (the
    entry past the block in ``raw``)."""
    if raw is t:
        raise ValueError("KV split over the mesh needs a write sink: "
                         "allocate it with ShardPlan.zeros_kv_pages / "
                         "zeros_kv_dense")
    i = i - lo
    return torch.where((i >= 0) & (i < hi - lo), i,
                       torch.full_like(i, hi - lo))


def _page_write_plan(mp: MeshParams, st, m: int, idx, off) -> list:
    """Where column ``m`` writes pages ``idx`` (offsets ``off``) of a
    paged KV stack: per target shard (tensor, local page, offset, head
    offset); a shard's pages owned by another shard go to its sink."""
    n = st.shape[1]
    out = []
    for raw, t, rows, _, h0 in _kv_targets(mp, st, m):
        i, o = idx.to(t.device), off.to(t.device)
        if (rows.start, rows.stop) == (0, n):
            out.append((t, i, o, h0))
        else:
            out.append((raw, _sink(raw, t, i, rows.start, rows.stop),
                        o, h0))
    return out


def _page_write(plan: list, layer: int, val) -> None:
    """Write ``val`` (B, w, Dh) into layer ``layer`` at each target."""
    w = val.shape[1]
    for t, i, o, h0 in plan:
        t[layer][i, o, h0:h0 + w] = val.to(t.device, t.dtype)


def _slab_write_mesh(mp: MeshParams, st, layer: int, m: int, new, pos,
                     keep) -> None:
    """``_slab_write`` of column ``m``'s heads ``new`` (B, S, w, Dh)
    into the slab shards that hold them: each takes its block of rows,
    and where positions split over "model", the positions it holds
    (the rest to its sink)."""
    T = st.shape[2]
    w = new.shape[2]
    for raw, t, rows, seq, h0 in _kv_targets(mp, st, m):
        dev = t.device
        r0, r1 = rows.start, rows.stop
        nb, p, k = (x[r0:r1].to(dev) for x in (new, pos, keep))
        if (seq.start, seq.stop) == (0, T):
            _slab_write((t[layer][:, :, h0:h0 + w],), (nb,), p, k)
            continue
        i = _sink(raw, t, torch.where(k, p, torch.full_like(p, -1)),
                  seq.start, seq.stop)
        rr = torch.arange(r1 - r0, device=dev)[:, None]
        raw[layer][rr, i, h0:h0 + w] = nb.to(raw.dtype)


def _kv_sources(mp: MeshParams, st, m: int, device) -> list:
    """Where column ``m`` reads its KV heads from: per distinct block of
    rows/pages and positions, (rows slice, positions slice, shard, head
    offset) of one shard that holds them (on ``device`` when one
    does)."""
    mi = st.mesh.axis_names.index("model")
    a, b = mp.kv_heads[m]
    best: dict = {}
    for coords in np.ndindex(*st.shards.shape):
        slc = st.sharding.index(coords, st.shape)
        if not (slc[3].start <= a and b <= slc[3].stop):
            continue
        t = st.shards[coords]
        key = (slc[1].start, slc[1].stop, slc[2].start, slc[2].stop)
        rank = (t.device != device, coords[mi] != m)
        if key not in best or rank < best[key][0]:
            best[key] = (rank, (slc[1], slc[2], t, a - slc[3].start))
    return [v for _, v in sorted(best.values(), key=lambda e: (
        e[1][0].start, e[1][1].start))]


def _kv_read(sources: list, layer: int, w: int, device) -> torch.Tensor:
    """Layer ``layer`` of a column's KV heads (N, T, w, Dh), its shards
    gathered onto ``device``."""
    pieces = [((r, sq), t[layer][:, :, h0:h0 + w])
              for r, sq, t, h0 in sources]
    return acts.gather_region(pieces, device)


def _attn_columns(call: _MeshCall, h, cos, sin, i: int, aidx, backend,
                  attend, write=None) -> list:
    """q/k/v of every column for layer ``i``, then ``write(m, k, v)``
    on each (every column's KV writes land before any column reads:
    a column may read positions another column wrote) and
    ``attend(m, q, k, v)`` on each: the columns' attention outputs
    (B, S, q_dim / M)."""
    ps, lrs = call.layer(i)
    hr = acts.replicate(h)
    qkv = []
    for m in range(call.M):
        with on_device(hr[m].device):
            qkv.append(_qkv_proj(call.ccfg, hr[m], ps[m], cos[m], sin[m],
                                 lrs[m], aidx[m][0],
                                 lora_backend=backend)[1:])
    if write is not None:
        for m, (_, k, v) in enumerate(qkv):
            with on_device(k.device):
                write(m, k, v)
    outs = []
    for m, (q, k, v) in enumerate(qkv):
        with on_device(q.device):
            outs.append(attend(m, q, k, v))
    return outs, ps, lrs


def _layers_mesh(call: _MeshCall, h, cos, sin, aidx, backend, attend,
                 write=None):
    """The layer stack on the mesh: per layer the columns' attention
    (``attend``/``write`` take the layer index first), the o
    projection, then the MLP, or for MoE configs the superstep's dense
    MLP or MoE layer (as ``_backbone_moe`` indexes them)."""
    cfg = call.mp.cfg
    E = cfg.moe_every
    for i in range(cfg.n_layers):
        outs, ps, lrs = _attn_columns(
            call, h, cos, sin, i, aidx, backend,
            lambda m, q, k, v, i=i: attend(i, m, q, k, v),
            None if write is None else
            (lambda m, k, v, i=i: write(i, m, k, v)))
        h = _o_proj_mesh(call, h, outs, ps, lrs, aidx, backend)
        if cfg.family != Family.MOE:
            h = _mlp_mesh(call, h, ps)
            continue
        s, e = divmod(i, E)
        if e == E - 1:
            h = _moe_mesh(call, h, s)
        else:
            j = s * (E - 1) + e
            h = _mlp_mesh(call, h, [{k: v[j] for k, v in st.items()}
                                    for st in call.dense])
    return h


def _prefill_mesh(cfg, mp: MeshParams, tokens, lora, adapter_idx,
                  last_pos, lora_backend):
    """``prefill`` on the mesh; (k, v) come back as per-column lists of
    (L, B, S, kv heads of the column, Dh) stacks."""
    with _mesh_scope(mp):
        call = _MeshCall(mp, lora)
        B, S = tokens.shape
        x = _embed_mesh(mp, tokens)
        cos, sin = _positions(cfg, tokens.to(mp.home), 0)
        cos, sin = zip(*call.rep(cos, sin))
        aidx = call.rep(adapter_idx)
        ks = [[] for _ in range(call.M)]
        vs = [[] for _ in range(call.M)]
        qd = call.ccfg.q_dim

        def attend(i, m, q, k, v):
            ks[m].append(k)
            vs[m].append(v)
            return flash_attention(q, k, v, causal=True).reshape(B, S, qd)

        h = _layers_mesh(call, x, cos, sin, aidx, lora_backend, attend)
        if last_pos is None:
            h_last = h[:, -1:]
        else:
            rows = torch.arange(B, device=h.device)
            h_last = h[rows, last_pos.to(h.device).long()][:, None]
        kv = ([torch.stack(k) for k in ks], [torch.stack(v) for v in vs])
        return _head_mesh(call, h_last)[:, 0], kv


def _decode_step_mesh(cfg, mp: MeshParams, tokens, kv_caches, cache_len,
                      lora, adapter_idx, lora_backend):
    """``decode_step`` over the dense slab on the mesh: slab rows over
    "data", KV heads (or, when they do not divide, positions) over
    "model"."""
    with _mesh_scope(mp):
        call = _MeshCall(mp, lora)
        B, S = tokens.shape
        home = mp.home
        tokens, cache_len = tokens.to(home), cache_len.to(home)
        x = _embed_mesh(mp, tokens)
        cos, sin = _positions(cfg, tokens, cache_len)
        Smax = kv_caches[0].shape[2]
        pos = (cache_len.long()[:, None]
               + torch.arange(S, device=home)[None, :])
        keep = pos < Smax
        per = call.rep(cos, sin, cache_len, adapter_idx)
        cos, sin = [p[0] for p in per], [p[1] for p in per]
        aidx = [p[3:] for p in per]
        c = call.ccfg
        src = [[_kv_sources(mp, t, m, mp.devices[m]) for t in kv_caches]
               for m in range(call.M)]

        def write(i, m, k, v):
            for t, new in zip(kv_caches, (k, v)):
                _slab_write_mesh(mp, t, i, m, new, pos, keep)

        def attend(i, m, q, k, v):
            dev = q.device
            kc, vc = (_kv_read(s_, i, c.n_kv_heads, dev) for s_ in src[m])
            out = decode_attention(q, kc, vc, per[m][2] + S).to(q.dtype)
            return out.reshape(B, S, c.q_dim)

        h = _layers_mesh(call, x, cos, sin, aidx, lora_backend, attend,
                         write)
        return _head_mesh(call, h)[:, 0], kv_caches


def _paged_geometry(kv_pages, page_table, start, valid):
    """Write page and offset of each of the rows' tokens at ``start``
    (B,) .. (as in ``_paged_layers``; ``valid`` None = all)."""
    S = valid.shape[1]
    page = kv_pages[0].shape[2]
    P = page_table.shape[1]
    pt = page_table.long()
    pos = start.long()[:, None] + torch.arange(S, device=pt.device)[None]
    blk = torch.clamp(pos // page, max=P - 1)
    page_idx = torch.where(valid, torch.gather(pt, 1, blk),
                           torch.zeros_like(blk))
    return pos, page_idx, pos % page


def _paged_mesh(cfg, mp: MeshParams, tokens, kv_pages, page_table, start,
                valid, lora, adapter_idx, lora_backend, decode: bool):
    """The paged layer stack on the mesh (pages over "data", KV heads
    over "model" or whole): ``decode_step_paged`` (``decode``: one token
    a row, through paged_attention) or the suffix pass of
    ``_paged_layers``. Returns the hidden (B, S, D) on the first
    column's device."""
    call = _MeshCall(mp, lora)
    B, S = tokens.shape
    home = mp.home
    tokens, start, page_table, valid = (t.to(home) for t in
                                        (tokens, start, page_table, valid))
    x = _embed_mesh(mp, tokens)
    cos, sin = _positions(cfg, tokens, start)
    pos, page_idx, page_off = _paged_geometry(kv_pages, page_table, start,
                                              valid)
    per = call.rep(cos, sin, page_table, start, page_idx, page_off, pos,
                   adapter_idx)
    cos, sin = [p[0] for p in per], [p[1] for p in per]
    aidx = [p[7:] for p in per]
    c = call.ccfg
    G = c.n_heads // c.n_kv_heads
    page, P = kv_pages[0].shape[2], page_table.shape[1]

    def plan(t, m):
        pi, po = per[m][4:6]
        if decode:
            pi, po = pi[:, 0], po[:, 0]
        return _page_write_plan(mp, t, m, pi, po)

    where = [[plan(t, m) for t in kv_pages] for m in range(call.M)]
    src = [[_kv_sources(mp, t, m, mp.devices[m]) for t in kv_pages]
           for m in range(call.M)]

    def write(i, m, k, v):
        if decode:
            k, v = k[:, 0], v[:, 0]
        for pl, new in zip(where[m], (k, v)):
            _page_write(pl, i, new)

    def attend(i, m, q, k, v):
        pt, st, _, _, ps_ = per[m][2:7]
        kp, vp = (_kv_read(s_, i, c.n_kv_heads, q.device) for s_ in src[m])
        if decode:
            qh = q[:, 0].reshape(B, c.n_kv_heads, G, c.head_dim)
            out = paged_attention(qh, kp, vp, pt, st + 1)
        else:
            pl = pt.long()
            kf = kp[pl].reshape(B, P * page, c.n_kv_heads, c.head_dim)
            vf = vp[pl].reshape(B, P * page, c.n_kv_heads, c.head_dim)
            out = suffix_attention(q, kf, vf, ps_).to(q.dtype)
        return out.reshape(B, S, c.q_dim)

    return _layers_mesh(call, x, cos, sin, aidx, lora_backend, attend,
                        write), call


def _decode_step_paged_mesh(cfg, mp, tokens, kv_pages, page_table,
                            cache_len, lora, adapter_idx, lora_backend):
    with _mesh_scope(mp):
        valid = torch.ones(tokens.shape, dtype=torch.bool,
                           device=tokens.device)
        h, call = _paged_mesh(cfg, mp, tokens, kv_pages, page_table,
                              cache_len, valid, lora, adapter_idx,
                              lora_backend, decode=True)
        return _head_mesh(call, h)[:, 0], kv_pages


def _prefill_paged_mesh(cfg, mp, tokens, kv_pages, page_table, start,
                        seq_len, lora, adapter_idx, lora_backend):
    with _mesh_scope(mp):
        B, S = tokens.shape
        dev = tokens.device
        seq_len = seq_len.to(dev)
        valid = torch.arange(S, device=dev)[None, :] < seq_len.long()[:, None]
        h, call = _paged_mesh(cfg, mp, tokens, kv_pages, page_table, start,
                              valid, lora, adapter_idx, lora_backend,
                              decode=False)
        last = (seq_len.long().to(h.device) - 1).clamp(min=0)
        h_last = h[torch.arange(B, device=h.device), last][:, None]
        return _head_mesh(call, h_last)[:, 0], kv_pages


# ------------------------------------------------- training on a mesh
# The forward and train_loss of every family on a placed train state
# (``sharding.TrainView``): the counterpart of the JAX step under
# ``activation_sharding(batch_axes)``. Position (b, m) runs batch shard
# b's rows (``act_sharding.batch_shards``; VLM M-RoPE positions split
# with them on their dimension 1, enc-dec frames with the rows)
# through column m: its heads with their KV heads (flash_attention
# forward, and backward under autograd, per shard), its gate/up
# columns, its rows of the row-parallel o and down, whose partial
# products ``psum_columns`` sums over the columns, and its vocabulary
# block (the embedding's rows, summed likewise; the logits stay split
# and the cross-entropy combines the blocks' exp-sums). A vocabulary
# the columns do not divide stays whole: each column looks up whole
# rows (its copy of the residual stream, as after ``psum_columns``)
# and each batch shard's first column takes the logits and the
# cross-entropy with the whole head. MoE supersteps put ``moe_every -
# 1`` dense layers (the ``dense_mlp/`` stack, row-parallel like the
# dense MLP) before each MoE layer, whose experts run over "data" with
# their hidden over "model" (``moe.moe_block_train``: capacity groups
# and the aux loss of the global batch) and whose shared expert is
# column/row-parallel. The SSM, hybrid and enc-dec families build
# their stacks from the same pieces (``ssm_lm``, ``hybrid``,
# ``encdec``). Each weight is gathered over the batch axes where a
# position computes with it (``TrainView.view``). The loss is the mean
# of the batch shards' means (the global mean, since the shards are
# equal) plus ``aux_weight`` times the summed aux losses.

_ATTN_LEAVES = ("attn_norm", "q", "k", "v", "o", "q_bias", "k_bias",
                "v_bias", "q_norm", "k_norm")
_MLP_LEAVES = ("mlp_norm", "gate", "up", "down")
_SHARED_LEAVES = ("shared_gate", "shared_up", "shared_down")


def _placed(params) -> bool:
    return any(isinstance(v, ShardedTensor) for v in params.values())


def _attn_train(tv: TrainView, hb: list, rope: list | None, b: int,
                i: int | None, prefix: str = "layers/",
                causal: bool = True) -> list:
    """Attention of entry ``i`` of the ``prefix`` stack (None: a block
    that is not stacked) for batch shard ``b``: ``hb`` its residual
    stream, a copy on each column's device; ``rope`` each column's
    (cos, sin), or None for learned positions (enc-dec)."""
    c = tv.col_cfg
    parts = []
    for m, x in enumerate(hb):
        with on_device(x.device):
            p = tv.layer(i, b, m, _ATTN_LEAVES, prefix)
            cos, sin = rope[m] if rope is not None else (None, None)
            _, q, k, v = _qkv_proj(c, x, p, cos, sin)
            out = flash_attention(q, k, v, causal=causal)
            out = out.reshape(x.shape[0], x.shape[1], c.q_dim)
            parts.append(einsum("bse,ed->bsd", out, p["o"]))
    return [x + y for x, y in zip(hb, acts.psum_columns(parts))]


def _mlp_train(cfg, tv: TrainView, hb: list, b: int, i: int | None,
               prefix: str = "layers/") -> list:
    """The MLP of entry ``i`` of the ``prefix`` stack for batch shard
    ``b``."""
    parts = []
    for m, x in enumerate(hb):
        with on_device(x.device):
            p = tv.layer(i, b, m, _MLP_LEAVES, prefix)
            h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
            parts.append(swiglu(h, p["gate"], p["up"], p["down"])
                         if cfg.gated_mlp else
                         gelu_mlp(h, p["up"], p["down"]))
    return [x + y for x, y in zip(hb, acts.psum_columns(parts))]


def _moe_train(cfg, tv: TrainView, h: list, s: int):
    """MoE superstep ``s``'s expert layer over every batch shard ``h[b]``
    (the capacity groups and the aux loss span them). Returns (the
    residual streams, the layer's aux loss)."""
    hn, router, experts = [], [], []
    for b, hb in enumerate(h):
        row, exp = [], []
        for m, x in enumerate(hb):
            with on_device(x.device):
                row.append(rms_norm(x, tv.view("moe/norm", b, m, s),
                                    cfg.norm_eps))
            exp.append(tuple(tv.view("moe/" + leaf, b, m, s)
                             for leaf in ("w_gate", "w_up", "w_down")))
        hn.append(row)
        experts.append(exp)
        router.append(tv.view("moe/router", b, 0, s))
    ys, aux = moe_block_train(hn, router, experts, cfg.top_k,
                              cfg.capacity_factor, tv.n_data)
    out = []
    for b, hb in enumerate(h):
        parts = ys[b]
        if cfg.shared_expert_ff:
            parts = []
            for m, y in enumerate(ys[b]):
                with on_device(y.device):
                    p = tv.layer(s, b, m, _SHARED_LEAVES, "moe/")
                    parts.append(y + swiglu(hn[b][m], p["shared_gate"],
                                            p["shared_up"],
                                            p["shared_down"]))
        out.append([x + y for x, y in zip(hb, acts.psum_columns(parts))])
    return out, aux


def _embed_train(tv: TrainView, toks: list) -> list:
    """[batch shard][column] residual streams of the batch-sharded
    tokens ``toks``: the columns' vocabulary blocks looked up and summed
    over the columns, or, for a vocabulary left whole, each column's
    lookup in the whole table."""
    h = []
    for b, row in enumerate(toks):
        parts = []
        for m, t in enumerate(row):
            tab = tv.view("embed/tok", b, m)
            parts.append(embed(t, tab) if tv.M == 1 or tv.whole_vocab
                         else embed_rows(t, tab, m * tab.shape[0]))
        h.append(parts if tv.whole_vocab else acts.psum_columns(parts))
    return h


def _head_train(cfg, tv: TrainView, h: list) -> list:
    """[batch shard][column] f32 logits (B / n_batch, S, V / M) of the
    final hidden ``h``; a whole vocabulary: one block a batch shard,
    from its first column."""
    out = []
    for b, hb in enumerate(h):
        row = []
        for m, x in enumerate(hb[:1] if tv.whole_vocab else hb):
            x = rms_norm(x, tv.view("final_norm", b, m), cfg.norm_eps)
            table = (tv.view("embed/tok", b, m).T if cfg.tie_embeddings
                     else tv.view("lm_head", b, m))
            row.append(unembed(x, table))
        out.append(row)
    return out


def _logits_train_mesh(cfg, tv: TrainView, tokens, mrope_pos=None):
    """([batch shard][column] f32 logits (B / n_batch, S, V / M), the
    summed MoE aux loss or None)."""
    toks = acts.batch_shards(tokens)
    mpos = (acts.batch_shards(mrope_pos, dim=1) if mrope_pos is not None
            else [[None] * tv.M] * tv.n_batch)
    h = _embed_train(tv, toks)
    rope = [[_positions(cfg, t, 0, mp) for t, mp in zip(row, mpos[b])]
            for b, row in enumerate(toks)]
    E = cfg.moe_every if cfg.family == Family.MOE else 0
    aux = None
    for i in range(cfg.n_layers):
        h = [_attn_train(tv, hb, rope[b], b, i) for b, hb in enumerate(h)]
        if not E:
            h = [_mlp_train(cfg, tv, hb, b, i) for b, hb in enumerate(h)]
            continue
        s, e = divmod(i, E)
        if e == E - 1:
            h, a = _moe_train(cfg, tv, h, s)
            aux = a if aux is None else aux + a
        else:
            h = [_mlp_train(cfg, tv, hb, b, s * (E - 1) + e, "dense_mlp/")
                 for b, hb in enumerate(h)]
    return _head_train(cfg, tv, h), aux


def _train_scope(tv: TrainView):
    return acts.activation_sharding(tv.batch_axes, mesh=tv.mesh)


def mesh_train_loss(tv: TrainView, logits_fn, labels,
                    aux_weight: float = 0.0) -> torch.Tensor:
    """The mean NLL of ``labels`` over a placed state, plus
    ``aux_weight`` times the aux loss: ``logits_fn()`` runs in the
    train scope and returns ([batch shard][column] logits, aux or
    None)."""
    with _train_scope(tv):
        logits, aux = logits_fn()
        labs = acts.batch_shards(labels)
        loss = None
        for row, lab in zip(logits, labs):
            nll = cross_entropy_columns(row, lab[0]).to(tv.home)
            loss = nll if loss is None else loss + nll
        loss = loss / tv.n_batch
        return loss if aux is None else loss + aux_weight * aux


def mesh_forward(tv: TrainView, logits_fn) -> torch.Tensor:
    """``logits_fn``'s logits gathered onto the mesh's first position
    (B, S, V)."""
    with _train_scope(tv):
        logits, _ = logits_fn()
        rows = [torch.cat([t.to(tv.home) for t in row], dim=-1)
                for row in logits]
        return torch.cat(rows, dim=0)


def _train_loss_mesh(cfg, params: dict, tokens, labels, mrope_pos=None,
                     aux_weight: float = 0.01) -> torch.Tensor:
    tv = TrainView(cfg, params)
    return mesh_train_loss(
        tv, lambda: _logits_train_mesh(cfg, tv, tokens, mrope_pos), labels,
        aux_weight)


def _forward_train_mesh(cfg, params: dict, tokens,
                        mrope_pos=None) -> torch.Tensor:
    tv = TrainView(cfg, params)
    return mesh_forward(
        tv, lambda: _logits_train_mesh(cfg, tv, tokens, mrope_pos))
