"""Whisper-style encoder-decoder backbone, audio frontend stubbed
(PyTorch).

Port of ``src/repro/models/encdec.py``. The encoder consumes
precomputed frame embeddings (B, enc_ctx, D); positions are learned
tables (``enc_pos``, and ``dec_pos`` indexed by the decoder position);
the decoder has causal self-attention plus cross-attention to the
encoder output; norms are RMS.

The encoder's full self-attention and the decoder's causal prefill
self-attention run through ``kernels.ops.flash_attention`` (the CUDA
kernel on the card, its plain version on the CPU), as the port's
``lm._attn`` runs prefill; the JAX package computes the same function
with ``gqa_attention``. Cross-attention has as many keys as encoder
frames and fewer queries, a shape the flash wrapper does not take
(it needs Sq == Sk), so it stays the plain ``gqa_attention``, as does
decode attention over the self-attention slab.

Serve path: ``prefill`` encodes the frames once and returns (self-KV,
cross-KV); ``decode_step`` writes the token's self-attention K/V into
the slab it is given, in place (the JAX function returns new arrays).

On a placed train state (``sharding.device_put`` with the train rule
table) ``forward`` and ``train_loss`` run sharded, as ``lm``'s mesh
train path does, the frames split with the batch rows: the encoder's
full and the decoder's causal self-attention through
``lm._attn_train`` (flash_attention per shard), the MLPs through
``lm._mlp_train``. The JAX rule table replicates every cross-attention
leaf (``dec/x*``); each column computes its heads of the cross
attention from its block of them (``TrainView``: xq and xk/xv by
heads, xo by rows), and ``psum_columns`` sums the row-parallel xo
products, so no head is counted twice. The positions tables are whole
on every column.
"""
from __future__ import annotations

import torch

from repro_torch.device import on_device
from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed.sharding import TrainView
from repro_torch.kernels.ops import flash_attention
from repro_torch.models.base import ModelConfig
from repro_torch.models.layers import (cross_entropy, decode_attention,
                                       einsum, embed, gqa_attention,
                                       rms_norm, swiglu)
from repro_torch.models.lm import (_attn_train, _embed_train, _head,
                                   _head_train, _logits, _mlp_train,
                                   _placed, _slab_write, mesh_forward,
                                   mesh_train_loss)


def _grp(params, prefix):
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix) and not k[len(prefix):].startswith("x")}


def _grp_cross(params):
    return {k[len("dec/x"):]: v for k, v in params.items()
            if k.startswith("dec/x")}


def _self_attn(cfg, x, p, causal, kv_cache=None, cache_len=None):
    B, S, _ = x.shape
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q = einsum("bsd,de->bse", h, p["q"]).reshape(
        B, S, cfg.n_heads, cfg.head_dim)
    k = einsum("bsd,de->bse", h, p["k"]).reshape(
        B, S, cfg.n_kv_heads, cfg.head_dim)
    v = einsum("bsd,de->bse", h, p["v"]).reshape(
        B, S, cfg.n_kv_heads, cfg.head_dim)
    if kv_cache is None:
        out = flash_attention(q, k, v, causal=causal)
        new_kv = (k, v)
    else:
        kc, vc = kv_cache
        pos = (cache_len.long()[:, None]
               + torch.arange(S, device=x.device)[None, :])
        _slab_write(kv_cache, (k, v), pos, pos < kc.shape[1])
        out = decode_attention(q, kc, vc, cache_len + S)
        new_kv = (kc, vc)
    out = out.reshape(B, S, cfg.q_dim)
    return x + einsum("bse,ed->bsd", out, p["o"]), new_kv


def _cross_attn(cfg, x, p, kx, vx):
    """kx, vx: precomputed encoder K/V (B, Senc, Kh, Dh). Plain
    attention: Sq != Senc, which the flash wrapper does not take."""
    B, S, _ = x.shape
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q = einsum("bsd,de->bse", h, p["q"]).reshape(
        B, S, cfg.n_heads, cfg.head_dim)
    out = gqa_attention(q, kx, vx, causal=False)
    out = out.reshape(B, S, cfg.q_dim)
    return x + einsum("bse,ed->bsd", out, p["o"])


def _mlp(cfg, x, p):
    h = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + swiglu(h, p["gate"], p["up"], p["down"])


# ---------------------------------------------------------------- encoder
def encode(cfg: ModelConfig, params: dict,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, enc_ctx, D) stub embeddings -> encoder states."""
    x = frames + params["enc_pos"][None, : frames.shape[1]]
    enc = _grp(params, "enc/")
    for i in range(cfg.n_enc_layers):
        p = {k: v[i] for k, v in enc.items()}
        x, _ = _self_attn(cfg, x, p, causal=False)
        x = _mlp(cfg, x, p)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def cross_kv(cfg: ModelConfig, params: dict, enc_out: torch.Tensor):
    """Per-decoder-layer cross K/V (L, B, Senc, Kh, Dh) from the encoder
    output."""
    B, Se, _ = enc_out.shape
    xp = _grp_cross(params)
    k = einsum("bsd,lde->lbse", enc_out, xp["k"]).reshape(
        cfg.n_layers, B, Se, cfg.n_kv_heads, cfg.head_dim)
    v = einsum("bsd,lde->lbse", enc_out, xp["v"]).reshape(
        cfg.n_layers, B, Se, cfg.n_kv_heads, cfg.head_dim)
    return k, v


# ---------------------------------------------------------------- decoder
def _decoder(cfg, params, x, kx, vx, kv_caches=None, cache_len=None):
    """The decoder stack. Without ``kv_caches`` the fresh per-layer K/V
    are stacked to (L, B, S, Kh, Dh); with them each layer decodes
    against its slab, written in place. Returns (x, (k, v))."""
    dec = _grp(params, "dec/")
    xdec = _grp_cross(params)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p = {k: v[i] for k, v in dec.items()}
        kv = ((kv_caches[0][i], kv_caches[1][i])
              if kv_caches is not None else None)
        x, new_kv = _self_attn(cfg, x, p, causal=True, kv_cache=kv,
                               cache_len=cache_len)
        px = {"attn_norm": xdec["attn_norm"][i], "q": xdec["q"][i],
              "o": xdec["o"][i]}
        x = _cross_attn(cfg, x, px, kx[i], vx[i])
        x = _mlp(cfg, x, p)
        ks.append(new_kv[0])
        vs.append(new_kv[1])
    if kv_caches is not None:
        return x, kv_caches
    return x, (torch.stack(ks), torch.stack(vs))


def _dec_in(params, tokens, pos):
    return embed(tokens, params["embed/tok"]) + params["dec_pos"][pos]


def forward(cfg: ModelConfig, params: dict, tokens,
            frames: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder logits (B, S, V) f32."""
    if _placed(params):
        tv = TrainView(cfg, params)
        return mesh_forward(tv, lambda: _logits_mesh(cfg, tv, tokens,
                                                      frames))
    enc_out = encode(cfg, params, frames)
    kx, vx = cross_kv(cfg, params, enc_out)
    x = _dec_in(params, tokens, slice(0, tokens.shape[1]))
    x, _ = _decoder(cfg, params, x, kx, vx)
    return _logits(cfg, params, x)


def train_loss(cfg, params, tokens, labels, frames,
               aux_weight=0.0) -> torch.Tensor:
    if _placed(params):
        tv = TrainView(cfg, params)
        return mesh_train_loss(
            tv, lambda: _logits_mesh(cfg, tv, tokens, frames), labels)
    return cross_entropy(forward(cfg, params, tokens, frames), labels)


# ------------------------------------------------- training on a mesh
def _cross_kv_train(cfg, tv: TrainView, enc: list, b: int) -> list:
    """Each column's cross K/V (L, B, Senc, Kh / M, Dh) of its KV heads,
    from its copy of batch shard ``b``'s encoder output."""
    out = []
    for m, e in enumerate(enc):
        with on_device(e.device):
            k, v = (einsum("bsd,lde->lbse", e, tv.view(f"dec/x{n}", b, m))
                    for n in "kv")
            shape = (cfg.n_layers,) + tuple(e.shape[:2]) + (
                tv.col_cfg.n_kv_heads, cfg.head_dim)
            out.append((k.reshape(shape), v.reshape(shape)))
    return out


def _cross_train(cfg, tv: TrainView, hb: list, b: int, i: int,
                 kvs: list) -> list:
    """Cross attention of decoder layer ``i`` for batch shard ``b``: each
    column's heads, their xo products summed over the columns."""
    c = tv.col_cfg
    parts = []
    for m, x in enumerate(hb):
        with on_device(x.device):
            B, S, _ = x.shape
            p = tv.layer(i, b, m, ("xattn_norm", "xq", "xo"), "dec/")
            h = rms_norm(x, p["xattn_norm"], cfg.norm_eps)
            q = einsum("bsd,de->bse", h, p["xq"]).reshape(
                B, S, c.n_heads, c.head_dim)
            kx, vx = kvs[m]
            out = gqa_attention(q, kx[i], vx[i], causal=False)
            parts.append(einsum("bse,ed->bsd", out.reshape(B, S, c.q_dim),
                                p["xo"]))
    return [x + y for x, y in zip(hb, acts.psum_columns(parts))]


def _logits_mesh(cfg: ModelConfig, tv: TrainView, tokens, frames):
    """([batch shard][column] f32 logits, None) on a placed state."""
    toks = acts.batch_shards(tokens)
    S = tokens.shape[1]
    enc = [[f + tv.view("enc_pos", b, m)[None, :f.shape[1]]
            for m, f in enumerate(row)]
           for b, row in enumerate(acts.batch_shards(frames))]
    for i in range(cfg.n_enc_layers):
        enc = [_mlp_train(cfg, tv,
                          _attn_train(tv, hb, None, b, i, "enc/",
                                      causal=False), b, i, "enc/")
               for b, hb in enumerate(enc)]
    kvs = [_cross_kv_train(
        cfg, tv, [rms_norm(x, tv.view("enc_final_norm", b, m), cfg.norm_eps)
                  for m, x in enumerate(hb)], b)
        for b, hb in enumerate(enc)]
    del enc
    h = [[x + tv.view("dec_pos", b, m)[:S] for m, x in enumerate(hb)]
         for b, hb in enumerate(_embed_train(tv, toks))]
    for i in range(cfg.n_layers):
        h = [_attn_train(tv, hb, None, b, i, "dec/") for b, hb in
             enumerate(h)]
        h = [_cross_train(cfg, tv, hb, b, i, kvs[b])
             for b, hb in enumerate(h)]
        h = [_mlp_train(cfg, tv, hb, b, i, "dec/") for b, hb in enumerate(h)]
    return _head_train(cfg, tv, h), None


def prefill(cfg: ModelConfig, params: dict, tokens, frames: torch.Tensor,
            lora=None, adapter_idx=None, lora_backend: str = "einsum"):
    """Returns (last logits (B,V), ((k, v) (L,B,S,Kh,Dh), (kx, vx))).
    ``lora`` is accepted and ignored, as in JAX."""
    enc_out = encode(cfg, params, frames)
    kx, vx = cross_kv(cfg, params, enc_out)
    x = _dec_in(params, tokens, slice(0, tokens.shape[1]))
    x, kv = _decoder(cfg, params, x, kx, vx)
    return _head(cfg, params, x[:, -1:]), (kv, (kx, vx))


def decode_step(cfg: ModelConfig, params: dict, tokens, state, cache_len,
                lora=None, adapter_idx=None, lora_backend: str = "einsum"):
    """tokens (B,1); state = ((k, v) self slabs (L,B,Smax,Kh,Dh),
    (kx, vx)); cache_len (B,). The token's K/V is written into (k, v) in
    place. Returns (logits (B,V) f32, state)."""
    kv, (kx, vx) = state
    pos = cache_len.long().reshape(-1, 1)                  # (B, 1)
    x = _dec_in(params, tokens, pos)
    x, kv = _decoder(cfg, params, x, kx, vx, kv_caches=kv,
                     cache_len=cache_len)
    return _head(cfg, params, x), (kv, (kx, vx))
