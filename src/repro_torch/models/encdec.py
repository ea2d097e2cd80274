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
heads, xo by rows), and ``act_sharding.residual_add`` sums the row-parallel xo
products, so no head is counted twice. The positions tables are whole
on every column.

On serving ``MeshParams`` ``prefill`` and ``decode_step`` run each
batch row of positions on its rows (the frames with them), every
attention by heads in exact mode: the encoder's full flash attention,
the cross K/V (``cross_kv`` by KV heads, placed by ``kv_cache_spec``
over ``enc_ctx``), the decoder's causal self attention (with its slab
write when decoding), then cross attention by heads; xo, like o, is
column-parallel after the heads' gather. A vocabulary the columns do
not divide (whisper's 51865 at 2 or 4 columns) is whole on every
column.
"""
from __future__ import annotations

import torch

from repro_torch.device import on_device
from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed.sharding import (MeshParams, TrainView,
                                              all_gather)
from repro_torch.kernels.ops import flash_attention
from repro_torch.models.base import ModelConfig
from repro_torch.models.layers import (cross_entropy, decode_attention,
                                       einsum, embed, gqa_attention,
                                       rms_norm, swiglu)
from repro_torch.models.lm import (_attn_sublayer, _attn_train,
                                   _embed_mesh, _embed_train,
                                   _head, _head_train, _heads, _logits,
                                   _mesh_calls, _mesh_scope, _mlp_mesh,
                                   _mlp_train, _o_proj_mesh, _placed,
                                   _slab_ops, _slab_write, kv_placed,
                                   mesh_forward, mesh_train_loss,
                                   remat_rows)
from repro_torch.models.remat import remat


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

        def layer(x, p=p):
            x, _ = _self_attn(cfg, x, p, causal=False)
            return _mlp(cfg, x, p)

        x = remat(layer, x, on=cfg.remat)
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
        px = {"attn_norm": xdec["attn_norm"][i], "q": xdec["q"][i],
              "o": xdec["o"][i]}

        def layer(x, p=p, kv=kv, px=px, i=i):
            x, new_kv = _self_attn(cfg, x, p, causal=True, kv_cache=kv,
                                   cache_len=cache_len)
            x = _cross_attn(cfg, x, px, kx[i], vx[i])
            return _mlp(cfg, x, p), new_kv

        # Never over a slab written in place (decode).
        x, new_kv = remat(layer, x, on=cfg.remat and kv_caches is None)
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
    """Each attention column's cross K/V (L, B, Senc, Kh / M, Dh) of its
    KV heads (whole heads: the first column's, every head), from its
    copy of batch shard ``b``'s encoder output, normed here."""
    out = []
    cols = tv.rows[b][:tv.n_cols("attn")]
    for m, x in enumerate(acts.columns_in(enc, cols)):
        with on_device(x.device):
            e = rms_norm(x, tv.view("enc_final_norm", b, m), cfg.norm_eps)
            k, v = (einsum("bsd,lde->lbse", e, tv.view(f"dec/x{n}", b, m))
                    for n in "kv")
            shape = (cfg.n_layers,) + tuple(e.shape[:2]) + (
                tv.col_cfg.n_kv_heads, cfg.head_dim)
            out.append((k.reshape(shape), v.reshape(shape)))
    return out


def _cross_train(cfg, tv: TrainView, hb: list, b: int, i: int,
                 kvs: list) -> list:
    """Cross attention of decoder layer ``i`` for batch shard ``b``: each
    column's heads, their xo products summed over the columns (whole
    heads: the first column's, copied)."""
    c = tv.col_cfg
    parts = []
    for m, x in enumerate(acts.columns_in(hb, tv.rows[b][:tv.n_cols("attn")])):
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
    return acts.residual_add(hb, parts, tv.rows[b])


def _with_positions(tv: TrainView, hb: list, path: str, b: int) -> list:
    """Residual ``hb`` of batch shard ``b`` plus the learned positions
    ``path`` of the positions each piece holds (piece m on column m)."""
    return [x + tv.view(path, b, m)[None, lo:hi]
            for m, (x, (lo, hi)) in enumerate(
                zip(hb, acts.residual_spans(hb)))]


def _logits_mesh(cfg: ModelConfig, tv: TrainView, tokens, frames):
    """([batch shard][column] f32 logits, None) on a placed state."""
    toks = acts.batch_shards(tokens)
    enc = [_with_positions(tv, acts.residual_pieces(row), "enc_pos", b)
           for b, row in enumerate(acts.batch_shards(frames))]
    for i in range(cfg.n_enc_layers):
        enc, _ = remat_rows(lambda h, i=i: ([
            _mlp_train(cfg, tv, _attn_train(tv, hb, None, b, i, "enc/",
                                            causal=False), b, i, "enc/")
            for b, hb in enumerate(h)], None), enc, cfg.remat)
    kvs = [_cross_kv_train(cfg, tv, hb, b) for b, hb in enumerate(enc)]
    del enc
    h = [_with_positions(tv, hb, "dec_pos", b)
         for b, hb in enumerate(_embed_train(tv, toks))]

    def layer(h, i):
        h = [_attn_train(tv, hb, None, b, i, "dec/") for b, hb in
             enumerate(h)]
        h = [_cross_train(cfg, tv, hb, b, i, kvs[b])
             for b, hb in enumerate(h)]
        return [_mlp_train(cfg, tv, hb, b, i, "dec/")
                for b, hb in enumerate(h)], None

    for i in range(cfg.n_layers):
        h, _ = remat_rows(lambda h, i=i: layer(h, i), h, cfg.remat)
    return _head_train(cfg, tv, h), None


def prefill(cfg: ModelConfig, params: dict, tokens, frames: torch.Tensor,
            lora=None, adapter_idx=None, lora_backend: str = "einsum"):
    """Returns (last logits (B,V), ((k, v) (L,B,S,Kh,Dh), (kx, vx))).
    ``lora`` is accepted and ignored, as in JAX."""
    if isinstance(params, MeshParams):
        return _serve_mesh(cfg, params, tokens, frames=frames)
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
    if isinstance(params, MeshParams):
        return _serve_mesh(cfg, params, tokens, state, cache_len)
    kv, (kx, vx) = state
    pos = cache_len.long().reshape(-1, 1)                  # (B, 1)
    x = _dec_in(params, tokens, pos)
    x, kv = _decoder(cfg, params, x, kx, vx, kv_caches=kv,
                     cache_len=cache_len)
    return _head(cfg, params, x), (kv, (kx, vx))


# ------------------------------------------------- serving on a mesh
def _cross_columns(cfg, call, h, ps: list, kxs: list, vxs: list):
    """Cross attention of a batch row on its columns: column m's heads
    over its cross K/V (``kxs[m]``: this layer's (n, Senc, Kh/M, Dh)),
    the heads gathered, xo column-parallel, the residual gathered."""
    c = call.ccfg
    outs = []
    for m, x in enumerate(call.ins(h)):
        with on_device(x.device):
            n, S, _ = x.shape
            hm = rms_norm(x, ps[m]["attn_norm"], cfg.norm_eps)
            q = einsum("bsd,de->bse", hm, ps[m]["q"]).reshape(
                n, S, c.n_heads, c.head_dim)
            out = gqa_attention(q, kxs[m], vxs[m], causal=False)
            outs.append(out.reshape(n, S, c.q_dim))
    return _o_proj_mesh(call, h, outs, ps, [None] * call.M,
                        [(None,)] * call.M, "einsum")


def _serve_mesh(cfg: ModelConfig, mp: MeshParams, tokens, state=None,
                cache_len=None, frames=None):
    """``prefill`` (``frames`` given: encode them, then the prompt) or
    ``decode_step`` (``state``) on the mesh."""
    with _mesh_scope(mp):
        B, S = tokens.shape
        calls = _mesh_calls(mp, None, B)
        dec = [[_grp(c, "dec/") for c in call.cols] for call in calls]
        xdec = [[_grp_cross(c) for c in call.cols] for call in calls]
        hs, kxs, vxs = [], [], []
        for r, call in enumerate(calls):
            with call.scope():
                x = _embed_mesh(call, call.rows(tokens))
                pos = (slice(0, S) if state is None
                       else call.rows(cache_len).long().reshape(-1, 1))
                hs.append(x + call.cols[0]["dec_pos"][pos])
                if state is None:
                    kx, vx = _encode_columns(cfg, call, call.rows(frames))
                else:
                    kx, vx = ([all_gather(t, (slice(None),
                                               slice(call.lo, call.hi),
                                               slice(None), slice(*hd)),
                                           dev)
                               for hd, dev in zip(
                                  mp.kv_heads[:mp.n_cols("attn")],
                                  call.devices)]
                              for t in state[1])
            kxs.append(kx)
            vxs.append(vx)
        if state is None:
            ks = [[[] for _ in range(mp.n_cols("attn"))] for _ in calls]
            vs = [[[] for _ in range(mp.n_cols("attn"))] for _ in calls]

            def attend(r, i, m, q, k, v):
                ks[r][m].append(k)
                vs[r][m].append(v)
                return flash_attention(q, k, v, causal=True).reshape(
                    q.shape[0], S, mp.col_cfg.q_dim)
            write = None
        else:
            write, attend = _slab_ops(mp, calls, state[0], cache_len, S,
                                      cast=False)
        for i in range(cfg.n_layers):
            for r, call in enumerate(calls):
                with call.scope():
                    ps = [{k: v[i] for k, v in d.items()} for d in dec[r]]
                    h = _attn_sublayer(
                        call, hs[r], ps,
                        lambda m, q, k, v, r=r, i=i: attend(r, i, m, q, k,
                                                            v),
                        None if write is None else
                        (lambda m, k, v, r=r, i=i: write(r, i, m, k, v)))
                    px = [{k: v[i] for k, v in d.items()} for d in xdec[r]]
                    h = _cross_columns(cfg, call, h, px,
                                       [t[i] for t in kxs[r]],
                                       [t[i] for t in vxs[r]])
                    hs[r] = _mlp_mesh(call, h, ps, gated=True)
        logits = _heads(mp, calls, [h[:, -1:] for h in hs])
        if state is not None:
            return logits, state
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
        xshape = (cfg.n_layers, B, frames.shape[1], cfg.n_kv_heads,
                  cfg.head_dim)
        kv = tuple(kv_placed(mp, calls, [[torch.stack(t) for t in row]
                                         for row in x], shape)
                   for x in (ks, vs))
        cross = tuple(kv_placed(mp, calls, x, xshape) for x in (kxs, vxs))
        return logits, (kv, cross)


def _encode_columns(cfg, call, frames):
    """A batch row's frames through the encoder by heads, then each
    column's cross K/V (L, n, Senc, Kh/M, Dh) of its KV heads."""
    enc = [_grp(c, "enc/") for c in call.cols]
    S = frames.shape[1]
    x = frames + call.cols[0]["enc_pos"][None, :S]

    def attend(m, q, k, v):
        return flash_attention(q, k, v, causal=False).reshape(
            q.shape[0], S, call.ccfg.q_dim)

    for i in range(cfg.n_enc_layers):
        ps = [{k: v[i] for k, v in e.items()} for e in enc]
        x = _mlp_mesh(call, _attn_sublayer(call, x, ps, attend), ps,
                      gated=True)
    x = rms_norm(x, call.cols[0]["enc_final_norm"], cfg.norm_eps)
    kx, vx = [], []
    for xm, c in zip(call.ins(x), call.cols):
        with on_device(xm.device):
            n, Se, _ = xm.shape
            for out, leaf in ((kx, "dec/xk"), (vx, "dec/xv")):
                out.append(einsum("bsd,lde->lbse", xm, c[leaf]).reshape(
                    cfg.n_layers, n, Se, call.ccfg.n_kv_heads,
                    cfg.head_dim))
    return kx, vx
