"""Plain-PyTorch oracles, twins of ``src/repro/kernels/ref.py``.

These compute what the JAX oracles compute — including where they
differ from the kernels: ``bgmv_ref``/``sgmv_ref`` round the rank-r
intermediate to *x's* dtype, where the kernels round it to the weights'
dtype. ``preferred_element_type=float32`` contractions run on f32
operands; plain contractions run in the promoted dtype, as
``jnp.einsum`` promotes.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import gqa_attention, promoted


def bgmv_ref(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             idx: torch.Tensor) -> torch.Tensor:
    """Batched-gather LoRA: y[b] = x[b] @ A[idx[b]] @ B[idx[b]].

    x: (Bt, din); A: (n_slots, din, r); B: (n_slots, r, dout); idx: (Bt,).
    """
    idx = idx.long()
    t = torch.einsum("bd,bdr->br", x.float(), A[idx].float())
    y = torch.einsum("br,bro->bo", t.to(x.dtype).float(), B[idx].float())
    return y.to(x.dtype)


def sgmv_ref(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             tile_slot: torch.Tensor, tile: int) -> torch.Tensor:
    """Segmented LoRA: tile t of ``tile`` tokens uses adapter tile_slot[t].

    x: (T, din) with T % tile == 0, tokens pre-grouped so that each tile
    maps to exactly one adapter; tile_slot: (T/tile,).
    """
    T, din = x.shape
    n_tiles = T // tile
    ts = tile_slot.long()
    xt = x.reshape(n_tiles, tile, din)
    t = torch.einsum("ntd,ndr->ntr", xt.float(), A[ts].float())
    y = torch.einsum("ntr,nro->nto", t.to(x.dtype).float(), B[ts].float())
    return y.reshape(T, -1).to(x.dtype)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over paged KV.

    q: (B, Kh, G, dh) — grouped queries; k_pages/v_pages:
    (n_pages, page, Kh, dh); page_table: (B, pages_per_seq);
    lengths: (B,) valid tokens. Returns (B, Kh, G, dh).
    """
    B, Kh, G, dh = q.shape
    _, page, _, _ = k_pages.shape
    P = page_table.shape[1]
    pt = page_table.long()
    # Gather each sequence's pages: (B, P, page, Kh, dh).
    k = k_pages[pt].permute(0, 3, 1, 2, 4).reshape(B, Kh, P * page, dh)
    v = v_pages[pt].permute(0, 3, 1, 2, 4).reshape(B, Kh, P * page, dh)
    scores = torch.einsum("bkgd,bksd->bkgs", q.float(), k.float())
    scores = scores * (dh ** -0.5)
    valid = (torch.arange(P * page, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", *promoted(probs.to(v.dtype), v))
    return out.to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Plain attention oracle. q: (B,S,H,dh); k,v: (B,S,Kh,dh)."""
    return gqa_attention(q, k, v, causal=causal)
