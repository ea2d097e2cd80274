"""Core layer primitives: norms, RoPE (+M-RoPE), GQA attention, SwiGLU,
cross-entropy (PyTorch).

Port of ``src/repro/models/layers.py`` with the JAX package's layouts at
every public function. GQA never materialises repeated KV heads:
queries are reshaped to (kv_head, group) and contracted against the raw
KV tensors. Softmax and norms accumulate in fp32 regardless of
activation dtype.

dtype rules follow ``jnp``: a plain contraction runs in the promoted
dtype of its operands (bf16 x f32 -> f32; ``torch.einsum`` would raise
on the mix), and a ``preferred_element_type=float32`` contraction runs
on f32 operands.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def promoted(*ts: torch.Tensor) -> list[torch.Tensor]:
    """Operands cast to their promoted dtype (``jnp.promote_types``)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t if t.dtype == dt else t.to(dt) for t in ts]


def einsum(eq: str, *ts: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` without a preferred type: promoted-dtype einsum."""
    return torch.einsum(eq, *promoted(*ts))


def einsum_f32(eq: str, *ts: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(..., preferred_element_type=float32)``."""
    return torch.einsum(eq, *(t.float() for t in ts))


# ---------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def head_rms_norm(x: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """qk_norm (qwen3): per-head RMS over head_dim; w is (head_dim,)."""
    return rms_norm(x, w, eps)


# ---------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., S) int -> cos/sin (..., S, head_dim/2)."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  sections: tuple[int, ...]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multimodal RoPE (qwen2-vl): positions (3, B, S) for the t/h/w axes.

    The head_dim/2 frequency slots are partitioned into ``sections``
    (t, h, w); each section takes its angle from the matching position
    axis. Text tokens carry identical t/h/w positions, so M-RoPE reduces
    to 1-D RoPE for them. Returns cos/sin (B, S, head_dim/2).
    """
    if positions.shape[0] != 3:
        raise ValueError(f"M-RoPE positions must be (3, B, S), got "
                         f"{tuple(positions.shape)}")
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim/2 = {half}")
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang_all = positions.float()[..., None] * freqs        # (3, B, S, half)
    parts, off = [], 0
    for axis, sec in enumerate(sections):
        parts.append(ang_all[axis, ..., off:off + sec])
        off += sec
    ang = torch.cat(parts, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) — rotate-half convention."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------ attention
# Above this query length, attention runs query-chunked (memory-bounded).
Q_CHUNK_THRESHOLD = 2048
Q_CHUNK = 1024


def _masked_softmax_out(scores, mask, v):
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)


def _attn_block(qg, k, v, q_offset, kv_len, causal, scale):
    """One query block. qg: (B, Sq, Kh, G, D); full k/v. Exact softmax
    per query row (query-chunking needs no online rescaling)."""
    Sq = qg.shape[1]
    Sk = k.shape[1]
    dev = qg.device
    scores = einsum_f32("bqkgd,bskd->bkgqs", qg, k) * scale
    mask = None
    if causal:
        qpos = torch.arange(Sq, device=dev)[:, None] + q_offset
        kpos = torch.arange(Sk, device=dev)[None, :]
        mask = (kpos <= qpos)[None, None, None]
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=dev).reshape(-1, 1)
        valid = torch.arange(Sk, device=dev)[None, :] < kv_len
        valid = valid[:, None, None, None, :]
        mask = valid if mask is None else (mask & valid)
    return _masked_softmax_out(scores, mask, v)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, q_offset=0,
                  kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """Grouped-query attention without KV duplication.

    q: (B, Sq, H, D); k, v: (B, Sk, Kh, D) with H = Kh * G.
    ``q_offset`` is the absolute position of q[0] (decode: cache length).
    ``kv_len`` masks out cache slots >= kv_len (padded decode caches).
    Long sequences run query-chunked (blocks of ``Q_CHUNK`` queries) so
    the (Sq, Sk) score matrix never materialises. Returns (B, Sq, H, D).
    """
    B, Sq, H, D = q.shape
    Kh = k.shape[2]
    G = H // Kh
    qg = q.reshape(B, Sq, Kh, G, D)
    scale = D ** -0.5
    if Sq < Q_CHUNK_THRESHOLD or Sq % Q_CHUNK != 0:
        out = _attn_block(qg, k, v, q_offset, kv_len, causal, scale)
        return out.reshape(B, Sq, H, D)
    outs = [_attn_block(qg[:, c:c + Q_CHUNK], k, v, q_offset + c, kv_len,
                        causal, scale)
            for c in range(0, Sq, Q_CHUNK)]
    return torch.cat(outs, dim=1).reshape(B, Sq, H, D)


def suffix_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_positions: torch.Tensor) -> torch.Tensor:
    """Causal attention where each *row* starts at its own offset.

    Suffix prefill over a prefix-cache hit: row ``b``'s queries sit at
    absolute positions ``q_positions[b, :]`` while k/v hold the whole
    context (cached prefix + fresh suffix, gathered from KV pages). The
    per-row mask is ``kpos <= q_positions[b, i]``; otherwise this is the
    exact ``_attn_block`` computation (same contractions, NEG_INF
    masking, softmax), plain einsum by design.

    q: (B, S, H, D); k, v: (B, T, Kh, D); q_positions: (B, S) int.
    Returns (B, S, H, D).
    """
    B, S, H, D = q.shape
    Kh = k.shape[2]
    G = H // Kh
    qg = q.reshape(B, S, Kh, G, D)
    scale = D ** -0.5
    scores = einsum_f32("bqkgd,bskd->bkgqs", qg, k) * scale
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = kpos[None, None, :] <= q_positions[:, :, None]   # (B, S, T)
    out = _masked_softmax_out(scores, mask[:, None, None], v)
    return out.reshape(B, S, H, D)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """Single-token decode against a padded KV cache.

    q: (B, 1, H, D); caches: (B, Smax, Kh, D); cache_len: (B,) — number
    of valid entries (the new token's KV must already be written).
    """
    return gqa_attention(q, k_cache, v_cache, causal=False,
                         kv_len=cache_len)


# ----------------------------------------------------------------- MLP
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = einsum("bsd,df->bsf", x, w_gate)
    u = einsum("bsd,df->bsf", x, w_up)
    return einsum("bsf,fd->bsd", F.silu(g) * u, w_down)


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    h = F.gelu(einsum("bsd,df->bsf", x, w_up), approximate="tanh")
    return einsum("bsf,fd->bsd", h, w_down)


# ---------------------------------------------------------- embeddings
def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def embed_sharded(tokens: torch.Tensor, tables: list) -> torch.Tensor:
    """``embed`` over a vocab-sharded table: ``tables[i]`` holds the
    i-th block of rows, on its own device. Each block looks up the ids
    it holds (the others clamped, then masked) and a select keeps the
    owner's row, on the first block's device. A row lookup is a copy, so
    this equals ``embed`` on the whole table exactly."""
    home = tables[0].device
    tok = tokens.to(home).long()
    out, lo = None, 0
    for tab in tables:
        n = tab.shape[0]
        rows = tab[(tok.to(tab.device) - lo).clamp(0, n - 1)].to(home)
        mine = ((tok >= lo) & (tok < lo + n))[..., None]
        out = rows if out is None else torch.where(mine, rows, out)
        lo += n
    return out


def embed_rows(tokens: torch.Tensor, table: torch.Tensor,
               lo: int) -> torch.Tensor:
    """Rows of a block of the embedding table holding ids [lo, lo + n):
    the ids it holds looked up, the others zero. Summed over the blocks
    (each id has one owner, the other terms are zeros) this is ``embed``
    on the whole table, exactly."""
    n = table.shape[0]
    tok = tokens.long() - lo
    mine = ((tok >= 0) & (tok < n))[..., None]
    return torch.where(mine, table[tok.clamp(0, n - 1)], 0)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D); table: (D, V) -> f32 logits (B, S, V).

    ``preferred_element_type=float32``: the product runs on f32
    operands, so bf16 weights give f32 logits that are not rounded back
    to bf16 (greedy argmax would otherwise see bf16 ties).
    """
    return einsum_f32("bsd,dv->bsv", x, table)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token NLL in fp32. logits (B,S,V), labels (B,S) int; with
    ``mask`` (B,S) the masked mean over ``max(mask.sum(), 1)``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None]).squeeze(-1)
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def cross_entropy_columns(blocks: list, labels: torch.Tensor
                          ) -> torch.Tensor:
    """``cross_entropy`` of logits split over the vocabulary: ``blocks``
    are (B, S, V_m) f32 blocks in vocabulary order, each on its own
    device. Each block gives its exp-sum under the rows' shared maximum
    and its label logits (zero where another block holds the label);
    the sums run in block order on the first block's device. One block
    is ``cross_entropy``."""
    if len(blocks) == 1:
        return cross_entropy(blocks[0], labels)
    home = blocks[0].device
    lab = labels.to(home).long()
    # The shift cancels in the value and the gradient: no grad through it.
    mx = torch.stack([b.detach().amax(-1).to(home) for b in blocks]).amax(0)
    se = gold = None
    lo = 0
    for blk in blocks:
        dev, n = blk.device, blk.shape[-1]
        s = torch.exp(blk.float() - mx.to(dev)[..., None]).sum(-1).to(home)
        i = lab.to(dev) - lo
        mine = (i >= 0) & (i < n)
        g = torch.gather(blk.float(), -1, i.clamp(0, n - 1)[..., None])
        g = torch.where(mine, g.squeeze(-1), 0).to(home)
        se, gold = (s, g) if se is None else (se + s, gold + g)
        lo += n
    return (torch.log(se) + mx - gold).mean()
