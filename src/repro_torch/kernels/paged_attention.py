"""paged_attention — decode attention over a paged KV pool (hand-written
CUDA for Hopper).

The serving engine stores KV in fixed-size pages; request b's pages are
listed in ``page_table[b]``. Per (batch row, kv head):

    out[b,h] = softmax(q[b,h] · K[pages(b)] / sqrt(dh)) · V[pages(b)]

with positions >= ``lengths[b]`` masked at -1e30 and the output divided
by max(denominator, 1e-30), written in q's dtype. Replaces
``src/repro/kernels/paged_attention.py::paged_attention`` (Pallas body
``_paged_attn_kernel``). Source: ``csrc/paged_attention.cu``.

Bound on the H100: bytes — each row's valid K and V pages, read once.
Where the Pallas grid visits every page of the table in order and
carries the online-softmax state across grid steps, the CUDA kernel
visits only a row's ``ceil(lengths[b] / page)`` pages and splits them
over a thread-block cluster of ``splits`` blocks per (b, kv head), in
one launch: each warp scores whole K rows with coalesced loads staged
through a cp.async ring, keeps its own online softmax, the warps of a
block merge once, and the blocks of the cluster merge once through
distributed shared memory in split order. ``paged_attention_plain`` is
the same function in plain PyTorch; the wrapper uses it only for CPU
tensors.
"""
from __future__ import annotations

import ctypes

import torch

from .build import (CUDA_CORES, KernelStats, check_launch, dtype_code,
                    library, stream_handle)

NEG_INF = -1e30
MAX_G, MAX_DH = 16, 256
# Blocks per (row, kv head), one cluster each: at most 8, the portable
# cluster size. SPLITS is the one measured point of the served path
# (8 rows x 32 kv heads of Llama-7B on an H100): 2 ran as fast as 1 and
# faster than 4 or 8 (PERF.md section 6).
SPLITS = 2
MAX_SPLITS = 8
STATS = KernelStats()

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: the exact softmax the
    online recurrence evaluates (queries pre-scaled, f32 throughout)."""
    B, Kh, G, dh = q.shape
    _, page, _, _ = k_pages.shape
    P = page_table.shape[1]
    pt = page_table.long()
    k = k_pages[pt].permute(0, 3, 1, 2, 4).reshape(B, Kh, P * page, dh)
    v = v_pages[pt].permute(0, 3, 1, 2, 4).reshape(B, Kh, P * page, dh)
    qs = q.float() * (dh ** -0.5)
    scores = torch.einsum("bkgd,bksd->bkgs", qs, k.float())
    valid = (torch.arange(P * page, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _check(q, k_pages, v_pages, page_table, lengths):
    if q.dim() != 4 or k_pages.dim() != 4 or page_table.dim() != 2:
        raise ValueError("paged_attention expects q (B, Kh, G, dh), pages "
                         "(n_pages, page, Kh, dh), page_table (B, P)")
    B, Kh, G, dh = q.shape
    n_pages, page, Kh_p, dh_p = k_pages.shape
    if v_pages.shape != k_pages.shape or (Kh_p, dh_p) != (Kh, dh) \
            or page_table.shape[0] != B or lengths.shape != (B,):
        raise ValueError(
            f"paged_attention shape mismatch: q {tuple(q.shape)}, k "
            f"{tuple(k_pages.shape)}, v {tuple(v_pages.shape)}, table "
            f"{tuple(page_table.shape)}, lengths {tuple(lengths.shape)}")
    if k_pages.dtype != v_pages.dtype:
        raise TypeError("k_pages and v_pages must share a dtype")
    devs = {t.device for t in (q, k_pages, v_pages, page_table, lengths)}
    if len(devs) != 1:
        raise ValueError(f"paged_attention operands on several devices: "
                         f"{devs}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, splits: int = SPLITS
                    ) -> torch.Tensor:
    """q: (B, Kh, G, dh); k/v_pages: (n_pages, page, Kh, dh);
    page_table: (B, P) ints; lengths: (B,) ints -> (B, Kh, G, dh).

    CUDA tensors launch the kernel with ``splits`` blocks (one cluster)
    per (row, kv head), 1..8; CPU
    tensors take ``paged_attention_plain``. Rows need ``lengths >= 1``
    to match the Pallas kernel up to summation order (the engine passes
    ``cache_len + 1``).
    """
    _check(q, k_pages, v_pages, page_table, lengths)
    if q.device.type == "cpu":
        STATS.plain += 1
        return paged_attention_plain(q, k_pages, v_pages, page_table,
                                     lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    B, Kh, G, dh = q.shape
    n_pages, page, _, _ = k_pages.shape
    P = page_table.shape[1]
    if G > MAX_G or dh > MAX_DH or dh % 4:
        raise ValueError(f"paged_attention supports G <= {MAX_G} and dh "
                         f"<= {MAX_DH} a multiple of 4; got G={G}, "
                         f"dh={dh}")
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"paged_attention splits must be in "
                         f"1..{MAX_SPLITS}, got {splits}")
    qc, kc = dtype_code(q, "q"), dtype_code(k_pages, "k/v_pages")
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if B == 0 or P == 0:
        return out.zero_()
    lib = library("paged_attention", _ARGTYPES)
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), pt.data_ptr(),
        lens.data_ptr(), out.data_ptr(), B, Kh, G, dh, page, P, n_pages,
        splits, qc, kc, stream_handle(q.device))
    check_launch("paged_attention", err)
    STATS.launched(CUDA_CORES)
    return out
