"""bgmv — decode-time batched-gather LoRA (hand-written CUDA for Hopper).

One token per request; request b applies adapter ``idx[b]``:

    y[b] = round_W(x[b] @ A[idx[b]]) @ B[idx[b]]

Replaces ``src/repro/kernels/bgmv.py::bgmv`` (Pallas body
``_bgmv_kernel``): the rank-r intermediate is accumulated in f32,
rounded to the weights' dtype (``bgmv.py:33``), expanded in f32 and
written in x's dtype. Source: ``csrc/bgmv.cu``.

Bound on the H100: bytes (x, the used adapters' A and B, y), about
4 MB at the engine's decode widths, so the call is bound by launch
latency and by how many loads are in flight. One launch, no scratch
tensor: each token row gets a thread-block cluster of ``splits``
blocks; each block shrinks a slice of din with 16-byte loads, the
blocks' rank-r partial sums meet through distributed shared memory (in
split order, so results do not vary between runs), and each block
expands a slice of dout. ``bgmv_plain`` is the same function in plain
PyTorch; the wrapper uses it only for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from .build import (CUDA_CORES, KernelStats, check_launch, dtype_code,
                    library, stream_handle)

MAX_RANK = 128
# Blocks per token row: one cluster each. 16 is Hopper's largest
# (non-portable) cluster size; at the engine's 8 decode rows it gives
# 128 blocks, about one wave over the H100's 132 SMs.
SPLITS = 16
MAX_SPLITS = 16
STATS = KernelStats()

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def bgmv_plain(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch (f32 accumulation)."""
    idx = idx.long()
    t = torch.einsum("bd,bdr->br", x.float(), A[idx].float())
    t = t.to(B.dtype).float()
    y = torch.einsum("br,bro->bo", t, B[idx].float())
    return y.to(x.dtype)


def _check(x, A, B, idx):
    if x.dim() != 2 or A.dim() != 3 or B.dim() != 3 or idx.dim() != 1:
        raise ValueError("bgmv expects x (Bt, din), A (n, din, r), "
                         "B (n, r, dout), idx (Bt,)")
    Bt, din = x.shape
    n, din_a, r = A.shape
    if din_a != din or B.shape[0] != n or B.shape[1] != r \
            or idx.shape[0] != Bt:
        raise ValueError(f"bgmv shape mismatch: x {tuple(x.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)}, idx "
                         f"{tuple(idx.shape)}")
    if A.dtype != B.dtype:
        raise TypeError(f"A and B must share a dtype, got {A.dtype}, "
                        f"{B.dtype}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"bgmv supports rank 1..{MAX_RANK}, got {r}")
    devs = {t.device for t in (x, A, B, idx)}
    if len(devs) != 1:
        raise ValueError(f"bgmv operands on several devices: {devs}")


def bgmv(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
         idx: torch.Tensor, splits: int = SPLITS) -> torch.Tensor:
    """x: (Bt, din); A: (n, din, r); B: (n, r, dout); idx: (Bt,) ints.

    CUDA tensors launch the kernel with ``splits`` blocks (one cluster)
    per token row, 1..16; CPU tensors take ``bgmv_plain``.
    """
    _check(x, A, B, idx)
    if x.device.type == "cpu":
        STATS.plain += 1
        return bgmv_plain(x, A, B, idx)
    if x.device.type != "cuda":
        raise ValueError(f"bgmv runs on cuda or cpu, not {x.device}")
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"bgmv splits must be in 1..{MAX_SPLITS}, got "
                         f"{splits}")
    xc, wc = dtype_code(x, "x"), dtype_code(A, "A/B")
    x, A, B = x.contiguous(), A.contiguous(), B.contiguous()
    idx = idx.to(torch.int32).contiguous()
    Bt, din = x.shape
    n, _, r = A.shape
    dout = B.shape[2]
    y = torch.empty((Bt, dout), dtype=x.dtype, device=x.device)
    if Bt == 0 or dout == 0:
        return y
    lib = library("bgmv", _ARGTYPES)
    err = lib.bgmv_launch(x.data_ptr(), A.data_ptr(), B.data_ptr(),
                          idx.data_ptr(), y.data_ptr(), Bt, din, r, dout, n,
                          splits, xc, wc, stream_handle(x.device))
    check_launch("bgmv", err)
    STATS.launched(CUDA_CORES)
    return y
