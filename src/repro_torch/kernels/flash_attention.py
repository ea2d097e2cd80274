"""flash_attention — prefill attention over a whole sequence
(hand-written CUDA for Hopper).

Per (batch row b, query head h), with kv head h // G:

    out[b, :, h] = softmax(q[b, :, h] · K[b, :, h // G]^T / sqrt(dh)
                           [+ causal mask]) · V[b, :, h // G]

written in q's dtype. Replaces
``src/repro/kernels/flash_attention.py::flash_attention`` (Pallas body
``_flash_kernel``). Source: ``csrc/flash_attention.cu``.

Bound on the H100: bytes at the engine's (8, 256) prefill bucket,
operations (4·B·H·S²·dh, halved when causal) from about a thousand
positions. The Pallas grid walks the key blocks of one query block in
order and carries the online-softmax state in VMEM scratch; a CUDA
block per (64 query rows, h, b) walks its 64-position key tiles in a
loop with the state in registers, stops at the diagonal when causal,
and masks the ragged query rows and key columns itself, so any S works
(the engine's prefill buckets start at 8 positions; the Pallas kernel
needs S % 128 == 0). Two instances, picked by ``flash_instance`` from
dtype and head_dim alone:

- ``tensor_cores`` for bf16 with dh % 16 == 0 (the dense prefill at
  full width): both products on mma.sync, K/V through a cp.async double
  buffer, and the probabilities split into two bf16 parts (hi + lo) for
  P·V, so P keeps f32 accuracy as in the Pallas kernel.
- ``cuda_cores`` for f32, and for bf16 with dh % 16 != 0: f32 FMAs
  from 16-byte shared-memory reads. Tensor cores would change f32's
  arithmetic.

``STATS.instances`` counts the launches of each.
``flash_attention_plain`` is the function the kernel computes, in
plain PyTorch: the port's ``gqa_attention``, which the JAX package's
oracle also is; the wrapper uses it only for CPU tensors.

Both instances can also return each query row's log-sum-exp of the
scaled, masked scores (``return_lse=True``; f32, (B, H, S)), which the
backward reads instead of rebuilding it; ``flash_attention_lse_plain``
is its plain version (``torch.logsumexp``).

The gradient (new in the port: the JAX package trains through einsum
attention, which XLA differentiates, so no Pallas kernel has one):
``flash_attention_bwd`` launches ``csrc/flash_attention_bwd.cu`` on
tensor cores (``flash_bwd_instance``: ``tensor_cores``, bf16 mma.sync,
for bf16; ``tf32x3``, three TF32 products an f32 product, for f32): a
dq kernel that walks the key tiles once with P from the forward's
log-sum-exp and writes D = rowsum(dO * o), then a dk/dv kernel that
holds its K/V rows for the whole walk and sums the GQA group inside its
block, counted in ``BWD_STATS``; ``flash_attention_bwd_plain`` is
autograd through ``flash_attention_plain``. ``FlashAttentionFn`` is the
``torch.autograd.Function`` that ties the two kernels together: its
forward launches the forward kernel with ``return_lse=True`` and saves
q, k, v, the output and the log-sum-exp, its backward launches the
backward kernel on them (no second forward).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.models.layers import gqa_attention

from . import meta
from .build import (CUDA_CORES, TENSOR_CORES, TF32X3, KernelStats,
                    check_launch, dtype_code, library, stream_handle)

MAX_DH = 256
STATS = KernelStats()
BWD_STATS = KernelStats()

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
             + [ctypes.c_void_p] * 2)
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                 + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 2
                 + [ctypes.c_void_p])


def flash_instance(dtype: torch.dtype, dh: int) -> str:
    """The kernel instance a CUDA call launches: ``tensor_cores`` for
    bf16 with dh a multiple of 16, else ``cuda_cores``. Raises for a dh
    neither takes (above 256 or not a multiple of 4)."""
    if dh > MAX_DH or dh < 4 or dh % 4:
        raise ValueError(f"flash_attention supports dh <= {MAX_DH} a "
                         f"multiple of 4, got {dh}")
    if dtype == torch.bfloat16 and dh % 16 == 0:
        return TENSOR_CORES
    return CUDA_CORES


def flash_bwd_instance(dtype: torch.dtype, dh: int) -> str:
    """The backward kernel's instance: ``tensor_cores`` (bf16 mma.sync)
    for bf16, ``tf32x3`` for f32, any dh the forward takes. Raises for a
    dh it cannot take."""
    flash_instance(dtype, dh)
    return TENSOR_CORES if dtype == torch.bfloat16 else TF32X3


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True
                          ) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: the dense prefill's
    attention (``layers.gqa_attention``), exact softmax per row with the
    probabilities cast to v's dtype, query-chunked from 2048 rows."""
    return gqa_attention(q, k, v, causal=causal)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              causal: bool = True) -> torch.Tensor:
    """The log-sum-exp the kernel returns with ``return_lse=True``, in
    plain PyTorch: per (b, h, query row), ``torch.logsumexp`` of the
    scores q·k / sqrt(dh) in f32, keys after the row masked when causal.
    -> (B, H, S) f32."""
    B, S, H, dh = q.shape
    Kh = k.shape[2]
    qg = q.float().reshape(B, S, Kh, H // Kh, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * dh ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool, device=q.device)
                          .triu(1), float("-inf"))
    return torch.logsumexp(s, -1).reshape(B, H, S)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention expects q (B, S, H, dh), k/v (B, S, Kh, dh); "
            f"got q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")
    B, S, H, dh = q.shape
    Bk, Sk, Kh, dhk = k.shape
    if (Bk, Sk, dhk) != (B, S, dh) or Kh < 1 or H % Kh:
        raise ValueError(
            f"flash_attention shape mismatch: q {tuple(q.shape)}, "
            f"k/v {tuple(k.shape)} (H must be a multiple of Kh)")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention needs one dtype for q, k and v; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"flash_attention operands on several devices: "
                         f"{devs}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, *, return_lse: bool = False):
    """q: (B, S, H, dh); k/v: (B, S, Kh, dh) with H a multiple of Kh
    -> (B, S, H, dh) in q's dtype, and with ``return_lse`` also each
    query row's log-sum-exp (B, H, S) f32, as (out, lse).

    CUDA tensors launch the kernel instance ``flash_instance`` names
    (any S, dh <= 256 a multiple of 4, q/k/v of one dtype, f32 or bf16;
    strided views are read in place as long as the head_dim axis is
    contiguous); CPU tensors take ``flash_attention_plain`` (and
    ``flash_attention_lse_plain``); meta tensors (the dry-run) its shapes
    and operation count (``meta.flash_attention``).
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        STATS.plain += 1
        out = flash_attention_plain(q, k, v, causal)
        return (out, flash_attention_lse_plain(q, k, causal)) if return_lse \
            else out
    if q.device.type == "meta":
        out, lse = meta.flash_attention(q, k, v, causal)
        return (out, lse) if return_lse else out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    B, S, H, dh = q.shape
    Kh = k.shape[2]
    inst = flash_instance(q.dtype, dh)
    code = dtype_code(q, "q/k/v")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B == 0 or S == 0:
        return (out, lse) if return_lse else out
    lib = library("flash_attention", _ARGTYPES)
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        Kh, dh, *strides, int(causal), code, int(inst == TENSOR_CORES),
        lse.data_ptr() if return_lse else None, stream_handle(q.device))
    check_launch("flash_attention", err)
    STATS.launched(inst)
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              dout: torch.Tensor, causal: bool = True
                              ) -> tuple[torch.Tensor, ...]:
    """What the backward kernel computes, in plain PyTorch: (dq, dk, dv)
    by ``torch.autograd.grad`` through ``flash_attention_plain`` (which
    recomputes the forward, so ``out`` is not read)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = flash_attention_plain(*leaves, causal)
        return torch.autograd.grad(o, leaves, dout)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        causal: bool = True, *,
                        lse: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, ...]:
    """Gradient of ``flash_attention``: q, k, v as the forward took them,
    ``out`` its output and ``dout`` the output's gradient (both
    (B, S, H, dh), q's dtype), ``lse`` the log-sum-exp the forward
    returned with ``return_lse=True`` -> (dq, dk, dv) in q's dtype.

    CUDA tensors launch ``csrc/flash_attention_bwd.cu``, instance
    ``flash_bwd_instance`` (the shapes the forward takes; strided views
    read in place when head_dim is contiguous); without ``lse`` one
    forward launch with ``return_lse=True`` (counted in ``STATS``)
    supplies it first. CPU tensors take ``flash_attention_bwd_plain``,
    which needs no ``lse``; meta tensors (the dry-run) its shapes and
    operation count (``meta.flash_attention_bwd``).
    """
    _check(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"flash_attention_bwd: {name} must match q's shape, dtype "
                f"and device {tuple(q.shape)}, {q.dtype}, {q.device}; got "
                f"{tuple(t.shape)}, {t.dtype}, {t.device}")
    B, S, H, dh = q.shape
    if lse is not None and (lse.shape != (B, H, S)
                            or lse.dtype != torch.float32
                            or lse.device != q.device):
        raise ValueError(
            f"flash_attention_bwd: lse must be float32 {(B, H, S)} on "
            f"{q.device}; got {lse.dtype} {tuple(lse.shape)} on "
            f"{lse.device}")
    if q.device.type == "cpu":
        BWD_STATS.plain += 1
        return flash_attention_bwd_plain(q, k, v, out, dout, causal)
    if q.device.type == "meta":
        if lse is None:
            _, lse = meta.flash_attention(q, k, v, causal)
        return meta.flash_attention_bwd(q, k, v, out, dout, lse, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not "
                         f"{q.device}")
    Kh = k.shape[2]
    inst = flash_bwd_instance(q.dtype, dh)  # raises for a dh it cannot take
    code = dtype_code(q, "q/k/v")
    q, k, v, out, dout = (t if t.stride(-1) == 1 else t.contiguous()
                          for t in (q, k, v, out, dout))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if B == 0 or S == 0:
        return dq, dk, dv
    if lse is None:
        _, lse = flash_attention(q, k, v, causal, return_lse=True)
    lse = lse.contiguous()
    delta = torch.empty_like(lse)
    strides = (ctypes.c_longlong * 24)(*(
        st for t in (q, k, v, out, dout, dq, dk, dv)
        for st in t.stride()[:3]))
    lib = library("flash_attention_bwd", _BWD_ARGTYPES)
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), B, S, H, Kh, dh, strides,
        int(causal), code, stream_handle(q.device))
    check_launch("flash_attention_bwd", err)
    BWD_STATS.launched(inst)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with the backward kernel as its gradient: the
    forward launches the forward kernel with ``return_lse=True`` and
    saves q, k, v, the output and the log-sum-exp; the backward launches
    ``flash_attention_bwd`` on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention(q, k, v, causal, return_lse=True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.to(out.dtype),
                                         ctx.causal, lse=lse)
        return dq, dk, dv, None
