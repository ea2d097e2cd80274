"""Public wrappers for the CUDA kernels + the LoRA dispatch layer.

Kernel choice follows the tensors: the kernel wrappers launch the
hand-written CUDA kernel for CUDA tensors and run their plain PyTorch
version for CPU tensors. There is no switch around them: a card tensor
always goes through its kernel. The oracles in ``ref`` serve only the
tests.

The LoRA *dispatch layer* (``resolve_lora_backend`` /
``lora_delta_kernel``) is what the model data plane calls
(models/lora_apply.py): decode steps (S == 1) route per-token LoRA
through bgmv, batched prefill (S > 1, one contiguous run of S tokens per
request) through sgmv with tile-aligned segments, and the einsum path
stays available as the CPU route. The JAX wrappers pad din and
dout to 128 for the TPU's tiling; the CUDA kernels mask ragged edges
themselves, so nothing here pads them.

flash_attention has a backward kernel: card tensors that require grad,
with grad mode on, go through ``FlashAttentionFn`` (the training path).
bgmv, sgmv and paged_attention have none, since LoRA and paged decode
do not enter ``train_loss``: their wrappers, given such tensors, raise
``NotImplementedError`` (``_no_autograd``) rather than return a tensor
autograd cannot see through.
"""
from __future__ import annotations

import contextlib
import time

import torch

from .bgmv import bgmv as _bgmv_kernel
from .flash_attention import FlashAttentionFn
from .flash_attention import flash_attention as _flash_kernel
from .paged_attention import paged_attention as _paged_kernel
from .sgmv import pack_segments, sgmv as _sgmv_kernel

LORA_BACKENDS = ("auto", "einsum", "kernel")


def _on_card(t: torch.Tensor) -> bool:
    """Whether a wrapper launches its CUDA kernel for ``t``."""
    return t.device.type == "cuda"


def _no_autograd(name: str, *ts: torch.Tensor) -> None:
    """Refuse a kernel call autograd would need to see through.

    The CUDA kernels launch through ``ctypes`` and record no autograd
    graph, so their output would be a tensor cut off from its inputs
    and a ``backward()`` would silently miss their gradients. bgmv, sgmv
    and paged_attention have no backward kernel (no training path runs
    them), so a card call with grad mode on and an input that requires
    grad raises; CPU tensors run the plain versions, where autograd
    works."""
    if _needs_grad(*ts):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward pass (LoRA and "
            f"paged decode are not on the training path); call it under "
            f"torch.no_grad() or on CPU tensors")


def _needs_grad(*ts: torch.Tensor) -> bool:
    """A card call autograd would have to differentiate."""
    return (torch.is_grad_enabled() and _on_card(ts[0])
            and any(t.requires_grad for t in ts))


def _meta_grad(*ts: torch.Tensor) -> bool:
    """A meta call (the dry-run) autograd would have to differentiate:
    it takes the card's autograd path, with the meta ops in place of the
    launches."""
    return (torch.is_grad_enabled() and ts[0].device.type == "meta"
            and any(t.requires_grad for t in ts))


class DispatchMeter:
    """Hot-loop observability: device dispatches and host-sync wall time.

    The serving engine ticks the meter once per device dispatch it
    launches on the decode path (one fused horizon, or one decode step
    plus one sampling call on the seed loop) and wraps its device→host
    token reads in ``sync()``. Dispatches per token and the host-sync
    fraction are the two numbers the fused loop exists to shrink. A
    plain counter + accumulator, so the meter stays on in production
    paths.

    Speculative decoding splits its device work into
    ``draft_dispatches`` (draft forwards: the chained proposal steps
    and the draft-KV catch-up passes) and ``verify_dispatches``
    (multi-token target verify passes); ``dispatches`` still counts the
    dispatches launched, so one speculative block ticks ``tick(1)``
    plus the per-phase counts of the forwards inside it.
    """

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.dispatches = 0
        self.draft_dispatches = 0
        self.verify_dispatches = 0
        self.sync_seconds = 0.0

    def tick(self, n: int = 1) -> None:
        self.dispatches += n

    def tick_draft(self, n: int = 1) -> None:
        self.draft_dispatches += n

    def tick_verify(self, n: int = 1) -> None:
        self.verify_dispatches += n

    @contextlib.contextmanager
    def sync(self):
        """Time a blocking device→host readback."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync_seconds += time.perf_counter() - t0


#: Process-wide meter the engine step loops tick (reset by benchmarks).
DISPATCH_METER = DispatchMeter()


class CollectiveMeter(DispatchMeter):
    """DISPATCH_METER-style probe for the sharded data plane.

    A mesh>1 engine ticks this once per sharded dispatch; the gather
    points of ``distributed.act_sharding`` count each gather in
    ``gathers`` and time it in ``sync()`` (host seconds: on the card
    the launch of the copies, which then run in stream order), so
    ``frac()`` reports the gather/wall time fraction the per-device
    gauges export. The train step's FSDP collectives count here too
    (``distributed.sharding.all_gather`` in ``gathers``,
    ``reduce_scatter`` in ``reduces``, the MoE exchange each way in
    ``all_to_alls``). ``reset()`` also restarts the
    wall clock the fraction is taken over.
    """

    def __init__(self) -> None:
        super().__init__()
        self._t0 = time.perf_counter()

    def reset(self) -> None:
        super().reset()
        self.gathers = 0
        self.reduces = 0
        self.all_to_alls = 0
        self._t0 = time.perf_counter()

    def frac(self) -> float:
        wall = time.perf_counter() - self._t0
        return (self.sync_seconds / wall) if wall > 0 else 0.0


#: Process-wide probe for sharded (mesh>1) engine dispatches.
COLLECTIVE_METER = CollectiveMeter()


def resolve_lora_backend(backend: str | None,
                         device: torch.device | str) -> str:
    """Resolve an ``EngineConfig.lora_backend`` knob to a concrete path.

    ``auto`` (or None) picks the CUDA kernels on a CUDA device and the
    einsum path elsewhere; ``kernel`` forces the kernel wrappers (their
    plain versions on CPU tensors); ``einsum`` forces the einsum path.
    """
    if backend in (None, "auto"):
        return "kernel" if torch.device(device).type == "cuda" else "einsum"
    if backend not in ("einsum", "kernel"):
        raise ValueError(
            f"lora_backend must be one of {LORA_BACKENDS}, got {backend!r}")
    return backend


def lora_bgmv(x, A, B, idx):
    """Decode LoRA delta. x: (Bt, din) -> (Bt, dout)."""
    _no_autograd("bgmv", x, A, B)
    return _bgmv_kernel(x, A, B, idx)


def lora_sgmv(x, A, B, seq_lens, adapter_slots, *, tile: int = 128):
    """Prefill LoRA delta over concatenated sequences.

    x: (T, din) tokens concatenated per request (seq_lens[i] each),
    adapter_slots[i] the adapter of request i. Returns (T, dout).
    """
    _no_autograd("sgmv", x, A, B)
    perm, tile_slot, _ = pack_segments(seq_lens, adapter_slots, tile)
    perm_t = torch.as_tensor(perm, dtype=torch.long, device=x.device)
    valid = perm_t >= 0
    gathered = torch.where(valid[:, None], x[perm_t.clamp(min=0)],
                           torch.zeros((), dtype=x.dtype, device=x.device))
    ts = torch.as_tensor(tile_slot, dtype=torch.int32, device=x.device)
    y = _sgmv_kernel(gathered, A, B, ts, tile)
    # Scatter back to original token order.
    out = torch.zeros((x.shape[0], y.shape[-1]), dtype=y.dtype,
                      device=x.device)
    return out.index_add_(0, perm_t[valid], y[valid])


def _lora_sgmv_uniform(x, A, B, idx, tile):
    """Prefill LoRA via sgmv for *uniform* segments.

    x: (Bt, S, din) — request b's tokens are the contiguous run x[b],
    all runs the same length S, adapter idx[b] per run: the batched
    prefill layout the engine produces (right-padded (B, S) buckets).
    S is padded up to a tile multiple and ``tile_slot`` is idx repeated
    per tile; the tile shrinks to a multiple of 8 for short S.
    """
    Bt, S, din = x.shape
    tile = min(tile, -(-S // 8) * 8)
    S_pad = -(-S // tile) * tile
    if S_pad != S:
        x = torch.nn.functional.pad(x, (0, 0, 0, S_pad - S))
    xt = x.reshape(Bt * S_pad, din)
    tile_slot = idx.to(torch.int32).repeat_interleave(S_pad // tile)
    y = _sgmv_kernel(xt, A, B, tile_slot, tile)
    return y.reshape(Bt, S_pad, -1)[:, :S]


def lora_delta_kernel(x, A, B, idx, *, scale: float = 1.0,
                      tile: int = 128):
    """Multi-adapter LoRA delta through the kernels.

    x: (Bt, S, din); A: (n_slots, din, r); B: (n_slots, r, dout);
    idx: (Bt,). Decode (S == 1) routes through bgmv (one gathered
    adapter per token); prefill (S > 1) routes each request's
    contiguous token run through sgmv tiles. Returns (Bt, S, dout).
    """
    _no_autograd("bgmv" if x.shape[1] == 1 else "sgmv", x, A, B)
    if x.shape[1] == 1:
        y = _bgmv_kernel(x[:, 0].contiguous(), A, B, idx)[:, None]
    else:
        y = _lora_sgmv_uniform(x, A, B, idx, tile)
    if scale != 1.0:        # 1.0 * y is y: skip the launch
        y = scale * y
    return y.to(x.dtype)


def paged_attention(q, k_pages, v_pages, page_table, lengths):
    """Decode attention over paged KV; see paged_attention.py."""
    _no_autograd("paged_attention", q, k_pages, v_pages)
    return _paged_kernel(q, k_pages, v_pages, page_table, lengths)


def flash_attention(q, k, v, causal: bool = True):
    """Attention over a whole sequence; see flash_attention.py. Card
    tensors that need a gradient go through ``FlashAttentionFn``, whose
    backward is the flash_attention_bwd kernel; meta tensors that need
    one take the same path through the meta ops (the dry-run)."""
    if _needs_grad(q, k, v) or _meta_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal)
    return _flash_kernel(q, k, v, causal)
