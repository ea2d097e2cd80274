"""sgmv — prefill-time segmented LoRA (hand-written CUDA for Hopper).

The ops.py wrapper lays tokens out so every tile of ``tile`` tokens
belongs to exactly one adapter (``tile_slot[t]``); the kernel runs, per
tile,

    y_tile = round_W(x_tile @ A[slot]) @ B[slot]

Replaces ``src/repro/kernels/sgmv.py::sgmv`` (Pallas body
``_sgmv_kernel``), with the same f32 accumulation and rounding of the
rank-r intermediate to the weights' dtype (``sgmv.py:30``). Source:
``csrc/sgmv.cu``.

Bound on the H100: bytes at the engine's widths (x, the used adapters'
A and B, y); the 2·T·r·(din + dout) operations sit far below the bf16
ridge. Two instances of a shrink launch (x·A, din split over blocks,
f32 partial sums) and an expand launch (the splits summed in a fixed
order, rounded, times B), picked by ``sgmv_instance`` from the dtypes
alone:

- ``tensor_cores`` when x, A and B are all bf16 (the engine at full
  width): 64 rows of a tile per block, x and A streamed through a
  cp.async ring, both products on mma.sync; any tile, rank up to 128
  and ragged din/dout, masked in the kernel.
- ``cuda_cores`` when any operand is f32 (the reduced f32 models):
  ``csrc/lora.cuh`` with 16 rows of a tile per block and f32 FMAs.
  Tensor cores would round an f32 x to bf16 or TF32.

``STATS.instances`` counts the launches of each, ``STATS.tiles`` the
launches at each tile size (128 for a prefill bucket, 8 for a
speculative verify pass of 2-8 tokens a row). ``sgmv_plain`` is the
same function in plain PyTorch; the wrapper uses it only for CPU
tensors.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import meta
from .build import (CUDA_CORES, TENSOR_CORES, KernelStats, check_launch,
                    dtype_code, library, lora_splits, stream_handle)

MAX_RANK = 128


class SgmvStats(KernelStats):
    """``KernelStats`` plus the launches at each tile size."""

    def reset(self) -> None:
        super().reset()
        self.tiles: dict[int, int] = {}


STATS = SgmvStats()

ROWS_PER_BLOCK = 16          # CUDA-core instance (csrc/lora.cuh)
TC_ROWS_PER_BLOCK = 64       # tensor-core instance (csrc/sgmv.cu)
TC_DIN_STEP = 64             # din per pipeline stage of its shrink
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def sgmv_instance(x_dtype: torch.dtype, w_dtype: torch.dtype, r: int,
                  tile: int) -> str:
    """The kernel instance a CUDA call launches: ``tensor_cores`` when
    x and the weights are both bf16, else ``cuda_cores``. The rank
    (1..128) and the tile (any size) do not change the choice."""
    if not 1 <= r <= MAX_RANK or tile < 1:
        raise ValueError(f"sgmv takes rank 1..{MAX_RANK} and tile >= 1, "
                         f"got r={r}, tile={tile}")
    if x_dtype == w_dtype == torch.bfloat16:
        return TENSOR_CORES
    return CUDA_CORES


def tc_splits(T: int, tile: int, din: int) -> int:
    """How many blocks split din in the tensor-core shrink: about two
    waves over the H100's 132 SMs, at least four pipeline stages of din
    per split, at most 64 splits; each split a whole number of stages,
    every split non-empty. The wrapper allocates the (splits, T, r) f32
    partial sums."""
    n_chunks = (T // tile) * -(-tile // TC_ROWS_PER_BLOCK)
    want = max(1, min(-(-264 // n_chunks), din // (4 * TC_DIN_STEP), 64))
    split_len = -(-(-(-din // want)) // TC_DIN_STEP) * TC_DIN_STEP
    return -(-din // split_len)


def sgmv_plain(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               tile_slot: torch.Tensor, tile: int) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch (f32 accumulation)."""
    T, din = x.shape
    n_tiles = T // tile
    ts = tile_slot.long()
    xt = x.reshape(n_tiles, tile, din).float()
    t = torch.einsum("ntd,ndr->ntr", xt, A[ts].float())
    t = t.to(B.dtype).float()
    y = torch.einsum("ntr,nro->nto", t, B[ts].float())
    return y.reshape(T, -1).to(x.dtype)


def _check(x, A, B, tile_slot, tile):
    if x.dim() != 2 or A.dim() != 3 or B.dim() != 3 or tile_slot.dim() != 1:
        raise ValueError("sgmv expects x (T, din), A (n, din, r), "
                         "B (n, r, dout), tile_slot (T/tile,)")
    T, din = x.shape
    n, din_a, r = A.shape
    if tile < 1 or T % tile or tile_slot.shape[0] != T // tile:
        raise ValueError(f"sgmv needs T % tile == 0 and one slot per tile: "
                         f"T={T}, tile={tile}, "
                         f"tile_slot {tuple(tile_slot.shape)}")
    if din_a != din or B.shape[0] != n or B.shape[1] != r:
        raise ValueError(f"sgmv shape mismatch: x {tuple(x.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)}")
    if A.dtype != B.dtype:
        raise TypeError(f"A and B must share a dtype, got {A.dtype}, "
                        f"{B.dtype}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"sgmv supports rank 1..{MAX_RANK}, got {r}")
    devs = {t.device for t in (x, A, B, tile_slot)}
    if len(devs) != 1:
        raise ValueError(f"sgmv operands on several devices: {devs}")


def sgmv(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
         tile_slot: torch.Tensor, tile: int = 128) -> torch.Tensor:
    """x: (T, din), T % tile == 0; tile_slot: (T/tile,) adapter slots.

    CUDA tensors launch the kernel instance ``sgmv_instance`` names;
    CPU tensors take ``sgmv_plain``; meta tensors (the dry-run) its
    shapes and operation count (``meta.sgmv``).
    """
    _check(x, A, B, tile_slot, tile)
    if x.device.type == "cpu":
        STATS.plain += 1
        return sgmv_plain(x, A, B, tile_slot, tile)
    if x.device.type == "meta":
        return meta.sgmv(x, A, B, tile_slot, tile)
    if x.device.type != "cuda":
        raise ValueError(f"sgmv runs on cuda or cpu, not {x.device}")
    xc, wc = dtype_code(x, "x"), dtype_code(A, "A/B")
    x, A, B = x.contiguous(), A.contiguous(), B.contiguous()
    ts = tile_slot.to(torch.int32).contiguous()
    T, din = x.shape
    n, _, r = A.shape
    dout = B.shape[2]
    y = torch.empty((T, dout), dtype=x.dtype, device=x.device)
    if T == 0 or dout == 0:
        return y
    inst = sgmv_instance(x.dtype, A.dtype, r, tile)
    if inst == TENSOR_CORES:
        n_split = tc_splits(T, tile, din)
    else:
        n_split = lora_splits(T, tile, ROWS_PER_BLOCK, din, r)
    part = torch.empty((n_split, T, r), dtype=torch.float32,
                       device=x.device)
    lib = library("sgmv", _ARGTYPES)
    err = lib.sgmv_launch(x.data_ptr(), A.data_ptr(), B.data_ptr(),
                          ts.data_ptr(), part.data_ptr(), y.data_ptr(), T,
                          tile, din, r, dout, n, n_split, xc, wc,
                          int(inst == TENSOR_CORES), stream_handle(x.device))
    check_launch("sgmv", err)
    STATS.launched(inst)
    STATS.tiles[tile] = STATS.tiles.get(tile, 0) + 1
    return y


def pack_segments(seq_lens, adapter_slots, tile: int = 128):
    """Host-side packing: per-request segment → tile-aligned layout.

    Returns (perm, tile_slot, padded_T): ``perm[i]`` gives the source
    row of packed row i (or -1 for padding). Tokens of each request are
    padded up to a tile multiple so no tile spans two adapters.
    """
    perm, tile_slot = [], []
    src = 0
    for L, slot in zip(seq_lens, adapter_slots):
        pad = (-L) % tile
        perm.extend(range(src, src + L))
        perm.extend([-1] * pad)
        tile_slot.extend([slot] * ((L + pad) // tile))
        src += L
    return (np.asarray(perm, np.int32),
            np.asarray(tile_slot, np.int32),
            len(perm))
