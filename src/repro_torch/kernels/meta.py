"""The kernels' meta paths: shapes, dtypes and operation counts, no launch.

The dry-run (``launch/dryrun.py``) runs a step on ``meta`` tensors
(under ``FakeTensorMode``, each mesh position a ``meta:i`` device) and
counts the operations each op does. A kernel wrapper given meta tensors
calls the ``torch.library`` op here instead of launching: its fake
implementation gives the kernel's output shapes and dtypes, and its
operation count (``torch.utils.flop_counter.register_flop_formula``) is
the work the hand-written kernel does, not the arithmetic of the plain
version. These ops are used for meta tensors only: the card path (a
``ctypes`` launch) and the CPU path (the plain version) go through no
dispatcher op.

Counting rules (a multiply-add is two operations; a product computed
in split arithmetic, bf16 hi + lo or 3xTF32, counts once: the splits
are how it reaches its precision, not more of the function):

- bgmv: 2·Bt·r·(din + dout), the shrink and the expand of each row.
- sgmv: 2·T·r·(din + dout) over the T tile-aligned rows it is given
  (padding rows included: the kernel computes them).
- flash_attention: 4·dh·H·B·V, V the (query row, key) pairs the kernel
  visits. The forward walks, for each 64-row query tile, the 64-key
  tiles up to the tile's diagonal when causal (every key otherwise),
  masking inside the diagonal tile: a row r of a causal call visits
  min(S, 64·(r // 64 + 1)) keys (``visited_pairs``). Two products a
  pair: Q·Kᵀ and P·V.
- flash_attention_bwd: 14·dh·H·B·V over the same pairs. The dq kernel
  computes Q·Kᵀ, dO·Vᵀ and dS·K, the dk/dv kernel Q·Kᵀ and dO·Vᵀ again,
  Pᵀ·dO and dSᵀ·Q: seven products a pair (``csrc/flash_attention_bwd.cu``;
  its walks are 64 rows deep below dh 256, so they visit the forward's
  tiles).
"""
from __future__ import annotations

import torch
from torch.library import custom_op
from torch.utils.flop_counter import register_flop_formula

TILE = 64        # csrc/flash_attention.cu kTile; the backward's kRows


def visited_pairs(S: int, causal: bool) -> int:
    """(query row, key) pairs one (batch row, head) of flash_attention
    visits: every pair, or when causal each 64-row tile's keys up to the
    end of its diagonal tile."""
    if not causal:
        return S * S
    full, rest = divmod(S, TILE)
    # tile t (rows [64t, 64t + 64)) visits 64(t + 1) keys; a ragged last
    # tile of ``rest`` rows visits all S keys.
    return TILE * TILE * full * (full + 1) // 2 + rest * S


def _only_meta(name: str):
    raise RuntimeError(f"{name}: the meta op takes meta tensors only; "
                       f"cards launch the kernel, the CPU runs its plain "
                       f"version")


@custom_op("repro_torch::bgmv_meta", mutates_args=())
def bgmv(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
         idx: torch.Tensor) -> torch.Tensor:
    _only_meta("bgmv")


@bgmv.register_fake
def _(x, A, B, idx):
    return x.new_empty((x.shape[0], B.shape[2]))


@register_flop_formula(torch.ops.repro_torch.bgmv_meta)
def _(x_shape, A_shape, B_shape, idx_shape, *_, **__) -> int:
    return 2 * x_shape[0] * A_shape[2] * (A_shape[1] + B_shape[2])


@custom_op("repro_torch::sgmv_meta", mutates_args=())
def sgmv(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
         tile_slot: torch.Tensor, tile: int) -> torch.Tensor:
    _only_meta("sgmv")


@sgmv.register_fake
def _(x, A, B, tile_slot, tile):
    return x.new_empty((x.shape[0], B.shape[2]))


@register_flop_formula(torch.ops.repro_torch.sgmv_meta)
def _(x_shape, A_shape, B_shape, ts_shape, tile, *_, **__) -> int:
    return 2 * x_shape[0] * A_shape[2] * (A_shape[1] + B_shape[2])


@custom_op("repro_torch::flash_attention_meta", mutates_args=())
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    _only_meta("flash_attention")


@flash_attention.register_fake
def _(q, k, v, causal):
    B, S, H, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, S),
                                             dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.flash_attention_meta)
def _(q_shape, k_shape, v_shape, causal, *_, **__) -> int:
    B, S, H, dh = q_shape
    return 4 * dh * H * B * visited_pairs(S, causal)


@custom_op("repro_torch::flash_attention_bwd_meta", mutates_args=())
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, causal: bool
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _only_meta("flash_attention_bwd")


@flash_attention_bwd.register_fake
def _(q, k, v, out, dout, lse, causal):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd_meta)
def _(q_shape, k_shape, v_shape, out_shape_, dout_shape, lse_shape,
      causal, *_, **__) -> int:
    B, S, H, dh = q_shape
    return 14 * dh * H * B * visited_pairs(S, causal)
