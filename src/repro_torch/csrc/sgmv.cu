// sgmv — prefill-time segmented LoRA on Hopper.
//
// Replaces src/repro/kernels/sgmv.py::sgmv (body _sgmv_kernel): for
// every tile of `tile` consecutive tokens with adapter tile_slot[t],
//     y_tile = round_W(x_tile @ A[slot]) @ B[slot]
// with f32 accumulation, the rank-r intermediate rounded to the
// weights' dtype, and the output written in x's dtype.
//
// Bound: bytes at the engine's widths. Per call the card must read x
// (T x din), the used adapters' A and B and write y (T x dout); the
// 2 T r (din + dout) operations sit far below the bf16 ridge.
//
// Design: the shared shrink/expand pair of lora.cuh with 16 rows of a
// tile per block, so each A row and each B column read serves 16
// tokens. CUDA-core FMAs only: tensor cores are a later step.
#include "lora.cuh"

extern "C" int sgmv_launch(const void* x, const void* A, const void* B,
                           const void* tile_slot, void* part, void* y, int T,
                           int tile, int din, int r, int dout, int n_slots,
                           int n_split, int x_dtype, int w_dtype,
                           void* stream) {
  return lora::dispatch<16>(x, A, B, tile_slot, part, y, T, tile, din, r,
                            dout, n_slots, n_split, x_dtype, w_dtype, stream);
}
