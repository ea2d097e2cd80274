// bgmv — decode-time batched-gather LoRA on Hopper.
//
// Replaces src/repro/kernels/bgmv.py::bgmv (body _bgmv_kernel):
//     y[b] = round_W(x[b] @ A[idx[b]]) @ B[idx[b]]
// with the rank-r intermediate accumulated in f32, rounded to the
// weights' dtype, expanded in f32 and written in x's dtype.
//
// Bound: bytes. Per call the card must read x, the distinct adapters'
// A and B and write y: at Llama-7B decode width (8 tokens, 4096 wide,
// r 32) about 4 MB, 1.3 us at 3.35 TB/s, so the call is bound by
// launch latency and by how many loads are in flight.
//
// Design: the shared shrink/expand pair of lora.cuh with one row per
// block (each token has its own slot). The shrink splits din over
// blocks so 8 tokens still spread over the card; the expand sums the
// splits in a fixed order, rounds, and writes 256 columns per block.
#include "lora.cuh"

extern "C" int bgmv_launch(const void* x, const void* A, const void* B,
                           const void* idx, void* part, void* y, int Bt,
                           int din, int r, int dout, int n_slots,
                           int n_split, int x_dtype, int w_dtype,
                           void* stream) {
  return lora::dispatch<1>(x, A, B, idx, part, y, Bt, /*tile=*/1, din, r,
                           dout, n_slots, n_split, x_dtype, w_dtype, stream);
}
