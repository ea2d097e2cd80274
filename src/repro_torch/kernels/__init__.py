"""Hand-written Hopper kernels for the serving hot spots + torch oracles.

bgmv  — decode-time batched-gather LoRA (csrc/bgmv.cu)
sgmv  — prefill-time segmented LoRA matmul (csrc/sgmv.cu)
paged_attention — decode attention over the paged KV pool
                  (csrc/paged_attention.cu)
flash_attention — prefill attention over a whole sequence
                  (csrc/flash_attention.cu), and its gradient for
                  training (csrc/flash_attention_bwd.cu)

Importing this package needs no CUDA toolkit: kernels build at first
launch (see build.py).
"""
from .ops import flash_attention, lora_bgmv, lora_sgmv, paged_attention
from . import ref
