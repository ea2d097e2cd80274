"""llama4-maverick-400b-a17b [moe]: 48L d5120 40H/8kv ff8192 V=202048,
MoE 128e top-1, interleaved (MoE every 2nd layer) + shared expert —
matches ~400B total / ~17B active. Early-fusion multimodal frontend is
out of backbone scope (text path only). [hf:meta-llama/Llama-4; unverified]
"""
from repro_torch.models.base import Family, ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family=Family.MOE,
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    n_experts=128, top_k=1, d_ff_expert=8192, shared_expert_ff=8192,
    moe_every=2, rope_theta=5e5)
