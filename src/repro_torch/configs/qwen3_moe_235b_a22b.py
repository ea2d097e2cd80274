"""qwen3-moe-235b-a22b [moe]: 94L d4096 64H/4kv (head_dim 128) ff_expert
1536 V=151936, 128 experts top-8, qk_norm. [hf:Qwen/Qwen3-*; hf]"""
from repro_torch.models.base import Family, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family=Family.MOE,
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=0, vocab_size=151936, qk_norm=True,
    n_experts=128, top_k=8, d_ff_expert=1536, moe_every=1,
    rope_theta=1e6)
