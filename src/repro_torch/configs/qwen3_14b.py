"""qwen3-14b [dense]: 40L d5120 40H/8kv ff17408 V=151936, qk_norm.
[hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.models.base import Family, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family=Family.DENSE,
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab_size=151936, qk_norm=True, rope_theta=1e6)
