"""qwen2.5-32b [dense]: 64L d5120 40H/8kv ff27648 V=152064, QKV bias.
[hf:Qwen/Qwen2.5; hf]"""
from repro_torch.models.base import Family, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family=Family.DENSE,
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=27648, vocab_size=152064, qkv_bias=True, rope_theta=1e6)
