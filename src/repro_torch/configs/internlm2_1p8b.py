"""internlm2-1.8b [dense]: 24L d2048 16H/8kv ff8192 V=92544.
[arXiv:2403.17297; hf]"""
from repro_torch.models.base import Family, ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family=Family.DENSE,
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92544, rope_theta=1e6)
