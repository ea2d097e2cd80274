"""zamba2-1.2b [hybrid]: 38 Mamba2 layers d2048, one shared attention
block (32H kv=32, d_head 64) + shared MLP ff8192 applied every 6 layers,
ssm_state=64. V=32000. [arXiv:2411.15242; hf]"""
from repro_torch.models.base import Family, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family=Family.HYBRID,
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_version=2, d_state=64, expand=2, ssm_head_dim=64, d_conv=4,
    attn_every=6, rope_theta=1e4, scan_layers=False)
