"""granite-34b [dense]: 88L d6144 48H MQA(kv=1) ff24576 V=49152 —
GPT-BigCode-arch code model (MQA, non-gated GELU MLP). [arXiv:2405.04324; hf]"""
from repro_torch.models.base import Family, ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family=Family.DENSE,
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152, rope_theta=1e5,
    gated_mlp=False)
