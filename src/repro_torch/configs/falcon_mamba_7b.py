"""falcon-mamba-7b [ssm]: 64L d4096 attention-free Mamba1, d_state=16,
expand=2 (d_inner 8192), V=65024. [arXiv:2410.05355; unverified]"""
from repro_torch.models.base import Family, ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family=Family.SSM,
    n_layers=64, d_model=4096, vocab_size=65024,
    ssm_version=1, d_state=16, expand=2, d_conv=4)
