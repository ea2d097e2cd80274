"""The paper's own evaluation model: Llama-7B (32L d4096 32H MHA ff11008
V=32000) — used by the serving engine example and paper-figure
benchmarks. [arXiv:2307.09288; hf]"""
from repro_torch.models.base import Family, ModelConfig

CONFIG = ModelConfig(
    name="chameleon-llama-7b", family=Family.DENSE,
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab_size=32000, rope_theta=1e4)
