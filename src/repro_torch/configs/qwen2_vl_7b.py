"""qwen2-vl-7b [vlm]: 28L d3584 28H/4kv ff18944 V=152064, M-RoPE
(t/h/w sections 16/24/24 of head_dim/2=64); vision frontend STUBBED
(input_specs provides token ids + 3-axis position ids).
[arXiv:2409.12191; hf]"""
from repro_torch.models.base import Family, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family=Family.VLM,
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064, mrope=True, mrope_sections=(16, 24, 24),
    rope_theta=1e6)
