"""whisper-base [audio]: 6L encoder + 6L decoder, d512 8H ff2048
V=51865; conv/mel frontend STUBBED (input_specs provides 1500 frame
embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.models.base import Family, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family=Family.ENCDEC,
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    head_dim=64, d_ff=2048, vocab_size=51865, enc_ctx=1500,
    max_seq_len=32769)
