"""Model configuration shared by all assigned architectures.

One dataclass covers dense / MoE / SSM / hybrid / enc-dec / VLM families;
family-specific fields are ignored elsewhere. Configs are constructed in
``repro.configs.<arch>`` and consumed by ``repro.models.lm`` (decoder-only
assembly), ``repro.models.hybrid`` (zamba2), ``repro.models.encdec``
(whisper).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Optional


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"
    ENCDEC = "encdec"       # audio backbone (whisper): enc-dec transformer
    VLM = "vlm"             # vision backbone (qwen2-vl): M-RoPE decoder


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    vocab_size: int
    # Attention (unused for attn-free SSM).
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    mrope: bool = False              # 3-axis multimodal RoPE (qwen2-vl)
    mrope_sections: tuple = (16, 24, 24)   # t/h/w split of head_dim/2
    # MLP.
    d_ff: int = 0
    gated_mlp: bool = True   # False: GPT-BigCode-style GELU up/down
    # MoE.
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    shared_expert_ff: int = 0
    moe_every: int = 1               # 2 => MoE on odd layers (llama4)
    capacity_factor: float = 1.25
    # SSM (mamba).
    ssm_version: int = 0             # 1 = mamba1, 2 = mamba2
    d_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_head_dim: int = 64           # mamba2
    dt_rank: int = 0                 # mamba1 (0 => ceil(d_model/16))
    ssm_chunk: int = 128             # mamba2 SSD chunk length
    # Hybrid (zamba2): one *shared* attention+MLP block applied every
    # ``attn_every`` mamba layers.
    attn_every: int = 0
    # Enc-dec (whisper).
    n_enc_layers: int = 0
    enc_ctx: int = 1500              # stubbed audio frames
    # Misc.
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 32768
    # Execution knobs.
    scan_layers: bool = True
    remat: bool = True
    # LoRA serving.
    lora_ranks: tuple = (8, 16, 32, 64, 128)
    lora_target: tuple = ("q", "k", "v", "o")

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)
        if self.ssm_version == 1 and not self.dt_rank:
            object.__setattr__(self, "dt_rank",
                               -(-self.d_model // 16))

    @property
    def attn_free(self) -> bool:
        return self.family == Family.SSM

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.family != Family.MOE:
            return False
        return (layer_idx % self.moe_every) == (self.moe_every - 1)

    # Parameter counting (documentation + roofline MODEL_FLOPS).
    def param_count(self) -> int:
        return sum(int(np.prod(s)) for s in _param_shapes(self).values())

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE counts top_k experts only)."""
        total = self.param_count()
        if self.family != Family.MOE or not self.n_experts:
            return total
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if self.is_moe_layer(i))
        per_expert = 3 * self.d_model * self.d_ff_expert
        inactive = n_moe_layers * (self.n_experts - self.top_k) * per_expert
        return total - inactive

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        shrink = dict(
            n_layers=min(self.n_layers, 4 if self.attn_every == 0 else 6),
            d_model=128,
            vocab_size=512,
            d_ff=256 if self.d_ff else 0,
            max_seq_len=256,
            rope_theta=1e4,
            scan_layers=self.scan_layers,
            remat=False,
        )
        if self.n_heads:
            shrink.update(n_heads=4, head_dim=32,
                          n_kv_heads=max(1, min(self.n_kv_heads, 2)))
            if self.mrope:
                # Rescale t/h/w frequency sections to the reduced
                # head_dim/2 while keeping the 2:3:3 ratio.
                half = 16
                shrink.update(mrope_sections=(
                    half * 2 // 8, half * 3 // 8, half * 3 // 8))
        if self.n_experts:
            shrink.update(n_experts=8, top_k=min(self.top_k, 2),
                          d_ff_expert=64,
                          shared_expert_ff=64 if self.shared_expert_ff else 0)
        if self.ssm_version:
            shrink.update(d_state=16, ssm_head_dim=32, ssm_chunk=32)
        if self.n_enc_layers:
            shrink.update(n_enc_layers=2, enc_ctx=16)
        if self.attn_every:
            shrink.update(attn_every=3)
        shrink.update(overrides)
        return replace(self, **shrink)


import numpy as np  # noqa: E402  (used by param_count)


def _param_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    """Flat {path: shape} map — single source of truth for init/sharding."""
    D, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    shapes: dict[str, tuple] = {"embed/tok": (V, D), "final_norm": (D,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, V)

    def attn_shapes(prefix: str):
        s = {
            f"{prefix}attn_norm": (D,),
            f"{prefix}q": (D, cfg.q_dim),
            f"{prefix}k": (D, cfg.kv_dim),
            f"{prefix}v": (D, cfg.kv_dim),
            f"{prefix}o": (cfg.q_dim, D),
        }
        if cfg.qkv_bias:
            s[f"{prefix}q_bias"] = (cfg.q_dim,)
            s[f"{prefix}k_bias"] = (cfg.kv_dim,)
            s[f"{prefix}v_bias"] = (cfg.kv_dim,)
        if cfg.qk_norm:
            s[f"{prefix}q_norm"] = (cfg.head_dim,)
            s[f"{prefix}k_norm"] = (cfg.head_dim,)
        return s

    def mlp_shapes(prefix: str, ff: int):
        s = {f"{prefix}mlp_norm": (D,),
             f"{prefix}up": (D, ff),
             f"{prefix}down": (ff, D)}
        if cfg.gated_mlp:
            s[f"{prefix}gate"] = (D, ff)
        return s

    def ssm_shapes(prefix: str):
        Di, N = cfg.d_inner, cfg.d_state
        if cfg.ssm_version == 1:
            return {f"{prefix}ssm_norm": (D,),
                    f"{prefix}in_proj": (D, 2 * Di),
                    f"{prefix}conv_w": (cfg.d_conv, Di),
                    f"{prefix}conv_b": (Di,),
                    f"{prefix}x_proj": (Di, cfg.dt_rank + 2 * N),
                    f"{prefix}dt_proj": (cfg.dt_rank, Di),
                    f"{prefix}dt_bias": (Di,),
                    f"{prefix}A_log": (Di, N),
                    f"{prefix}ssm_D": (Di,),
                    f"{prefix}out_proj": (Di, D)}
        H = cfg.n_ssm_heads
        conv_dim = Di + 2 * N          # x, B, C all convolved (mamba2)
        return {f"{prefix}ssm_norm": (D,),
                f"{prefix}in_proj": (D, 2 * Di + 2 * N + H),
                f"{prefix}conv_w": (cfg.d_conv, conv_dim),
                f"{prefix}conv_b": (conv_dim,),
                f"{prefix}dt_bias": (H,),
                f"{prefix}A_log": (H,),
                f"{prefix}ssm_D": (H,),
                f"{prefix}gate_norm": (Di,),
                f"{prefix}out_proj": (Di, D)}

    if cfg.family == Family.SSM:
        for k, v in ssm_shapes("layers/").items():
            shapes[k] = (L,) + v
        return shapes

    if cfg.family == Family.HYBRID:
        for k, v in ssm_shapes("layers/").items():
            shapes[k] = (L,) + v
        # One *shared* attention+MLP block (zamba2).
        shapes.update(attn_shapes("shared/"))
        shapes.update(mlp_shapes("shared/", cfg.d_ff))
        return shapes

    if cfg.family == Family.ENCDEC:
        Le = cfg.n_enc_layers
        for k, v in attn_shapes("enc/").items():
            shapes[k] = (Le,) + v
        for k, v in mlp_shapes("enc/", cfg.d_ff).items():
            shapes[k] = (Le,) + v
        shapes["enc_final_norm"] = (D,)
        shapes["enc_pos"] = (cfg.enc_ctx, D)
        for k, v in attn_shapes("dec/").items():
            shapes[k] = (L,) + v
        for k, v in attn_shapes("dec/x").items():     # cross-attention
            shapes[k] = (L,) + v
        for k, v in mlp_shapes("dec/", cfg.d_ff).items():
            shapes[k] = (L,) + v
        shapes["dec_pos"] = (cfg.max_seq_len, D)
        return shapes

    # Dense / MoE / VLM decoder-only.
    for k, v in attn_shapes("layers/").items():
        shapes[k] = (L,) + v
    if cfg.family == Family.MOE:
        n_moe = sum(1 for i in range(L) if cfg.is_moe_layer(i))
        n_dense = L - n_moe
        Fe, E = cfg.d_ff_expert, cfg.n_experts
        shapes["moe/router"] = (n_moe, D, E)
        shapes["moe/norm"] = (n_moe, D)
        shapes["moe/w_gate"] = (n_moe, E, D, Fe)
        shapes["moe/w_up"] = (n_moe, E, D, Fe)
        shapes["moe/w_down"] = (n_moe, E, Fe, D)
        if cfg.shared_expert_ff:
            shapes["moe/shared_gate"] = (n_moe, D, cfg.shared_expert_ff)
            shapes["moe/shared_up"] = (n_moe, D, cfg.shared_expert_ff)
            shapes["moe/shared_down"] = (n_moe, cfg.shared_expert_ff, D)
        if n_dense:
            for k, v in mlp_shapes("dense_mlp/", cfg.d_ff).items():
                shapes[k] = (n_dense,) + v
    else:
        for k, v in mlp_shapes("layers/", cfg.d_ff).items():
            shapes[k] = (L,) + v
    return shapes


def param_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    return _param_shapes(cfg)
