"""Architecture registry: ``--arch <id>`` resolution + input shape sets.

Every assigned architecture is a selectable config; each LM arch pairs
with four shapes (train_4k / prefill_32k / decode_32k / long_500k).
``long_500k`` requires sub-quadratic attention and is skipped for pure
full-attention archs (recorded, not silently dropped); it runs for the
SSM and hybrid families. See DESIGN.md §3.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

from repro_torch.models.base import Family, ModelConfig

ARCH_IDS = (
    "llama4-maverick-400b-a17b",
    "qwen3-moe-235b-a22b",
    "zamba2-1.2b",
    "granite-34b",
    "qwen2.5-32b",
    "qwen3-14b",
    "internlm2-1.8b",
    "whisper-base",
    "qwen2-vl-7b",
    "falcon-mamba-7b",
    "chameleon-llama-7b",          # the paper's own model (extra)
)

_MODULES = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "zamba2-1.2b": "zamba2_1p2b",
    "granite-34b": "granite_34b",
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen3-14b": "qwen3_14b",
    "internlm2-1.8b": "internlm2_1p8b",
    "whisper-base": "whisper_base",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "chameleon-llama-7b": "chameleon_llama_7b",
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; one of {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}

# Sub-quadratic-attention requirement: long_500k runs only for families
# whose decode state does not force a full 500k KV scan per layer
# (SSM: O(1) state; hybrid: SSM layers O(1) + a handful of shared-attn
# sites). Pure full-attention archs skip the cell (DESIGN.md §3).
LONG_CTX_FAMILIES = (Family.SSM, Family.HYBRID)


def cell_applicable(arch_id: str, shape_name: str) -> tuple[bool, str]:
    cfg = get_config(arch_id)
    if shape_name == "long_500k" and cfg.family not in LONG_CTX_FAMILIES:
        return False, "full-attention arch: 500k decode KV infeasible " \
                      "(sub-quadratic attention required; see DESIGN.md)"
    return True, ""


def assigned_cells(include_paper_model: bool = False):
    """All (arch, shape) cells — the 40-cell dry-run/roofline grid."""
    out = []
    for a in ARCH_IDS:
        if a == "chameleon-llama-7b" and not include_paper_model:
            continue
        for s in SHAPES:
            out.append((a, s.name))
    return out
