"""Bridge: numpy-convertible arrays (e.g. from the JAX package) → tensors.

Converts, with dtypes kept, the structures the engine and models take:
the flat params dict, the LoRA slot dict ({proj: (A, B)}), an adapter
catalog's weights ({adapter_id: {proj: (A, B)}}) and the paged KV pair.
A JAX optimizer state is a flat dict too (``"step"``, ``m/<path>``,
``v/<path>``): ``params_to_torch`` carries it as it is, the int32 step
as a 0-dim int32 tensor and bf16 moments as bf16.
The inputs only need ``np.asarray`` to work on them, so this module
imports no array library besides numpy and torch. Like every entry
point of the port, ``device=None`` means the card (and raises without
one); pass ``device="cpu"`` for CPU tensors.

bfloat16: ``np.asarray`` of a bf16 array yields the ``ml_dtypes``
bfloat16 dtype, which ``torch.from_numpy`` rejects; such arrays go
through float32 (exact for every bf16 value) and back to bf16.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def to_torch(a, device: torch.device | str | None = None) -> torch.Tensor:
    """One array → a tensor of the same dtype and shape (a copy)."""
    device = resolve_device(device)
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def params_to_torch(params: dict, device=None) -> dict:
    """Flat params dict {path: array} → {path: tensor}."""
    device = resolve_device(device)
    return {k: to_torch(v, device) for k, v in params.items()}


def lora_to_torch(slots: dict, device=None) -> dict:
    """LoRA slot dict {proj: (A, B)} → the same with tensors."""
    device = resolve_device(device)
    return {k: (to_torch(a, device), to_torch(b, device))
            for k, (a, b) in slots.items()}


def catalog_weights_to_torch(weights: dict, device=None) -> dict:
    """{adapter_id: {proj: (A, B)}} → the same with tensors."""
    device = resolve_device(device)
    return {aid: lora_to_torch(w, device) for aid, w in weights.items()}


def kv_to_torch(kv, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Paged KV pair (k_pages, v_pages) → tensors."""
    device = resolve_device(device)
    k, v = kv
    return to_torch(k, device), to_torch(v, device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor → float32/int numpy (bf16 widened to float32)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
