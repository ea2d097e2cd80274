"""Multi-adapter LoRA application: backend dispatch + reference path.

The serving data plane applies, per request b with adapter index
idx[b]:

    y[b] = x[b] @ W  +  (x[b] @ A[idx[b]]) @ B[idx[b]]

A: (n_slots, d_in, r_max), B: (n_slots, r_max, d_out) — adapter *slots*
are fixed device buffers managed by the Chameleon cache (weights of
evicted adapters are overwritten in place; ranks < r_max are
zero-padded so one static shape serves every rank).

``lora_delta`` dispatches on ``backend``: ``"kernel"`` routes through
the CUDA bgmv (decode, S == 1) / sgmv (prefill, S > 1) kernels in
repro_torch.kernels.ops (their plain versions on CPU tensors);
``"einsum"`` is the reference path the CPU engine runs. The engine
resolves its ``EngineConfig.lora_backend`` knob once (kernel on CUDA,
einsum elsewhere under ``auto``).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import einsum


class EinsumCounter:
    """Calls of the einsum LoRA path (lets a run show it stayed on the
    kernels)."""

    def __init__(self) -> None:
        self.calls = 0

    def reset(self) -> None:
        self.calls = 0


EINSUM = EinsumCounter()


def lora_delta(x: torch.Tensor, ab: tuple[torch.Tensor, torch.Tensor],
               adapter_idx: torch.Tensor, scale: float = 1.0,
               backend: str = "einsum") -> torch.Tensor:
    """x: (B, S, d_in); ab = (A (n,din,r), B (n,r,dout)); idx: (B,)."""
    A, Bm = ab
    if backend == "kernel":
        from repro_torch.kernels.ops import lora_delta_kernel
        return lora_delta_kernel(x, A, Bm, adapter_idx, scale=scale)
    EINSUM.calls += 1
    idx = adapter_idx.long()
    t = einsum("bsd,bdr->bsr", x, A[idx])
    return scale * einsum("bsr,bro->bso", t, Bm[idx])


def init_lora_slots(n_slots: int, n_layers: int, d_model: int, q_dim: int,
                    kv_dim: int, r_max: int, dtype=torch.bfloat16,
                    device: torch.device | str | None = None) -> dict:
    """Zero-initialised adapter slot buffers for q/k/v/o projections:
    {proj: (A (L, n_slots, din, r_max), B (L, n_slots, r_max, dout))}."""
    dev = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)
    return {
        "q": (z(n_layers, n_slots, d_model, r_max),
              z(n_layers, n_slots, r_max, q_dim)),
        "k": (z(n_layers, n_slots, d_model, r_max),
              z(n_layers, n_slots, r_max, kv_dim)),
        "v": (z(n_layers, n_slots, d_model, r_max),
              z(n_layers, n_slots, r_max, kv_dim)),
        "o": (z(n_layers, n_slots, q_dim, r_max),
              z(n_layers, n_slots, r_max, d_model)),
    }


def random_lora_weights(generator: torch.Generator, rank: int, r_max: int,
                        n_layers: int, d_model: int, q_dim: int,
                        kv_dim: int, dtype=torch.bfloat16) -> dict:
    """One adapter's weights (rank-r content, zero-padded to r_max),
    drawn from ``generator`` on its device."""
    dev = generator.device
    out = {}
    dims = {"q": (d_model, q_dim), "k": (d_model, kv_dim),
            "v": (d_model, kv_dim), "o": (q_dim, d_model)}
    for name, (din, dout) in dims.items():
        a = torch.zeros((n_layers, din, r_max), dtype=dtype, device=dev)
        b = torch.zeros((n_layers, r_max, dout), dtype=dtype, device=dev)
        a[:, :, :rank] = (din ** -0.5) * torch.randn(
            (n_layers, din, rank), generator=generator,
            device=dev).to(dtype)
        # LoRA-B starts at zero in fine-tuning; for serving we use
        # random B so the delta is observable.
        b[:, :rank, :] = (rank ** -0.5) * torch.randn(
            (n_layers, rank, dout), generator=generator,
            device=dev).to(dtype)
        out[name] = (a, b)
    return out


def write_adapter_to_slot(slots: dict, adapter: dict, slot: int,
                          non_blocking: bool = False) -> dict:
    """Slot update (engine: cache-fill on load), *in place*: each
    projection's host weights are ``copy_``-ed into column ``slot`` of
    the device slot buffers, which are returned. The JAX version builds
    new arrays instead; the port overwrites the free slot, which no
    placed request reads (see the engine's async-load notes)."""
    for name, (a_s, b_s) in slots.items():
        a_w, b_w = adapter[name]
        a_s[:, slot].copy_(a_w, non_blocking=non_blocking)
        b_s[:, slot].copy_(b_w, non_blocking=non_blocking)
    return slots
