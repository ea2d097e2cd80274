"""Device resolution for the port's entry points.

The card is the default: an entry point called without ``device=`` runs
on CUDA and raises when no CUDA device is present. The CPU is used only
when the caller asks for it (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port runs on the GPU by "
                "default; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available")
    return dev


def indexed(dev: torch.device) -> torch.device:
    """``dev`` with its card's index: a bare ``cuda`` names the current
    card. A tensor reports an indexed device, so a device compared with
    a tensor's, or a key looked up by one, must be indexed too."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def on_device(dev: torch.device):
    """Make ``dev`` the current card while a shard or column launches
    its kernels (a launch goes to the current device); nothing on the
    CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()
