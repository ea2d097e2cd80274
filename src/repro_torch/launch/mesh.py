"""Device meshes (port of ``src/repro/launch/mesh.py``).

A ``Mesh`` is a grid of ``torch.device`` positions with named axes —
the counterpart of ``jax.sharding.Mesh``: ``devices`` (a numpy object
array), ``axis_names``, ``shape`` (axis name -> size) and ``size``.
Functions, not module constants: importing this module touches no
device.

Positions live on one platform. On the card a mesh of n positions is
``cuda:0 .. cuda:n-1`` and asking for more than
``torch.cuda.device_count()`` raises. The CPU counts its positions as
JAX does, from ``--xla_force_host_platform_device_count=N`` in the
``XLA_FLAGS`` environment variable (1 without it), read at call time;
every position is the one ``cpu`` device, the fake-mesh pattern of the
JAX tests. A mesh over repeated positions of one card
(``Mesh(np.array([cuda0] * 4).reshape(2, 2), axes)``) is built
directly.
"""
from __future__ import annotations

import os
import re
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.device import indexed, resolve_device

_HOST_COUNT = re.compile(r"--xla_force_host_platform_device_count=(\d+)")


class Mesh:
    """Named grid of device positions (``jax.sharding.Mesh``). A bare
    ``cuda`` position is held as the current card's index, the device
    its shards' tensors report."""

    def __init__(self, devices, axis_names: tuple):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        grid = np.empty(devices.size, dtype=object)
        grid[:] = [indexed(torch.device(d)) for d in devices.flat]
        self.devices = grid.reshape(devices.shape)
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"{sorted({str(d) for d in self.devices.flat})})")


def device_count(device: torch.device | str | None = None) -> int:
    """Mesh positions the platform of ``device`` offers: the visible
    cards, or the CPU's forced host device count."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.device_count()
    m = _HOST_COUNT.search(os.environ.get("XLA_FLAGS", ""))
    return int(m.group(1)) if m else 1


def make_mesh(shape: tuple, axes: tuple,
              device: torch.device | str | None = None) -> Mesh:
    """``jax.make_mesh``: the first prod(shape) positions of the
    platform of ``device`` (the card by default), in row-major order."""
    dev = resolve_device(device)
    n = int(np.prod(shape))
    avail = device_count(dev)
    if n > avail:
        raise ValueError(f"mesh of shape {tuple(shape)} needs {n} "
                         f"devices, only {avail} available")
    if dev.type == "cuda":
        grid = [torch.device("cuda", i) for i in range(n)]
    else:
        grid = [dev] * n
    arr = np.empty(n, dtype=object)
    arr[:] = grid
    return Mesh(arr.reshape(tuple(shape)), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: torch.device | str | None = None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(device: torch.device | str | None = None) -> Mesh:
    """Whatever this host actually has (tests / examples)."""
    n = device_count(device)
    return make_mesh((n, 1), ("data", "model"), device)


def make_serving_mesh(n_devices: int, model_parallel: int = 1,
                      device: torch.device | str | None = None) -> Mesh:
    """The serving data plane's ("data", "model") mesh.

    ``EngineConfig.mesh_shape = (d, m)`` resolves through here (the
    single factory — the engine never builds a mesh itself): d*m
    devices, batch/KV-pages over "data", weights/LoRA-slot dout over
    "model". CPU CI gets its devices from
    ``XLA_FLAGS=--xla_force_host_platform_device_count=N``.
    """
    if n_devices < 1 or model_parallel < 1:
        raise ValueError(
            f"mesh shape must be positive, got n_devices={n_devices} "
            f"model_parallel={model_parallel}")
    if n_devices % model_parallel != 0:
        raise ValueError(
            f"model_parallel={model_parallel} must divide "
            f"n_devices={n_devices}")
    avail = device_count(device)
    if n_devices > avail:
        raise ValueError(
            f"mesh wants {n_devices} devices but only {avail} are "
            f"available (CPU CI: set XLA_FLAGS="
            f"--xla_force_host_platform_device_count={n_devices})")
    return make_mesh((n_devices // model_parallel, model_parallel),
                     ("data", "model"), device)
