"""System assembly for the PyTorch engine.

Port of the real-engine half of ``src/repro/serving/systems.py``: the
same ``ENGINE_SYSTEMS`` policy matrix and ``build_engine``, and
``build_system`` for ``tier="engine"``. The simulator, cluster and
disaggregated tiers are not ported yet and raise.
"""
from __future__ import annotations

import torch

from repro_torch.core import (ChameleonScheduler, FIFOScheduler,
                              SJFScheduler)

# System -> (scheduler class, adapter cache enabled) for the real engine.
ENGINE_SYSTEMS = {
    "chameleon": (ChameleonScheduler, True),
    "chameleon-nocache": (ChameleonScheduler, False),
    "chameleon-nosched": (FIFOScheduler, True),
    "slora": (FIFOScheduler, False),
    "userve-sjf": (SJFScheduler, False),
}

TIERS = ("sim", "engine", "cluster", "sim-cluster", "disagg")


def build_engine(system: str, cfg, params, ecfg=None, catalog=None,
                 clock=None, device: torch.device | str | None = None):
    """Assemble one engine replica for ``system`` (CUDA by default)."""
    from .engine import ChameleonEngine
    if system not in ENGINE_SYSTEMS:
        raise ValueError(f"unknown engine system {system!r}; "
                         f"one of {tuple(ENGINE_SYSTEMS)}")
    sched_cls, cache_enabled = ENGINE_SYSTEMS[system]
    return ChameleonEngine(cfg, params, ecfg, scheduler_cls=sched_cls,
                           cache_enabled=cache_enabled, catalog=catalog,
                           clock=clock, device=device)


def _default_model(device):
    """Reduced Llama-style model (the JAX package's engine-tier
    default), f32 weights from the port's seeded init."""
    from repro_torch.configs import get_config
    from repro_torch.models import api

    cfg = get_config("chameleon-llama-7b").reduced()
    return cfg, api.init_params(cfg, 0, torch.float32, device=device)


def build_system(system: str = "chameleon", tier: str = "engine", *,
                 model_cfg=None, params=None, ecfg=None,
                 device: torch.device | str | None = None, **unported):
    """Build a ``ServingSystem``; the port serves ``tier="engine"``.

    The other tiers, and the JAX factory's ``node``/``n_nodes``/
    ``policy``/``mesh_shape``/``gateway`` options, raise
    ``NotImplementedError`` until they are ported.
    """
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}; one of {TIERS}")
    if tier != "engine":
        raise NotImplementedError(
            f"tier {tier!r} is not ported to PyTorch yet (only 'engine')")
    if unported:
        raise NotImplementedError(
            f"build_system options not ported yet: {sorted(unported)}")
    from repro_torch.device import resolve_device
    device = resolve_device(device)
    if model_cfg is None or params is None:
        model_cfg, params = _default_model(device)
    return build_engine(system, model_cfg, params, ecfg, device=device)
