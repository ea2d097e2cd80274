"""AdamW from scratch with production knobs (PyTorch).

Port of ``src/repro/training/optimizer.py``, with the same state and
arithmetic:

- moment dtype is configurable: fp32 (default) or bf16; the update math
  always runs in fp32 and bf16 moments round-trip through fp32 every
  step;
- global-norm gradient clipping;
- decoupled weight decay (skipped for norms/biases/1-D params);
- linear warmup + cosine decay schedule.

State is a flat dict mirroring the param dict: ``m/<path>``,
``v/<path>`` plus a scalar int32 ``"step"``, so checkpoints of either
package hold the same leaves. Not ``torch.optim.AdamW``: its schedule,
decay mask and clipping differ.

The JAX launcher donates params and state to the jitted step
(``donate_argnums=(0, 1)``); the port's counterpart is to update both
**in place** under ``torch.no_grad()``: ``adamw_update`` writes the new
values into the given tensors and returns the same dicts. A state placed
on a mesh (``ShardedTensor`` leaves, ``distributed.sharding``) updates
shard by shard, each position its own block of params and moments.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.distributed.sharding import (NamedSharding, PartitionSpec,
                                              ShardedTensor)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"       # "float32" | "bfloat16"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _moment_dtype(cfg: AdamWConfig) -> torch.dtype:
    return getattr(torch, cfg.moment_dtype)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` (an int or an integer tensor), f32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(params: dict, cfg: AdamWConfig) -> dict:
    """Zero moments and step 0. For a placed state (``ShardedTensor``
    leaves) the moments are placed where their parameter is and the
    step is replicated, ``opt_shardings``' layout, allocated shard by
    shard."""
    dt = _moment_dtype(cfg)
    first = next(iter(params.values()), None)
    if isinstance(first, ShardedTensor):
        rep = NamedSharding(first.mesh, PartitionSpec())
        state = {"step": rep.zeros((), torch.int32)}
        for k, p in params.items():
            state[f"m/{k}"] = p.sharding.zeros(p.shape, dt)
            state[f"v/{k}"] = p.sharding.zeros(p.shape, dt)
        return state
    dev = first.device if first is not None else None
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
    for k, p in params.items():
        state[f"m/{k}"] = torch.zeros(p.shape, dtype=dt, device=p.device)
        state[f"v/{k}"] = torch.zeros(p.shape, dtype=dt, device=p.device)
    return state


def _decay_mask(path: str, p: torch.Tensor) -> bool:
    leaf = path.split("/")[-1]
    return p.dim() >= 2 and "norm" not in leaf and not leaf.endswith("bias")


def _sq_sum(g) -> torch.Tensor:
    """Sum of squares of a gradient, over its entries in row-major order
    whatever its strides (autograd hands some gradients over transposed,
    enc-dec's cross K/V weights for one, and the order of a sum moves
    its rounding); of a placed one, each distinct block counted once (a
    replicated block once, not once a position), summed in block order
    on the mesh's first position."""
    if not isinstance(g, ShardedTensor):
        return torch.sum(torch.square(g.float().contiguous()))
    home = g.mesh.devices.flat[0]
    total = None
    for _, ts in g.blocks():
        s = torch.sum(torch.square(ts[0].float())).to(home)
        total = s if total is None else total + s
    return total


def global_norm(grads: dict) -> torch.Tensor:
    return torch.sqrt(sum(_sq_sum(g) for g in grads.values()))


def _tensors(x) -> list:
    """The tensors an update writes: a placed leaf's distinct shards, in
    position order, or the tensor itself."""
    if isinstance(x, ShardedTensor):
        return [t for _, t in x.unique()]
    return [x]


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict,
                 cfg: AdamWConfig) -> tuple[dict, dict, dict]:
    """One AdamW step, in place. Returns (params, state, metrics): the
    given dicts, their tensors holding the new values. A placed state
    (``ShardedTensor`` leaves, grads placed alike) updates each shard
    on its position: the params, moments and grads of a leaf share one
    sharding, so their shards pair up position by position."""
    step_t = state["step"]
    placed = isinstance(step_t, ShardedTensor)
    step = (step_t.full() if placed else step_t) + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.float()
    b1c = 1 - torch.pow(torch.full((), cfg.b1, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.full((), cfg.b2, device=stepf.device), stepf)
    consts: dict = {}

    def on(dev):
        if dev not in consts:
            consts[dev] = tuple(t.to(dev) for t in (lr, scale, b1c, b2c))
        return consts[dev]

    dt = _moment_dtype(cfg)
    for k, p in params.items():
        for p_, g_, m_, v_ in zip(*map(_tensors, (p, grads[k],
                                                   state[f"m/{k}"],
                                                   state[f"v/{k}"]))):
            _update(cfg, k, p_, g_, m_, v_, *on(p_.device), dt)
    for t in _tensors(step_t):
        t.copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _update(cfg: AdamWConfig, k: str, p, g, m_t, v_t, lr, scale, b1c, b2c,
            dt) -> None:
    g = g.float() * scale
    m = cfg.b1 * m_t.float() + (1 - cfg.b1) * g
    v = cfg.b2 * v_t.float() + (1 - cfg.b2) * g * g
    upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    if cfg.weight_decay and _decay_mask(k, p):
        upd = upd + cfg.weight_decay * p.float()
    p.copy_((p.float() - lr * upd).to(p.dtype))
    m_t.copy_(m.to(dt))
    v_t.copy_(v.to(dt))
