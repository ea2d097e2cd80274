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
values into the given tensors and returns the same dicts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


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
    dt = _moment_dtype(cfg)
    dev = next(iter(params.values())).device if params else None
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
    for k, p in params.items():
        state[f"m/{k}"] = torch.zeros(p.shape, dtype=dt, device=p.device)
        state[f"v/{k}"] = torch.zeros(p.shape, dtype=dt, device=p.device)
    return state


def _decay_mask(path: str, p: torch.Tensor) -> bool:
    leaf = path.split("/")[-1]
    return p.dim() >= 2 and "norm" not in leaf and not leaf.endswith("bias")


def global_norm(grads: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict,
                 cfg: AdamWConfig) -> tuple[dict, dict, dict]:
    """One AdamW step, in place. Returns (params, state, metrics): the
    given dicts, their tensors holding the new values."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.float()
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)

    dt = _moment_dtype(cfg)
    for k, p in params.items():
        g = grads[k].float() * scale
        m = state[f"m/{k}"].float()
        v = state[f"v/{k}"].float()
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay and _decay_mask(k, p):
            upd = upd + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))
        state[f"m/{k}"].copy_(m.to(dt))
        state[f"v/{k}"].copy_(v.to(dt))
        del g, m, v, upd
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
