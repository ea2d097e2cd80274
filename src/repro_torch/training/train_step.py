"""Train-step builder shared by the launcher and the examples (PyTorch).

Port of ``src/repro/training/train_step.py``. ``jax.value_and_grad``
becomes ``torch.autograd.grad`` over the param leaves (not
``torch.func``, which would need functorch rules on every
``autograd.Function``, the flash_attention kernel's included), and the
jitted, donated step becomes an in-place update: the step writes the
new params and optimizer state into the given tensors
(``optimizer.adamw_update``) and returns the same dicts.
"""
from __future__ import annotations

import torch

from repro_torch.models import api
from repro_torch.models.base import Family, ModelConfig

from .optimizer import AdamWConfig, adamw_update, init_opt_state


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1):
    """Returns step(params, opt_state, batch) -> (params, opt, metrics).

    ``batch`` carries tokens/labels (+ frames for enc-dec, mrope_pos for
    VLM) as tensors on the params' device (``training.data`` batches
    moved there). ``metrics`` holds 0-dim tensors ``loss``,
    ``grad_norm`` and ``lr``.

    ``microbatches`` > 1 runs gradient accumulation: the global batch is
    split on axis 0 (``mrope_pos`` on axis 1) and the microbatches run
    one after another, their gradients summed in f32, dividing peak
    activation memory by the factor.
    """

    def loss_fn(params, batch):
        kw = {}
        if cfg.family == Family.ENCDEC:
            kw["frames"] = batch["frames"]
        if cfg.mrope:
            kw["mrope_pos"] = batch["mrope_pos"]
        return api.train_loss(cfg, params, batch["tokens"],
                              batch["labels"], **kw)

    def grad_fn(params, batch):
        # Leaf aliases of the params (same storage), so the caller's
        # tensors never carry requires_grad.
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        with torch.enable_grad():
            loss = loss_fn(leaves, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = grad_fn(params, batch)
        else:
            def split(k, v):
                axis = 1 if k == "mrope_pos" else 0  # (3, B, S)
                return v.chunk(microbatches, dim=axis)
            parts = {k: split(k, v) for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            for i in range(microbatches):
                loss_i, grads_i = grad_fn(
                    params, {k: v[i] for k, v in parts.items()})
                loss = loss + loss_i
                for k, g in grads_i.items():
                    grads[k] += g
                del grads_i
            loss = loss / microbatches
            for g in grads.values():
                g /= microbatches
        params, opt_state, metrics = adamw_update(params, grads,
                                                  opt_state, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, seed: int = 0,
                     dtype=torch.bfloat16,
                     device: torch.device | str | None = None):
    """(params, opt_state) from the port's seeded ``init_params``, on
    the card unless ``device`` says otherwise."""
    params = api.init_params(cfg, seed, dtype, device=device)
    return params, init_opt_state(params, opt_cfg)
