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

from repro_torch.distributed.sharding import FsdpStep, ShardedTensor
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

    A state placed on a mesh (``ShardedTensor`` leaves:
    ``sharding.device_put`` with ``param_shardings(kind="train")``, and
    ``init_opt_state`` of the placed params or ``opt_shardings``), as
    JAX's jitted step takes it, trains every family sharded, on a mesh
    of any size: each microbatch's rows split over the batch axes, FSDP
    gathers and reduce-scatters (``sharding.FsdpStep``), and each
    position updates its shards. The batch stays whole (tensors on any
    device); its rows must split evenly over the batch axes. Every
    config trains on every mesh: a block with a dimension the "model"
    axis does not divide (heads, d_ff, the SSM channels, an expert
    hidden) runs whole on each batch row's first column, and experts
    the "data" axis does not divide run on every batch row
    (``sharding.whole_blocks``). With
    ``cfg.remat`` each layer body is recomputed in the backward
    (``models/remat.py``).
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

    def sharded_grads(params, batch):
        """The loss and the f32 gradients of a placed state, each
        placed like its parameter: one FSDP forward-backward a
        microbatch, each reduce-scattering into the same gradients."""
        grads = {k: st.sharding.zeros(st.shape, torch.float32)
                 for k, st in params.items()}
        loss = None
        for mb in _microbatches(batch, microbatches):
            fs = FsdpStep(params, grads)
            with torch.enable_grad():
                with fs.recording():
                    loss_i = loss_fn(params, mb)
                torch.autograd.grad(loss_i, [fs.anchor])
            fs.finish()
            loss_i = loss_i.detach()
            loss = loss_i if loss is None else loss + loss_i
        if microbatches > 1:
            loss = loss / microbatches
            for g in grads.values():
                for _, t in g.unique():
                    t /= microbatches
        return loss, grads

    def step(params, opt_state, batch):
        st = next(iter(params.values()))
        if isinstance(st, ShardedTensor):
            loss, grads = sharded_grads(params, batch)
        elif microbatches == 1:
            loss, grads = grad_fn(params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            for mb in _microbatches(batch, microbatches):
                loss_i, grads_i = grad_fn(params, mb)
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


def _microbatches(batch: dict, n: int):
    """The batch split into ``n`` microbatches on axis 0 (``mrope_pos``,
    (3, B, S), on axis 1); one microbatch is the batch itself."""
    if n == 1:
        yield batch
        return
    parts = {k: v.chunk(n, dim=1 if k == "mrope_pos" else 0)
             for k, v in batch.items()}
    for i in range(n):
        yield {k: v[i] for k, v in parts.items()}


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, seed: int = 0,
                     dtype=torch.bfloat16,
                     device: torch.device | str | None = None):
    """(params, opt_state) from the port's seeded ``init_params``, on
    the card unless ``device`` says otherwise."""
    params = api.init_params(cfg, seed, dtype, device=device)
    return params, init_opt_state(params, opt_cfg)
