"""Rematerialisation: the port's ``jax.checkpoint``.

The reference wraps each layer body in ``jax.checkpoint`` when
``cfg.remat`` is set (every published config; ``.reduced()`` turns it
off), and always the Mamba1 chunk step and the query-chunk attention
body, so the backward recomputes a body's activations instead of
keeping them. ``remat(fn, *args)`` is that here:
``torch.utils.checkpoint.checkpoint`` (non-reentrant) while autograd
records, a plain call otherwise (serving, ``no_grad``). It changes
memory and time, never a value: the recompute runs the same operations
on the same inputs.

On a placed train state a body gathers its weights through the
recording ``sharding.FsdpStep``. The recompute runs inside
``torch.autograd.grad``, after the recording has ended, so ``remat``
runs it with the step replaying (``sharding.replaying``): each block
is gathered again as a graph node like the forward's, whose gradient
goes nowhere (the recomputed graph only supplies saved tensors; the
gradient flows through the forward's nodes, and each leaf is
reduce-scattered once). ``recomputing()`` tells a counter of a step's
events (the MoE drops) that a body runs a second time. A body's tensor
inputs are what the checkpoint keeps for the backward: they count in
an installed ``sharding.saved_probe``.
"""
from __future__ import annotations

import threading

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding

_TLS = threading.local()


def recomputing() -> bool:
    """Whether this thread is inside a remat body's recompute."""
    return getattr(_TLS, "on", False)


def remat(fn, *args, on: bool = True):
    """``fn(*args)``, its activations recomputed in the backward when
    ``on`` and autograd records (else a plain call). ``fn`` may read
    tensors it closes over (per-layer weights); only ``args`` and those
    are its inputs, and it must not write a tensor in place that
    outlives it."""
    if not (on and torch.is_grad_enabled()):
        return fn(*args)
    for a in args:
        if isinstance(a, torch.Tensor):
            sharding.note_saved(a, boundary=True)
    step = sharding.recording_step()
    ran = []

    def body(*a):
        if not ran:                       # the forward
            ran.append(True)
            return fn(*a)
        prev = recomputing()
        _TLS.on = True
        try:
            with sharding.replaying(step):
                return fn(*a)
        finally:
            _TLS.on = prev

    return checkpoint(body, *args, use_reentrant=False,
                      preserve_rng_state=False)
