"""Elastic scaling: re-mesh plans after node loss or scale events.

Port of ``src/repro/distributed/elastic.py``. The planners are plain
arithmetic and equal the JAX package's; ``MeshPlan.make`` builds the
port's ``launch.mesh.Mesh``.

At 1000+ nodes, failures are routine; the recovery loop needs a
*plan*: given the surviving chip count, pick the largest valid mesh
that keeps the model axis intact (TP degree is fixed by the weight
sharding; shrinking it would change every weight shard) and shrinks
the data/pod axes, then rescale the data pipeline.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.launch.mesh import make_mesh


@dataclass(frozen=True)
class MeshPlan:
    shape: tuple
    axes: tuple
    n_devices: int
    global_batch: int

    def make(self, device: torch.device | str | None = None):
        """The planned mesh (``launch.mesh.make_mesh``) on the platform
        of ``device`` (the card by default)."""
        return make_mesh(self.shape, self.axes, device)


def plan_after_failure(current_shape: tuple, axes: tuple,
                       surviving_devices: int, global_batch: int,
                       tokens_per_device_min: int = 1) -> MeshPlan:
    """Largest mesh ≤ surviving_devices that preserves the model axis.

    Only the leading data-like axes shrink (pod first, then data). The
    global batch is kept when it still divides the new data extent,
    else reduced to the largest multiple that fits (the optimizer's
    schedule is step-based, so batch changes are logged, not fatal).
    """
    model = current_shape[-1]
    if surviving_devices < model:
        raise ValueError(
            f"cannot keep TP={model} with {surviving_devices} devices")
    data_total = surviving_devices // model
    if len(current_shape) == 3:
        pod = min(current_shape[0], max(1, data_total
                                        // current_shape[1]))
        data = data_total // pod
        shape = (pod, data, model)
    else:
        shape = (data_total, model)
    n_dev = 1
    for s in shape:
        n_dev *= s
    data_extent = n_dev // model
    batch = global_batch
    if batch % data_extent != 0:
        batch = max(data_extent,
                    (global_batch // data_extent) * data_extent)
    return MeshPlan(shape=shape, axes=axes[-len(shape):], n_devices=n_dev,
                    global_batch=batch)


def scale_out_plan(current_shape: tuple, axes: tuple, new_devices: int,
                   global_batch: int) -> MeshPlan:
    """Grow the data axes when capacity arrives (same constraints)."""
    return plan_after_failure(current_shape, axes, new_devices,
                              global_batch)
