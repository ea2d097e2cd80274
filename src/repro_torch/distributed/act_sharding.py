"""Activation sharding: the gather points of the mesh data plane.

Port of ``src/repro/distributed/act_sharding.py`` for the serving
engine's exact-reductions mode. In the JAX package the model code calls
``constrain_*`` at layer boundaries and GSPMD inserts the collectives;
here one Python process drives every mesh position (single
controller), the model code computes one "model" column per shard, and
the ``constrain_*`` functions are the places where column shards are
gathered: each takes a list of per-column tensors and returns the
gathered tensor on the first column's device (``constrain_heads`` goes
the other way, splitting heads into columns). A plain tensor passes
through unchanged, and every function does nothing when no mesh is
installed (tests, single-device engine).

Exact mode (``exact_reductions=True``, the serving engine's): no
contraction runs over a sharded dimension — merged attention heads, the
FFN hidden and the residual stream are gathered before the projection
or norm that reduces over them, and logits are gathered to whole vocab
rows before sampling. Compute runs at full batch; "data" shards only
storage (KV pages, batch state).

Not ported with this slice (each raises ``NotImplementedError``): the
batch-sharded activations, the row-parallel (non-exact) mode, the
sequence-parallel boundary (``seq_shard_boundary``) and MoE token
parallelism (``moe_token_parallel``) — training and dry-run features —
and with them the anchors only they use (``constrain_btd``,
``constrain_boundary``, ``constrain_bd``, the MoE and SSM anchors,
``moe_a2a_mesh``).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.ops import COLLECTIVE_METER

_MESH = None
_DEVICES: list = []          # the "model" columns' devices of _MESH


@contextlib.contextmanager
def activation_sharding(batch_axes: tuple, model_axis: str = "model",
                        seq_shard_boundary: bool = False,
                        moe_token_parallel: bool = False,
                        mesh=None, exact_reductions: bool = False):
    """Install ``mesh`` for the model code's gather points for the
    duration of the block (scoped, so single-device engines in the same
    process are untouched). The serving engine enters it around every
    dispatch with ``batch_axes=()`` and ``exact_reductions=True``."""
    if seq_shard_boundary:
        raise NotImplementedError(
            "activation_sharding(seq_shard_boundary=True): sequence-"
            "parallel boundaries are a training feature, ported with the "
            "training-on-a-mesh slice")
    if moe_token_parallel:
        raise NotImplementedError(
            "activation_sharding(moe_token_parallel=True): MoE token "
            "parallelism needs models/moe_shard_map.py, not ported yet")
    if mesh is not None and batch_axes:
        raise NotImplementedError(
            f"activation_sharding(batch_axes={batch_axes!r}): batch-"
            f"sharded activations are a training feature; the serving "
            f"data plane computes at full batch (batch_axes=())")
    if mesh is not None and not exact_reductions:
        raise NotImplementedError(
            "activation_sharding(exact_reductions=False): the row-"
            "parallel mode (partial sums over a sharded contraction) is "
            "a training feature; the port serves in exact mode")
    global _MESH, _DEVICES
    prev = (_MESH, _DEVICES)
    _MESH, _DEVICES = mesh, []
    if mesh is not None:
        from repro_torch.distributed.sharding import column_coords
        _DEVICES = [mesh.devices[column_coords(mesh, m)]
                    for m in range(mesh.shape[model_axis])]
    try:
        yield
    finally:
        _MESH, _DEVICES = prev


def installed_mesh():
    """The mesh of the enclosing ``activation_sharding`` block, or
    None."""
    return _MESH


def _gather(x, dim: int, device=None):
    """Concatenate shards along ``dim`` onto ``device`` (the first
    shard's by default); one shard is returned as is (moved if it lives
    elsewhere)."""
    if not isinstance(x, (list, tuple)):
        return x
    device = x[0].device if device is None else device
    if len(x) == 1:
        return x[0].to(device)
    with COLLECTIVE_METER.sync():
        COLLECTIVE_METER.gathers += 1
        return torch.cat([t.to(device) for t in x], dim=dim)


def gather_blocks(blocks: list, dim: int, device) -> torch.Tensor:
    """The data shards of a KV layer (pages or slab rows) gathered onto
    the device that computes with them: every page a row reads has to
    reach the column's device."""
    return _gather(blocks, dim, device)


def replicate(x: torch.Tensor) -> list:
    """A gathered (replicated) value as every column's copy: one tensor
    per column device (the same tensor where devices repeat)."""
    if not _DEVICES:
        return [x]
    if all(d == x.device for d in _DEVICES):
        return [x] * len(_DEVICES)
    with COLLECTIVE_METER.sync():
        return [x.to(d) for d in _DEVICES]


def constrain_logits(x):
    """(B, S, V) or (B, V) logits: exact mode gathers the vocab dim —
    sampling consumes these (sort / cumsum / top-k over V) and must see
    whole rows in single-device FP order; the unembedding still runs
    column-parallel, the gather after it is elementwise."""
    return _gather(x, -1)


def constrain_heads(x):
    """Attention head tensors — (B, S, H, D) q/k/v or (B, S, Kh, G, D)
    grouped query: heads over the model axis, one block per column
    device. A list (already per column) passes through."""
    if isinstance(x, (list, tuple)) or not _DEVICES or x.ndim not in (4, 5):
        return x
    M = len(_DEVICES)
    return [t.contiguous().to(d)
            for t, d in zip(torch.chunk(x, M, dim=2), _DEVICES)]


def constrain_ffn_hidden(x):
    """(B, S, F) MLP hidden: exact mode gathers F, so the down
    projection contracts an unsharded dim in single-device FP order."""
    return _gather(x, -1)


def constrain_attn_merged(x):
    """(B, S, q_dim) attention output after heads merge, feeding the o
    projection: the head shards are gathered so the o-proj contraction
    runs unsharded."""
    return _gather(x, -1)


def constrain_residual(x):
    """(B, S, D) residual stream mid-layer: the column-parallel o
    projection leaves D model-sharded, and the next rms_norm reduces
    over D, so the shards are gathered here."""
    return _gather(x, -1)
