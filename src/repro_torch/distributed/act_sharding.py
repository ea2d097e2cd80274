"""Activation sharding: the gather points of the mesh data plane.

Port of ``src/repro/distributed/act_sharding.py`` for the serving
engine's exact-reductions mode and the train step's row-parallel mode.
In the JAX package the model code calls
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

MoE (exact mode): the expert stacks lie over "data" (experts) with the
FFN unsharded, as the serving rule table puts them. The four MoE
anchors are where the single controller splits and gathers:
``constrain_expert_ecd`` splits the capacity buckets (or the decode
rows grouped by expert) by expert range onto each data shard's device,
``constrain_expert_ecf`` keeps each shard's hidden on its device, and
``constrain_moe_local`` gathers the expert outputs back onto the home
device in the unsharded expert order, so the combine runs in the
single-device FP order; ``constrain_moe_groups`` is the identity
(compute at full batch). ``moe_token_parallel=True`` arms
``moe_a2a_mesh()``: ``lm._moe`` then runs
``models/moe_shard_map.moe_block_a2a`` (each data shard routes its own
batch rows and exchanges buckets with the others).

Training (``exact_reductions=False``, the row-parallel mode, with the
batch axes installed): ``batch_shards`` (and the anchors
``constrain_btd``, ``constrain_bd`` and ``constrain_boundary``, which
call it) split the batch rows over the batch axes, every axis but
"model", onto each position of the row's batch shard; each position
computes its rows and its column (``lm``'s mesh train path). o and down
are row-parallel there: each column's partial product is summed over
the columns by ``psum_columns``, the all-reduce GSPMD inserts, whose
gradient is the same all-reduce. The merged heads, the FFN hidden, the
residual and the vocabulary stay split over the columns (those anchors
pass a per-column list through). MoE in this mode (TP mode): the
experts lie over "data" with their hidden over "model", as the train
rule table puts them; ``moe_all_to_all`` moves each batch shard's
capacity buckets to the expert blocks of its pod and
``moe_all_to_all_back`` returns the outputs (the counterparts of
``constrain_moe_local`` then ``constrain_expert_ecd``, and back).

The SSM anchors (``constrain_ssm_channels``, ``_bthp``, ``_bth``) put
the mixer's channels or heads over "model" with the sequence whole: the
train step's columns compute their own block from the start (each
column's in_proj, conv and scan run over its channels or heads), so
the per-column lists they are given pass through, and a whole tensor
is split onto the columns, as ``constrain_heads`` splits heads.

Not ported (raises ``NotImplementedError``): the sequence-parallel
boundary (``seq_shard_boundary``), which only the dry-run tooling turns
on.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.ops import COLLECTIVE_METER

_MESH = None
_DEVICES: list = []          # the "model" columns' devices of _MESH
_MOE_TOKEN_PARALLEL = False
_EXACT = True
_BATCH_AXES: tuple = ()
_ROWS: list = []             # [batch shard][column] devices (training)


@contextlib.contextmanager
def activation_sharding(batch_axes: tuple, model_axis: str = "model",
                        seq_shard_boundary: bool = False,
                        moe_token_parallel: bool = False,
                        mesh=None, exact_reductions: bool = False):
    """Install ``mesh`` for the model code's gather points for the
    duration of the block (scoped, so single-device engines in the same
    process are untouched). The serving engine enters it around every
    dispatch with ``batch_axes=()`` and ``exact_reductions=True``;
    ``moe_token_parallel`` arms ``moe_a2a_mesh``. The mesh train step
    enters it with the batch axes and ``exact_reductions=False``."""
    if seq_shard_boundary:
        raise NotImplementedError(
            "activation_sharding(seq_shard_boundary=True): sequence-"
            "parallel boundaries come with the dry-run tooling")
    if mesh is not None and batch_axes and exact_reductions:
        raise NotImplementedError(
            f"activation_sharding(batch_axes={batch_axes!r}, "
            f"exact_reductions=True): the serving data plane computes at "
            f"full batch (batch_axes=()); batch-sharded activations run "
            f"in the row-parallel mode")
    global _MESH, _DEVICES, _MOE_TOKEN_PARALLEL, _EXACT, _BATCH_AXES, _ROWS
    prev = (_MESH, _DEVICES, _MOE_TOKEN_PARALLEL, _EXACT, _BATCH_AXES,
            _ROWS)
    _MESH, _DEVICES, _MOE_TOKEN_PARALLEL = mesh, [], moe_token_parallel
    _EXACT, _BATCH_AXES, _ROWS = exact_reductions, tuple(batch_axes), []
    if mesh is not None:
        from repro_torch.distributed.sharding import (batch_rows,
                                                      column_coords)
        _DEVICES = [mesh.devices[column_coords(mesh, m)]
                    for m in range(mesh.shape[model_axis])]
        if _BATCH_AXES:
            _ROWS = batch_rows(mesh, model_axis)
    try:
        yield
    finally:
        (_MESH, _DEVICES, _MOE_TOKEN_PARALLEL, _EXACT, _BATCH_AXES,
         _ROWS) = prev


def installed_mesh():
    """The mesh of the enclosing ``activation_sharding`` block, or
    None."""
    return _MESH


def moe_a2a_mesh():
    """(mesh, "data") when the all-to-all MoE should run (token
    parallelism under an installed mesh; the experts lie over "data"),
    else None."""
    if _MOE_TOKEN_PARALLEL and _MESH is not None:
        return _MESH, "data"
    return None


def _gather(x, dim: int, device=None):
    """Concatenate shards along ``dim`` onto ``device`` (the first
    shard's by default); one shard is returned as is (moved if it lives
    elsewhere). Outside exact mode a list of shards stays split."""
    if not isinstance(x, (list, tuple)) or not _EXACT:
        return x
    device = x[0].device if device is None else device
    if len(x) == 1:
        return x[0].to(device)
    with COLLECTIVE_METER.sync():
        COLLECTIVE_METER.gathers += 1
        return torch.cat([t.to(device) for t in x], dim=dim)


def gather_region(pieces: list, device) -> torch.Tensor:
    """The data (and, for a sequence-split slab, "model") shards of a KV
    layer gathered onto the device that computes with them: ``pieces``
    are ((rows slice, positions slice), block) covering the region;
    one block is returned as is (moved if it lives elsewhere)."""
    if len(pieces) == 1:
        return pieces[0][1].to(device)
    n = max(r.stop for (r, _), _ in pieces)
    t = max(q.stop for (_, q), _ in pieces)
    first = pieces[0][1]
    with COLLECTIVE_METER.sync():
        COLLECTIVE_METER.gathers += 1
        out = torch.empty((n, t) + tuple(first.shape[2:]),
                          dtype=first.dtype, device=device)
        for (r, q), b in pieces:
            out[r, q] = b.to(device)
        return out


def replicate(x: torch.Tensor) -> list:
    """A gathered (replicated) value as every column's copy: one tensor
    per column device (the same tensor where devices repeat)."""
    if not _DEVICES:
        return [x]
    if all(d == x.device for d in _DEVICES):
        return [x] * len(_DEVICES)
    with COLLECTIVE_METER.sync():
        return [x.to(d) for d in _DEVICES]


def batch_shards(x, dim: int = 0):
    """Split the batch rows (dimension ``dim``: 1 for M-RoPE positions
    (3, B, S)) of ``x`` over the installed batch axes: [batch
    shard][column] blocks, each on its position's device (the positions
    of one batch shard hold the same rows). A list (already split) or no
    installed batch axes: ``x`` as it is. The rows must split evenly, as
    a batch sharded over the batch axes must."""
    if isinstance(x, (list, tuple)) or not _ROWS:
        return x
    nb = len(_ROWS)
    if x.shape[dim] % nb:
        raise ValueError(
            f"a batch of {x.shape[dim]} rows does not split over the {nb} "
            f"shards of the batch axes {_BATCH_AXES}")
    return [[blk.to(d) for d in devs]
            for blk, devs in zip(torch.chunk(x, nb, dim=dim), _ROWS)]


def constrain_btd(x):
    """(B, S, D) activations: batch over the batch axes."""
    return batch_shards(x)


def constrain_bd(x):
    """(B, D) decode activations: batch over the batch axes."""
    return batch_shards(x)


def constrain_boundary(x):
    """Inter-layer residual (B, S, D): batch over the batch axes (the
    sequence split of ``seq_shard_boundary`` is not ported)."""
    return batch_shards(x)


class _SumColumns(torch.autograd.Function):
    """The columns' partial products summed in column order on the first
    column's device, a copy on every column's device; the gradient is
    the same all-reduce of the copies' gradients (each column's copy
    feeds that column only)."""

    @staticmethod
    def forward(ctx, *parts):
        ctx.devices = [p.device for p in parts]
        return _all_reduce(parts, ctx.devices)

    @staticmethod
    def backward(ctx, *grads):
        return _all_reduce(grads, ctx.devices)


def _all_reduce(parts, devices) -> tuple:
    home = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(home)
    with COLLECTIVE_METER.sync():
        return tuple(total.to(d) if d != home else total.clone()
                     for d in devices)


def psum_columns(parts: list) -> list:
    """The row-parallel mode's all-reduce over "model": one column's
    (B, S, D) partial products each (o, down, the vocab-split
    embedding), their sum on every column's device. One column: as
    it is."""
    if len(parts) == 1:
        return list(parts)
    return list(_SumColumns.apply(*parts))


def constrain_logits(x):
    """(B, S, V) or (B, V) logits: exact mode gathers the vocab dim —
    sampling consumes these (sort / cumsum / top-k over V) and must see
    whole rows in single-device FP order; the unembedding still runs
    column-parallel, the gather after it is elementwise. Outside exact
    mode the vocabulary stays split over the columns."""
    return _gather(x, -1)


def constrain_heads(x):
    """Attention head tensors — (B, S, H, D) q/k/v or (B, S, Kh, G, D)
    grouped query: heads over the model axis, one block per column
    device. A list (already per column) passes through."""
    if isinstance(x, (list, tuple)) or x.ndim not in (4, 5):
        return x
    return _columns(x, 2)


def _columns(x, dim: int):
    """``x`` split into one block a column along ``dim`` (each on its
    column's device); a list, or no installed mesh: as it is."""
    if isinstance(x, (list, tuple)) or not _DEVICES:
        return x
    M = len(_DEVICES)
    return [t.contiguous().to(d)
            for t, d in zip(torch.chunk(x, M, dim=dim), _DEVICES)]


def constrain_ssm_channels(x):
    """(B, S, C) SSM activations: channels over "model", S whole (the
    recurrence runs along S)."""
    return _columns(x, -1)


def constrain_ssm_bthp(x):
    """SSM activations (B, T, H, P): heads over "model"."""
    return _columns(x, 2)


def constrain_ssm_bth(x):
    """(B, T, H) per-head scalars: heads over "model"."""
    return _columns(x, 2)


def constrain_ffn_hidden(x):
    """(B, S, F) MLP hidden: exact mode gathers F, so the down
    projection contracts an unsharded dim in single-device FP order;
    outside it F stays over "model" (the down projection is then
    row-parallel)."""
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


def constrain_moe_groups(x):
    """Group-major MoE tensors (G, ...): groups follow the batch
    sharding. The serving plane computes at full batch
    (``batch_axes=()``), so they stay whole on the home device; the
    train step's groups are already per batch shard (each shard buckets
    the groups its rows touch, ``moe.moe_block_train``)."""
    return x


def constrain_expert_ecd(x: torch.Tensor, sizes: list, devices: list
                         ) -> list:
    """Expert-major MoE operands — the (E, G*C, D) capacity buckets, or
    the decode rows grouped by expert — split along dim 0 into the data
    shards' blocks (``sizes`` entries each) and each block moved to its
    shard's device (``devices``): the dispatch half of the MoE
    exchange. One block stays where it is."""
    if len(sizes) == 1:
        return [x.to(devices[0])]
    with COLLECTIVE_METER.sync():
        COLLECTIVE_METER.gathers += 1
        return [b.to(d) for b, d in zip(torch.split(x, sizes), devices)]


def constrain_expert_ecf(x):
    """A data shard's expert hidden (E_d, n, F): unsharded in exact mode
    and over "model" in TP mode (the train step: each column computes
    its block of F), so it stays on its position's device."""
    return x


def constrain_moe_local(blocks: list, device) -> torch.Tensor:
    """The data shards' expert outputs gathered onto ``device`` in the
    unsharded expert order (concatenated along dim 0): the combine
    half of the MoE exchange."""
    return _gather(list(blocks), 0, device)


# TP mode (the train step): the counterparts of ``constrain_moe_local``
# then ``constrain_expert_ecd`` (the bucket tensor leaves its batch
# shard for its expert block: the all-to-all over "data") and back, one
# "model" column at a time. Position b of the column is batch shard b
# and runs expert block ``b % n_data`` for the shards of its pod
# (``b // n_data``), whose groups span [g0, g1) over all of them.

def _pod(b: int, n_data: int, spans: list) -> tuple:
    """(shards, g0, g1) of batch shard ``b``'s pod."""
    shards = range(b // n_data * n_data, (b // n_data + 1) * n_data)
    return (shards, min(spans[s][0] for s in shards),
            max(spans[s][1] for s in shards))


def moe_all_to_all(buckets: list, spans: list, n_data: int) -> list:
    """``buckets[b]``: batch shard b's capacity buckets (n_g, E, C, D) of
    the groups [g0, g1) = ``spans[b]`` its rows touch, zero where
    another shard's token fills a slot, on the column's position b.
    Returns, for each position b, the buckets of its expert block
    (E / n_data experts) over its pod's groups, expert-major (E_d,
    G_pod * C, D) on its device: the pod's shards' blocks, a group that
    straddles shards summed over them (each slot has one owner, the
    others add zeros)."""
    E, C, D = buckets[0].shape[1:]
    Ed = E // n_data
    out = []
    with COLLECTIVE_METER.sync():
        COLLECTIVE_METER.all_to_alls += 1
        for u, dst in enumerate(buckets):
            d = u % n_data
            shards, g0, g1 = _pod(u, n_data, spans)
            rows = []
            for g in range(g0, g1):
                acc = None
                for b in shards:
                    lo, hi = spans[b]
                    if lo <= g < hi:
                        part = buckets[b][g - lo, d * Ed:(d + 1) * Ed] \
                            .to(dst.device)
                        acc = part if acc is None else acc + part
                rows.append(acc)
            out.append(torch.stack(rows, dim=1).reshape(Ed, -1, D))
    return out


def moe_all_to_all_back(outs: list, spans: list, n_data: int, cap: int,
                        devices: list) -> list:
    """The inverse of ``moe_all_to_all``: ``outs[u]`` position u's
    expert outputs (E_d, G_pod * C, D). Returns, for each batch shard b,
    its groups' rows of every expert block of its pod, in expert order,
    group-major (n_g, E * C, D) on ``devices[b]``."""
    Ed, _, D = outs[0].shape
    back = []
    with COLLECTIVE_METER.sync():
        COLLECTIVE_METER.all_to_alls += 1
        for b, dev in enumerate(devices):
            shards, g0, g1 = _pod(b, n_data, spans)
            lo, hi = spans[b][0] - g0, spans[b][1] - g0
            x = torch.cat([outs[u].view(Ed, g1 - g0, cap, D)[:, lo:hi]
                           .to(dev) for u in shards])
            back.append(x.transpose(0, 1).reshape(hi - lo, -1, D))
    return back
