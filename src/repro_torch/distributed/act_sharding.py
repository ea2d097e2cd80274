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
rows before sampling. The serving engine enters it with ``batch_axes=()``:
compute runs at full batch and "data" shards only storage (KV pages,
batch state). With the batch axes installed (``batch_axes=("data",)``
or ``("pod", "data")``, as the dry-run's cases are run), each row of
positions (``sharding.batch_rows``: every axis but "model") runs the
exact-mode column step on its block of the batch (``row_spans``,
``batch_row``), as GSPMD has each position compute its own batch rows;
a batch the rows do not divide is computed whole by the first row, as
``fit_spec`` replicates a B=1 bucket.

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
the columns onto the residual stream (``residual_add``, below); inside
a mixer ``psum_columns`` is the all-reduce GSPMD inserts, whose
gradient is the same all-reduce. The merged heads, the FFN hidden and
the vocabulary stay split over the columns (those anchors pass a
per-column list through). MoE in this mode (TP mode): the
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

The train step's residual stream (every family): the layer bodies take
and return one batch shard's residual as a list of pieces, entered with
``residual_in`` (the embedding's column partial products summed) and
carried by ``residual_add`` (a sublayer's partial products added);
``columns_in`` gives each column the whole sequence it computes on.
Without ``seq_shard_boundary`` the residual is one tensor on the batch
shard's first column: ``columns_in`` copies it to the columns (its
gradient: the copies' gradients summed in column order) and
``residual_add`` sums the partial products onto it in column order
(each part's gradient: the sum's). With ``seq_shard_boundary=True``
(the reference's sequence-parallel boundary, which the dry-run turns
on for train cells) and a sequence the "model" axis divides, the
residual is one S/M block a column: ``columns_in`` all-gathers the
blocks over the columns (gradient: a reduce-scatter in column order)
and ``residual_add`` reduce-scatters the partial products in column
order (gradient: an all-gather). Both modes add the same terms in the
same order in the forward and in the backward (each residual piece
feeds exactly its residual add and ``columns_in``, two gradient terms,
whose sum does not depend on their order), so a step is bit-identical
either way; the residual kept for a remat body's recompute falls from
S to S/M positions a column.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.ops import COLLECTIVE_METER
from repro_torch.roofline import hlo_stats

_MESH = None
_DEVICES: list = []          # the "model" columns' devices of _MESH
_MOE_TOKEN_PARALLEL = False
_EXACT = True
_BATCH_AXES: tuple = ()
_ROWS: list = []             # [batch shard][column] devices (training)
_SEQ = False                 # seq_shard_boundary


@contextlib.contextmanager
def activation_sharding(batch_axes: tuple, model_axis: str = "model",
                        seq_shard_boundary: bool = False,
                        moe_token_parallel: bool = False,
                        mesh=None, exact_reductions: bool = False):
    """Install ``mesh`` for the model code's gather points for the
    duration of the block (scoped, so single-device engines in the same
    process are untouched). The serving engine enters it around every
    dispatch with ``batch_axes=()`` and ``exact_reductions=True``;
    ``moe_token_parallel`` arms ``moe_a2a_mesh``. With the batch axes
    and ``exact_reductions=True`` the serving step functions compute
    batch rows over them (``row_spans``). The mesh train step enters it
    with the batch axes and ``exact_reductions=False``;
    ``seq_shard_boundary`` splits its residual stream's sequence over
    the columns (module docstring). Serving never sets it."""
    global _MESH, _DEVICES, _MOE_TOKEN_PARALLEL, _EXACT, _BATCH_AXES, \
        _ROWS, _SEQ
    prev = (_MESH, _DEVICES, _MOE_TOKEN_PARALLEL, _EXACT, _BATCH_AXES,
            _ROWS, _SEQ)
    _MESH, _DEVICES, _MOE_TOKEN_PARALLEL = mesh, [], moe_token_parallel
    _EXACT, _BATCH_AXES, _ROWS = exact_reductions, tuple(batch_axes), []
    _SEQ = seq_shard_boundary
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
         _ROWS, _SEQ) = prev


def seq_shard_boundary() -> bool:
    """Whether the enclosing scope splits the train step's residual
    sequence over "model"."""
    return _SEQ


def exact_reductions() -> bool:
    """Whether a mesh is installed in exact mode (the serving data
    plane's: every reduction unsharded)."""
    return _EXACT and _MESH is not None


def row_spans(n: int) -> list:
    """(row, lo, hi): the batch rows [lo, hi) of ``n`` that each row of
    positions computes in exact mode with the batch axes installed (row
    b of ``sharding.batch_rows``, block b); [(0, 0, n)] without them, or
    when the rows do not divide ``n`` (computed whole by the first
    row)."""
    if not (_EXACT and _ROWS) or n % len(_ROWS):
        return [(0, 0, n)]
    w = n // len(_ROWS)
    return [(b, b * w, (b + 1) * w) for b in range(len(_ROWS))]


@contextlib.contextmanager
def batch_row(b: int):
    """Within the block, the exact-mode gather points (``replicate``,
    the column splits) act on batch row ``b``'s positions (row 0's
    outside batch rows)."""
    global _DEVICES
    prev = _DEVICES
    if _ROWS:
        _DEVICES = list(_ROWS[b])
    try:
        yield
    finally:
        _DEVICES = prev


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


def gather_columns(x, dim: int = -1, device=None):
    """The columns' blocks of a dimension split over "model"
    concatenated along ``dim`` onto ``device`` (the first block's by
    default): exact mode's gather before a contraction or norm over
    it. One block is returned as is (moved if it lives elsewhere). A
    plain tensor, or any list outside exact mode, stays as it is."""
    if not isinstance(x, (list, tuple)) or not _EXACT:
        return x
    device = x[0].device if device is None else device
    if len(x) == 1:
        return x[0].to(device)
    with COLLECTIVE_METER.sync():
        COLLECTIVE_METER.gathers += 1
        out = torch.cat([t.to(device) for t in x], dim=dim)
    rec = hlo_stats.recorder()
    if rec is not None:
        rec.add("all-gather", len(x), hlo_stats.nbytes(out),
                [t.device for t in x] + [device],
                hlo_stats.moved(device, x), "gathers", dst=device)
    return out


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
    rec = hlo_stats.recorder()
    if rec is not None:
        rec.add("all-gather", len(pieces), hlo_stats.nbytes(out),
                [b.device for _, b in pieces] + [device],
                hlo_stats.moved(device, [b for _, b in pieces]), "gathers",
                dst=device)
    return out


def replicate(x: torch.Tensor) -> list:
    """A gathered (replicated) value as every column's copy: one tensor
    per column device (the same tensor where devices repeat)."""
    if not _DEVICES:
        return [x]
    rec = hlo_stats.recorder()
    if rec is not None and len(_DEVICES) > 1:
        rec.add("collective-broadcast", len(_DEVICES), hlo_stats.nbytes(x),
                _DEVICES, hlo_stats.nbytes(x)
                * len({d for d in _DEVICES if d != x.device}))
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
    blocks = torch.chunk(x, nb, dim=dim)
    rec = hlo_stats.recorder()
    if rec is not None:
        devs = [d for row in _ROWS for d in row]
        rec.add("collective-permute", len(devs), hlo_stats.nbytes(blocks[0]),
                devs, sum(hlo_stats.nbytes(blk) * len({d for d in row
                                                       if d != x.device})
                          for blk, row in zip(blocks, _ROWS)))
    return [[blk.to(d) for d in devs]
            for blk, devs in zip(blocks, _ROWS)]


def constrain_btd(x):
    """(B, S, D) activations: batch over the batch axes."""
    return batch_shards(x)


def constrain_bd(x):
    """(B, D) decode activations: batch over the batch axes."""
    return batch_shards(x)


def constrain_boundary(x):
    """Inter-layer residual (B, S, D): batch over the batch axes; the
    sequence split of ``seq_shard_boundary`` is the train step's
    residual layout (``residual_in``, ``residual_add``)."""
    return batch_shards(x)


# ------------------------------------------- the train step's residual
def _blocks(S: int, M: int) -> list:
    w = S // M
    return [slice(m * w, (m + 1) * w) for m in range(M)]


def _col_sum(parts, sl, device):
    """parts' entries ``sl`` of dim 1 summed in column order on
    ``device`` (a fresh tensor)."""
    total = parts[0][:, sl].to(device, copy=len(parts) == 1)
    for p in parts[1:]:
        total = total + p[:, sl].to(device)
    return total


def _record(op: str, k: int, b: int, devices, moved: float,
            dst=None) -> None:
    rec = hlo_stats.recorder()
    if rec is not None:
        rec.add(op, k, b, devices, moved, dst=dst)


class _SumTo(torch.autograd.Function):
    """The columns' partial products summed in column order on
    ``device``; each part's gradient is the sum's, on its device."""

    @staticmethod
    def forward(ctx, device, *parts):
        ctx.devices = [p.device for p in parts]
        _record("reduce", len(parts), hlo_stats.nbytes(parts[0]),
                ctx.devices + [device], hlo_stats.moved(device, parts))
        with COLLECTIVE_METER.sync():
            return _col_sum(parts, slice(None), device)

    @staticmethod
    def backward(ctx, g):
        _record("collective-broadcast", len(ctx.devices), hlo_stats.nbytes(g),
                ctx.devices, hlo_stats.nbytes(g)
                * len({d for d in ctx.devices if d != g.device}))
        with COLLECTIVE_METER.sync():
            return (None,) + tuple(g.to(d) for d in ctx.devices)


class _ReduceScatterSeq(torch.autograd.Function):
    """The columns' (B, S, D) partial products summed in column order,
    block m of S on ``devices[m]``; each part's gradient is the blocks'
    gradients gathered along S on its device."""

    @staticmethod
    def forward(ctx, devices, *parts):
        ctx.devices = [p.device for p in parts]
        sls = _blocks(parts[0].shape[1], len(devices))
        blk = hlo_stats.nbytes(parts[0]) // len(devices)
        _record("reduce-scatter", len(devices), blk,
                ctx.devices + list(devices),
                sum(blk for p in parts for d in devices if d != p.device))
        with COLLECTIVE_METER.sync():
            return tuple(_col_sum(parts, sl, d)
                         for sl, d in zip(sls, devices))

    @staticmethod
    def backward(ctx, *grads):
        _record("all-gather", len(grads),
                hlo_stats.nbytes(grads[0]) * len(grads),
                [g.device for g in grads] + ctx.devices,
                sum(hlo_stats.moved(d, grads) for d in ctx.devices))
        with COLLECTIVE_METER.sync():
            return (None,) + tuple(torch.cat([g.to(d) for g in grads], dim=1)
                                   for d in ctx.devices)


class _GatherSeq(torch.autograd.Function):
    """The S blocks (one a column) gathered whole onto each of
    ``devices``; block m's gradient is the copies' gradients of its
    entries summed in column order on its device."""

    @staticmethod
    def forward(ctx, devices, *blocks):
        ctx.devices = [b.device for b in blocks]
        ctx.devs = list(devices)
        whole = hlo_stats.nbytes(blocks[0]) * len(blocks)
        _record("all-gather", len(blocks), whole,
                ctx.devices + ctx.devs,
                sum(hlo_stats.moved(d, blocks) for d in devices),
                dst=devices[0] if len(devices) == 1 else None)
        with COLLECTIVE_METER.sync():
            return tuple(torch.cat([b.to(d) for b in blocks], dim=1)
                         for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        sls = _blocks(grads[0].shape[1], len(ctx.devices))
        _record("reduce-scatter", len(ctx.devices),
                hlo_stats.nbytes(grads[0]) // len(ctx.devices),
                ctx.devs + ctx.devices,
                sum(hlo_stats.nbytes(grads[0]) // len(ctx.devices)
                    for g in grads for d in ctx.devices if d != g.device))
        with COLLECTIVE_METER.sync():
            return (None,) + tuple(_col_sum(grads, sl, d)
                                   for sl, d in zip(sls, ctx.devices))


def _split(S: int, M: int) -> bool:
    """Whether a residual of S positions splits over M columns."""
    return _SEQ and M > 1 and S % M == 0


def residual_in(parts: list, devices: list) -> list:
    """A batch shard's residual stream from its columns' partial
    products (the vocab-split embedding; one part: a value computed
    whole), ``devices`` the shard's columns: their sum in column order,
    one tensor on the first column, or its S blocks over the columns
    under ``seq_shard_boundary`` (M dividing S)."""
    return residual_add(None, parts, devices)


def residual_add(h, parts: list, devices: list) -> list:
    """``h`` (a residual from ``residual_in``; None: zero) plus the sum
    of the columns' (B, S, D) partial products ``parts`` (one: a block
    one column computed whole), in ``h``'s layout."""
    if _split(parts[0].shape[1], len(devices)):
        ys = _ReduceScatterSeq.apply(devices, *parts)
    elif len(parts) == 1 and parts[0].device == devices[0]:
        ys = parts
    else:
        ys = [_SumTo.apply(devices[0], *parts)]
    return list(ys) if h is None else [x + y for x, y in zip(h, ys)]


def residual_pieces(row: list) -> list:
    """A whole per-column value ``row`` (a copy on each column, as
    ``batch_shards`` gives it) in the residual's layout: the first
    column's copy, or each column's S block of its copy."""
    if not _split(row[0].shape[1], len(row)):
        return row[:1]
    return [x[:, sl].contiguous()
            for x, sl in zip(row, _blocks(row[0].shape[1], len(row)))]


def residual_spans(h: list) -> list:
    """(lo, hi): the positions of S each piece of residual ``h``
    holds."""
    w = h[0].shape[1]
    return [(m * w, (m + 1) * w) for m in range(len(h))]


def columns_in(h: list, devices: list) -> list:
    """The whole (B, S, D) residual ``h`` on each of ``devices`` (the
    first columns of its batch shard): copies of the one tensor, or the
    S blocks all-gathered. Their gradients are summed back in column
    order. One column holding the whole residual: ``h`` itself."""
    if len(h) > 1:
        return list(_GatherSeq.apply(devices, *h))
    if len(devices) == 1 and devices[0] == h[0].device:
        return list(h)
    return list(broadcast_columns(h[0], devices))


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
    rec = hlo_stats.recorder()
    if rec is not None:
        b = hlo_stats.nbytes(parts[0])
        rec.add("all-reduce" if len(devices) > 1 else "reduce",
                len(parts), b, [p.device for p in parts] + list(devices),
                hlo_stats.moved(home, parts)
                + b * len({d for d in devices if d != home}))
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


class _BroadcastColumns(torch.autograd.Function):
    """A value one column computed whole, a copy on every column's
    device; the gradient is the copies' gradients summed in column
    order on the value's device."""

    @staticmethod
    def forward(ctx, x, devices):
        ctx.home = x.device
        rec = hlo_stats.recorder()
        if rec is not None:
            rec.add("collective-broadcast", len(devices),
                    hlo_stats.nbytes(x), devices, hlo_stats.nbytes(x)
                    * len({d for d in devices if d != x.device}))
        with COLLECTIVE_METER.sync():
            return tuple(x.to(d) if d != x.device else x.clone()
                         for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        return _all_reduce(grads, [ctx.home])[0], None


def broadcast_columns(x: torch.Tensor, devices: list) -> list:
    """The row-parallel mode's copy of a block one column computed whole
    (attention over heads the columns do not divide) onto every column's
    ``devices``: each column's copy feeds that column only, so the
    block's gradient is their sum. One column: as it is."""
    if len(devices) == 1:
        return [x]
    return list(_BroadcastColumns.apply(x, list(devices)))


def constrain_logits(x):
    """(B, S, V) or (B, V) logits: exact mode gathers the vocab dim —
    sampling consumes these (sort / cumsum / top-k over V) and must see
    whole rows in single-device FP order; the unembedding still runs
    column-parallel, the gather after it is elementwise. Outside exact
    mode the vocabulary stays split over the columns."""
    return gather_columns(x, -1)


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
    return gather_columns(x, -1)


def constrain_attn_merged(x):
    """(B, S, q_dim) attention output after heads merge, feeding the o
    projection: the head shards are gathered so the o-proj contraction
    runs unsharded."""
    return gather_columns(x, -1)


def constrain_residual(x):
    """(B, S, D) residual stream mid-layer: the column-parallel o
    projection leaves D model-sharded, and the next rms_norm reduces
    over D, so the shards are gathered here."""
    return gather_columns(x, -1)


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
    blocks = torch.split(x, sizes)
    rec = hlo_stats.recorder()
    if rec is not None:
        rec.add("all-to-all", len(sizes),
                max(hlo_stats.nbytes(b) for b in blocks),
                [x.device] + list(devices),
                sum(hlo_stats.nbytes(b) for b, d in zip(blocks, devices)
                    if d != x.device), "gathers")
    with COLLECTIVE_METER.sync():
        COLLECTIVE_METER.gathers += 1
        return [b.to(d) for b, d in zip(blocks, devices)]


def constrain_expert_ecf(x):
    """A data shard's expert hidden (E_d, n, F): unsharded in exact mode
    and over "model" in TP mode (the train step: each column computes
    its block of F), so it stays on its position's device."""
    return x


def constrain_moe_local(blocks: list, device) -> torch.Tensor:
    """The data shards' expert outputs gathered onto ``device`` in the
    unsharded expert order (concatenated along dim 0): the combine
    half of the MoE exchange."""
    return gather_columns(list(blocks), 0, device)


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
    _record_a2a(buckets, out, n_data)
    return out


def _record_a2a(src: list, dst: list, n_data: int) -> None:
    """One leg of the MoE exchange: every position's blocks (``src``)
    to every position's (``dst``) within a pod of ``n_data`` shards.
    Moved: the bytes each destination gathers from the other positions
    of its pod."""
    rec = hlo_stats.recorder()
    if rec is None:
        return
    moved = 0.0
    for u, t in enumerate(dst):
        pod = range(u // n_data * n_data, (u // n_data + 1) * n_data)
        others = sum(1 for s in pod if src[s].device != t.device)
        moved += hlo_stats.nbytes(t) * others / n_data
    rec.add("all-to-all", n_data, max(hlo_stats.nbytes(t) for t in dst),
            [t.device for t in src] + [t.device for t in dst], moved,
            "all_to_alls")


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
    _record_a2a(outs, back, n_data)
    return back
