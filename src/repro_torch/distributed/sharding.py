"""Sharding policy: parameter/state paths → PartitionSpecs (PyTorch).

Port of ``src/repro/distributed/sharding.py``: the same rule table for
every (family × step-kind), function for function, held spec for spec
to the JAX package by ``tests/test_torch_sharding.py``. Axis
conventions (DESIGN §4):

- ``model``  — tensor parallelism: attention heads / FFN hidden /
               expert-FFN hidden / vocab.
- ``data``   — batch parallelism; for *training* also FSDP (params +
               AdamW moments sharded over data — ZeRO-3 style); for MoE
               the expert dimension.
- ``pod``    — second-level data axis (multi-pod): batch + FSDP.

Inference shards weights over "model" only (plus experts over "data");
training adds FSDP axes.

The JAX types this table speaks in have small counterparts here:
``PartitionSpec`` (a tuple of axis entries), ``NamedSharding`` (mesh +
spec, which splits a tensor into per-position shards) and
``ShardedTensor`` (those shards, gathered back on demand). One Python
process drives every position (single controller, as the JAX engine
is): a shard is a plain tensor on its position's device.
``MeshParams`` holds placed weights with each "model" column's compute
view and each "data" shard's MoE experts, the operand the serving step
functions take on a mesh. A train state is placed leaf by leaf
(``device_put``, {path: ShardedTensor}); ``TrainView`` is how the model
computes with it, and ``FsdpStep`` carries one forward-backward's
gathers and reduce-scatters (``all_gather``, ``reduce_scatter``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
import weakref

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models.base import Family, ModelConfig


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per dimension — None
    (replicated), an axis name, or a tuple of axis names. Entries
    normalise as JAX's do: an empty tuple is None, a one-name tuple is
    that name, a list is a tuple."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axes(mesh: Mesh):
    names = mesh.axis_names
    pod = ("pod",) if "pod" in names else ()
    return pod, "data", "model"


def _axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name]


# Weight tensors silently degrading to replicated (a 40-head model on a
# 16-way "model" axis, say) used to be invisible; warn once per
# (label, shape, spec) so a misfit shows up in logs without spamming a
# per-step path. Batch/state fits (B=1 buckets legitimately drop
# "data") stay silent — only callers that pass ``warn_label`` opt in.
_FIT_WARNED: set = set()


def fit_spec(shape: tuple, spec: P, mesh: Mesh, *,
             warn_label: str | None = None) -> P:
    """Drop axes that do not divide their dimension.

    A shard is an even block of its dimension, so every spec passes
    through this fitter. Tuples are trimmed left-to-right:
    ("pod","data") on a dim of size 2 keeps ("pod",). With
    ``warn_label`` set, each axis dropped from that tensor warns once
    via ``warnings.warn``.
    """
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    dropped = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = []
        prod = 1
        for a in axes:
            sz = _axis_size(mesh, a)
            if dim % (prod * sz) == 0:
                kept.append(a)
                prod *= sz
            else:
                dropped.append((a, dim, sz))
        if not kept:
            out.append(None)
        elif isinstance(entry, tuple) and len(axes) > 1:
            # A multi-axis tuple stays a tuple even when trimmed to one
            # axis — ("pod","data") on dim 2 keeps ("pod",) — while a
            # singleton entry normalises to its scalar form.
            out.append(tuple(kept))
        else:
            out.append(kept[0])
    while out and out[-1] is None:
        out.pop()
    if dropped and warn_label is not None:
        key = (warn_label, tuple(shape), str(spec))
        if key not in _FIT_WARNED:
            _FIT_WARNED.add(key)
            detail = ", ".join(
                f"'{a}' (size {sz}) on dim {dim}" for a, dim, sz in dropped)
            warnings.warn(
                f"fit_spec[{warn_label}]: shape {tuple(shape)} spec "
                f"{spec} drops non-dividing mesh axes: {detail}; the "
                f"dimension stays replicated", stacklevel=2)
    return P(*out)


def param_spec(path: str, shape: tuple, cfg: ModelConfig, mesh: Mesh,
               kind: str) -> P:
    """PartitionSpec for one parameter. ``kind``: train|prefill|decode."""
    pod, data, model = _axes(mesh)
    train = kind == "train"
    # FSDP axes used only in training.
    fsdp = (pod + (data,)) if train else ()

    leaf = path.split("/")[-1]
    stacked = shape[0] == cfg.n_layers and len(shape) > 1 \
        or path.startswith(("layers/", "moe/", "dense_mlp/", "enc/",
                            "dec/"))

    def sp(*entries):
        # Strip trailing Nones.
        out = list(entries)
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    # ---- embeddings / head -------------------------------------------------
    if path == "embed/tok":                      # (V, D)
        return sp(model, fsdp if fsdp else None)
    if path == "lm_head":                        # (D, V)
        return sp(fsdp if fsdp else None, model)
    if leaf in ("final_norm", "enc_final_norm"):
        return P()
    if leaf in ("enc_pos", "dec_pos"):
        return P()

    # Layer-stacked tensors: first axis is the layer stack (replicated).
    L = None  # placeholder for the stacked layer axis

    # ---- MoE ---------------------------------------------------------------
    if path.startswith("moe/"):
        if leaf == "router":                     # (nm, D, E)
            return sp(L, fsdp if fsdp else None, None)
        if leaf == "norm":
            return P()
        if leaf in ("w_gate", "w_up"):           # (nm, E, D, Fe)
            if not train:
                # Token-parallel inference: experts over data, FFN
                # unsharded (see act_sharding.constrain_expert_ecd).
                return sp(L, data, None, None)
            return sp(L, data, fsdp and pod or None, model)
        if leaf == "w_down":                     # (nm, E, Fe, D)
            if not train:
                return sp(L, data, None, None)
            return sp(L, data, model, fsdp and pod or None)
        if leaf in ("shared_gate", "shared_up"):  # (nm, D, F)
            return sp(L, fsdp if fsdp else None, model)
        if leaf == "shared_down":                # (nm, F, D)
            if not train:
                return sp(L)                # replicated: see "down"
            return sp(L, model, fsdp if fsdp else None)

    # ---- attention ---------------------------------------------------------
    if leaf == "q":                              # (..., D, q_dim)
        return sp(*([L] if stacked else []),
                  fsdp if fsdp else None, model)
    if leaf in ("k", "v"):                       # (..., D, kv_dim)
        return sp(*([L] if stacked else []),
                  fsdp if fsdp else None, model)
    if leaf == "o":                              # (..., q_dim, D)
        if not train:
            # Inference: column-parallel (output D over model). Row-
            # parallel would shard the contraction and sum partials —
            # a different FP reduction order per mesh shape. Keeping
            # every contraction dim unsharded makes sharded inference
            # token-identical to single-device at the cost of the
            # pre-projection head gather.
            return sp(*([L] if stacked else []), None, model)
        return sp(*([L] if stacked else []),
                  model, fsdp if fsdp else None)
    if leaf.endswith("_bias"):
        return P()
    if leaf.endswith("norm") or "norm" in leaf:
        return P()

    # ---- dense MLP ---------------------------------------------------------
    if leaf in ("gate", "up"):                   # (..., D, F)
        return sp(*([L] if stacked else []),
                  fsdp if fsdp else None, model)
    if leaf == "down":                           # (..., F, D)
        if not train:
            # Inference keeps the down projection *replicated*, not
            # column-parallel: a narrower local matmul over the long F
            # contraction may block differently than the full-width one
            # (the reference observed 3e-5 drift at K=256), so only a
            # replicated weight keeps the local matmul shape identical
            # to single-device.
            return sp(*([L] if stacked else []))
        return sp(*([L] if stacked else []),
                  model, fsdp if fsdp else None)

    # ---- SSM ---------------------------------------------------------------
    if leaf == "in_proj":                        # (L, D, E*)
        return sp(L, fsdp if fsdp else None, model)
    if leaf == "out_proj":                       # (L, Di, D)
        if not train:
            return sp(L, None, model)       # column-parallel: see "o"
        return sp(L, model, fsdp if fsdp else None)
    if leaf in ("conv_w",):                      # (L, K, conv_dim)
        return sp(L, None, model)
    if leaf in ("conv_b",):                      # (L, conv_dim)
        return sp(L, model)
    if leaf == "x_proj":                         # (L, Di, dt+2N)
        return sp(L, model, None)
    if leaf == "dt_proj":                        # (L, dt_rank, Di)
        return sp(L, None, model)
    if leaf in ("dt_bias", "A_log", "ssm_D"):    # (L, Di|H[,N])
        return sp(L, model) if len(shape) >= 2 else P()

    return P()


def batch_spec(kind: str, mesh: Mesh) -> P:
    pod, data, model = _axes(mesh)
    return P(pod + (data,))


def param_shardings(cfg: ModelConfig, params_or_shapes: dict, mesh: Mesh,
                    kind: str) -> dict:
    out = {}
    for path, v in params_or_shapes.items():
        shape = v if isinstance(v, tuple) else tuple(v.shape)
        spec = fit_spec(shape, param_spec(path, shape, cfg, mesh, kind),
                        mesh, warn_label=path)
        out[path] = NamedSharding(mesh, spec)
    return out


def opt_shardings(param_sh: dict, mesh: Mesh) -> dict:
    """AdamW moments follow their parameter's sharding (ZeRO-ish: the
    params are already FSDP-sharded in training, so moments are too)."""
    out = {"step": NamedSharding(mesh, P())}
    for path, sh in param_sh.items():
        out[f"m/{path}"] = sh
        out[f"v/{path}"] = sh
    return out


# ------------------------------------------------------------- activations
def kv_cache_spec(mesh: Mesh, shape: tuple) -> P:
    """(L, B, S, Kh, Dh): batch over data axes; kv heads over model
    when divisible, else *sequence*-sharded KV (each position holds S/tp
    of every head — the layout for MQA/GQA with few kv heads)."""
    pod, data, model = _axes(mesh)
    L, B, S, Kh, Dh = shape
    tp = _axis_size(mesh, model)
    if Kh % tp == 0:
        spec = P(None, pod + (data,), None, model)
    elif S % tp == 0:
        spec = P(None, pod + (data,), model, None)
    else:
        spec = P(None, pod + (data,))
    return fit_spec(shape, spec, mesh)


def kv_pages_spec(mesh: Mesh, shape: tuple) -> P:
    """Paged KV pool (L, n_pages, page, Kh, Dh): the *page* axis shards
    over "data" (each position owns n_pages/d physical pages), kv heads
    over "model" when divisible. The host-side page table stays global:
    page indices address the logical pool."""
    pod, data, model = _axes(mesh)
    L, n_pages, page, Kh, Dh = shape
    tp = _axis_size(mesh, model)
    head = model if Kh % tp == 0 else None
    return fit_spec(shape, P(None, pod + (data,), None, head), mesh)


def ssm_state_spec(mesh: Mesh, shape: tuple) -> P:
    """(L, B, Di, N): batch over data, d_inner over model."""
    pod, data, model = _axes(mesh)
    return fit_spec(shape, P(None, pod + (data,), model), mesh)


def conv_state_spec(mesh: Mesh, shape: tuple) -> P:
    """(L, B, K-1, C): batch over data, channels over model."""
    pod, data, model = _axes(mesh)
    return fit_spec(shape, P(None, pod + (data,), None, model), mesh)


def lora_spec(proj: str, which: str, mesh: Mesh) -> P:
    """LoRA slot buffers: A (L, slots, din, r) replicated on din/r;
    B (L, slots, r, dout) with dout over model (matches the projection
    output sharding so the delta adds without a reshard)."""
    pod, data, model = _axes(mesh)
    if which == "a":
        return P(None, None, None, None)
    # Projection output dims are model-sharded at inference (q/k/v over
    # heads, o column-parallel); the down projection's output is
    # replicated, but its LoRA delta contracts only over r (a single
    # K-block), so a sharded B adds without a reduction-order change.
    return P(None, None, None, model)


# ------------------------------------------------- shards on the devices
class NamedSharding:
    """``jax.sharding.NamedSharding``: a mesh and a (fitted) spec. A
    sharded dimension splits into even contiguous blocks, block index
    row-major over the entry's axes, as GSPMD lays them out."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def index(self, coords: tuple, shape: tuple) -> tuple:
        """The slices of a ``shape`` tensor that mesh position
        ``coords`` holds."""
        mesh = self.mesh
        entries = list(self.spec) + [None] * (len(shape) - len(self.spec))
        out = []
        for dim, entry in zip(shape, entries):
            if entry is None:
                out.append(slice(0, dim))
                continue
            n, b = 1, 0
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                k = mesh.axis_names.index(a)
                b = b * mesh.shape[a] + coords[k]
                n *= mesh.shape[a]
            if dim % n:
                raise ValueError(
                    f"spec {self.spec} on {mesh!r} splits dim {dim} of "
                    f"{tuple(shape)} into {n} uneven blocks; pass it "
                    f"through fit_spec")
            step = dim // n
            out.append(slice(b * step, (b + 1) * step))
        return tuple(out)

    def shard(self, x: torch.Tensor, copy: bool = False
              ) -> "ShardedTensor":
        """Split ``x`` onto the mesh: each position gets its block,
        contiguous, on its device. Positions that hold the same block on
        the same device share one tensor (a block that already is ``x``
        on that device is ``x`` itself, no copy; so is a stacked block
        on ``x``'s device whose layers are contiguous, a view of
        ``x``). ``copy``: every block is a fresh tensor, never a view
        of ``x``."""
        shards = np.empty(self.mesh.devices.shape, dtype=object)
        made: dict = {}
        for coords in np.ndindex(*self.mesh.devices.shape):
            dev = self.mesh.devices[coords]
            slc = self.index(coords, tuple(x.shape))
            key = (tuple((s.start, s.stop) for s in slc), str(dev))
            if key not in made:
                t = x[slc].to(dev)
                same = t.data_ptr() == x[slc].data_ptr()
                if copy and same:
                    t = t.clone(memory_format=torch.contiguous_format)
                # A stacked block on x's own device whose layers are each
                # contiguous (experts split below the layer axis) stays a
                # view: a second copy of a model's experts does not fit
                # beside the first on one card.
                elif not (same and t.dim() >= 3 and t[0].is_contiguous()):
                    t = t.contiguous()
                made[key] = t
            shards[coords] = made[key]
        return ShardedTensor(self, tuple(x.shape), shards)

    def zeros(self, shape: tuple, dtype: torch.dtype,
              sink_dim: int | None = None) -> "ShardedTensor":
        """A zeroed tensor of global ``shape`` allocated shard by shard
        (never whole on one device). ``sink_dim``: each shard keeps one
        extra entry past its block along that dimension — its write
        sink for rows whose index lives on another shard
        (``ShardedTensor.raw``)."""
        shards = np.empty(self.mesh.devices.shape, dtype=object)
        raws = {}
        made: dict = {}
        for coords in np.ndindex(*self.mesh.devices.shape):
            dev = self.mesh.devices[coords]
            slc = self.index(coords, tuple(shape))
            key = (tuple((s.start, s.stop) for s in slc), str(dev))
            if key not in made:
                local = [s.stop - s.start for s in slc]
                if sink_dim is None:
                    made[key] = torch.zeros(local, dtype=dtype, device=dev)
                else:
                    n = local[sink_dim]
                    local[sink_dim] += 1
                    raw = torch.zeros(local, dtype=dtype, device=dev)
                    made[key] = raw.narrow(sink_dim, 0, n)
                    raws[id(made[key])] = raw
            shards[coords] = made[key]
        return ShardedTensor(self, tuple(shape), shards, raws)


class ShardedTensor:
    """A tensor held as per-position shards (a ``jax.Array`` with a
    ``NamedSharding``). Writes go to every shard that holds the written
    index, in place; ``full`` gathers the whole tensor onto one
    device."""

    def __init__(self, sharding: NamedSharding, shape: tuple, shards,
                 raws: dict | None = None):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.shards = shards
        self._raws = raws or {}
        # Shards are written in place, never replaced: their layout is
        # computed once (the model code reads it every layer).
        self._unique = None
        self._blocks = None
        self._parts: dict = {}

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def dtype(self) -> torch.dtype:
        return self.shards.flat[0].dtype

    def local(self, coords: tuple) -> torch.Tensor:
        return self.shards[coords]

    def raw(self, t: torch.Tensor) -> torch.Tensor:
        """The shard ``t`` with its write sink (itself without one)."""
        return self._raws.get(id(t), t)

    def unique(self) -> list:
        """(slices, tensor) of each distinct shard tensor."""
        if self._unique is None:
            seen, out = set(), []
            for coords in np.ndindex(*self.shards.shape):
                t = self.shards[coords]
                if id(t) not in seen:
                    seen.add(id(t))
                    out.append((self.sharding.index(coords, self.shape), t))
            self._unique = out
        return self._unique

    def blocks(self) -> list:
        """(slices, [tensors]) of each distinct block, in position order,
        with every distinct tensor that holds it (the copies of a
        replicated block on several devices)."""
        if self._blocks is None:
            out: dict = {}
            for slc, t in self.unique():
                key = tuple((s.start, s.stop) for s in slc)
                out.setdefault(key, (slc, []))[1].append(t)
            self._blocks = list(out.values())
        return self._blocks

    def parts(self, coords_fixed: dict, dim: int) -> list:
        """The blocks along ``dim`` seen from the positions whose
        coordinates match ``coords_fixed`` ({axis: index}): a list of
        (lo, hi, [tensors]) sorted by lo, one entry per distinct block
        with every distinct tensor that holds it."""
        key = (tuple(sorted(coords_fixed.items())), dim)
        if key in self._parts:
            return self._parts[key]
        names = self.mesh.axis_names
        blocks: dict = {}
        for coords in np.ndindex(*self.shards.shape):
            if any(coords[names.index(a)] != i
                   for a, i in coords_fixed.items()):
                continue
            s = self.sharding.index(coords, self.shape)[dim]
            ts = blocks.setdefault((s.start, s.stop), [])
            t = self.shards[coords]
            if all(t is not u for u in ts):
                ts.append(t)
        out = [(lo, hi, ts) for (lo, hi), ts in sorted(blocks.items())]
        self._parts[key] = out
        return out

    def full(self, device: torch.device | str | None = None
             ) -> torch.Tensor:
        """The gathered tensor on ``device`` (the first position's by
        default). When one shard holds everything, that shard itself
        (moved if it lives elsewhere)."""
        device = torch.device(device) if device is not None \
            else self.mesh.devices.flat[0]
        pieces = [(slc, ts[0]) for slc, ts in self.blocks()]
        if len(pieces) == 1:
            return pieces[0][1].to(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for slc, t in pieces:
            out[slc] = t.to(device)
        return out

    def cpu(self) -> torch.Tensor:
        return self.full("cpu")

    def copy_(self, src: torch.Tensor) -> "ShardedTensor":
        """Overwrite every shard in place with its block of ``src``."""
        for slc, t in self.unique():
            t.copy_(src[slc].to(t.device))
        return self

    def _row_targets(self, row: int):
        for slc, t in self.unique():
            s = slc[0]
            if s.start <= row < s.stop:
                yield row - s.start, t

    def __setitem__(self, key, value) -> None:
        """``x[row, ...] = value`` with an int ``row``: written into
        every shard that holds the row."""
        key = key if isinstance(key, tuple) else (key,)
        for r, t in self._row_targets(int(key[0])):
            t[(r,) + key[1:]] = value

    def __getitem__(self, key):
        key = key if isinstance(key, tuple) else (key,)
        r, t = next(self._row_targets(int(key[0])))
        return t[(r,) + key[1:]]

    def nbytes_per_device(self) -> int:
        """Bytes the first position holds."""
        t = self.shards.flat[0]
        return t.numel() * t.element_size()


# ------------------------------------------- weights as the model sees them
#: The dimension each weight's compute splits over "model" (exact mode:
#: column-parallel q/k/v/o/gate/up, the shared expert's gate/up and the
#: vocab); every other weight is used whole by each column.
_COLUMN_DIM = {"embed/tok": 0, "lm_head": -1, "q": -1, "k": -1, "v": -1,
               "q_bias": -1, "k_bias": -1, "v_bias": -1, "o": -1,
               "gate": -1, "up": -1, "shared_gate": -1, "shared_up": -1}

#: Weights a column computes over its KV heads' block, which need not be
#: the block that storage puts at the column when the KV heads do not
#: split over "model".
_KV_LEAVES = ("k", "v", "k_bias", "v_bias")

#: The MoE expert stacks: split over "data" (experts) by the serving
#: rule table and computed by their data shards (``MeshParams.experts``),
#: never by a column.
_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def batch_rows(mesh: Mesh, model_axis: str = "model") -> list:
    """The mesh's devices as [batch shard][column]: batch shard b is
    row-major over every axis but ``model_axis`` (the batch axes, as
    ``batch_spec`` splits the rows), column m its index on that axis."""
    grid = np.moveaxis(mesh.devices, mesh.axis_names.index(model_axis), -1)
    return grid.reshape(-1, grid.shape[-1]).tolist()


def column_coords(mesh: Mesh, m: int) -> tuple:
    """The mesh position that computes "model" column ``m``: the first
    of every other axis."""
    return tuple(m if a == "model" else 0 for a in mesh.axis_names)


def kv_heads_of_column(n_kv_heads: int, M: int, m: int) -> tuple:
    """The KV heads [lo, hi) column ``m`` of ``M`` reads: its query
    heads' groups (``h // G``). KV heads that split over the columns
    give each column its block; fewer KV heads than columns give each
    column the one head its query block reads, shared by ``M //
    n_kv_heads`` columns (MQA: every column reads head 0)."""
    if n_kv_heads % M == 0:
        w = n_kv_heads // M
        return m * w, (m + 1) * w
    j = m // (M // n_kv_heads)
    return j, j + 1


def mesh_unsupported(cfg: ModelConfig, model_size: int) -> list[str]:
    """Why the mesh data plane cannot serve ``cfg`` with ``model_size``
    columns (empty when it can)."""
    if cfg.family not in (Family.DENSE, Family.MOE):
        return [f"model family {cfg.family.name} on a mesh"]
    return _column_unsupported(cfg, model_size)


def _column_unsupported(cfg: ModelConfig, M: int) -> list[str]:
    """Why ``cfg``'s column compute cannot split over ``M`` columns."""
    out = []
    dims = [("n_heads", cfg.n_heads), ("d_model", cfg.d_model),
            ("d_ff", cfg.d_ff), ("vocab_size", cfg.vocab_size)]
    if cfg.family == Family.MOE:
        dims.append(("shared_expert_ff", cfg.shared_expert_ff))
    for name, n in dims:
        if n % M:
            out.append(f"{name}={n} on a {M}-way model axis (column "
                       f"compute needs even blocks; uneven column splits "
                       f"are not ported)")
    Kh = cfg.n_kv_heads
    if Kh % M and M % Kh:
        out.append(f"n_kv_heads={Kh} on a {M}-way model axis (a column's "
                   f"query heads would read parts of two KV groups)")
    return out


def _split_axes(st: ShardedTensor) -> set:
    return {a for e in st.sharding.spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}


class MeshParams:
    """Weights placed on a mesh (``placed``: {path: ShardedTensor}) and
    what each part of the mesh computes with:

    - ``cols[m]``: "model" column m's flat param dict on the column's
      device. Its column-parallel weights hold block m (q heads, o and
      gate/up output columns, the shared expert's gate/up, vocab
      rows/columns), k/v hold the KV heads its query heads read
      (``kv_heads[m]``), and the other weights are whole. A block that
      storage does not put at the column (replicated storage, or KV
      heads shared by several columns) is sliced or gathered once
      here.
    - ``experts``: each "data" shard's MoE experts, for MoE configs:
      its device, its expert range and its stacked ``w_gate``/``w_up``/
      ``w_down`` blocks (``moe/`` stacks (n_moe, E_d, ...)) and router.
      A shard's experts run on its device only.

    ``col_cfg`` is the config one column computes (n_heads/M and its
    KV heads)."""

    def __init__(self, cfg: ModelConfig, placed: dict, mesh: Mesh):
        M = mesh.shape["model"]
        bad = mesh_unsupported(cfg, M)
        if bad:
            raise NotImplementedError(
                "the mesh data plane does not serve: " + ", ".join(bad))
        self.cfg, self.placed, self.mesh = cfg, placed, mesh
        self.model_size = M
        self.coords = [column_coords(mesh, m) for m in range(M)]
        self.devices = [mesh.devices[c] for c in self.coords]
        self.home = self.devices[0]
        self.kv_heads = [kv_heads_of_column(cfg.n_kv_heads, M, m)
                         for m in range(M)]
        #: Columns that read one KV head (1 when the heads split).
        self.kv_share = (1 if cfg.n_kv_heads % M == 0
                         else M // cfg.n_kv_heads)
        lo, hi = self.kv_heads[0]
        self.col_cfg = dataclasses.replace(
            cfg, n_heads=cfg.n_heads // M, n_kv_heads=hi - lo)
        self.cols = [{path: self._column(path, st, m)
                      for path, st in placed.items()
                      if path.split("/")[-1] not in _EXPERT_LEAVES
                      or not path.startswith("moe/")}
                     for m in range(M)]
        self.experts = (expert_shards(placed)
                        if "moe/w_gate" in placed else None)

    def kv_range(self, m: int, width: int) -> tuple:
        """Column ``m``'s KV heads as a [lo, hi) range of a dimension of
        ``width`` = n_kv_heads * per-head entries."""
        lo, hi = self.kv_heads[m]
        per = width // self.cfg.n_kv_heads
        return lo * per, hi * per

    def _column(self, path: str, st: ShardedTensor, m: int):
        split = _split_axes(st) - {"model"}
        if split:
            raise NotImplementedError(
                f"{path} is split over {sorted(split)}: a column reads a "
                f"weight whole or over 'model', and no data shard's block "
                f"may stand for the others")
        leaf = path.split("/")[-1]
        dim = _COLUMN_DIM.get(path, _COLUMN_DIM.get(leaf))
        if leaf in _KV_LEAVES and self.kv_share > 1:
            lo, hi = self.kv_range(m, st.shape[-1])
            return column_range(st, self.coords[m], -1, lo, hi)
        if dim is None or self.model_size == 1:
            return st.local(self.coords[m])
        return column_block(st, self.coords[m], dim, m, self.model_size)

    def lora_cols(self, lora: dict) -> list:
        """Each column's LoRA slot arena: A whole, B's dout block m (for
        k/v: its KV heads' columns, gathered where the heads are shared
        by several columns)."""
        out = []
        for m, c in enumerate(self.coords):
            cols = {}
            for proj, (a, b) in lora.items():
                if proj in _KV_LEAVES and self.kv_share > 1:
                    lo, hi = self.kv_range(m, b.shape[-1])
                    bm = column_range(b, c, -1, lo, hi)
                else:
                    bm = column_block(b, c, -1, m, self.model_size)
                cols[proj] = (a.local(c), bm)
            out.append(cols)
        return out


def expert_shards(placed: dict) -> list:
    """Each "data" block of the MoE expert stacks (``moe/w_*``, experts
    on dim 1): a dict of its expert range (``lo``, ``hi``), ``device``
    and the stacked ``w_gate``/``w_up``/``w_down`` and the ``router``
    it computes with, all on that device (the shard at the first
    "model" column; a replicated stack is one block)."""
    parts = {leaf: placed["moe/" + leaf].parts({"model": 0}, 1)
             for leaf in _EXPERT_LEAVES}
    router = placed["moe/router"]
    out = []
    for i, (lo, hi, ts) in enumerate(parts["w_gate"]):
        dev = ts[0].device
        blk = {"lo": lo, "hi": hi, "device": dev}
        for leaf in _EXPERT_LEAVES:
            blk[leaf] = next(u for u in parts[leaf][i][2] if u.device == dev)
        blk["router"] = next(u for _, u in router.unique()
                             if u.device == dev)
        out.append(blk)
    return out


def column_range(st: ShardedTensor, coords: tuple, dim: int, lo: int,
                 hi: int) -> torch.Tensor:
    """Entries [lo, hi) of a weight along ``dim``, on the device of the
    position ``coords``: its shard when storage puts exactly that block
    there, a contiguous slice of it when storage is whole there, else
    the blocks of the positions that share ``coords`` off "model",
    gathered (counted in ``COLLECTIVE_METER``)."""
    local = st.local(coords)
    ndim = len(st.shape)
    dim %= ndim
    spec = list(st.sharding.spec) + [None] * (ndim - len(st.sharding.spec))
    if spec[dim] is None:
        if (lo, hi) == (0, st.shape[dim]):
            return local
        return local.narrow(dim, lo, hi - lo).contiguous()
    if spec[dim] != "model":
        raise NotImplementedError(
            f"a weight of shape {st.shape} is split over {spec[dim]!r} "
            f"along dim {dim}; column compute needs 'model' or nothing")
    own = st.sharding.index(coords, st.shape)[dim]
    if (own.start, own.stop) == (lo, hi):
        return local
    names = st.mesh.axis_names
    fixed = {a: coords[i] for i, a in enumerate(names) if a != "model"}
    pieces = []
    for blo, bhi, ts in st.parts(fixed, dim):
        a, b = max(lo, blo), min(hi, bhi)
        if a < b:
            t = next((u for u in ts if u.device == local.device), ts[0])
            pieces.append(t.narrow(dim, a - blo, b - a).to(local.device))
    if len(pieces) == 1:
        return pieces[0].contiguous()
    from repro_torch.kernels.ops import COLLECTIVE_METER
    with COLLECTIVE_METER.sync():
        COLLECTIVE_METER.gathers += 1
        return torch.cat(pieces, dim=dim)


def column_block(st: ShardedTensor, coords: tuple, dim: int, m: int,
                 M: int) -> torch.Tensor:
    """Column ``m``'s block of a weight along ``dim``: the shard at
    ``coords`` when storage splits that dimension over "model", else a
    contiguous slice of the whole shard (replicated storage)."""
    w = st.shape[dim] // M
    return column_range(st, coords, dim, m * w, (m + 1) * w)


# ------------------------------------------------ a train state on a mesh
# The train rule table (``param_shardings(kind="train")``) splits every
# weight's non-"model" dimension over the batch axes (FSDP) on top of
# its "model" split, and ``opt_shardings`` puts the AdamW moments where
# their parameter is. A position computes with the block its column
# needs, gathered whole over the batch axes (``all_gather``); the
# gradients of those blocks go back to each shard's owner summed over
# the positions that computed with them (``reduce_scatter``). Both run
# in position order, so a step's result does not depend on the order
# in which autograd delivers the gradients.

def device_put(tree: dict, shardings: dict) -> dict:
    """``jax.device_put(tree, shardings)`` for a flat tree: each leaf
    with a sharding becomes a ``ShardedTensor`` whose blocks are fresh
    tensors (the train step updates them in place, so none may alias
    the caller's tensor); a leaf without one is kept as it is."""
    return {k: shardings[k].shard(v, copy=True) if k in shardings else v
            for k, v in tree.items()}


def _box(index: tuple, shape: tuple) -> list:
    """``index`` (a slice or an int per leading dimension) as one slice
    per dimension of ``shape``."""
    index = tuple(index) + (slice(None),) * (len(shape) - len(index))
    return [slice(i, i + 1) if isinstance(i, int)
            else slice(*i.indices(n)[:2]) for i, n in zip(index, shape)]


def _overlap(box: list, slc: tuple):
    """(entries of the block ``slc`` local to it, the same entries local
    to ``box``) where they overlap, or None."""
    lo = [max(a.start, b.start) for a, b in zip(box, slc)]
    hi = [min(a.stop, b.stop) for a, b in zip(box, slc)]
    if any(a >= b for a, b in zip(lo, hi)):
        return None
    return (tuple(slice(a - s.start, b - s.start)
                  for a, b, s in zip(lo, hi, slc)),
            tuple(slice(a - s.start, b - s.start)
                  for a, b, s in zip(lo, hi, box)))


def all_gather(st: ShardedTensor, index: tuple, device) -> torch.Tensor:
    """Entries ``index`` of ``st`` (a slice or an int per leading
    dimension; an int drops its dimension) on ``device``, assembled from
    the distinct blocks that hold them, each read from its copy on
    ``device`` where there is one. When one block on ``device`` holds
    them all, a view of it (no copy); else a fresh tensor (counted in
    ``COLLECTIVE_METER.gathers``)."""
    box = _box(index, st.shape)
    shape = [s.stop - s.start for s in box]
    keep = [n for n, i in zip(shape, tuple(index) + (None,) * len(shape))
            if not isinstance(i, int)]
    pieces = []
    for slc, ts in st.blocks():
        ov = _overlap(box, slc)
        if ov is not None:
            t = next((u for u in ts if u.device == device), ts[0])
            pieces.append((ov[1], t[ov[0]]))
    if len(pieces) == 1 and pieces[0][1].device == device:
        return pieces[0][1].reshape(keep)
    from repro_torch.kernels.ops import COLLECTIVE_METER
    with COLLECTIVE_METER.sync():
        COLLECTIVE_METER.gathers += 1
        out = torch.empty(shape, dtype=st.dtype, device=device)
        for dest, piece in pieces:
            out[dest] = piece.to(device)
    return out.reshape(keep)


def reduce_scatter(out: ShardedTensor, parts: list) -> None:
    """Add to each distinct block of ``out`` the sum of the gradients
    ``parts`` hold of it: ``parts`` are (index, gradient) of the
    positions that computed with entries ``index`` (``all_gather``'s)
    of the leaf, in position order, and the sum runs in that order on
    the block's first copy, then goes to its other copies (counted in
    ``COLLECTIVE_METER.reduces``)."""
    from repro_torch.kernels.ops import COLLECTIVE_METER
    boxes = [(_box(i, out.shape), g) for i, g in parts]
    with COLLECTIVE_METER.sync():
        COLLECTIVE_METER.reduces += 1
        for slc, ts in out.blocks():
            acc, done = ts[0], []
            for box, g in boxes:
                ov = _overlap(box, slc)
                if ov is None:
                    continue
                g = g.reshape([s.stop - s.start for s in box])
                acc[ov[0]] += g[ov[1]].to(acc.device, acc.dtype)
                done.append(ov[0])
            for t in ts[1:]:
                for local in done:
                    t[local] = acc[local].to(t.device)


#: The dimension each weight's compute splits over "model" in training:
#: the serving table's column-parallel weights, with o, down and the
#: shared expert's down row-parallel (each column takes a block of their
#: input rows, and their products are partial sums over the columns).
#: The SSM leaves split d_inner (Mamba1 channels, Mamba2 heads):
#: ``x_proj`` and ``out_proj`` by rows, ``dt_proj`` and the Mamba1 conv
#: by columns, the per-channel or per-head vectors on their dimension 1
#: (after the layer axis), whatever storage does with them. Cross
#: attention (enc-dec) splits its heads as self-attention does.
_TRAIN_COLUMN_DIM = {**_COLUMN_DIM, "o": -2, "down": -2, "shared_down": -2,
                     "out_proj": -2, "x_proj": -2, "dt_proj": -1,
                     "conv_w": -1, "conv_b": -1, "A_log": 1, "ssm_D": 1,
                     "dt_bias": 1, "gate_norm": 1, "xq": -1, "xo": -2}

#: Weights a training column computes over its KV heads' block.
_TRAIN_KV_LEAVES = _KV_LEAVES + ("xk", "xv")

#: The expert stacks' hidden dimension, split over "model" in training
#: (``w_gate``/``w_up`` by columns, ``w_down`` by rows).
_EXPERT_HIDDEN_DIM = {"w_gate": -1, "w_up": -1, "w_down": -2}


def ssm_segments(cfg: ModelConfig, leaf: str) -> list | None:
    """The segments (offset, width, split) of an SSM leaf whose last
    dimension packs several tensors, or None: Mamba1's ``in_proj`` is
    [x | z], Mamba2's [z | x | B | C | dt] and its conv [x | B | C].
    A split segment (channels or heads) divides over the columns; B
    and C (one group) are whole on every column."""
    Di, N = cfg.d_inner, cfg.d_state
    if cfg.ssm_version == 1 and leaf == "in_proj":
        return [(0, Di, True), (Di, Di, True)]
    if cfg.ssm_version == 2:
        if leaf == "in_proj":
            return [(0, Di, True), (Di, Di, True), (2 * Di, 2 * N, False),
                    (2 * Di + 2 * N, cfg.n_ssm_heads, True)]
        if leaf in ("conv_w", "conv_b"):
            return [(0, Di, True), (Di, 2 * N, False)]
    return None


def column_segments(segments: list, m: int, M: int) -> list:
    """Column ``m``'s ranges [lo, hi) of a packed dimension: its block of
    each split segment, each whole one, adjacent ranges merged (one
    column: the whole dimension)."""
    out = []
    for off, w, split in segments:
        lo, hi = ((off + m * w // M, off + (m + 1) * w // M) if split
                  else (off, off + w))
        if out and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def train_unsupported(cfg: ModelConfig, mesh: Mesh) -> list[str]:
    """Why a train step cannot run ``cfg`` on ``mesh`` (empty when it
    can): a head, channel or hidden count the "model" axis does not
    divide, or MoE experts the "data" axis does not divide. A vocabulary
    that "model" does not divide stays whole on every column."""
    M, n_data = mesh.shape["model"], mesh.shape["data"]
    out = [r for r in _column_unsupported(cfg, M)
           if not r.startswith("vocab_size=")]
    dims = []
    if cfg.ssm_version:
        dims.append(("d_inner", cfg.d_inner, M, "model"))
        if cfg.ssm_version == 2:
            dims.append(("n_ssm_heads", cfg.n_ssm_heads, M, "model"))
    if cfg.family == Family.MOE:
        dims += [("n_experts", cfg.n_experts, n_data, "data"),
                 ("d_ff_expert", cfg.d_ff_expert, M, "model")]
    for name, n, k, axis in dims:
        if n % k:
            out.append(f"{name}={n} on a {k}-way {axis} axis (the "
                       f"train rule table would replicate it; uneven "
                       f"splits are not ported: ROADMAP Queue 1)")
    return out


class TrainView:
    """A placed train state ({path: ShardedTensor} under the train rule
    table) as the model computes with it. Position (b, m) is batch
    shard b and column m (``batch_rows``); it computes the column config
    ``col_cfg`` over its batch rows with each weight's column block
    gathered over the batch axes (``view``): q/k/v/gate/up/biases, the
    shared expert's gate/up and the vocabulary (``embed/tok`` rows,
    ``lm_head`` columns) split over "model", o, down and shared_down by
    input rows, k/v over the KV heads its query heads read
    (``kv_heads_of_column``), norms and the router whole. A vocabulary
    that "model" does not divide (the rule table leaves it unsplit,
    ``whole_vocab``) is whole on every column. MoE experts: position
    (b, m) also runs expert block ``b % n_data`` (its "data"
    coordinate) with column m's block of their hidden, D gathered over
    "pod", for the batch shards of its pod (``b // n_data``). SSM
    leaves: column m's block of d_inner (``_TRAIN_COLUMN_DIM``), a
    packed leaf one segment at a time (``ssm_segments``). Cross
    attention: heads as self-attention's, from replicated leaves."""

    def __init__(self, cfg: ModelConfig, placed: dict):
        mesh = next(iter(placed.values())).mesh
        bad = train_unsupported(cfg, mesh)
        if bad:
            raise NotImplementedError(
                "the mesh train step does not run: " + ", ".join(bad))
        self.cfg, self.placed, self.mesh = cfg, placed, mesh
        self.M = M = mesh.shape["model"]
        self.n_data = mesh.shape["data"]
        self.batch_axes = tuple(a for a in mesh.axis_names if a != "model")
        self.rows = batch_rows(mesh)
        self.n_batch = len(self.rows)
        self.kv_heads = [kv_heads_of_column(cfg.n_kv_heads, M, m)
                         for m in range(M)]
        lo, hi = self.kv_heads[0]
        self.col_cfg = dataclasses.replace(
            cfg, n_heads=cfg.n_heads // M, n_kv_heads=hi - lo)
        self.whole_vocab = cfg.vocab_size % M != 0
        self.home = mesh.devices.flat[0]

    def boxes(self, path: str, m: int, layer: int | None = None,
              b: int = 0) -> list:
        """The entries of leaf ``path`` position (``b``, ``m``) computes
        with (of layer ``layer`` for a stacked leaf): one index (a slice
        or an int per dimension), or one a range of a packed leaf's last
        dimension, in order."""
        shape = self.placed[path].shape
        leaf = path.split("/")[-1]
        out = [slice(None)] * len(shape)
        if layer is not None:
            out[0] = layer
        if path in ("embed/tok", "lm_head") and self.whole_vocab:
            return [tuple(out)]
        segs = ssm_segments(self.cfg, leaf)
        if segs is not None:
            return [tuple(out[:-1]) + (slice(lo, hi),)
                    for lo, hi in column_segments(segs, m, self.M)]
        dim = _TRAIN_COLUMN_DIM.get(path, _TRAIN_COLUMN_DIM.get(leaf))
        if path.startswith("moe/") and leaf in _EXPERT_HIDDEN_DIM:
            d, e = b % self.n_data, shape[1] // self.n_data
            out[1] = slice(d * e, (d + 1) * e)
            dim = _EXPERT_HIDDEN_DIM[leaf]
        if leaf in _TRAIN_KV_LEAVES:
            lo, hi = self.kv_heads[m]
            per = shape[-1] // self.cfg.n_kv_heads
            out[-1] = slice(lo * per, hi * per)
        elif dim is not None:
            w = shape[dim] // self.M
            out[dim] = slice(m * w, (m + 1) * w)
        return [tuple(out)]

    def view(self, path: str, b: int, m: int, layer: int | None = None
             ) -> torch.Tensor:
        """Position (b, m)'s block of ``path`` on its device: through the
        recording ``FsdpStep`` when one is active (its gradient then
        reaches the shards' owners), else a plain ``all_gather``; a
        packed leaf's ranges concatenated on its last dimension."""
        st, dev = self.placed[path], self.rows[b][m]
        parts = [_STEP.gather(path, st, i, dev) if _STEP is not None
                 else all_gather(st, i, dev)
                 for i in self.boxes(path, m, layer, b)]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)

    def layer(self, i: int | None, b: int, m: int, leaves,
              prefix: str = "layers/") -> dict:
        return {leaf: self.view(prefix + leaf, b, m, i)
                for leaf in leaves if prefix + leaf in self.placed}


_STEP = None           # the recording FsdpStep, if any


def _address(t: torch.Tensor) -> tuple:
    """Where ``t``'s memory lives: its device and storage address."""
    return t.device, t.untyped_storage().data_ptr()


class _Gathered(torch.autograd.Function):
    """A position's gathered block as a node of the graph: its gradient
    goes to the step's sink (``FsdpStep._deposit``), not to a tensor."""

    @staticmethod
    def forward(ctx, anchor, step, key, seq, st, index, device):
        ctx.args = (step, key, seq, index)
        w = all_gather(st, index, device)
        # A fresh alias: autograd must not mark the shard itself.
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        step, key, seq, index = ctx.args
        step._deposit(key, seq, index, g)
        return (torch.zeros(0),) + (None,) * 6


class FsdpStep:
    """The gradient flow of one forward-backward over a placed state.

    While ``recording()``, every block a position gathers
    (``TrainView.view``) is a node of the graph whose gradient comes
    back to ``_deposit``. Once every position that gathered a leaf's
    layer has delivered its gradient, those gradients are reduce-
    scattered in position order into ``grads`` (a ShardedTensor a leaf,
    the parameter's sharding), so a layer's gradients live only until
    its last position is done. A gathered copy is not kept for the
    backward: autograd saves a handle to it (``saved_tensors_hooks``),
    and the backward gathers it again, as FSDP frees a layer after its
    forward. Gradients reach the graph's one leaf, ``anchor``:
    differentiate the loss with respect to it, then ``finish()``."""

    def __init__(self, placed: dict, grads: dict):
        self.placed, self.grads = placed, grads
        self.anchor = torch.zeros(0, requires_grad=True)
        self._want: dict = {}
        self._got: dict = {}
        self._seq = 0
        self._lock = threading.Lock()
        self._saved: dict = {}     # storage address -> (st, index, device)
        self._own = {_address(t) for st in placed.values()
                     for _, t in st.unique()}

    @contextlib.contextmanager
    def recording(self):
        global _STEP
        prev, _STEP = _STEP, self
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                          self._unpack):
                yield self
        finally:
            _STEP = prev

    def gather(self, path: str, st: ShardedTensor, index: tuple, device
               ) -> torch.Tensor:
        key = (path, index[0] if isinstance(index[0], int) else None)
        self._want[key] = self._want.get(key, 0) + 1
        self._seq += 1
        out = _Gathered.apply(self.anchor, self, key, self._seq, st, index,
                              device)
        ptr = _address(out)
        if ptr not in self._own:
            self._saved[ptr] = (st, index, device)
            weakref.finalize(out, self._saved.pop, ptr, None)
        return out

    def _pack(self, t: torch.Tensor):
        rec = self._saved.get(_address(t))
        if rec is None:
            return t
        return rec, tuple(t.shape), t.stride(), t.storage_offset()

    @staticmethod
    def _unpack(x):
        if isinstance(x, torch.Tensor):
            return x
        (st, index, device), shape, stride, offset = x
        return all_gather(st, index, device).as_strided(shape, stride, offset)

    def _deposit(self, key, seq: int, index: tuple, g) -> None:
        with self._lock:
            got = self._got.setdefault(key, [])
            got.append((seq, index, g))
            if len(got) == self._want[key]:
                self._reduce(key)

    def _reduce(self, key) -> None:
        got = sorted(self._got.pop(key), key=lambda e: e[0])
        reduce_scatter(self.grads[key[0]], [(i, g) for _, i, g in got])

    def finish(self) -> None:
        """Reduce what arrived for layers some of whose positions sent
        no gradient (a block that did not reach the loss: zero)."""
        with self._lock:
            for key in list(self._got):
                self._reduce(key)
