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
view, the operand the model functions take on a mesh.
"""
from __future__ import annotations

import dataclasses
import warnings

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
                    f"spec {self.spec} splits dim {dim} of {tuple(shape)} "
                    f"into {n} uneven blocks; pass it through fit_spec")
            step = dim // n
            out.append(slice(b * step, (b + 1) * step))
        return tuple(out)

    def shard(self, x: torch.Tensor) -> "ShardedTensor":
        """Split ``x`` onto the mesh: each position gets its block,
        contiguous, on its device. Positions that hold the same block on
        the same device share one tensor (a block that already is ``x``
        on that device is ``x`` itself, no copy)."""
        shards = np.empty(self.mesh.devices.shape, dtype=object)
        made: dict = {}
        for coords in np.ndindex(*self.mesh.devices.shape):
            dev = self.mesh.devices[coords]
            slc = self.index(coords, tuple(x.shape))
            key = (tuple((s.start, s.stop) for s in slc), str(dev))
            if key not in made:
                made[key] = x[slc].to(dev).contiguous()
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
        pieces, done = [], set()
        for slc, t in self.unique():
            key = tuple((s.start, s.stop) for s in slc)
            if key not in done:
                done.add(key)
                pieces.append((slc, t))
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
#: column-parallel q/k/v/o/gate/up and the vocab); every other weight
#: is used whole by each column.
_COLUMN_DIM = {"embed/tok": 0, "lm_head": -1, "q": -1, "k": -1, "v": -1,
               "q_bias": -1, "k_bias": -1, "v_bias": -1, "o": -1,
               "gate": -1, "up": -1}


def column_coords(mesh: Mesh, m: int) -> tuple:
    """The mesh position that computes "model" column ``m``: the first
    of every other axis."""
    return tuple(m if a == "model" else 0 for a in mesh.axis_names)


def mesh_unsupported(cfg: ModelConfig, model_size: int) -> list[str]:
    """Why the mesh data plane cannot serve ``cfg`` with ``model_size``
    columns (empty when it can)."""
    out = []
    if cfg.family != Family.DENSE:
        out.append(f"model family {cfg.family.name} on a mesh"
                   + (" (the MoE step functions on MeshParams, experts "
                      "over \"data\" under exact_reductions=True, are "
                      "not ported yet)"
                      if cfg.family == Family.MOE else ""))
        return out
    for name, n in (("n_heads", cfg.n_heads),
                    ("n_kv_heads", cfg.n_kv_heads),
                    ("d_model", cfg.d_model), ("d_ff", cfg.d_ff),
                    ("vocab_size", cfg.vocab_size)):
        if n % model_size:
            out.append(f"{name}={n} on a {model_size}-way model axis "
                       f"(column compute needs even blocks)")
    return out


class MeshParams:
    """Weights placed on a mesh (``placed``: {path: ShardedTensor}) and
    each "model" column's compute view: ``cols[m]`` is a flat param dict
    on the column's device whose column-parallel weights hold block m
    (q/k/v heads, o and gate/up output columns, vocab rows/columns) and
    whose other weights are whole. ``col_cfg`` is the config one column
    computes (n_heads/M, n_kv_heads/M). A weight whose storage is
    replicated (a bias) is sliced once here."""

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
        self.col_cfg = dataclasses.replace(
            cfg, n_heads=cfg.n_heads // M, n_kv_heads=cfg.n_kv_heads // M)
        self.cols = [{path: self._column(path, st, m)
                      for path, st in placed.items()} for m in range(M)]

    def _column(self, path: str, st: ShardedTensor, m: int):
        dim = _COLUMN_DIM.get(path, _COLUMN_DIM.get(path.split("/")[-1]))
        if dim is None or self.model_size == 1:
            return st.local(self.coords[m])
        return column_block(st, self.coords[m], dim, m, self.model_size)

    def lora_cols(self, lora: dict) -> list:
        """Each column's LoRA slot arena: A whole, B's dout block m."""
        out = []
        for m, c in enumerate(self.coords):
            out.append({
                proj: (a.local(c),
                       column_block(b, c, -1, m, self.model_size))
                for proj, (a, b) in lora.items()})
        return out


def column_block(st: ShardedTensor, coords: tuple, dim: int, m: int,
                 M: int) -> torch.Tensor:
    """Column ``m``'s block of a weight along ``dim``: the shard at
    ``coords`` when storage splits that dimension over "model", else a
    contiguous slice of the whole shard (replicated storage)."""
    local = st.local(coords)
    ndim = len(st.shape)
    dim %= ndim
    spec = list(st.sharding.spec) + [None] * (ndim - len(st.sharding.spec))
    if spec[dim] == "model":
        return local
    if spec[dim] is not None:
        raise NotImplementedError(
            f"a weight of shape {st.shape} is split over {spec[dim]!r} "
            f"along dim {dim}; column compute needs 'model' or nothing")
    w = st.shape[dim] // M
    return local.narrow(dim, m * w, w).contiguous()
