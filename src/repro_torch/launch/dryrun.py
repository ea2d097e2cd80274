"""Multi-pod dry-run: what one step of each cell costs each mesh position.

Port of ``src/repro/launch/dryrun.py``. For every assigned (architecture
× input shape) cell, build the step (train step, prefill or serve
decode) on the production meshes, 16×16 and 2×16×16, and record what
each position computes, reads and writes, and what the collectives
carry.

The reference lowers and compiles the step with XLA and reads
``cost_analysis()``, ``memory_analysis()`` and the partitioned HLO.
Torch compiles nothing ahead of time, so the port runs the step itself
on tensors without storage: every mesh position is a ``meta:i``
device, and the case (``cases.build_case``, placed by ``cases.place``)
runs under ``FakeTensorMode``, which carries each tensor's position.
No JAX, no XLA flags and no device: a CPU-only machine runs it.

- ``cost``: ``flops`` are the products' operations (the
  ``torch.utils.flop_counter`` formulas for matmuls, and the kernels'
  own counts through their meta ops, ``kernels/meta.py``);
  ``bytes_accessed`` is each op's operand plus result bytes, views
  excluded: the pre-fusion definition of XLA's ``bytes accessed``.
  Each op counts on the position of its first output (queries that
  return no tensor count nothing; work outside any position, on an
  unindexed device, counts on the mesh's first). A device index has 8
  bits, so past 128 positions (the production meshes) the positions
  i and i + 128 share ``meta:i``: rows r and r + 8 of "data" and the
  two pods, which compute the same shapes (``meta_mesh``; the first
  position, which also takes the work outside any position, keeps its
  index alone). A shared index's counts are divided by the positions
  that share it (their mean); the sums over positions are exact, and
  bytes copied between positions that share an index do not count as
  moved. The record holds the busiest position's counts, as
  ``cost_analysis()`` is per device, and the sums over positions beside
  them (``flops_sum``, ``bytes_accessed_sum``).
- ``memory``: ``argument_size_in_bytes`` is the busiest position's
  shards of the arguments under the rule table (the case's
  ``NamedSharding``s); ``output_size_in_bytes`` the busiest position's
  outputs that are not its arguments updated in place
  (``alias_size_in_bytes``: the trained params and moments, the decode's
  slab). Train cells add ``saved_bytes``: the busiest position's
  storage that autograd keeps for the backward (``sharding.
  saved_probe``). ``temp_size_in_bytes`` and
  ``generated_code_size_in_bytes`` are null: no compiler plans a
  buffer or emits code (``null_reason``).
- ``collectives``: the busiest position's record of the gather points
  (``roofline/hlo_stats.py``) with ``total_bytes_scaled``, and the
  mesh-wide record (each collective once) as ``collectives_mesh``.

The step runs in the reference's scope: the batch axes installed,
``seq_shard_boundary`` on train cells, and on serving cells token-
parallel MoE and exact reductions (the port's serving data plane).
There is no donation: the train step and the decode update their
buffers in place.

Depth: one Python process steps through every position of every
layer, so a full-depth cell at 16×16 is long (an hour of CPU and more
for a train cell). The layers of a stack are alike, so each count is
affine in the number of stack units (layers; MoE supersteps of
``moe_every`` layers; hybrid periods of ``attn_every``; an enc-dec
encoder-and-decoder layer pair): ``--depth fit`` (the default) counts
the cell cut to 1 and to 2 units and extends the line to the config's
units, position by position (exact for identical units; tests hold it
to a full count), and ``--depth full`` counts every layer. The record
says which (``depth``), and ``count_s`` the CPU seconds.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch qwen3-14b] [--shape decode_32k] [--mesh single|multi|both]
        [--depth fit|full] [--out results/torch_dryrun.json]
Results append cell by cell, so a cut sweep resumes.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import warnings
from collections import defaultdict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (SHAPE_BY_NAME, assigned_cells,
                                 cell_applicable, get_config)
from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed import sharding as shp
from repro_torch.launch import cases
from repro_torch.launch.mesh import Mesh
from repro_torch.models.base import Family, ModelConfig
from repro_torch.roofline import hlo_stats

NULL_REASON = ("torch compiles nothing ahead of time: no compiler plans "
               "temporary buffers or emits code")

#: Ops that touch no memory (metadata, fresh allocations).
_NO_BYTES = {torch.ops.aten.empty.memory_format,
             torch.ops.aten.empty_strided.default,
             torch.ops.aten.new_empty.default,
             torch.ops.aten.new_empty_strided.default,
             torch.ops.aten.empty_like.default,
             torch.ops.aten.detach.default,
             torch.ops.aten.lift_fresh.default}


#: Distinct ``meta:i`` devices: c10's device index is 8 bits.
MAX_INDEX = 128


def _is_view(func) -> bool:
    """Whether an op returns a view of an input (moves no data)."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def meta_mesh(shape: tuple, axes: tuple) -> Mesh:
    """A mesh whose position i (row-major) is the device ``meta:i``.
    Past ``MAX_INDEX`` positions i takes index i modulo ``MAX_INDEX``
    (on the production meshes rows r and r + 8 of "data", and the two
    pods, share a device: ``share``), except that the mesh's first
    position keeps index 0 to itself: the positions that would share it
    take the index of the second row's first column."""
    n = int(np.prod(shape))
    idx = [i % MAX_INDEX for i in range(n)]
    idx = [shape[-1] if i and j == 0 else j for i, j in enumerate(idx)]
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device("meta", j) for j in idx]
    return Mesh(grid.reshape(shape), axes)


def share(mesh: Mesh) -> dict:
    """{device index: how many positions share it}."""
    out: dict = defaultdict(int)
    for d in mesh.devices.flat:
        out[d.index] += 1
    return dict(out)


def production_mesh(multi_pod: bool) -> Mesh:
    """The reference's production mesh, over ``meta`` positions."""
    if multi_pod:
        return meta_mesh((2, 16, 16), ("pod", "data", "model"))
    return meta_mesh((16, 16), ("data", "model"))


def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(n) for n in mesh.shape.values())


class OpCounter(TorchDispatchMode):
    """Per-position operation and byte counts of the ops run inside it
    (``cost`` of the module docstring). Enter it inside a
    ``FakeTensorMode`` whose devices name the positions."""

    def __init__(self) -> None:
        super().__init__()
        self.flops: dict = defaultdict(float)
        self.bytes: dict = defaultdict(float)
        self.by_op: dict = defaultdict(float)     # flops, mesh-wide

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in flop_registry and \
                func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if func in _NO_BYTES or _is_view(func):
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs:               # a query (device, sizes): no data
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        p = hlo_stats.position(outs[0].device)
        self.bytes[p] += sum(map(hlo_stats.nbytes, ins + outs))
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops[p] += f
            self.by_op[str(packet)] += f
        return out


@dataclasses.dataclass
class Counts:
    """One run's per-position counts ({position: value}) and records."""
    flops: dict
    bytes: dict
    saved: dict
    boundary: dict             # the saved bytes that are remat inputs
    coll: dict                 # position -> hlo_stats record
    coll_mesh: dict            # the mesh-wide record
    by_op: dict
    outputs: dict              # position -> bytes
    alias: dict                # position -> bytes
    seconds: float


def _leaves(tree):
    """The tensors of an output tree (dicts, tuples, lists,
    ``ShardedTensor``s)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, shp.ShardedTensor):
        for _, t in tree.unique():
            yield t
    elif isinstance(tree, torch.Tensor):
        yield tree


def _per_position_bytes(tensors, skip: set = frozenset()) -> dict:
    """{position: bytes} of distinct storages (``skip``: addresses left
    out)."""
    seen, out = set(), defaultdict(float)
    for t in tensors:
        a = shp._address(t)
        if a in seen or a in skip:
            continue
        seen.add(a)
        out[hlo_stats.position(t.device)] += hlo_stats.nbytes(t)
    return out


def argument_bytes(args, shardings, mesh: Mesh) -> float:
    """A position's shards of ``args`` under ``shardings`` (the rule
    table), in bytes: the same at every position, since a sharded
    dimension splits into even blocks."""
    first = (0,) * len(mesh.axis_names)
    total = 0
    for t, sh in zip(_walk(args), _walk(shardings)):
        if isinstance(t, torch.Tensor):
            n = 1
            for s in sh.index(first, tuple(t.shape)):
                n *= s.stop - s.start
            total += n * t.element_size()
    return float(total)


def _walk(tree):
    """The leaves of a case's argument or sharding tree, in order (an
    empty tuple is a leaf: "no LoRA")."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _walk(v)
    elif isinstance(tree, tuple) and len(tree):
        for v in tree:
            yield from _walk(v)
    else:
        yield tree


def scope(mesh: Mesh, kind: str, seq_shard: bool | None = None):
    """The reference dry-run's activation scope: batch rows over every
    axis but "model"; sequence-parallel boundaries on train cells
    (``seq_shard`` True or False overrides); token-parallel MoE and
    exact reductions on serving cells."""
    axes = tuple(a for a in mesh.axis_names if a != "model")
    seq = kind == "train" if seq_shard is None else seq_shard
    return acts.activation_sharding(
        axes, mesh=mesh, seq_shard_boundary=seq,
        moe_token_parallel=kind != "train",
        exact_reductions=kind != "train")


@contextlib.contextmanager
def fake_mode():
    """``FakeTensorMode`` with the data-pointer warning of the placement
    code's aliasing tests silenced (a meta tensor has no data)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*data pointer.*")
        warnings.filterwarnings("ignore", message="fit_spec")
        with FakeTensorMode():
            yield


def count_case(arch: str, shape_name: str, mesh: Mesh, cfg: ModelConfig,
               seq_override: int | None = None,
               batch_override: int | None = None,
               seq_shard: bool | None = None) -> Counts:
    """Run the cell's step once on ``mesh`` (``meta`` positions) in
    ``scope`` and count it."""
    from repro_torch.models import moe
    kind = SHAPE_BY_NAME[shape_name].kind
    with fake_mode():
        fn, args, sh = cases.build_case(arch, shape_name, mesh,
                                        batch_override, config=cfg,
                                        seq_override=seq_override)
        placed = cases.place(cfg, kind, args, sh)
        ins = {shp._address(t) for t in _leaves(placed)}
        counter = OpCounter()
        t0 = time.process_time()
        grad = torch.enable_grad() if kind == "train" else torch.no_grad()
        with scope(mesh, kind, seq_shard), hlo_stats.recording() as rec, \
                shp.saved_probe() as saved, grad, counter:
            out = fn(*placed)
        seconds = time.process_time() - t0
        outs = list(_leaves(out))
        alias = {a for a in (shp._address(t) for t in outs) if a in ins}
        outputs = _per_position_bytes(outs, skip=alias)
        aliased = _per_position_bytes(
            [t for t in outs if shp._address(t) in alias])
    moe.STATS.reset()
    return Counts(
        flops=dict(counter.flops), bytes=dict(counter.bytes),
        saved=saved.per_position(saved.kept),
        boundary=saved.per_position(saved.boundary),
        coll={p: r.record() for p, r in rec.positions.items()},
        coll_mesh=rec.record(), by_op=dict(counter.by_op),
        outputs=dict(outputs), alias=dict(aliased), seconds=seconds)


# --------------------------------------------------------------- depth
def units(cfg: ModelConfig) -> int:
    """The stack units of ``cfg``: what ``--depth fit`` extends over."""
    if cfg.family == Family.MOE:
        return cfg.n_layers // cfg.moe_every
    if cfg.family == Family.HYBRID:
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def cut(cfg: ModelConfig, k: int) -> ModelConfig:
    """``cfg`` cut to ``k`` stack units (the hybrid keeps its tail
    layers; an enc-dec cuts encoder and decoder alike)."""
    if cfg.family == Family.MOE:
        return dataclasses.replace(cfg, n_layers=k * cfg.moe_every)
    if cfg.family == Family.HYBRID:
        return dataclasses.replace(
            cfg, n_layers=k * cfg.attn_every + cfg.n_layers % cfg.attn_every)
    if cfg.family == Family.ENCDEC:
        if cfg.n_layers != cfg.n_enc_layers:
            raise NotImplementedError(
                "--depth fit needs as many encoder as decoder layers")
        return dataclasses.replace(cfg, n_layers=k, n_enc_layers=k)
    return dataclasses.replace(cfg, n_layers=k)


def _line(a, b, n: int):
    """The value at ``n`` units of the line through ``a`` (1 unit) and
    ``b`` (2 units): dicts key by key (a missing key is 0)."""
    if isinstance(a, dict) or isinstance(b, dict):
        a, b = a or {}, b or {}
        return {k: _line(a.get(k, 0), b.get(k, 0), n)
                for k in sorted(set(a) | set(b), key=str)}
    return a + (n - 1) * (b - a)


def extend(c1: Counts, c2: Counts, n: int) -> Counts:
    """The counts of ``n`` units from those of 1 and 2."""
    fields = {f.name: _line(getattr(c1, f.name), getattr(c2, f.name), n)
              for f in dataclasses.fields(Counts) if f.name != "seconds"}
    return Counts(seconds=c1.seconds + c2.seconds, **fields)


# ---------------------------------------------------------------- cells
def _per_position(d: dict, shared: dict) -> dict:
    """Per-device-index values as one position's: each divided by the
    positions that share its index (records field by field)."""
    def div(v, n):
        if isinstance(v, dict):
            return {k: div(x, n) for k, x in v.items()}
        return v / n
    return {p: div(v, shared.get(p, 1)) for p, v in d.items()}


def _busiest(d: dict) -> tuple[int, float]:
    if not d:
        return 0, 0.0
    p = max(sorted(d), key=lambda i: d[i])
    return p, d[p]


def count_cell(arch: str, shape_name: str, mesh: Mesh, *,
               config: ModelConfig | None = None,
               seq_override: int | None = None,
               batch_override: int | None = None,
               depth: str = "fit", seq_shard: bool | None = None) -> dict:
    """The dry-run record of (``arch``, ``shape_name``) on ``mesh``
    (``config``, ``seq_override`` and ``batch_override`` stand in for the
    published config, sequence and batch; ``seq_shard`` for the
    reference's sequence-parallel boundary on train cells)."""
    cfg = config or get_config(arch)
    n = units(cfg)
    t0 = time.process_time()
    if depth == "fit" and n > 2:
        c1, c2 = (count_case(arch, shape_name, mesh, cut(cfg, k),
                             seq_override, batch_override, seq_shard)
                  for k in (1, 2))
        c = extend(c1, c2, n)
        how = {"method": "fit", "units": n, "counted_units": [1, 2]}
    elif depth in ("fit", "full"):
        c = count_case(arch, shape_name, mesh, cfg, seq_override,
                       batch_override, seq_shard)
        how = {"method": "full", "units": n, "counted_units": [n]}
    else:
        raise ValueError(f"depth must be 'fit' or 'full', got {depth!r}")
    kind = SHAPE_BY_NAME[shape_name].kind
    with fake_mode():
        _, args, sh = cases.build_case(arch, shape_name, mesh,
                                       batch_override, config=cfg,
                                       seq_override=seq_override)
        arg_bytes = argument_bytes(args, sh, mesh)
    sums = {"flops_sum": float(sum(c.flops.values())),
            "bytes_accessed_sum": float(sum(c.bytes.values())),
            "saved_bytes_sum": float(sum(c.saved.values()))}
    shared = share(mesh)
    c = dataclasses.replace(c, **{
        f: _per_position(getattr(c, f), shared)
        for f in ("flops", "bytes", "saved", "boundary", "coll", "outputs",
                  "alias")})
    p_flops, flops = _busiest(c.flops)
    _, nbytes = _busiest(c.bytes)
    p_coll = max(sorted(c.coll), default=0,
                 key=lambda i: c.coll[i]["total_bytes"])
    coll = dict(c.coll.get(p_coll) or {"per_op": {}, "count": {},
                                       "total_bytes": 0.0,
                                       "moved_bytes": {},
                                       "total_moved_bytes": 0.0})
    coll["total_bytes_scaled"] = hlo_stats.scaled_collective_bytes(
        coll, cfg.n_layers)
    coll["position"] = p_coll
    memory = {"argument_size_in_bytes": arg_bytes,
              "output_size_in_bytes": _busiest(c.outputs)[1],
              "alias_size_in_bytes": _busiest(c.alias)[1],
              "temp_size_in_bytes": None,
              "generated_code_size_in_bytes": None,
              "null_reason": NULL_REASON}
    if kind == "train":
        memory["saved_bytes"] = _busiest(c.saved)[1]
        memory["saved_bytes_sum"] = sums["saved_bytes_sum"]
        memory["saved_boundary_bytes"] = _busiest(c.boundary)[1]
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
        "n_devices": mesh.size, "ok": True,
        "lower_s": None, "compile_s": None,
        "count_s": round(time.process_time() - t0, 2),
        "depth": how,
        "memory": memory,
        "cost": {"flops": flops, "bytes_accessed": nbytes,
                 "flops_sum": sums["flops_sum"],
                 "bytes_accessed_sum": sums["bytes_accessed_sum"],
                 "busiest_position": p_flops,
                 "flops_by_op": c.by_op},
        "collectives": coll,
        "collectives_mesh": c.coll_mesh,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             depth: str = "fit") -> dict:
    """The cell on the production mesh (16×16, or 2×16×16 over two
    pods)."""
    return count_cell(arch, shape_name, production_mesh(multi_pod),
                      depth=depth)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--depth", default="fit", choices=("fit", "full"))
    ap.add_argument("--out", default="results/torch_dryrun.json")
    ap.add_argument("--skip-done", action="store_true", default=True)
    args = ap.parse_args()

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    cells = assigned_cells()
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    for arch, shape in cells:
        for multi in meshes:
            key = f"{arch}|{shape}|{'multi' if multi else 'single'}"
            if args.skip_done and key in results and results[key].get("ok"):
                continue
            ok, why = cell_applicable(arch, shape)
            if not ok:
                results[key] = {"arch": arch, "shape": shape,
                                "mesh": "2x16x16" if multi else "16x16",
                                "ok": False, "skipped": True,
                                "reason": why}
                print(f"[skip] {key}: {why}", flush=True)
            else:
                print(f"[run ] {key} ...", flush=True)
                try:
                    results[key] = run_cell(arch, shape, multi, args.depth)
                    r = results[key]
                    print(f"       ok count={r['count_s']}s "
                          f"flops={r['cost']['flops']:.3e} "
                          f"coll={r['collectives']['total_bytes']:.3e}B",
                          flush=True)
                except Exception as e:            # noqa: BLE001
                    results[key] = {"arch": arch, "shape": shape,
                                    "ok": False,
                                    "error": f"{type(e).__name__}: {e}",
                                    "trace": traceback.format_exc()[-2000:]}
                    print(f"       FAIL {type(e).__name__}: {e}",
                          flush=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results.values() if r.get("ok"))
    n_skip = sum(1 for r in results.values() if r.get("skipped"))
    n_fail = sum(1 for r in results.values()
                 if not r.get("ok") and not r.get("skipped"))
    print(f"done: {n_ok} ok, {n_skip} skipped-by-design, {n_fail} FAILED")


if __name__ == "__main__":
    main()
