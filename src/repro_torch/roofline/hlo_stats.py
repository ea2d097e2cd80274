"""Collective-byte accounting at the port's own gather points.

Port of ``src/repro/roofline/hlo_stats.py``. The reference parses the
compiled, partitioned HLO (``compiled.as_text()``) for the collectives
the SPMD partitioner inserted. The port compiles nothing: one Python
process drives every mesh position and moves blocks between them at
the gather points of ``distributed/act_sharding.py`` and
``distributed/sharding.py``. So the HLO text parser has nothing to read
here and is not ported; instead each gather point reports its op kind,
its group size k and its buffer bytes b to the active
``CollectiveRecorder``, which keeps the reference's record through the
same ring formulas.

Per-device wire bytes per op (ring algorithms, k = group size, b =
result buffer bytes), as in the reference:

    all-reduce          2·b·(k-1)/k
    all-gather            b·(k-1)/k
    reduce-scatter        b·(k-1)          (result is the scattered 1/k)
    all-to-all            b·(k-1)/k
    collective-permute    b

Beside the ring's wire bytes a record keeps ``moved_bytes``: the bytes
the port's peer copies actually moved between distinct positions (a
copy within one device moves nothing; on a mesh over repeated
positions of one card, nothing moves at all).

The port runs no ``while`` loop over layers: each layer's collectives
are recorded as they run, once per trip, so no key is ``@loop`` and
``scaled_collective_bytes`` returns ``total_bytes``.

Recording is arithmetic on shapes and happens only while a recorder is
installed (``recording()``): without one a gather point pays one
``None`` test, and nothing syncs the device or makes a tensor.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4,
    "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "s4": 0.5, "u4": 0.5,
}


def _wire_bytes(op: str, b: float, k: int) -> float:
    k = max(k, 2)
    if op == "all-reduce":
        return 2.0 * b * (k - 1) / k
    if op == "all-gather":
        return b * (k - 1) / k
    if op == "reduce-scatter":
        return b * (k - 1)
    if op == "all-to-all":
        return b * (k - 1) / k
    return b        # permute / broadcast


def scaled_collective_bytes(coll: dict, n_layers: int) -> float:
    """Total per-device wire bytes with loop-body ops scaled by the
    scan trip count (scan-over-layers)."""
    total = 0.0
    for op, b in coll["per_op"].items():
        total += b * (n_layers if op.endswith("@loop") else 1)
    return total


def nbytes(t) -> int:
    """A tensor's bytes (its shape times its element size)."""
    return t.numel() * t.element_size()


def position(device) -> int:
    """The mesh position a device stands for: its index (a ``meta:i``
    position of the dry-run, a card), 0 for an unindexed device."""
    return device.index or 0


class _Record:
    """The reference's record, {per_op, count, total_bytes}, plus the
    bytes moved between distinct positions (``moved_bytes``) and the
    ``COLLECTIVE_METER`` counter each call ticks (``meter``)."""

    def __init__(self) -> None:
        self.per_op: dict = defaultdict(float)
        self.count: dict = defaultdict(int)
        self.moved: dict = defaultdict(float)
        self.meter: dict = defaultdict(int)

    def add(self, op: str, wire: float | None, moved: float,
            meter: str | None) -> None:
        if wire is not None:
            self.per_op[op] += wire
            self.count[op] += 1
            self.moved[op] += moved
        if meter:
            self.meter[meter] += 1

    def record(self) -> dict:
        return {"per_op": dict(self.per_op), "count": dict(self.count),
                "total_bytes": float(sum(self.per_op.values())),
                "moved_bytes": dict(self.moved),
                "total_moved_bytes": float(sum(self.moved.values()))}


class CollectiveRecorder:
    """The collectives of a run: ``mesh`` each call once (the
    ``COLLECTIVE_METER`` view: what the single controller issued) and
    ``positions[i]`` the calls position i takes part in, each with its
    per-device wire bytes (the reference's per-device HLO view)."""

    def __init__(self) -> None:
        self.mesh = _Record()
        self.positions: dict = defaultdict(_Record)

    def add(self, op: str, k: int, b: float, devices=(), moved: float = 0.0,
            meter: str | None = None, dst=None) -> None:
        """One collective: ``k`` members, ``b`` result bytes a member,
        ``devices`` the members' devices (each distinct position is
        charged once), ``moved`` the bytes copied between distinct
        positions, ``meter`` the ``COLLECTIVE_METER`` counter the call
        ticks (None: it ticks none). ``dst``: the one device a gather
        lands on; it takes the ring's wire bytes, and each other member
        only its own block (b / k), which is all it sends. A call of
        one member that moves nothing (a local sum, a block already in
        place) is no collective: it only counts in ``meter``."""
        wire = _wire_bytes(op, b, k) if k > 1 or moved else None
        self.mesh.add(op, wire, moved, meter)
        land = position(dst) if dst is not None else None
        for p in sorted({position(d) for d in devices} or {0}):
            w = wire if wire is None or land in (None, p) else b / k
            self.positions[p].add(op, w, 0.0, meter)

    def record(self) -> dict:
        """The mesh-wide record."""
        return self.mesh.record()


_ACTIVE: CollectiveRecorder | None = None


def recorder() -> CollectiveRecorder | None:
    """The installed recorder, or None (then a gather point records
    nothing)."""
    return _ACTIVE


@contextlib.contextmanager
def recording():
    """Install a fresh ``CollectiveRecorder`` for the block."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, CollectiveRecorder()
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def moved(dst, srcs) -> float:
    """Bytes of the tensors ``srcs`` that live on another device than
    ``dst``."""
    return float(sum(nbytes(t) for t in srcs if t.device != dst))
