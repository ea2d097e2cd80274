"""PyTorch serving engine: continuous batching with Chameleon integrated.

Port of ``src/repro/serving/engine.py`` for the dense and MoE
families: one ``ChameleonEngine`` over paged KV (16-token pages) with
the prefix cache in ``"exact"`` (or ``"alora"``) mode — the default —
or without it (``prefix_cache=False``: whole-prompt dense prefill whose
K/V are copied into the slot's pages), or over the dense KV slab
(``paged=False``: one (max_slots, max_len) row per batch slot); the
fused decode micro-horizon with pipelined readback or the seed loop,
asynchronous adapter loads and kernel LoRA on the card; chunked prefill
(``prefill_chunk_tokens > 0``), the KV-migration API the
disaggregated cluster ships requests with, and speculative draft–verify
decoding inside the fused loop (``spec_decode=True``: a dense draft on
its own f32 slab, one multi-token target verify a round, drained
synchronously). The control
plane — scheduler, adapter cache, memory pool, prefix radix tree,
prefetchers — is the reference's own code (``repro_torch.core`` is a
verbatim copy); this file moves bytes and drives the data plane.

Device state lives in preallocated tensors updated in place: the KV
page pool or slab (the JAX engine donates it into each jit), the
per-slot current token, ``cache_len`` and adapter index. The fused
horizon runs K decode+sample steps as a loop of device launches with an
on-device done mask; its (K, B) token block is copied to pinned host memory
behind an event as soon as it is enqueued, so the pipelined readback of
horizon N waits only for horizon N, not for horizon N+1 dispatched
after it.

Asynchronous adapter loads: a cache miss copies the adapter's pinned
host weights into its (free) device slot on a side CUDA stream and
records an event; ``_poll_loads`` retires the load once
``event.query()`` is true. Decode on the main stream keeps reading the
other slots meanwhile — the slot being written is free, and a LOADING
adapter is never placed. On the CPU the copy is synchronous.

Migration payloads are host copies in pinned memory, complete when
``begin_migration`` returns; imports write them into the pool in place
on the main stream, ahead of the next dispatch.

The MoE family serves through the same engine as the dense one, from
the dense KV slab whatever ``paged`` says (``api.supports_paged``), as
the reference does.

One engine can span a device **mesh** (``EngineConfig.mesh_shape =
(data, model)``, resolved through ``launch.mesh.make_serving_mesh``),
one Python process driving every position as the JAX engine's single
controller does. ``serving/shard_plan.py`` places the weights through
the serving rule table (q/k/v/o, gate/up and the vocab over "model",
the MoE experts over "data" with their FFN whole), the LoRA B halves
over "model" (LoRA A whole), KV pages (or slab rows) and the
batch-state vectors over "data", KV heads over "model" where they
divide (else whole in the pages, and the slab's positions over
"model"); the page table stays global. The model functions run one
"model" column per shard and one set of experts per "data" shard, and
gather at the ``act_sharding.constrain_*`` points in exact-reductions
mode (no contraction over a sharded dimension, compute at full batch),
so a mesh engine emits the tokens of ``mesh_shape=None``; the MoE
family serves from the slab there too. Physical pages round up to the
data axis with the free-list order unchanged; KV and batch state are
updated in place shard by shard; adapter uploads copy each device only
its shard, on that device's side stream. ``shard_stats`` reports
per-shard pages, the arena bytes a device holds and the
``COLLECTIVE_METER`` gather gauges. ``spec_decode=True`` warns and is
ignored on a mesh, as in the reference. Every config serves on every
mesh: a vocabulary the "model" axis does not divide stays whole on
every column, and a block with a dimension it does not divide (heads,
KV heads a column's query heads would read parts of, the D of o, d_ff,
an MoE config's ``shared_expert_ff``) runs whole on each batch row's
first column (``distributed.sharding.whole_blocks``), as the reference's
``fit_spec`` replicates it.

Not ported yet (each raises ``NotImplementedError`` at construction,
naming the knob): the VLM, SSM, hybrid and enc-dec families (the
reference engine cannot serve VLM either: it threads no M-RoPE
positions) and ``spec_decode=True`` on an MoE model (the reference's
MoE verify fails).
"""
from __future__ import annotations

import contextlib
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import (AdapterCache, AdapterInfo, CacheStats,
                              ChameleonScheduler, HistogramPrefetcher,
                              MemoryPool, NoisyOraclePredictor, PoolError,
                              PrefixCache, QueuedRequestPrefetcher, Request,
                              RequestState, SamplingParams)
from repro_torch.device import resolve_device
from repro_torch.distributed.act_sharding import activation_sharding
from repro_torch.distributed.sharding import (MeshParams, ShardedTensor,
                                              all_gather)
from repro_torch.kernels.ops import (COLLECTIVE_METER, DISPATCH_METER,
                                     resolve_lora_backend)
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import api
from repro_torch.models.base import Family, ModelConfig
from repro_torch.models.lora_apply import (init_lora_slots,
                                           random_lora_weights,
                                           write_adapter_to_slot)
from repro_torch.serving.handles import RequestHandle, prepare_request
from repro_torch.serving.metrics import RequestRecord, RunMetrics
from repro_torch.serving.shard_plan import ShardPlan


@dataclass
class EngineConfig:
    """Same fields and defaults as the JAX ``EngineConfig``; see there
    for each knob. The port rejects the knobs it does not implement yet
    at engine construction."""
    max_slots: int = 8
    max_len: int = 256
    n_lora_slots: int = 8
    r_max: int = 32
    n_adapters: int = 16
    predictor_accuracy: float = 0.8
    seed: int = 0
    paged: bool = True
    page_size: int = 16
    # "auto" = CUDA kernels on a CUDA device, einsum elsewhere.
    lora_backend: str = "auto"
    async_load: bool = True
    h2d_gbps: float = 0.0
    queued_prefetch: bool = True
    histogram_prefetch: bool = True
    fused_hotloop: bool = True
    max_horizon: int = 8
    pipeline_readback: bool = True
    prefix_cache: bool = True
    prefix_mode: str = "exact"
    mesh_shape: Optional[tuple] = None
    prefill_chunk_tokens: int = 0
    spec_decode: bool = False
    spec_k: int = 4
    spec_draft: str = "internlm2-1.8b"


#: Why the engine refuses a family that has model functions: the
#: reference engine cannot serve it either, and the port adds no feature
#: the reference lacks.
_WHY_NOT_SERVED = {
    Family.VLM: " (the reference engine threads no M-RoPE positions)",
    Family.SSM: " (the reference engine fails at construction: its "
                "adapter catalog scales LoRA by q_dim ** -0.5 with "
                "q_dim = 0)",
    Family.HYBRID: " (the reference engine fails at its first prefill: "
                   "the family's prefill takes no last_pos)",
    Family.ENCDEC: " (the reference engine fails at its first prefill: "
                   "the family's prefill takes no last_pos, and the "
                   "engine passes no encoder frames)",
}


def _unsupported(cfg: ModelConfig, e: EngineConfig) -> list[str]:
    out = []
    if cfg.family not in (Family.DENSE, Family.MOE):
        out.append(f"model family {cfg.family.name}"
                   + _WHY_NOT_SERVED.get(cfg.family, ""))
    if e.spec_decode and cfg.family == Family.MOE:
        # The reference engine builds and then fails at its first
        # verify: its lm.verify runs the dense MLP on every layer.
        out.append("spec_decode=True on model family MOE (no MoE "
                   "verify pass)")
    return out


def _bucket(n_rows: int, n_tokens: int) -> tuple[int, int]:
    """The (B, S) prefill bucket: powers of two, S at least 8."""
    return (1 << max(0, (n_rows - 1).bit_length()),
            1 << max(3, (n_tokens - 1).bit_length()))


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """Host copy of an adapter weight, pinned when a card is present so
    slot loads are true asynchronous H2D copies."""
    t = t.detach().to("cpu")
    return t.pin_memory() if torch.cuda.is_available() else t


def _payload(t: torch.Tensor) -> torch.Tensor:
    """A migration payload: a host copy of device KV, in pinned memory
    from the card. The copy is synchronous, so it is complete before
    the source frees the pages and before another engine reads it."""
    if t.device.type != "cuda":
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


class AdapterCatalog:
    """Host-side LoRA adapter store shared by every engine replica.

    Holds the adapter weights ("host memory" in the paper) and the
    AdapterInfo metadata the control plane prices residency with. The
    weights are either drawn from a seeded ``torch.Generator`` on
    ``device`` (then kept in pinned host memory) or given as
    ``weights`` ({adapter_id: {proj: (A (L, din, r_max), B (L, r_max,
    dout))}}, e.g. the JAX catalog's weights through ``bridge``).
    """

    def __init__(self, cfg: ModelConfig, n_adapters: int, r_max: int,
                 seed: int = 0, *, weights: Optional[dict] = None,
                 device: torch.device | str | None = None):
        self.cfg = cfg
        self.r_max = r_max
        self.ranks = [min(cfg.lora_ranks[i % len(cfg.lora_ranks)], r_max)
                      for i in range(n_adapters)]
        if weights is None:
            gen = torch.Generator(device=resolve_device(device))
            gen.manual_seed(seed)
            weights = {}
            for aid in range(n_adapters):
                w = random_lora_weights(gen, self.ranks[aid], r_max,
                                        cfg.n_layers, cfg.d_model,
                                        cfg.q_dim, cfg.kv_dim)
                weights[aid] = {name: (_host_copy(a), _host_copy(b))
                                for name, (a, b) in w.items()}
        elif len(weights) != n_adapters:
            raise ValueError(f"weights hold {len(weights)} adapters, "
                             f"n_adapters={n_adapters}")
        self.weights = weights
        kv_tok = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2
        lora_bytes = {aid: sum((a.numel() + b.numel()) * 2
                               for a, b in self.weights[aid].values())
                      for aid in self.weights}
        self.infos = {aid: AdapterInfo(
            adapter_id=aid, rank=self.ranks[aid],
            size_bytes=lora_bytes[aid],
            size_tokens=max(1, lora_bytes[aid] // kv_tok))
            for aid in self.weights}

    def __len__(self) -> int:
        return len(self.weights)

    def rank_of(self, adapter_id: int) -> int:
        return self.infos[adapter_id].rank


class ChameleonEngine:
    """Engine over a real model on one device (CUDA by default) or a
    device mesh (``EngineConfig.mesh_shape``)."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 ecfg: EngineConfig | None = None,
                 scheduler_cls=ChameleonScheduler, cache_enabled=True,
                 catalog: AdapterCatalog | None = None,
                 clock: Optional[Callable[[], float]] = None,
                 draft: Optional[tuple] = None,
                 device: torch.device | str | None = None):
        self.cfg = cfg
        self.ecfg = ecfg or EngineConfig()
        e = self.ecfg
        missing = _unsupported(cfg, e)
        if missing:
            raise NotImplementedError(
                "the PyTorch engine does not serve: " + ", ".join(missing))
        if e.prefix_mode not in ("exact", "alora"):
            raise ValueError(f"unknown prefix_mode {e.prefix_mode!r}")
        self.device = dev = resolve_device(device)

        # --- serving mesh: one engine across d*m devices ---
        self.mesh = None
        self.plan: Optional[ShardPlan] = None
        self._collective = False      # mesh>1: COLLECTIVE_METER armed
        if e.mesh_shape is not None:
            d, m = e.mesh_shape
            self.mesh = make_serving_mesh(d * m, m, device=dev)
            self.plan = ShardPlan(self.mesh, cfg)
            self.device = dev = self.mesh.devices[0, 0]
            # Weights land sharded over "model" once, up front —
            # resident, never re-gathered per step.
            sh = self.plan.params(params)
            self.params = MeshParams(
                cfg, {k: self.plan.put(v, sh[k]) for k, v in params.items()},
                self.mesh)
            self._collective = self.mesh.size > 1
        else:
            self.params = {k: v.to(dev) for k, v in params.items()}

        # --- LoRA adapter catalog (host-side weights = "host memory") ---
        self.catalog = catalog or AdapterCatalog(cfg, e.n_adapters,
                                                 e.r_max, seed=e.seed,
                                                 device=dev)
        self.host_adapters = self.catalog.weights
        # Device adapter-slot buffers, written in place by loads. On a
        # mesh the arena is in shard layout: A whole on every device, B
        # dout over "model" (the LoRA delta adds to the column's
        # projection output without a reshard), and host adapter
        # weights upload straight into it — each device receives only
        # its shard (``_adapter_sh``), never the whole B.
        self.lora = init_lora_slots(e.n_lora_slots, cfg.n_layers,
                                    cfg.d_model, cfg.q_dim, cfg.kv_dim,
                                    self.catalog.r_max, device=dev)
        self._adapter_sh = None
        self._host_blocks: dict = {}
        if self.plan is not None:
            lsh = self.plan.lora_slots(self.lora)
            self.lora = {p: (lsh[p][0].zeros(tuple(a.shape), a.dtype),
                             lsh[p][1].zeros(tuple(b.shape), b.dtype))
                         for p, (a, b) in self.lora.items()}
            if self.host_adapters:
                self._adapter_sh = self.plan.adapter_weights(
                    next(iter(self.host_adapters.values())))
        self.slot_of: dict[int, int] = {}       # adapter_id -> lora slot
        self.free_slots = list(range(e.n_lora_slots))
        # adapter_id -> (copy-done events or None, modeled-ready time).
        self._pending_loads: dict[int, tuple[Optional[list], float]] = {}
        # One side stream per card the arena lives on.
        self._load_streams: dict[torch.device, torch.cuda.Stream] = {}
        for d in ({dev} if self.mesh is None else set(self.mesh.devices.flat)):
            if d.type == "cuda":
                # Slot copies on the side stream must land after the
                # zero fill just enqueued on the main stream.
                st = torch.cuda.Stream(d)
                st.wait_stream(torch.cuda.current_stream(d))
                self._load_streams[d] = st
        self.n_async_loads = 0
        self._lora_backend = resolve_lora_backend(e.lora_backend, dev)

        # --- memory pool in token units ---
        infos = self.catalog.infos
        cap = e.max_slots * e.max_len \
            + 4 * max(c.size_tokens for c in infos.values())
        # Paged KV for the dense family only; MoE serves from the slab
        # (the prefix cache and chunked prefill then stay off).
        self.paged = bool(e.paged) and api.supports_paged(cfg)
        # Per-device sizing is telemetry (n_shards); the *accounting*
        # stays global so admission/eviction decisions — and therefore
        # emitted tokens — are identical at every mesh shape.
        self.pool = MemoryPool(capacity_tokens=cap,
                               page_size=e.page_size if self.paged else 1,
                               n_shards=(self.mesh.size
                                         if self.mesh is not None else 1))
        self.cache = AdapterCache(self.pool, infos,
                                  enabled=cache_enabled,
                                  on_load=self._load_adapter,
                                  on_evict=self._evict_adapter,
                                  max_entries=e.n_lora_slots)
        pred = NoisyOraclePredictor(accuracy=e.predictor_accuracy,
                                    seed=e.seed)
        skw = dict(max_batch_requests=e.max_slots)
        if issubclass(scheduler_cls, ChameleonScheduler):
            skw["t_refresh"] = 5.0
        self.sched = scheduler_cls(self.pool, self.cache, infos, pred,
                                   **skw)
        self.q_prefetch = (QueuedRequestPrefetcher(self.cache)
                           if e.queued_prefetch else None)
        self.h_prefetch = (HistogramPrefetcher(self.cache)
                           if e.histogram_prefetch else None)
        # Paged mode: the engine holds exactly its allocated pages in the
        # pool; the dense slab keeps the scheduler's reservation.
        self.sched.reserve_from_pool = not self.paged

        # --- device state: paged KV pool (page 0 = trash page) or the
        # dense slab, f32 as in the JAX engine ---
        self.kv_pages = self.kv = None
        if self.paged:
            ps = e.page_size
            self.n_pages = cap // ps + 1
            if self.mesh is not None:
                # Round physical pages up to the data-axis size so the
                # page axis shards evenly. The pool still caps
                # allocation at the unrounded capacity and pages pop
                # off the free list in the same 1, 2, 3… order, so the
                # extra pages are never allocated.
                ds = self.mesh.shape["data"]
                self.n_pages = -(-self.n_pages // ds) * ds
            self.pages_per_slot = -(-e.max_len // ps)
            if self.plan is not None:
                shape = (cfg.n_layers, self.n_pages, ps, cfg.n_kv_heads,
                         cfg.head_dim)
                self.kv_pages = tuple(
                    self.plan.zeros_kv_pages(shape, torch.float32)
                    for _ in range(2))
            else:
                self.kv_pages = api.init_paged_serve_state(
                    cfg, self.n_pages, ps, torch.float32, device=dev)
            self.page_table = np.zeros((e.max_slots, self.pages_per_slot),
                                       np.int32)
            self.slot_pages: list[list[int]] = [[] for _ in
                                                range(e.max_slots)]
            self.free_pages = list(range(self.n_pages - 1, 0, -1))
        elif self.plan is not None:
            shape = (cfg.n_layers, e.max_slots, e.max_len, cfg.n_kv_heads,
                     cfg.head_dim)
            self.kv = tuple(self.plan.zeros_kv_dense(shape, torch.float32)
                            for _ in range(2))
        else:
            self.kv = api.init_serve_state(cfg, e.max_slots, e.max_len,
                                           torch.float32, device=dev)
        # --- prefix KV reuse (radix tree over the paged pool) ---
        self.prefix: Optional[PrefixCache] = (
            PrefixCache(self.pool, e.page_size)
            if self.paged and e.prefix_cache else None)
        self.slot_shared: list[list[int]] = [[] for _ in range(e.max_slots)]
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        self.n_prefix_hits = 0
        self.n_cow_forks = 0
        # Per-slot batch state (over "data" on a mesh).
        self.tokens = self._batch_zeros((e.max_slots, 1), torch.int32)
        self.cache_len = self._batch_zeros((e.max_slots,), torch.int32)
        self.active = np.zeros((e.max_slots,), bool)
        self.adapter_slot = self._batch_zeros((e.max_slots,), torch.int32)
        self.slot_req: list[Optional[Request]] = [None] * e.max_slots
        self.t0 = time.monotonic()
        self._clock = clock
        self.completed: list[Request] = []
        self.records: list[RequestRecord] = []
        self.outputs: dict[int, list[int]] = {}
        self._tbts: dict[int, list[float]] = {}
        self._last_tok: dict[int, float] = {}
        self.handles: dict[int, RequestHandle] = {}
        self.batch_occupancy: list[int] = []
        self.n_preempted = 0
        self.n_cancelled = 0
        self.n_expired = 0
        self._deadlines_armed = False
        self._cancel_armed = False
        self._cancel_races: list[Request] = []

        # --- device-resident hot loop state ---
        self.fused = bool(e.fused_hotloop) and api.supports_fused(cfg)
        self.batch_epoch = 0
        self._dev: Optional[dict] = None
        self._dev_epoch = -1
        self._page_table_dev: Optional[torch.Tensor] = None
        self._page_table_dirty = True
        # One dispatched-but-unsynced horizon: (toks, emits, K), the
        # blocks as (host tensor, copy-done event or None).
        self._inflight: Optional[tuple] = None

        # --- chunked prefill: slot -> {req, prompt, done, table} ---
        self._chunked: dict[int, dict] = {}
        self.n_chunked_prefills = 0
        # --- KV handoff (disaggregation): req_id -> slot held while
        # MIGRATING ---
        self._migrating: dict[int, int] = {}
        self.n_kv_exports = 0
        self.n_kv_imports = 0
        self.kv_handoff_bytes = 0

        # --- speculative draft–verify decoding: ``self.spec`` is the
        # effective switch (spec_decode=True with a valid dense draft on
        # a fused engine); invalid draft configs raise here ---
        self.spec = False
        self.draft_cfg: Optional[ModelConfig] = None
        self.draft_params: Optional[dict] = None
        self.draft_kv = None
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        self.n_spec_dispatches = 0
        self.n_spec_draft_dispatches = 0
        self.n_spec_verify_dispatches = 0
        self._spec_ewma = 1.0     # acceptance EWMA -> adaptive spec_k
        if e.spec_decode:
            self._init_spec(draft)

    # ------------------------------------- speculative decoding setup
    def _init_spec(self, draft: Optional[tuple]) -> None:
        """Validate and build the speculative-decoding state.

        ``draft`` is an optional ``(draft_cfg, draft_params)`` pair;
        None resolves ``EngineConfig.spec_draft`` through the config
        registry with weights from the engine seed + 1. A non-dense
        draft, a vocabulary mismatch or ``spec_k < 1`` raise; a
        non-fused engine warns and runs without speculation. The draft
        KV is an f32 dense slab outside the paged pool: "freeing" a
        slot's draft KV is bookkeeping (``_draft_len`` drops to 0 and
        the next occupant's catch-up rewrites the rows)."""
        e = self.ecfg
        if draft is not None:
            draft_cfg, draft_params = draft
        else:
            from repro_torch.configs import get_config
            draft_cfg = get_config(e.spec_draft)
            draft_params = None
        if not api.supports_spec_draft(draft_cfg):
            raise ValueError(
                f"spec_decode=True needs a dense draft model: draft "
                f"{draft_cfg.name!r} is family {draft_cfg.family.name}, "
                f"which has no dense-KV decode_step for the speculative "
                f"scan (api.supports_spec_draft). Pick a Family.DENSE "
                f"config for EngineConfig.spec_draft (e.g. "
                f"'internlm2-1.8b') or turn spec_decode off.")
        if draft_cfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"spec_decode draft {draft_cfg.name!r} has vocab_size="
                f"{draft_cfg.vocab_size} but the target "
                f"{self.cfg.name!r} has vocab_size="
                f"{self.cfg.vocab_size}; draft and target must share a "
                f"vocabulary for draft tokens to be target-scorable.")
        if e.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {e.spec_k}")
        if not self.fused:
            warnings.warn(
                f"spec_decode=True ignored: target family "
                f"{self.cfg.family.name} (or fused_hotloop=False) has "
                f"no fused decode path to speculate inside — running "
                f"the non-speculative loop", RuntimeWarning,
                stacklevel=2)
            return
        if self.mesh is not None:
            warnings.warn(
                "spec_decode=True ignored on a mesh-sharded engine: "
                "the speculative passes are not sharded yet — running "
                "the non-speculative fused loop",
                RuntimeWarning, stacklevel=2)
            return
        dev = self.device
        if draft_params is None:
            draft_params = api.init_params(draft_cfg, seed=e.seed + 1,
                                           device=dev)
        self.draft_cfg = draft_cfg
        self.draft_params = {k: v.to(dev) for k, v in draft_params.items()}
        self.draft_kv = api.init_serve_state(draft_cfg, e.max_slots,
                                             e.max_len, torch.float32,
                                             device=dev)
        # Tokens of the *target* cache the draft cache mirrors, per
        # slot (host truth; the lazy catch-up syncs the gap).
        self._draft_len = np.zeros(e.max_slots, np.int64)
        self.spec = True

    # ------------------------------------------------------------- clock
    def now(self) -> float:
        if self._clock is not None:
            return self._clock()
        return time.monotonic() - self.t0

    # ----------------------------------------------------- adapter moves
    def _load_adapter(self, info: AdapterInfo) -> None:
        """Cache ``on_load`` hook: copy the adapter into a free slot.

        Async mode (default) issues the H2D copy on the load stream,
        records an event and marks the entry LOADING; decode keeps
        running on the main stream, and ``_poll_loads`` retires the
        load once the event completed. Sync mode blocks until the copy
        (plus any modeled H2D time) lands.
        """
        if not self.free_slots:
            raise RuntimeError(
                "adapter slot accounting drift: no free LoRA slot for "
                f"adapter {info.adapter_id} "
                f"(n_lora_slots={self.ecfg.n_lora_slots}, "
                f"slot_of={dict(sorted(self.slot_of.items()))}, "
                f"cache_resident={sorted(self.cache.resident_ids())}, "
                f"cache_loading={sorted(self.cache.loading_ids())})")
        slot = self.free_slots.pop()
        self.slot_of[info.adapter_id] = slot
        weights = self.host_adapters[info.adapter_id]
        e = self.ecfg
        delay = (info.size_bytes / (e.h2d_gbps * 1e9)
                 if e.h2d_gbps > 0 else 0.0)
        if e.async_load:
            events = None
            if self._load_streams:
                events = []
                for d, stream in self._load_streams.items():
                    with torch.cuda.stream(stream):
                        self._write_slot(info.adapter_id, weights, slot, d,
                                         non_blocking=True)
                        ev = torch.cuda.Event()
                        ev.record(stream)
                        events.append(ev)
            else:
                self._write_slot(info.adapter_id, weights, slot)
            self.cache.mark_loading(info.adapter_id)
            self._pending_loads[info.adapter_id] = (events,
                                                    self.now() + delay)
            self.n_async_loads += 1
        else:
            self._write_slot(info.adapter_id, weights, slot)
            if delay:
                time.sleep(delay)   # modeled H2D stall blocks the loop

    def _write_slot(self, aid: int, weights: dict, slot: int,
                    device: Optional[torch.device] = None,
                    non_blocking: bool = False) -> None:
        """Copy one adapter's host weights into column ``slot`` of the
        arena (on a mesh: of the shards on ``device``, or all). A mesh
        device receives only its shard of each weight, from a pinned
        contiguous host block cut once per adapter."""
        if self.plan is None:
            write_adapter_to_slot(self.lora, weights, slot,
                                  non_blocking=non_blocking)
            return
        for proj, sts in self.lora.items():
            for which, st in enumerate(sts):
                host = weights[proj][which]
                sh = self._adapter_sh[proj][which]
                done = set()
                for coords in np.ndindex(*self.mesh.devices.shape):
                    t = st.local(coords)
                    if id(t) in done or (device is not None
                                         and t.device != device):
                        continue
                    done.add(id(t))
                    slc = sh.index(coords, tuple(host.shape))
                    key = (aid, proj, which,
                           tuple((s.start, s.stop) for s in slc))
                    blk = self._host_blocks.get(key)
                    if blk is None:
                        blk = host[slc]
                        if not blk.is_contiguous():
                            blk = _host_copy(blk.contiguous())
                        self._host_blocks[key] = blk
                    t[:, slot].copy_(blk, non_blocking=non_blocking)

    def _poll_loads(self) -> None:
        """Retire in-flight loads; runs every step, never blocks. A load
        is READY once its copy completed and its modeled ``h2d_gbps``
        time passed. The load stream runs copies in order, so the first
        unfinished copy ends the scan."""
        now = self.now()
        for aid in list(self._pending_loads):
            events, t_ready = self._pending_loads[aid]
            if events is not None:
                if not all(ev.query() for ev in events):
                    break
                self._pending_loads[aid] = (None, t_ready)
            if now >= t_ready:
                del self._pending_loads[aid]
                self.cache.mark_ready(aid)

    def flush_loads(self) -> None:
        """Barrier: block until every in-flight load lands."""
        if not self._pending_loads:
            return
        for stream in self._load_streams.values():
            stream.synchronize()
        for aid in list(self._pending_loads):
            del self._pending_loads[aid]
            self.cache.mark_ready(aid)

    def _evict_adapter(self, info: AdapterInfo) -> None:
        slot = self.slot_of.pop(info.adapter_id)
        self.free_slots.append(slot)
        # LOADING entries are never eviction candidates.
        self._pending_loads.pop(info.adapter_id, None)

    def _prefill_lora(self):
        """LoRA tensors for *prefill*. aLoRA prefix mode computes prompt
        KV with the base model (the adapter activates at generation), so
        cached prefix pages are adapter-invariant; decode is untouched."""
        return None if self.ecfg.prefix_mode == "alora" else self.lora

    # ------------------------------------------------------- page moves
    def _alloc_page(self, req_id: int, now: float) -> Optional[int]:
        """One physical page for ``req_id``; None when memory is full
        (after reclaiming idle prefix pages, then shrinking the adapter
        cache)."""
        ps = self.pool.page_size
        if self.pool.free_tokens < ps and self.prefix is not None:
            self.free_pages.extend(self.prefix.evict_lru(1))
        if self.pool.free_tokens < ps and not self.cache.shrink_for_requests(
                ps, now, self.sched.queued_adapter_ids()):
            return None
        if not self.free_pages:
            return None
        try:
            self.pool.reserve_request_pages(req_id, 1)
        except PoolError:
            return None
        return self.free_pages.pop()

    def _grow_slot(self, slot: int, n_pages: int, now: float) -> bool:
        """Grow a slot's page list by ``n_pages``; all-or-nothing."""
        req = self.slot_req[slot]
        got = []
        for _ in range(n_pages):
            pid = self._alloc_page(req.req_id, now)
            if pid is None:
                for p in got:
                    self.free_pages.append(p)
                if got:
                    self.pool.shrink_request(
                        req.req_id, len(got) * self.pool.page_size)
                return False
            got.append(pid)
        base = len(self.slot_pages[slot])
        self.slot_pages[slot].extend(got)
        self.page_table[slot, base:base + len(got)] = got
        self._page_table_dirty = True
        return True

    def _free_slot_pages(self, slot: int, req_id: int) -> None:
        if not self.paged:
            return      # the scheduler releases the slab's reservation
        shared = self.slot_shared[slot]
        if shared:
            # Drop the slot's references; the prefix tree keeps its own.
            self.free_pages.extend(self.pool.release_shared(shared))
            self.slot_shared[slot] = []
            shared_set = set(shared)
            private = [p for p in self.slot_pages[slot]
                       if p not in shared_set]
        else:
            private = self.slot_pages[slot]
        self.free_pages.extend(private)
        self.slot_pages[slot] = []
        self.page_table[slot, :] = 0
        self._page_table_dirty = True
        self.pool.release_request(req_id)

    def _stash_progress(self, req: Request) -> None:
        """Squash/preemption: keep the streamed tokens and TBT records
        on the request across the requeue."""
        rid = req.req_id
        req.stash_progress(self.outputs.pop(rid, None),
                           self._tbts.pop(rid, None),
                           self._last_tok.pop(rid, None))

    def _squash_slot(self, slot: int) -> None:
        """Free a slot and requeue its request (bypass misprediction or
        page preemption — the request re-executes, keeping its streamed
        prefix)."""
        req = self.slot_req[slot]
        self.active[slot] = False
        self.slot_req[slot] = None
        self.batch_epoch += 1
        if self.spec:
            self._draft_len[slot] = 0    # draft KV freed with the slot
        self._stash_progress(req)
        self._free_slot_pages(slot, req.req_id)
        self.sched.on_squash(req, self.now())

    def _preempt(self, slot: int) -> None:
        """Out of pages mid-flight: squash, and count it."""
        self.n_preempted += 1
        self._squash_slot(slot)

    # ---------------------------------------------------------- lifecycle
    def submit(self, req: Request, *,
               sampling: Optional[SamplingParams] = None,
               on_token=None, ttl: Optional[float] = None,
               ) -> RequestHandle:
        """Non-blocking: enqueue with the scheduler; no device work."""
        now = self.now()
        handle = prepare_request(req, self, now, sampling, on_token, ttl)
        self.handles[req.req_id] = handle
        if req.deadline is not None:
            self._deadlines_armed = True
        self.sched.submit(req, now)
        if self.h_prefetch is not None:
            self.h_prefetch.observe_arrival(req.adapter_id, now)
        return handle

    def cancel(self, handle) -> bool:
        """Cancel a request. Queued / LOADING-deferred requests terminate
        immediately; RUNNING requests are finalised at the next step
        boundary. False once already terminal."""
        req = handle.req if isinstance(handle, RequestHandle) else handle
        if req.terminal:
            return False
        now = self.now()
        if any(r is req for r in self.slot_req):
            req.cancel_requested = True
            self._cancel_armed = True
            return True
        if self.sched.cancel(req, now):
            self._finalize_unplaced(req, RequestState.CANCELLED, now)
            return True
        req.cancel_requested = True
        self._cancel_armed = True
        self._cancel_races.append(req)
        return True

    def _finalize_unplaced(self, req: Request, state: RequestState,
                           now: float) -> None:
        req.state = state
        req.finish_time = now
        if state is RequestState.CANCELLED:
            self.n_cancelled += 1
        else:
            self.n_expired += 1

    # ------------------------------------------------------ token delivery
    def _record_token(self, req: Request, pos: int, tok: int,
                      now: float) -> None:
        """Record (and stream) the token at output position ``pos``;
        re-executed positions after a squash overwrite in place and are
        not re-streamed."""
        rid = req.req_id
        out = self.outputs[rid]
        if pos < len(out):
            out[pos] = tok
            return
        out.append(tok)
        if pos >= 1:
            tbts = self._tbts[rid]
            if len(tbts) < pos:
                tbts.append(now - self._last_tok[rid])
        self._last_tok[rid] = now
        handle = self.handles.get(rid)
        if handle is not None and not req.cancel_requested:
            handle._push(pos, tok)

    def _free_slots(self) -> list[int]:
        """Slots a new placement may take: off the active mask and
        holding no request (a chunked prefill in progress or a MIGRATING
        request holds an inactive slot)."""
        return [s for s in range(self.ecfg.max_slots)
                if not self.active[s] and self.slot_req[s] is None]

    def _prompt_tokens(self, req: Request) -> np.ndarray:
        """The request's prompt token ids, vocab-folded (trace-driven
        requests without token material get a deterministic prompt)."""
        if req.prompt is not None:
            return np.asarray(req.prompt, np.int32) % self.cfg.vocab_size
        return (np.arange(req.input_len) % self.cfg.vocab_size) \
            .astype(np.int32)

    def _sig_of(self, req: Request) -> int:
        """KV signature a cached page is keyed by: the adapter in exact
        mode, one shared tree in aLoRA mode."""
        return -1 if self.ecfg.prefix_mode == "alora" else req.adapter_id

    def _tensor(self, a, dtype) -> torch.Tensor:
        """A fresh device tensor holding host data ``a``."""
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    # --------------------------------------------- sharded data plane
    def _act_scope(self):
        """The model code's gather points, armed only while a mesh
        engine dispatches — scoped, not global, so single-device engines
        in the same process (cluster replicas, A/B baselines) are
        untouched. Batch axes are empty: compute runs at full batch (a
        data-split batch would change every local matmul's shape and
        with it the FP summation order); "data" shards storage only."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return activation_sharding((), mesh=self.mesh,
                                   exact_reductions=True)

    def _batch_zeros(self, shape: tuple, dtype) -> torch.Tensor:
        """Zeroed per-slot state: leading dim over "data" on a mesh."""
        if self.plan is None:
            return torch.zeros(shape, dtype=dtype, device=self.device)
        return self.plan.batch(shape).zeros(shape, dtype)

    def _batch_put(self, t: torch.Tensor):
        """Per-slot state ``t`` in its mesh placement (itself off-mesh)."""
        if self.plan is None:
            return t
        return self.plan.put(t, self.plan.batch(tuple(t.shape)))

    def _full(self, t):
        """A batch-state value as a dispatch reads it: gathered to full
        batch on the first device on a mesh, else itself."""
        return t.full(self.device) if isinstance(t, ShardedTensor) else t

    def _keep(self, cur, new: torch.Tensor):
        """A dispatch's output batch state: written into the shards in
        place on a mesh (the counterpart of donation), else ``new``."""
        if isinstance(cur, ShardedTensor):
            return cur.copy_(new)
        return new

    def _pages_read(self, st, pages) -> torch.Tensor:
        """Pages ``pages`` (host ids) of a paged KV stack, whole heads,
        (L, n, page, Kh, Dh) on the first device."""
        if not isinstance(st, ShardedTensor):
            return st[:, self._tensor(pages, torch.long)]
        pages = np.asarray(pages, np.int64)
        out = torch.empty((st.shape[0], len(pages)) + st.shape[2:],
                          dtype=st.dtype, device=self.device)
        for slc, t in st.unique():
            lo, hi = slc[1].start, slc[1].stop
            sel = np.nonzero((pages >= lo) & (pages < hi))[0]
            if len(sel):
                idx = torch.as_tensor(pages[sel] - lo, device=t.device)
                out[:, torch.as_tensor(sel, device=self.device), :,
                    slc[3]] = t[:, idx].to(self.device)
        return out

    def _pages_write(self, st, pages, val: torch.Tensor,
                     pos: slice = slice(None)) -> None:
        """Write ``val`` (L, n, len(pos), Kh, Dh) into positions ``pos``
        of pages ``pages`` (host ids), each page into the shards that
        own it."""
        if not isinstance(st, ShardedTensor):
            st[:, self._tensor(pages, torch.long), pos] = \
                val.to(st.device, st.dtype)
            return
        pages = np.asarray(pages, np.int64)
        for slc, t in st.unique():
            lo, hi = slc[1].start, slc[1].stop
            sel = np.nonzero((pages >= lo) & (pages < hi))[0]
            if len(sel):
                idx = torch.as_tensor(pages[sel] - lo, device=t.device)
                v = val[:, torch.as_tensor(sel, device=val.device)]
                t[:, idx, pos] = v[..., slc[3], :].to(t.device, t.dtype)

    def _rows_read(self, st, row: int, n: int) -> torch.Tensor:
        """The first ``n`` positions of slab row ``row``, (L, n, Kh, Dh)
        on the first device."""
        if not isinstance(st, ShardedTensor):
            return st[:, row, :n]
        out = torch.empty((st.shape[0], n) + st.shape[3:], dtype=st.dtype,
                          device=self.device)
        for slc, t in st.unique():
            r, q = slc[1], slc[2]
            hi = min(n, q.stop)
            if r.start <= row < r.stop and q.start < hi:
                out[:, q.start:hi, slc[3]] = t[
                    :, row - r.start, :hi - q.start].to(self.device)
        return out

    def _rows_write(self, st, row: int, val: torch.Tensor) -> None:
        """Write ``val`` (L, n, Kh, Dh) at positions ``:n`` of slab row
        ``row``, into every shard that holds the row (and, for a slab
        split along the positions, its positions)."""
        n = val.shape[1]
        if not isinstance(st, ShardedTensor):
            st[:, row, :n] = val.to(st.device, st.dtype)
            return
        for slc, t in st.unique():
            r, q = slc[1], slc[2]
            hi = min(n, q.stop)
            if r.start <= row < r.stop and q.start < hi:
                t[:, row - r.start, :hi - q.start] = val[
                    :, q.start:hi, slc[3]].to(t.device, t.dtype)

    def _place_batch_prefix(self, reqs: list[Request]) -> None:
        """Prefix-cache admission: match each prompt against the radix
        tree, map the shared pages into the slot's page table, COW-fork
        a mid-page divergence, then batch-prefill only the suffixes via
        ``prefill_paged`` (a miss is simply start=0). Freshly computed
        full prompt pages are adopted into the tree afterwards."""
        now = self.now()
        free = self._free_slots()
        placed, slots, starts, prompts = [], [], [], []
        for req in reqs:
            slot = free[len(placed)]
            toksr = self._prompt_tokens(req)
            L = req.input_len
            sig = self._sig_of(req)
            # Cap the match at L-1: the last prompt position always
            # prefills, so first-token logits are computed fresh.
            pages, m, ppage, plen = self.prefix.match(sig, toksr, L - 1)
            # Reference everything we plan to read *before* allocating.
            self.pool.share_pages(pages)
            if ppage is not None:
                self.pool.share_pages([ppage])
            self.slot_req[slot] = req
            self.slot_pages[slot] = list(pages)
            self.slot_shared[slot] = list(pages)
            if pages:
                self.page_table[slot, :len(pages)] = pages
                self._page_table_dirty = True
            n_priv = self.pool.pages_for(L) - len(pages)
            if not self._grow_slot(slot, n_priv, now):
                # Bounce: undo the mapping and requeue (squash path).
                self.free_pages.extend(self.pool.release_shared(pages))
                if ppage is not None:
                    self.free_pages.extend(
                        self.pool.release_shared([ppage]))
                self.slot_pages[slot] = []
                self.slot_shared[slot] = []
                self.page_table[slot, :] = 0
                self.slot_req[slot] = None
                self.n_preempted += 1
                self.sched.on_squash(req, now)
                continue
            start = m
            if ppage is not None:
                # Divergence mid-page: copy the agreeing head of the
                # cached page into the request's first private page.
                dst = self.slot_pages[slot][len(pages)]
                for kv in self.kv_pages:
                    self._pages_write(
                        kv, [dst], self._pages_read(kv, [ppage])[:, :, :plen],
                        slice(0, plen))
                self.free_pages.extend(self.pool.release_shared([ppage]))
                self.n_cow_forks += 1
                start = m + plen
            self.prefix_lookup_tokens += L
            self.prefix_hit_tokens += start
            if start:
                self.n_prefix_hits += 1
            placed.append(req)
            slots.append(slot)
            starts.append(start)
            prompts.append(toksr)
        if not placed:
            return
        B, S = _bucket(len(placed), max(r.input_len - s for r, s in
                                        zip(placed, starts)))
        toks = np.zeros((B, S), np.int32)
        start_arr = np.zeros((B,), np.int32)
        seq_len = np.ones((B,), np.int32)    # pad rows: 1 trash token
        lslots = np.zeros((B,), np.int32)
        row_table = np.zeros((B, self.pages_per_slot), np.int32)
        for i, req in enumerate(placed):
            s, L = starts[i], req.input_len
            toks[i, :L - s] = prompts[i][s:]
            start_arr[i] = s
            seq_len[i] = L - s
            lslots[i] = self.slot_of[req.adapter_id]
            row_table[i] = self.page_table[slots[i]]
        i32 = torch.int32
        with self._act_scope():
            logits, self.kv_pages = api.prefill_paged(
                self.cfg, self.params, self._tensor(toks, i32),
                self.kv_pages, self._tensor(row_table, i32),
                self._tensor(start_arr, i32), self._tensor(seq_len, i32),
                lora=self._prefill_lora(),
                adapter_idx=self._tensor(lslots, i32),
                lora_backend=self._lora_backend)
        first_toks = self._first_tokens(logits, placed, B)
        now = self.now()
        for i, req in enumerate(placed):
            self._start_decode(slots[i], req, int(first_toks[i]),
                               int(lslots[i]), now)
            self._adopt_prompt_pages(slots[i], req, prompts[i])
        self._end_placement(placed, slots)

    def _place_batch(self, reqs: list[Request]) -> None:
        """Batched prefill admission: one prefill over a (B, S) bucket of
        powers of two covers every request admitted this iteration.
        With the prefix cache on this is ``_place_batch_prefix``;
        otherwise the whole right-padded prompts run the dense
        ``prefill`` (flash attention), whose K/V are then copied into
        each slot's slab row or pages. Right-padding is safe under
        causal attention, and padded batch rows run masked garbage like
        inactive decode slots. Paged slots get their prompt pages up
        front; a request that cannot get them bounces back to its queue
        (squash path)."""
        if not reqs:
            return
        e = self.ecfg
        if self.paged and e.prefill_chunk_tokens > 0:
            big = [r for r in reqs if r.input_len > e.prefill_chunk_tokens]
            if big:
                # Long prompts prefill a chunk per step and skip the
                # prefix tree, as in the JAX engine.
                reqs = [r for r in reqs
                        if r.input_len <= e.prefill_chunk_tokens]
                self._start_chunked(big)
            if not reqs:
                return
        if self.prefix is not None:
            return self._place_batch_prefix(reqs)
        free = self._free_slots()
        if self.paged:
            now = self.now()
            placed = []
            for req in reqs:
                slot = free[len(placed)]
                self.slot_req[slot] = req
                if self._grow_slot(slot, self.pool.pages_for(req.input_len),
                                   now):
                    placed.append(req)
                else:
                    self.slot_req[slot] = None
                    self.n_preempted += 1
                    self.sched.on_squash(req, now)
            reqs = placed
            if not reqs:
                return
        slots = free[:len(reqs)]
        B, S = _bucket(len(reqs), max(r.input_len for r in reqs))
        toks = np.zeros((B, S), np.int32)
        last_pos = np.zeros((B,), np.int32)
        lslots = np.zeros((B,), np.int32)
        for i, req in enumerate(reqs):
            toks[i, :req.input_len] = self._prompt_tokens(req)
            last_pos[i] = req.input_len - 1
            lslots[i] = self.slot_of[req.adapter_id]
        i32 = torch.int32
        with self._act_scope():
            logits, (k_new, v_new) = api.prefill(
                self.cfg, self.params, self._tensor(toks, i32),
                lora=self._prefill_lora(),
                adapter_idx=self._tensor(lslots, i32),
                last_pos=self._tensor(last_pos, i32),
                lora_backend=self._lora_backend)
        first_toks = self._first_tokens(logits, reqs, B)
        self._write_prompt_kv(reqs, slots, k_new, v_new)
        now = self.now()
        for i, req in enumerate(reqs):
            self.slot_req[slots[i]] = req
            self._start_decode(slots[i], req, int(first_toks[i]),
                               int(lslots[i]), now)
        self._end_placement(reqs, slots)

    def _write_prompt_kv(self, reqs: list[Request], slots: list[int],
                         k_new: torch.Tensor, v_new: torch.Tensor) -> None:
        """Copy row i's first ``input_len`` K/V of the prefill stacks
        (L, B, S, Kh, Dh) into slot ``slots[i]``'s slab row or its pages:
        one indexed copy per stack, cast to the KV dtype. Slots never
        share a written position, so the copy equals the per-page
        writes of the JAX engine."""
        n = [r.input_len for r in reqs]
        src_row = np.repeat(np.arange(len(reqs)), n)
        src_pos = np.concatenate([np.arange(L) for L in n])
        if self.paged:
            ps = self.pool.page_size
            dst = (np.concatenate([np.asarray(self.slot_pages[s])[
                np.arange(L) // ps] for s, L in zip(slots, n)]),
                src_pos % ps)
            targets = self.kv_pages
        else:
            dst = (np.repeat(np.asarray(slots), n), src_pos)
            targets = self.kv
        if self.plan is not None:
            return self._write_prompt_kv_mesh(targets, (k_new, v_new),
                                              src_row, src_pos, dst)
        sr, sp, d0, d1 = (self._tensor(a, torch.long)
                          for a in (src_row, src_pos, *dst))
        for t, new in zip(targets, (k_new, v_new)):
            t[:, d0, d1] = new[:, sr, sp].to(t.dtype)

    def _write_prompt_kv_mesh(self, targets, new_kv, src_row, src_pos,
                              dst) -> None:
        """``_write_prompt_kv`` on a mesh: the prefill's K/V are placed
        stacks (``kv_cache_spec`` layout), and each target shard takes
        the entries whose page (or slab row, and for a slab split along
        the positions, position) it owns, of every KV head it holds,
        gathered from the prefill's shards onto its device."""
        d0, d1 = dst
        for st, new in zip(targets, new_kv):
            for slc, t in st.unique():
                lo, hi = slc[1].start, slc[1].stop
                keep = (d0 >= lo) & (d0 < hi)
                if not self.paged:
                    keep &= (d1 >= slc[2].start) & (d1 < slc[2].stop)
                sel = np.nonzero(keep)[0]
                if not len(sel):
                    continue
                rows = src_row[sel]
                r0, r1 = int(rows.min()), int(rows.max()) + 1
                blk = all_gather(new, (slice(None), slice(r0, r1),
                                       slice(None),
                                       slice(slc[3].start, slc[3].stop)),
                                 t.device)
                i1 = d1[sel] - (0 if self.paged else slc[2].start)
                sr, sp, i0, i1 = (torch.as_tensor(a, device=t.device)
                                  for a in (rows - r0, src_pos[sel],
                                            d0[sel] - lo, i1))
                t[:, i0, i1] = blk[:, sr, sp].to(t.dtype)

    def _first_tokens(self, logits: torch.Tensor, reqs: list[Request],
                      B: int) -> np.ndarray:
        """First tokens of a prefill batch: argmax, or the seeded
        sampler when any row samples."""
        if self._all_greedy(reqs):
            first = torch.argmax(logits, dim=-1)
        else:
            first = api.sample_tokens(
                logits, *self._sampling_arrays(reqs, B, first=True))
        return first.cpu().numpy()

    def _start_decode(self, slot: int, req: Request, first: int, lslot: int,
                      now: float) -> None:
        """A placed request's first token: the slot's decode state and
        the request's stream (a squash survivor keeps its streamed
        prefix and latency records)."""
        self.active[slot] = True
        self.tokens[slot, 0] = first
        self.cache_len[slot] = req.input_len
        self.adapter_slot[slot] = lslot
        req.generated = 1
        rid = req.req_id
        if req.preserved_tokens:
            self.outputs[rid] = list(req.preserved_tokens)
            self._tbts[rid] = list(req.preserved_tbts)
            if req.last_stream_time is not None:
                self._last_tok[rid] = req.last_stream_time
        else:
            self.outputs[rid] = []
            self._tbts[rid] = []
            req.first_token_time = now
        self._record_token(req, 0, first, now)

    def _end_placement(self, reqs: list[Request], slots: list[int]) -> None:
        """Admission boundary: the device batch state rebuilds at the
        next dispatch; requests done at their first token finish."""
        self.batch_epoch += 1
        for slot, req in zip(slots, reqs):
            if req.done or self._hit_stop(req):
                self._finish(slot)

    def _adopt_prompt_pages(self, slot: int, req: Request,
                            toks: np.ndarray) -> None:
        """Hand the request's fully-written prompt pages to the radix
        tree (a conserving transfer per adopted page: the request's hold
        shrinks, the shared ledger gains it, the slot takes a ref)."""
        n_full = req.input_len // self.pool.page_size
        if n_full == 0:
            return
        ps = self.pool.page_size
        pages = self.slot_pages[slot][:n_full]
        adopted = self.prefix.insert(self._sig_of(req), toks[:n_full * ps],
                                     pages)
        for pid in adopted:
            self.pool.shrink_request(req.req_id, ps)
            self.pool.add_shared_page(pid)
            self.pool.share_pages([pid])
            self.slot_shared[slot].append(pid)

    # ------------------------------------------------- chunked prefill
    def _start_chunked(self, reqs: list[Request]) -> None:
        """Admit long prompts onto slots without prefilling them yet:
        the slot takes the request and all its prompt pages up front
        (the memory admission decision of the monolithic path; a prompt
        that cannot get its pages bounces through the squash path), then
        ``_advance_chunked`` runs one ``prefill_chunk_tokens`` chunk per
        engine step."""
        now = self.now()
        free = self._free_slots()
        n_placed = 0
        for req in reqs:
            slot = free[n_placed]
            self.slot_req[slot] = req
            if self._grow_slot(slot, self.pool.pages_for(req.input_len),
                               now):
                # Decode writes each row's K/V at ``cache_len[row]``,
                # masked or not; an inactive row is harmless only while
                # its page-table row maps the trash page. The real row
                # stays private until activation, and the zeroed global
                # row reaches the card at the next dispatch (dirty).
                row = self.page_table[slot].copy()
                self.page_table[slot, :] = 0
                self._page_table_dirty = True
                self._chunked[slot] = {
                    "req": req, "prompt": self._prompt_tokens(req),
                    "done": 0, "table": row}
                self.n_chunked_prefills += 1
                n_placed += 1
            else:
                self.slot_req[slot] = None
                self.n_preempted += 1
                self.sched.on_squash(req, now)

    def _advance_chunked(self) -> None:
        """One prefill chunk for every mid-prefill slot: a B=1 suffix
        prefill whose tokens attend to every position written before,
        so the last chunk's logits (and every token) equal the
        monolithic prefill's. The last chunk's logits give the first
        token and the slot joins the decode batch."""
        if not self._chunked:
            return
        chunk = self.ecfg.prefill_chunk_tokens
        i32 = torch.int32
        for slot in sorted(self._chunked):
            st = self._chunked[slot]
            req = st["req"]
            done = st["done"]
            L = req.input_len
            n = min(chunk, L - done)
            _, S = _bucket(1, n)
            toks = np.zeros((1, S), np.int32)
            toks[0, :n] = st["prompt"][done:done + n]
            lslot = self.slot_of[req.adapter_id]
            with self._act_scope():
                logits, self.kv_pages = api.prefill_paged(
                    self.cfg, self.params, self._tensor(toks, i32),
                    self.kv_pages, self._tensor(st["table"][None, :], i32),
                    self._tensor([done], i32), self._tensor([n], i32),
                    lora=self._prefill_lora(),
                    adapter_idx=self._tensor([lslot], i32),
                    lora_backend=self._lora_backend)
            st["done"] = done + n
            if st["done"] >= L:
                del self._chunked[slot]
                self.page_table[slot] = st["table"]
                self._page_table_dirty = True
                first = int(self._first_tokens(logits, [req], 1)[0])
                self._start_decode(slot, req, first, lslot, self.now())
                self._end_placement([req], [slot])

    # ------------------------------------------- KV handoff (disagg)
    def begin_migration(self, req: Request) -> Optional[dict]:
        """Detach ``req`` from decode and copy its KV out for a
        prefill->decode handoff (``serving/disagg.py``). Returns the
        shipment, or None when the request cannot migrate (mid-chunk,
        finished, or not here).

        The slot is not freed: ``slot_req`` stays set, and the pool
        holds and shared-page refs stay live, so neither the prefix
        tree's eviction nor a cache shrink can take the pages. The
        request enters MIGRATING; ``complete_migration`` (the shipment
        landed) or ``abort_migration`` (cancel, deadline) releases it.
        The in-flight horizon is drained first, so the pending token and
        ``req.generated`` are current.
        """
        self._sync_inflight()
        slot = next((i for i, r in enumerate(self.slot_req) if r is req),
                    None)
        if slot is None or slot in self._chunked \
                or not self.active[slot] or req.terminal:
            return None
        cache_len = req.input_len + req.generated - 1
        pending = int(self.tokens[slot, 0])
        if self.paged:
            pages = self.slot_pages[slot][:self.pool.pages_for(cache_len)]
            k_pay, v_pay = (_payload(self._pages_read(t, pages))
                            for t in self.kv_pages)
        else:
            k_pay, v_pay = (_payload(self._rows_read(t, slot, cache_len))
                            for t in self.kv)
        rid = req.req_id
        shipment = {
            "req": req,
            "cache_len": cache_len,
            "pending_token": pending,
            "paged": self.paged,
            "k": k_pay, "v": v_pay,
            "nbytes": int(k_pay.nbytes + v_pay.nbytes),
            # Streamed-token state moves with the request, so the decode
            # replica's bookkeeping (positions, TBT reference point)
            # continues where the source stopped.
            "outputs": self.outputs.pop(rid, []),
            "tbts": self._tbts.pop(rid, []),
            "last_tok": self._last_tok.pop(rid, None),
            "handle": self.handles.pop(rid, None),
        }
        req.state = RequestState.MIGRATING
        self.active[slot] = False
        self._migrating[rid] = slot
        self.batch_epoch += 1
        return shipment

    def complete_migration(self, req: Request) -> None:
        """The shipment landed on the decode replica: release this end
        (adapter pin, KV pages, the slot)."""
        slot = self._migrating.pop(req.req_id, None)
        if slot is None:
            return
        self.sched.on_finish(req, self.now())
        self._free_slot_pages(slot, req.req_id)
        self.slot_req[slot] = None
        self.batch_epoch += 1
        if self.spec:
            self._draft_len[slot] = 0    # draft KV freed with the slot
        self.n_kv_exports += 1

    def abort_migration(self, req: Request,
                        state: RequestState = RequestState.CANCELLED,
                        shipment: Optional[dict] = None) -> bool:
        """Cancel or deadline expiry while MIGRATING: finalize on the
        source (the destination never saw the request). A shipment
        passed back restores the streamed-token records export popped,
        so ``handle.result()`` reports what the user saw."""
        slot = self._migrating.pop(req.req_id, None)
        if slot is None:
            return False
        if shipment is not None:
            rid = req.req_id
            self.outputs[rid] = list(shipment["outputs"])
            self._tbts[rid] = list(shipment["tbts"])
            if shipment["handle"] is not None:
                self.handles[rid] = shipment["handle"]
        self._finalize_slot(slot, state)
        return True

    def import_request_kv(self, shipment: dict) -> bool:
        """Decode-replica end of the handoff: pin the adapter, reserve
        pages (or slab tokens), write the shipped KV into this engine's
        pool in place, restore the streamed-token state and join the
        decode batch. Returns False, holding nothing, when a slot, the
        adapter or pages are not available; the caller retries.

        An adapter load this triggers is flushed synchronously: the
        modeled H2D time overlapped the KV transfer on the link, and the
        disagg router pre-warms decode replicas."""
        self._sync_inflight()
        req = shipment["req"]
        free = self._free_slots()
        if not free:
            return False
        slot = free[0]
        now = self.now()
        aid = req.adapter_id
        rid = req.req_id
        cache_len = shipment["cache_len"]
        protect = self.sched.queued_adapter_ids() - {aid}
        need = (self.pool.pages_for(cache_len) * self.pool.page_size
                if self.paged else req.input_len + req.predicted_output)
        extra = (0 if self.cache.resident(aid)
                 else self.catalog.infos[aid].size_tokens)
        if not self.cache.shrink_for_requests(need + extra, now, protect):
            return False
        try:
            self.cache.acquire(aid, now, queued_protect=protect)
        except PoolError:
            return False
        if not self.cache.is_ready(aid):
            self.flush_loads()
        self.slot_req[slot] = req
        if self.paged:
            if not self._grow_slot(slot, self.pool.pages_for(cache_len),
                                   now):
                self.slot_req[slot] = None
                self.cache.release(aid, now)
                return False
            for t, pay in zip(self.kv_pages, (shipment["k"], shipment["v"])):
                self._pages_write(t, self.slot_pages[slot], pay)
        else:
            try:
                self.pool.reserve_request(rid, need)
            except PoolError:
                self.slot_req[slot] = None
                self.cache.release(aid, now)
                return False
            req.reserved_tokens = need
            for t, pay in zip(self.kv, (shipment["k"], shipment["v"])):
                self._rows_write(t, slot, pay)
        req.adapter_ref = True
        self.active[slot] = True
        self.tokens[slot, 0] = shipment["pending_token"]
        self.cache_len[slot] = cache_len
        self.adapter_slot[slot] = self.slot_of[aid]
        self.outputs[rid] = list(shipment["outputs"])
        self._tbts[rid] = list(shipment["tbts"])
        if shipment["last_tok"] is not None:
            self._last_tok[rid] = shipment["last_tok"]
        if shipment["handle"] is not None:
            self.handles[rid] = shipment["handle"]
        req.state = RequestState.RUNNING
        if req.deadline is not None:
            self._deadlines_armed = True
        self.batch_epoch += 1
        self.n_kv_imports += 1
        self.kv_handoff_bytes += shipment["nbytes"]
        return True

    def _hit_stop(self, req: Request) -> bool:
        """Did the latest recorded token hit a SamplingParams stop id?"""
        sp = req.sampling
        if sp is None or not sp.stop_token_ids:
            return False
        return self.outputs[req.req_id][req.generated - 1] \
            in sp.stop_token_ids

    @staticmethod
    def _all_greedy(reqs) -> bool:
        """With no stochastic row in the batch, sampling is argmax."""
        return all(r is None or r.sampling is None or r.sampling.greedy
                   for r in reqs)

    def _sampling_arrays(self, reqs, B: int, first: bool = False):
        """Per-row sampler inputs (device tensors) for a prefill batch
        (``first=True`` → all positions 0) or the decode batch
        (``reqs = slot_req``; inactive slots run greedy garbage)."""
        temp = np.zeros(B, np.float32)
        topk = np.zeros(B, np.int32)
        topp = np.ones(B, np.float32)
        seeds = np.zeros(B, np.int64)
        pos = np.zeros(B, np.int32)
        for i, req in enumerate(reqs):
            if req is None:
                continue
            sp = req.sampling
            if sp is not None and not sp.greedy:
                temp[i] = sp.temperature
                topk[i] = sp.top_k
                topp[i] = sp.top_p
                seeds[i] = sp.seed_for(req.req_id)
            if not first:
                pos[i] = req.generated
        return (self._tensor(temp, torch.float32),
                self._tensor(topk, torch.int32),
                self._tensor(topp, torch.float32),
                self._tensor(seeds, torch.int64),
                self._tensor(pos, torch.int32))

    def _finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        self._finalize_slot(slot, RequestState.CANCELLED
                            if req.cancel_requested
                            else RequestState.FINISHED)

    def _finalize_slot(self, slot: int, state: RequestState) -> None:
        """Terminal transition for the request occupying ``slot``;
        releases the slot, its KV pages and the scheduler/pool/cache
        holds. Only FINISHED contributes a RequestRecord."""
        req = self.slot_req[slot]
        req.state = state
        now = self.now()
        req.finish_time = now
        self.sched.on_finish(req, now)
        self._free_slot_pages(slot, req.req_id)
        self.active[slot] = False
        self.slot_req[slot] = None
        self.batch_epoch += 1
        if self.spec:
            self._draft_len[slot] = 0    # draft KV freed with the slot
        tbts = self._tbts.pop(req.req_id, [])
        req.preserved_tbts = tbts
        self._last_tok.pop(req.req_id, None)
        if state is RequestState.CANCELLED:
            self.n_cancelled += 1
            return
        if state is RequestState.EXPIRED:
            self.n_expired += 1
            return
        self.completed.append(req)
        self.records.append(RequestRecord(
            req_id=req.req_id, adapter_id=req.adapter_id,
            rank=self.catalog.rank_of(req.adapter_id),
            input_len=req.input_len, output_len=req.output_len,
            arrival=req.arrival_time,
            ttft=req.ttft() or 0.0, e2e=req.e2e() or 0.0,
            tbt_mean=float(np.mean(tbts)) if tbts else 0.0,
            tbt_p99=float(np.percentile(tbts, 99)) if tbts else 0.0,
            slowdown=1.0,
            squashes=req.squash_count, bypassed=req.bypassed,
            queue_wait=req.queue_wait() or 0.0,
            load_wait=req.adapter_load_wait))

    def _ensure_decode_pages(self, lens: Optional[np.ndarray] = None
                             ) -> None:
        """Grow each active slot to cover its next decode write; slots
        that cannot get a page are preempted. The fused loop passes
        host-derived lengths so this never syncs the device."""
        now = self.now()
        if lens is None:
            lens = self.cache_len.cpu().numpy()
        ps = self.pool.page_size
        for slot in np.where(self.active)[0]:
            needed = int(lens[slot]) // ps + 1
            short = needed - len(self.slot_pages[slot])
            if short > 0 and not self._grow_slot(int(slot), short, now):
                self._preempt(int(slot))

    def _run_prefetchers(self, now: float) -> None:
        """Ahead-of-demand loads into idle slots only (paper §4.1)."""
        if not self.free_slots:
            return
        queued = self.sched.queued_requests_in_order()
        if self.q_prefetch is not None and queued:
            self.q_prefetch.run(queued, now, budget=len(self.free_slots))
        if self.h_prefetch is not None and self.free_slots:
            self.h_prefetch.run(
                now, queued_protect={r.adapter_id for r in queued},
                budget=len(self.free_slots))

    def _sweep_lifecycle(self, now: float) -> None:
        """Reap queued requests past their deadline, then finalise
        active slots whose request was cancelled or expired."""
        if self._deadlines_armed:
            for req in self.sched.reap_expired(now):
                self._finalize_unplaced(req, RequestState.EXPIRED, now)
            self._deadlines_armed = (
                any(r is not None and r.deadline is not None
                    for r in self.slot_req)
                or any(r.deadline is not None
                       for r in self.sched.queued_requests_in_order()))
        self._cancel_armed = False
        for slot in np.where(self.active)[0]:
            req = self.slot_req[slot]
            if req.cancel_requested:
                self._finalize_slot(int(slot), RequestState.CANCELLED)
            elif req.deadline is not None and now >= req.deadline:
                self._finalize_slot(int(slot), RequestState.EXPIRED)
        # Mid-chunk prefills hold a slot and pages off the active mask.
        for slot in list(self._chunked):
            req = self._chunked[slot]["req"]
            if req.cancel_requested:
                del self._chunked[slot]
                self._finalize_slot(slot, RequestState.CANCELLED)
            elif req.deadline is not None and now >= req.deadline:
                del self._chunked[slot]
                self._finalize_slot(slot, RequestState.EXPIRED)
        if self._cancel_races:
            races, self._cancel_races = self._cancel_races, []
            for req in races:
                if not req.terminal:
                    self.cancel(req)

    def _idle_wait(self) -> None:
        """Idle with loads in flight: wait up to the earliest modeled
        readiness (never under an injected clock)."""
        if self._pending_loads and self._clock is None:
            t_next = min(t for _, t in self._pending_loads.values())
            wait = t_next - self.now()
            time.sleep(min(max(wait, 1e-4), 0.05))

    def step(self) -> None:
        """One engine iteration: retire loads -> lifecycle sweep -> admit
        -> prefetch -> batched prefill -> decode (one fused horizon, or
        the seed decode + sampling pair)."""
        if self.fused:
            return self._step_fused()
        return self._step_seed()

    def _step_seed(self) -> None:
        """The seed decode loop: one decode dispatch, logits to a second
        sampling dispatch, per-step page-table and sampling uploads and
        a blocking token sync before bookkeeping. Kept as the fused
        loop's A/B baseline; token-identical to it."""
        self._poll_loads()
        now = self.now()
        self._sweep_lifecycle(now)
        running = [r for r in self.slot_req if r is not None]
        admitted = self.sched.schedule(now, running)
        self._run_prefetchers(now)
        self._place_batch(admitted)
        self._advance_chunked()
        if self.paged:
            self._ensure_decode_pages()
        if not self.active.any():
            self._idle_wait()
            return
        self.batch_occupancy.append(int(self.active.sum()))
        DISPATCH_METER.tick()
        if self._collective:
            COLLECTIVE_METER.tick()
        kw = dict(lora=self.lora, adapter_idx=self._full(self.adapter_slot),
                  lora_backend=self._lora_backend)
        tokens, cache_len = self._full(self.tokens), self._full(self.cache_len)
        with self._act_scope():
            if self.paged:
                logits, self.kv_pages = api.decode_step_paged(
                    self.cfg, self.params, tokens, self.kv_pages,
                    self._tensor(self.page_table, torch.int32), cache_len,
                    **kw)
            else:
                logits, self.kv = api.decode_step(
                    self.cfg, self.params, tokens, self.kv, cache_len, **kw)
        DISPATCH_METER.tick()
        if self._all_greedy(self.slot_req):
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            nxt = api.sample_tokens(
                logits, *self._sampling_arrays(self.slot_req,
                                               self.ecfg.max_slots))
        self.tokens = self._keep(self.tokens, nxt[:, None])
        self.cache_len = self._keep(
            self.cache_len, cache_len + self._tensor(self.active, torch.int32))
        now = self.now()
        with DISPATCH_METER.sync():
            nxt_host = nxt.cpu().numpy()
        to_finish, to_squash = [], []
        for slot in np.where(self.active)[0]:
            req = self.slot_req[slot]
            pos = req.generated
            req.generated += 1
            self._record_token(req, pos, int(nxt_host[slot]), now)
            if req.done or self._hit_stop(req) \
                    or req.generated + req.input_len \
                    >= self.ecfg.max_len - 1:
                to_finish.append(slot)
            elif req.bypassed and req.exceeded_prediction():
                to_squash.append(slot)
        for slot in to_finish:
            self._finish(slot)
        for slot in to_squash:
            self._squash_slot(slot)

    # ------------------------------------ fused device-resident hot loop
    def _host_work_pending(self) -> bool:
        """Queued admissions, armed deadline/cancel sweeps, or in-flight
        adapter loads to poll."""
        return bool(self._deadlines_armed or self._cancel_armed
                    or self._cancel_races or self._pending_loads
                    or self._chunked
                    or self.sched.pending_count() > 0)

    def _refresh_device_state(self) -> None:
        """(Re)build the device-resident batch state, only when the
        batch epoch moved."""
        if self._dev_epoch == self.batch_epoch and self._dev is not None:
            return
        B = self.ecfg.max_slots
        reqs = self.slot_req
        temp, topk, topp, seeds, pos = self._sampling_arrays(reqs, B)
        budget = np.zeros(B, np.int32)
        n_stop = max((len(r.sampling.stop_token_ids) for r in reqs
                      if r is not None and r.sampling is not None),
                     default=0)
        stop = np.full((B, n_stop), -1, np.int32)
        for i, r in enumerate(reqs):
            if r is None:
                continue
            budget[i] = r.max_output_tokens
            if r.sampling is not None and r.sampling.stop_token_ids:
                stop[i, :len(r.sampling.stop_token_ids)] = \
                    r.sampling.stop_token_ids
        self._dev = dict(
            active=self._batch_put(self._tensor(self.active, torch.bool)),
            positions=self._batch_put(pos),
            budget=self._batch_put(self._tensor(budget, torch.int32)),
            stop=self._batch_put(self._tensor(stop, torch.int32)),
            temp=self._batch_put(temp), topk=self._batch_put(topk),
            topp=self._batch_put(topp), seeds=self._batch_put(seeds),
            all_greedy=self._all_greedy(reqs))
        self._dev_epoch = self.batch_epoch

    def _host_lens(self) -> np.ndarray:
        """cache_len from host truth (no device sync)."""
        lens = np.zeros(self.ecfg.max_slots, np.int64)
        for i, r in enumerate(self.slot_req):
            if r is not None:
                lens[i] = r.input_len + r.generated - 1
        return lens

    def _choose_horizon(self) -> int:
        """Adaptive micro-horizon K: 1 whenever the host may need to
        intervene between tokens, else up to ``max_horizon`` clamped by
        the longest surviving budget and any bypasser's squash point,
        bucketed to a power of two."""
        e = self.ecfg
        if e.max_horizon <= 1 or self._host_work_pending():
            return 1
        reqs = [r for r in self.slot_req if r is not None]
        if not reqs:
            return 1
        K = min(e.max_horizon,
                max(r.max_output_tokens - r.generated for r in reqs))
        for r in reqs:
            if r.bypassed:
                K = min(K, r.predicted_output - r.generated + 1)
        if K <= 1:
            return 1
        return 1 << (K.bit_length() - 1)

    def _page_cover(self) -> int:
        """Tokens writable from already-allocated pages, minimised over
        active slots (host truth)."""
        ps = self.pool.page_size
        cover = 1 << 30
        for slot in np.where(self.active)[0]:
            r = self.slot_req[slot]
            cover = min(cover, len(self.slot_pages[slot]) * ps
                        - (r.input_len + r.generated - 1))
        return cover

    def _page_table_device(self) -> torch.Tensor:
        """The page table on the device, uploaded only when it changed."""
        if self._page_table_dirty or self._page_table_dev is None:
            self._page_table_dev = self._tensor(self.page_table, torch.int32)
            self._page_table_dirty = False
        return self._page_table_dev

    def _to_host(self, t: torch.Tensor):
        """Start the device→host copy of a result block: into pinned
        memory behind an event on the card, plain on the CPU."""
        if t.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    # ------------------------------- speculative draft–verify dispatch
    def _spec_k_eff(self) -> int:
        """Adaptive draft length: the acceptance EWMA scales ``spec_k``
        down when drafts stop landing (a round costs ``kk + 1`` draft
        steps and one verify whatever is accepted), bucketed to a power
        of two."""
        e = self.ecfg
        kk = int(round(self._spec_ewma * (e.spec_k + 1)))
        kk = max(1, min(e.spec_k, kk))
        return 1 << (kk.bit_length() - 1)

    def _draft_sync(self) -> None:
        """Lazy draft-KV catch-up: replay through one batched
        multi-token draft pass (``api.verify`` with ``seq_len`` over the
        draft slab) every token the target cache holds and the draft
        cache does not. Placement, prefix hits, chunked prefill, KV
        import and squash re-execution all advance the target without
        the draft; the tokens come from host truth (prompt + recorded
        outputs), so the draft prefix is the same on every
        re-execution."""
        lens = self._host_lens()
        rows = [int(s) for s in np.where(self.active)[0]
                if self._draft_len[s] < lens[s]]
        if not rows:
            return
        gap = max(int(lens[s] - self._draft_len[s]) for s in rows)
        S = 1 << max(3, (gap - 1).bit_length())
        B = self.ecfg.max_slots
        toks = np.zeros((B, S), np.int32)
        start = np.zeros(B, np.int32)
        seq = np.zeros(B, np.int32)
        for s in rows:
            req = self.slot_req[s]
            full = np.concatenate([
                self._prompt_tokens(req),
                np.asarray(self.outputs[req.req_id], np.int32)])
            lo, hi = int(self._draft_len[s]), int(lens[s])
            toks[s, :hi - lo] = full[lo:hi]
            start[s] = lo
            seq[s] = hi - lo
        DISPATCH_METER.tick()
        DISPATCH_METER.tick_draft()
        self.n_spec_draft_dispatches += 1
        i32 = torch.int32
        _, self.draft_kv = api.verify(
            self.draft_cfg, self.draft_params, self._tensor(toks, i32),
            self.draft_kv, self._tensor(start, i32),
            seq_len=self._tensor(seq, i32))
        for s in rows:
            self._draft_len[s] = int(lens[s])

    def _shrink_spec_pages(self) -> None:
        """Roll back speculative page growth: after the block drained,
        every surviving slot keeps exactly the pages the seed loop
        would hold (``len // ps + 1``, the next write covered); the rest
        go back to the free list and the pool hold shrinks to match."""
        ps = self.pool.page_size
        lens = self._host_lens()
        for slot in np.where(self.active)[0]:
            req = self.slot_req[slot]
            if req is None:
                continue
            keep = int(lens[slot]) // ps + 1
            extra = len(self.slot_pages[slot]) - keep
            if extra <= 0:
                continue
            for _ in range(extra):
                pid = self.slot_pages[slot].pop()
                self.page_table[slot, len(self.slot_pages[slot])] = 0
                self.free_pages.append(pid)
            self.pool.shrink_request(req.req_id, extra * ps)
            self._page_table_dirty = True

    def _dispatch_spec(self) -> bool:
        """One speculative block: draft catch-up, then ``n_rounds``
        draft–verify rounds, drained synchronously (emission counts are
        data-dependent, so the pipelined page math cannot cover it).
        Returns False (the caller runs the normal horizon) when
        speculation is not viable this step: nothing to decode, a
        bypasser's squash point inside the round, no context headroom,
        or (paged) not one round of page cover after best-effort
        growth. Speculation only shrinks on pressure; it never preempts
        a slot to grow. Called with no horizon in flight (``_step_fused``
        drains it first)."""
        e = self.ecfg
        reqs = [r for r in self.slot_req if r is not None]
        if not reqs or max(r.max_output_tokens - r.generated
                           for r in reqs) < 1:
            return False
        kk = self._spec_k_eff()
        has_bypass = False
        for r in reqs:
            # A bypasser squashes on the token past its predicted
            # length: the round must end at or before that point.
            if r.bypassed:
                has_bypass = True
                kk = min(kk, r.predicted_output - r.generated)
        lens = self._host_lens()
        for slot in np.where(self.active)[0]:
            # Rows at the context edge finish within a step or two.
            kk = min(kk, e.max_len - 2 - int(lens[slot]))
        if kk < 1:
            return False
        kk = 1 << (kk.bit_length() - 1)
        n_rounds = 1 if has_bypass else max(1, e.max_horizon // (kk + 1))
        if self.paged:
            now = self.now()
            ps = self.pool.page_size
            need = n_rounds * (kk + 1)
            for slot in np.where(self.active)[0]:
                needed = (int(lens[slot]) + need - 1) // ps + 1
                short = needed - len(self.slot_pages[slot])
                if short > 0:
                    self._grow_slot(int(slot), short, now)  # best effort
            cover = self._page_cover()
            while n_rounds > 1 and n_rounds * (kk + 1) > cover:
                n_rounds -= 1
            if kk + 1 > cover:
                kk = cover - 1
                if kk < 1:
                    self._shrink_spec_pages()
                    return False
                kk = 1 << (kk.bit_length() - 1)
        self._refresh_device_state()
        self._draft_sync()
        d = self._dev
        DISPATCH_METER.tick()
        DISPATCH_METER.tick_draft(n_rounds * (kk + 1))
        DISPATCH_METER.tick_verify(n_rounds)
        self.n_spec_dispatches += 1
        self.n_spec_draft_dispatches += n_rounds * (kk + 1)
        self.n_spec_verify_dispatches += n_rounds
        state = (d["active"], d["positions"], d["budget"], d["stop"],
                 d["temp"], d["topk"], d["topp"], d["seeds"])
        kw = dict(spec_k=kk, n_rounds=n_rounds, all_greedy=d["all_greedy"],
                  max_ctx=e.max_len, lora=self.lora,
                  adapter_idx=self.adapter_slot,
                  lora_backend=self._lora_backend)
        if self.paged:
            carry, toks, emits, accs = api.decode_spec_fused_paged(
                self.cfg, self.params, self.draft_cfg, self.draft_params,
                self.tokens, self.kv_pages, self._page_table_device(),
                self.draft_kv, self.cache_len, *state, **kw)
            (self.tokens, self.kv_pages, self.draft_kv, self.cache_len,
             d["active"], d["positions"]) = carry
        else:
            carry, toks, emits, accs = api.decode_spec_fused(
                self.cfg, self.params, self.draft_cfg, self.draft_params,
                self.tokens, self.kv, self.draft_kv, self.cache_len,
                *state, **kw)
            (self.tokens, self.kv, self.draft_kv, self.cache_len,
             d["active"], d["positions"]) = carry
        self._inflight = (self._to_host(toks), self._to_host(emits),
                          n_rounds * (kk + 1),
                          (self._to_host(accs), kk, n_rounds))
        self._drain_inflight()
        # The draft cache advanced in lockstep with the target for every
        # surviving slot (entries past the accepted prefix are
        # overwritten before the next read, as the target's are);
        # finished and squashed slots were cleared by their hooks.
        lens = self._host_lens()
        for slot in range(e.max_slots):
            if self.active[slot] and self.slot_req[slot] is not None:
                self._draft_len[slot] = int(lens[slot])
        if self.paged:
            self._shrink_spec_pages()
        return True

    def _dispatch_horizon(self, K: int, refresh: bool = True) -> None:
        """Launch one fused K-step horizon and re-point the engine's
        device state at its outputs. ``refresh=False`` (pipelined
        dispatch): the carried device state is the only truth — host
        truth lags by the in-flight horizon."""
        if refresh:
            self._refresh_device_state()
        d = self._dev
        DISPATCH_METER.tick()
        if self._collective:
            COLLECTIVE_METER.tick()
        state = tuple(self._full(d[k]) for k in (
            "active", "positions", "budget", "stop", "temp", "topk", "topp",
            "seeds"))
        kw = dict(n_steps=K, all_greedy=d["all_greedy"],
                  max_ctx=self.ecfg.max_len, lora=self.lora,
                  adapter_idx=self._full(self.adapter_slot),
                  lora_backend=self._lora_backend)
        tokens, cache_len = self._full(self.tokens), self._full(self.cache_len)
        with self._act_scope():
            if self.paged:
                carry, toks, emits = api.decode_fused_paged(
                    self.cfg, self.params, tokens, self.kv_pages,
                    self._page_table_device(), cache_len, *state, **kw)
                tokens, self.kv_pages, cache_len, active, positions = carry
            else:
                carry, toks, emits = api.decode_fused(
                    self.cfg, self.params, tokens, self.kv, cache_len,
                    *state, **kw)
                tokens, self.kv, cache_len, active, positions = carry
        self.tokens = self._keep(self.tokens, tokens)
        self.cache_len = self._keep(self.cache_len, cache_len)
        d["active"] = self._keep(d["active"], active)
        d["positions"] = self._keep(d["positions"], positions)
        self._inflight = (self._to_host(toks), self._to_host(emits), K)

    def _drain_inflight(self) -> None:
        """Sync the in-flight horizon's token block and replay the seed
        loop's per-token bookkeeping from it. A speculative block also
        carries (accepted counts, kk, n_rounds) for the spec gauges."""
        if self._inflight is None:
            return
        toks, emits, _K = self._inflight[:3]
        spec_meta = self._inflight[3] if len(self._inflight) > 3 else None
        self._inflight = None
        blocks = [toks, emits] + ([spec_meta[0]] if spec_meta else [])
        with DISPATCH_METER.sync():
            for _, ev in blocks:
                if ev is not None:
                    ev.synchronize()
            toks_h, emits_h, *accs_h = [t.numpy() for t, _ in blocks]
        if spec_meta is not None:
            # Emissions are per-round prefix-masked (round r emits its
            # first cnt[b] of kk+1 slots), so a rejected round leaves
            # empty *interior* steps; step 0 of each round is emitted by
            # every row active then, which counts the drafted tokens.
            _, kk, n_rounds = spec_meta
            round_act = emits_h.reshape(n_rounds, kk + 1, -1)[:, 0, :]
            drafted = int(round_act.sum()) * kk
            accepted = int(accs_h[0].sum())
            self.spec_drafted_tokens += drafted
            self.spec_accepted_tokens += accepted
            if drafted:
                self._spec_ewma = (0.8 * self._spec_ewma
                                   + 0.2 * accepted / drafted)
        now = self.now()
        for k in range(toks_h.shape[0]):
            em = emits_h[k]
            if not em.any():
                if spec_meta is not None:
                    continue        # interior rejection gap
                break               # every row finished earlier
            self.batch_occupancy.append(int(em.sum()))
            to_finish, to_squash = [], []
            for slot in np.where(em)[0]:
                req = self.slot_req[slot]
                if req is None:
                    continue        # squashed at an earlier sub-step
                pos = req.generated
                req.generated += 1
                self._record_token(req, pos, int(toks_h[k, slot]), now)
                if req.done or self._hit_stop(req) \
                        or req.generated + req.input_len \
                        >= self.ecfg.max_len - 1:
                    to_finish.append(int(slot))
                elif req.bypassed and req.exceeded_prediction():
                    to_squash.append(int(slot))
            for slot in to_finish:
                self._finish(slot)
            for slot in to_squash:
                self._squash_slot(slot)

    def _sync_inflight(self) -> None:
        """Barrier: retire any dispatched-but-unsynced horizon so host
        records are complete (stats resets, migrations)."""
        self._drain_inflight()

    def _plan_pipelined_horizon(self) -> Optional[int]:
        """Whether the *next* horizon can be dispatched from the carried
        device state before the in-flight one is synced; returns its K
        or None to sync first (every bound assumes the worst case of
        the in-flight K)."""
        e = self.ecfg
        if (not e.pipeline_readback or self._inflight is None
                or self._host_work_pending()):
            return None
        k_in = self._inflight[2]
        alive = 0
        for r in self.slot_req:
            if r is None or (r.sampling is not None
                             and r.sampling.stop_token_ids):
                continue        # a stop token could end the row any step
            rem = r.max_output_tokens - r.generated - k_in
            rem = min(rem, (e.max_len - 1 - r.input_len
                            - r.generated - k_in))
            alive = max(alive, rem)
        if alive <= 0:
            return None
        K = min(e.max_horizon, alive)
        for r in self.slot_req:
            if r is not None and r.bypassed:
                K = min(K, r.predicted_output - r.generated - k_in + 1)
        if K < 1:
            return None
        if self.paged:
            # Host truth lags by the in-flight writes; existing pages
            # must cover those plus the next horizon.
            K = min(K, self._page_cover() - k_in)
            if K < 1:
                return None
        return 1 << (K.bit_length() - 1)

    def _step_fused(self) -> None:
        """One fused-loop iteration. Steady state: dispatch horizon N+1
        from the carried device state, *then* sync horizon N. Pending
        host work first syncs, then runs the seed loop's admit/place
        path."""
        self._poll_loads()
        if self._inflight is not None:
            k_next = self._plan_pipelined_horizon()
            if k_next is not None:
                prev, self._inflight = self._inflight, None
                self._dispatch_horizon(k_next, refresh=False)
                nxt, self._inflight = self._inflight, prev
                self._drain_inflight()
                self._inflight = nxt
                return
            self._drain_inflight()
        now = self.now()
        self._sweep_lifecycle(now)
        running = [r for r in self.slot_req if r is not None]
        admitted = self.sched.schedule(now, running)
        self._run_prefetchers(now)
        self._place_batch(admitted)
        self._advance_chunked()
        if self.paged:
            self._ensure_decode_pages(self._host_lens())
        if not self.active.any():
            self._idle_wait()
            return
        K = self._choose_horizon()
        if self.spec and K > 1 and self._dispatch_spec():
            # Speculative block dispatched and drained; the K=1
            # demotions (backlog, armed sweeps, loads) keep speculation
            # off for the step, like the horizon collapse.
            return
        if self.paged and K > 1:
            # Clamp to allocated pages (allocation timing stays
            # seed-equal).
            K = 1 << (max(1, min(K, self._page_cover())).bit_length() - 1)
        self._dispatch_horizon(K)
        if not self.ecfg.pipeline_readback:
            self._drain_inflight()

    def busy(self) -> bool:
        """Work in flight or queued. Mid-prefill chunked slots count;
        MIGRATING slots do not (the disagg cluster's ``busy`` covers
        shipments in flight)."""
        return (bool(self.active.any()) or bool(self._chunked)
                or self.sched.pending_count() > 0)

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.busy():
                break
            self.step()

    drain = run_until_drained

    def reset_stats(self) -> None:
        """Clear accounting after a warmup pass; device state and cache
        residency are kept."""
        self._sync_inflight()
        self.flush_loads()
        self.completed = []
        self.records = []
        self.outputs = {}
        self._tbts = {}
        self._last_tok = {}
        self.handles = {}
        self.batch_occupancy = []
        self.n_preempted = 0
        self.n_cancelled = 0
        self.n_expired = 0
        self.n_async_loads = 0
        self.n_chunked_prefills = 0
        self.n_kv_exports = 0
        self.n_kv_imports = 0
        self.kv_handoff_bytes = 0
        # Speculation accounting restarts; the acceptance EWMA stays
        # warm (like cache residency), so the measured run speculates at
        # the adapted spec_k.
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        self.n_spec_dispatches = 0
        self.n_spec_draft_dispatches = 0
        self.n_spec_verify_dispatches = 0
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        self.n_prefix_hits = 0
        self.n_cow_forks = 0
        if self.prefix is not None:
            self.prefix.evictions = 0
            self.prefix.inserts = 0
        self.cache.stats = CacheStats()
        for counter in ("n_bypassed", "n_squashed", "n_deferred"):
            if hasattr(self.sched, counter):
                setattr(self.sched, counter, 0)

    # ---------------------------------------------------------- reporting
    def queue_pressure(self) -> float:
        """Routing signal: scheduler backlog plus occupied batch slots."""
        return self.sched.queue_pressure() + float(self.active.sum())

    def kv_page_stats(self) -> dict:
        """Page-occupancy telemetry (empty for the dense slab)."""
        if not self.paged:
            return {}
        total = self.n_pages - 1     # page 0 is the trash page
        used = total - len(self.free_pages)
        return {"kv_pages_used": used, "kv_pages_total": total,
                "kv_page_util": used / max(1, total),
                "preempted": self.n_preempted}

    def handoff_stats(self) -> dict:
        """Chunked-prefill and KV-handoff gauges (empty when unused)."""
        if not (self.n_chunked_prefills or self.n_kv_exports
                or self.n_kv_imports or self._chunked
                or self._migrating):
            return {}
        return {"chunked_prefills": self.n_chunked_prefills,
                "kv_exports": self.n_kv_exports,
                "kv_imports": self.n_kv_imports,
                "kv_handoff_gb": round(self.kv_handoff_bytes / 1e9, 6),
                "migrating": len(self._migrating)}

    def prefix_stats(self) -> dict:
        """Prefix-reuse gauges (empty when the cache is off)."""
        if self.prefix is None:
            return {}
        return {
            "prefix_hit_rate": round(
                self.prefix_hit_tokens
                / max(1, self.prefix_lookup_tokens), 4),
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_lookup_tokens": self.prefix_lookup_tokens,
            "prefix_hits": self.n_prefix_hits,
            "prefix_shared_pages": self.pool.n_shared_pages,
            "prefix_nodes": len(self.prefix),
            "prefix_evictions": self.prefix.evictions,
            "cow_forks": self.n_cow_forks,
        }

    def spec_stats(self) -> dict:
        """Speculative-decoding gauges (empty when spec is off).
        Acceptance is drafted-token yield: accepted over drafted
        proposals (``spec_k_eff`` a row a round); every round also
        emits its correction or bonus token. The dispatch counters split
        the device work into draft forwards (proposal steps and
        catch-up passes) and multi-token target verifies."""
        if not self.spec:
            return {}
        return {
            "spec_accept_rate": round(
                self.spec_accepted_tokens
                / max(1, self.spec_drafted_tokens), 4),
            "spec_drafted_tokens": self.spec_drafted_tokens,
            "spec_accepted_tokens": self.spec_accepted_tokens,
            "spec_draft_dispatches": self.n_spec_draft_dispatches,
            "spec_verify_dispatches": self.n_spec_verify_dispatches,
            "spec_dispatches": self.n_spec_dispatches,
            "spec_k_eff": self._spec_k_eff(),
        }

    def shard_stats(self) -> dict:
        """Per-device data-plane gauges (empty dict off-mesh): physical
        page occupancy per data shard, resident LoRA-arena bytes per
        device, and the gather gauges of the COLLECTIVE_METER probe."""
        if self.mesh is None:
            return {}
        out = {
            "mesh_shape": [self.mesh.shape["data"],
                           self.mesh.shape["model"]],
            "n_devices": self.mesh.size,
        }
        if self.paged:
            ds = self.mesh.shape["data"]
            stride = self.n_pages // ds
            per = [0] * ds
            used = set(range(1, self.n_pages)) - set(self.free_pages)
            for pid in used:
                per[pid // stride] += 1
            out["per_shard_pages_used"] = per
            out["per_shard_pages_total"] = stride
        # Actual bytes one device holds for the slot arena — with B
        # sharded over "model" this is arena_bytes/model_size + the
        # replicated A halves.
        out["per_shard_lora_slot_bytes"] = sum(
            a.nbytes_per_device() + b.nbytes_per_device()
            for a, b in self.lora.values())
        if self._collective:
            out["collective_frac"] = round(COLLECTIVE_METER.frac(), 4)
            out["collective_dispatches"] = COLLECTIVE_METER.dispatches
            out["collective_gathers"] = COLLECTIVE_METER.gathers
        return out

    def stats(self) -> dict:
        return {
            "completed": len(self.completed),
            "cache": self.cache.stats.__dict__.copy(),
            "bypassed": getattr(self.sched, "n_bypassed", 0),
            "squashed": getattr(self.sched, "n_squashed", 0),
            "deferred": getattr(self.sched, "n_deferred", 0),
            "cancelled": self.n_cancelled,
            "expired": self.n_expired,
            "async_loads": self.n_async_loads,
            "pending_loads": len(self._pending_loads),
            "resident_adapters": sorted(self.cache.resident_ids()),
            "pool": self.pool.snapshot(),
            "fused_hotloop": self.fused,
            "batch_epoch": self.batch_epoch,
            **self.kv_page_stats(),
            **self.handoff_stats(),
            **self.prefix_stats(),
            **self.spec_stats(),
            **self.shard_stats(),
        }

    def metrics(self) -> RunMetrics:
        """Per-node RunMetrics, aggregatable at cluster level."""
        n_sub = (len(self.records) + int(self.active.sum())
                 + self.sched.pending_count())
        m = RunMetrics(records=list(self.records), horizon=self.now(),
                       n_submitted=n_sub)
        m.cache_stats = {
            "hit_rate": round(self.cache.stats.hit_rate, 4),
            "hits": self.cache.stats.hits,
            "misses": self.cache.stats.misses,
            "evictions": self.cache.stats.evictions,
            "gb_loaded": round(self.cache.stats.bytes_loaded / 1e9, 6),
        }
        m.sched_stats = {
            "bypassed": getattr(self.sched, "n_bypassed", 0),
            "squashed": getattr(self.sched, "n_squashed", 0),
            "deferred": getattr(self.sched, "n_deferred", 0),
            "cancelled": self.n_cancelled,
            "expired": self.n_expired,
            "async_loads": self.n_async_loads,
            "pressure": round(self.queue_pressure(), 3),
            "batch_occupancy_mean": round(
                float(np.mean(self.batch_occupancy))
                if self.batch_occupancy else 0.0, 3),
            **self.kv_page_stats(),
            **self.handoff_stats(),
            **self.prefix_stats(),
            **self.spec_stats(),
            **self.shard_stats(),
        }
        return m
