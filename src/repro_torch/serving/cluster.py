"""Cluster-level routing over Chameleon nodes (paper §6: node-level
Chameleon composes with cluster schedulers like Llumnix/dLoRA).

Two data planes share one routing brain (DESIGN §3):

- ``Cluster``        — N independent NodeSimulators (DES, calibrated
  cost model): production-scale traffic in seconds of wall time;
- ``EngineCluster``  — N real ``ChameleonEngine`` replicas (jit'd
  prefill/decode on real tokens) sharing one ``AdapterCatalog``, so
  the paper's cluster story is exercised against real batched
  execution, not only the simulator.

Routing policies (``Router``):

- ``round_robin`` / ``random``  — baselines;
- ``least_loaded``              — lowest queue-pressure signal;
- ``adapter_affinity``          — prefer a node where the request's
  adapter is (or was recently) resident; first-touch adapters place on
  the least-loaded node; a *consistent hash* (rendezvous) of the
  adapter id is the fallback whenever no load feed is available, so
  routing stays deterministic and cache-friendly even when the
  frontend cannot scrape queue depths; when the affinity target is
  overloaded relative to the least-loaded node, spill to least-loaded
  (the bounded fallback that avoids dLoRA's imbalance trap). Affinity
  is the cluster policy the Chameleon cache makes profitable: it
  raises hit rates and cuts host->device adapter traffic without
  load-imbalance pathologies.
- ``prefix_affinity``             — consistent hash of the prompt's
  first KV page of token ids, so same-preamble requests land where the
  radix prefix tree (PR 6) is warm; spills to least-loaded like
  adapter_affinity when the target is overloaded. Promptless requests
  fall back to adapter-keyed hashing.

Nodes run independently (no cross-node migration — the paper treats
migration as out of scope; the *disaggregated* cluster in
``serving/disagg.py`` relaxes exactly this, migrating each request
once, prefill→decode, over an explicit KV handoff plane) and metrics
merge via ``metrics.merge_metrics``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

from .handles import DRAIN_MAX_STEPS
from .metrics import RunMetrics, merge_metrics
from .systems import NodeConfig, build_node
from .trace import Trace, TraceConfig, synthesize

POLICIES = ("round_robin", "random", "least_loaded", "adapter_affinity",
            "prefix_affinity")


def _stable_hash(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


def prefix_route_key(req, page_size: int = 16):
    """Routing key for ``prefix_affinity``: the prompt's first KV page
    of token ids. Two requests sharing a system prompt/few-shot
    preamble agree on this key, so a consistent hash of it lands them
    on the same replica — the one whose radix tree (PR 6) already holds
    their preamble's pages. Requests without real prompt tokens fall
    back to adapter-keyed routing (None)."""
    if req.prompt is None or len(req.prompt) == 0:
        return None
    return tuple(req.prompt[:page_size])


class Router:
    """Routing policy shared by the DES cluster and the engine cluster.

    The caller supplies, per decision, the live per-node load signal
    (queue pressure) and optionally per-node residency of the request's
    adapter; the router owns only policy state (RR counter, RNG,
    affinity hints, rendezvous hash).
    """

    def __init__(self, policy: str, n_nodes: int,
                 overload_factor: float = 1.5, seed: int = 0):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        self.policy = policy
        self.n = n_nodes
        self.overload_factor = overload_factor
        self.rng = np.random.default_rng(seed)
        self._rr = 0
        self._hint: dict[int, int] = {}         # adapter -> last node

    def _hash_key(self, key: str, nodes=None) -> int:
        """Rendezvous (highest-random-weight) hash: deterministic,
        uniform, and adding/removing a node only remaps ~1/N keys."""
        nodes = range(self.n) if nodes is None else nodes
        return max(nodes, key=lambda nd: _stable_hash(f"{key}:n{nd}"))

    def _hash_node(self, adapter_id: int, nodes=None) -> int:
        return self._hash_key(f"a{adapter_id}", nodes)

    def route(self, adapter_id: int, loads=None,
              resident=None, prefix_key=None) -> int:
        """Pick a node.

        ``loads``: per-node queue-pressure signal, or None when the
        frontend has no load feed (then affinity degrades to pure
        consistent hashing — still deterministic and cache-friendly);
        ``resident``: optional per-node bool, adapter currently cached;
        ``prefix_key``: ``prefix_route_key(req)`` output, consumed only
        by the ``prefix_affinity`` policy.
        """
        if self.policy == "round_robin":
            node = self._rr
            self._rr = (self._rr + 1) % self.n
            return node
        if self.policy == "random":
            return int(self.rng.integers(0, self.n))
        if loads is not None:
            loads = np.asarray(loads, dtype=float)
            least = int(np.argmin(loads))
        elif self.policy == "least_loaded":
            raise ValueError("least_loaded routing needs a load signal")
        # adapter_affinity: live residency beats the stale hint beats
        # load-based (or hash-based, without a load feed) placement.
        if self.policy == "least_loaded":
            return least
        if self.policy == "prefix_affinity":
            # Consistent hash of the prompt's first page of token ids:
            # same-preamble requests converge on the replica whose radix
            # tree already holds their prefix pages, so the suffix-only
            # prefill (PR 6) actually fires cluster-wide. Promptless
            # requests degrade to adapter-keyed hashing; an overloaded
            # target spills to least-loaded exactly like
            # adapter_affinity (warmth is worthless behind a deep queue).
            target = (self._hash_key(f"p{_stable_hash(repr(prefix_key))}")
                      if prefix_key is not None
                      else self._hash_node(adapter_id))
            if loads is not None and loads[target] \
                    > self.overload_factor * max(1.0, loads[least]):
                target = least
            return target
        target = None
        if resident is not None:
            res_nodes = [i for i, r in enumerate(resident) if r]
            if res_nodes:
                target = (min(res_nodes, key=lambda i: loads[i])
                          if loads is not None
                          else self._hash_node(adapter_id, res_nodes))
        if target is None:
            target = self._hint.get(adapter_id)
        if target is None:
            # First touch: the adapter is resident nowhere, so there is
            # no locality to honour — place by load when we can see it,
            # by consistent hash when we cannot.
            target = least if loads is not None \
                else self._hash_node(adapter_id)
        if loads is not None and loads[target] \
                > self.overload_factor * max(1.0, loads[least]):
            # Affinity target overloaded: spill and move the hint
            # (dLoRA's imbalance trap, bounded).
            target = least
        self._hint[adapter_id] = target
        return target


# ===================================================================
# Simulator-backed cluster (DES nodes, calibrated cost model)
# ===================================================================
@dataclass
class ClusterConfig:
    n_nodes: int = 4
    system: str = "chameleon"
    policy: str = "adapter_affinity"   # see POLICIES
    affinity_overload_factor: float = 1.5
    node: NodeConfig = field(default_factory=NodeConfig)


class Cluster:
    def __init__(self, cfg: ClusterConfig):
        self.cfg = cfg
        self.nodes = []
        self.adapters = None
        for i in range(cfg.n_nodes):
            node_cfg = NodeConfig(**{**cfg.node.__dict__,
                                     "seed": cfg.node.seed + i})
            sim, adapters, cost = build_node(cfg.system, node_cfg)
            self.nodes.append(sim)
            self.adapters = adapters
        self.router = Router(cfg.policy, cfg.n_nodes,
                             cfg.affinity_overload_factor,
                             seed=cfg.node.seed)
        self._outstanding = np.zeros(cfg.n_nodes, int)
        self.n_submitted = 0

    # ----------------------------------------------- serving surface
    # The DES cluster serves the same ServingSystem protocol as
    # EngineCluster: submit routes on live queue pressure + residency
    # and returns a handle; step advances every node's virtual time.
    def submit(self, req, *, sampling=None, on_token=None, ttl=None):
        loads = [sim.queue_pressure() for sim in self.nodes]
        resident = [sim.cache.resident(req.adapter_id)
                    for sim in self.nodes]
        node = self.router.route(req.adapter_id, loads, resident,
                                 prefix_key=prefix_route_key(req))
        handle = self.nodes[node].submit(
            req, sampling=sampling, on_token=on_token, ttl=ttl)
        handle.node = node
        handle._system = self
        self.n_submitted += 1
        return handle

    def cancel(self, handle) -> bool:
        if handle.node is None:
            return False
        return self.nodes[handle.node].cancel(handle)

    def step(self) -> None:
        for sim in self.nodes:
            if sim.busy():
                sim.step()

    def busy(self) -> bool:
        return any(sim.busy() for sim in self.nodes)

    def drain(self, max_steps: int = DRAIN_MAX_STEPS) -> None:
        for _ in range(max_steps):
            if not self.busy():
                break
            self.step()

    def queue_pressure(self) -> float:
        return float(sum(sim.queue_pressure() for sim in self.nodes))

    def stats(self) -> dict:
        return {"per_node": [sim.stats() for sim in self.nodes]}

    def metrics(self) -> tuple[RunMetrics, list[RunMetrics]]:
        per_node = [sim.metrics() for sim in self.nodes]
        merged = merge_metrics(per_node,
                               n_submitted=self.n_submitted or None)
        return merged, per_node

    # ------------------------------------------------------------- run
    def run(self, trace: Trace) -> tuple[RunMetrics, list[RunMetrics]]:
        """Split the trace by routing policy, run nodes, merge metrics.

        Routing decisions use arrival order with an outstanding-count
        estimate decayed by each node's mean service rate (the DES runs
        nodes independently afterwards, so the estimate mirrors what a
        real router would know: queue depths at arrival time).
        """
        per_node: list[list] = [[] for _ in range(self.cfg.n_nodes)]
        # Outstanding estimate: arrivals minus estimated completions.
        finish_heaps = [list() for _ in range(self.cfg.n_nodes)]
        import heapq
        for req in sorted(trace.requests, key=lambda r: r.arrival_time):
            for i in range(self.cfg.n_nodes):
                h = finish_heaps[i]
                while h and h[0] <= req.arrival_time:
                    heapq.heappop(h)
                    self._outstanding[i] -= 1
            node = self.router.route(req.adapter_id, self._outstanding,
                                     prefix_key=prefix_route_key(req))
            per_node[node].append(req)
            self._outstanding[node] += 1
            est_service = 1.0 + 0.01 * req.output_len
            heapq.heappush(finish_heaps[node],
                           req.arrival_time + est_service)

        node_metrics = []
        for sim, reqs in zip(self.nodes, per_node):
            sub = Trace(requests=reqs, config=trace.config)
            node_metrics.append(sim.run(sub))
        merged = merge_metrics(node_metrics, n_submitted=trace.n)
        return merged, node_metrics


def run_cluster(policy: str, rps: float, n_nodes: int = 4,
                duration: float = 120.0, seed: int = 0,
                system: str = "chameleon"):
    cfg = ClusterConfig(n_nodes=n_nodes, system=system, policy=policy)
    cluster = Cluster(cfg)
    trace = synthesize(
        TraceConfig(rps=rps, duration_s=duration, seed=seed),
        list(cluster.adapters.values()))
    return cluster.run(trace)


# ===================================================================
# Real-engine cluster (N ChameleonEngine replicas, shared catalog)
# ===================================================================
@dataclass
class EngineClusterConfig:
    n_engines: int = 2
    system: str = "chameleon"          # see systems.ENGINE_SYSTEMS
    policy: str = "adapter_affinity"
    affinity_overload_factor: float = 1.5
    seed: int = 0


class _SharedClock:
    """Resettable monotonic clock shared by every replica in a cluster."""

    def __init__(self):
        import time as _time
        self._time = _time
        self.t0 = _time.monotonic()

    def reset(self) -> None:
        self.t0 = self._time.monotonic()

    def __call__(self) -> float:
        return self._time.monotonic() - self.t0


class EngineCluster:
    """N real JAX engines behind one router, one shared AdapterCatalog.

    Engines share host-side adapter weights (the catalog) and a wall
    clock, but own private device state — KV caches, adapter-slot
    buffers, pool/cache/scheduler — exactly like replicas on separate
    accelerators. The router sees live queue pressure and adapter
    residency, the signals a real cluster frontend would scrape.
    """

    def __init__(self, cfg, params, ecfg=None, ccfg=None, device=None):
        from .engine import AdapterCatalog, EngineConfig
        from .systems import build_engine

        self.ccfg = ccfg or EngineClusterConfig()
        self.ecfg = ecfg or EngineConfig()
        if self.ecfg.mesh_shape is not None:
            # N sharded replicas need N x mesh.size devices' worth of
            # hardware — reject over-subscription up front instead of
            # letting replica 2 OOM replica 1's HBM. (Single-device
            # replicas deliberately skip this: co-locating CPU replicas
            # on one host device is the normal CI topology.)
            from repro_torch.launch.mesh import device_count
            d, m = self.ecfg.mesh_shape
            need = self.ccfg.n_engines * d * m
            have = device_count(device)
            if need > have:
                raise ValueError(
                    f"EngineCluster: {self.ccfg.n_engines} replicas x "
                    f"mesh {tuple(self.ecfg.mesh_shape)} need {need} "
                    f"devices, only {have} available")
        self.catalog = AdapterCatalog(cfg, self.ecfg.n_adapters,
                                      self.ecfg.r_max, device=device,
                                      seed=self.ccfg.seed)
        self._clock = _SharedClock()
        self.engines = [
            build_engine(self.ccfg.system, cfg, params, self.ecfg,
                         device=device,
                         catalog=self.catalog, clock=self._clock)
            for _ in range(self.ccfg.n_engines)]
        self.router = Router(self.ccfg.policy, self.ccfg.n_engines,
                             self.ccfg.affinity_overload_factor,
                             seed=self.ccfg.seed)
        self.routed = np.zeros(self.ccfg.n_engines, int)
        self.n_submitted = 0

    def now(self) -> float:
        return self._clock()

    def warmup(self) -> None:
        """Force the dominant jit compiles (decode + one prefill bucket)
        on every replica, then reset stats and the shared clock so a
        subsequent replay measures steady-state serving, not XLA
        compilation. Every replica ends in the same warm state, so
        policy comparisons stay fair."""
        from repro_torch.core import Request
        for e in self.engines:
            e.submit(Request(input_len=8, output_len=2, adapter_id=0))
            e.drain()
            e.reset_stats()
        self._clock.reset()

    # ------------------------------------------------------------ serve
    def submit(self, req, *, sampling=None, on_token=None,
               ttl=None):
        """Route and enqueue; returns the request's ``RequestHandle``
        with ``handle.node`` set to the chosen replica (the handle
        subsumes the bare node index the old surface returned —
        cluster-level cancellation routes through it)."""
        loads = [e.queue_pressure() for e in self.engines]
        resident = [e.cache.resident(req.adapter_id)
                    for e in self.engines]
        node = self.router.route(
            req.adapter_id, loads, resident,
            prefix_key=prefix_route_key(req, self.ecfg.page_size))
        handle = self.engines[node].submit(
            req, sampling=sampling, on_token=on_token, ttl=ttl)
        handle.node = node
        handle._system = self      # stream() pumps the whole cluster
        self.routed[node] += 1
        self.n_submitted += 1
        return handle

    def cancel(self, handle) -> bool:
        """Cluster-level cancel: route to the replica that owns the
        request (``handle.node``)."""
        if handle.node is None:
            return False
        return self.engines[handle.node].cancel(handle)

    def step(self) -> None:
        for e in self.engines:
            e.step()

    def busy(self) -> bool:
        return any(e.busy() for e in self.engines)

    def queue_pressure(self) -> float:
        """Cluster backlog: summed replica pressure (routing inside the
        cluster uses the per-replica signals; this export is for
        stacking clusters behind a higher-level balancer)."""
        return float(sum(e.queue_pressure() for e in self.engines))

    def drain(self, max_steps: int = DRAIN_MAX_STEPS) -> None:
        for _ in range(max_steps):
            if not self.busy():
                break
            self.step()

    def run(self, requests, max_steps: int = 100_000,
            ) -> tuple[RunMetrics, list[RunMetrics]]:
        """Replay requests against the wall clock: submit each when its
        ``arrival_time`` passes, stepping all engines in between.

        ``max_steps`` bounds *engine* iterations only; idle gaps
        between arrivals sleep until the next arrival instead of
        spinning the budget away.
        """
        import time as _time
        import warnings

        pending = sorted(requests, key=lambda r: r.arrival_time)
        i = 0
        steps = 0
        while steps < max_steps:
            now = self.now()
            while i < len(pending) and pending[i].arrival_time <= now:
                self.submit(pending[i])
                i += 1
            if not self.busy():
                if i >= len(pending):
                    break
                _time.sleep(min(0.05, max(0.0,
                            pending[i].arrival_time - self.now())))
                continue
            self.step()
            steps += 1
        if i < len(pending) or self.busy():
            warnings.warn(
                f"EngineCluster.run hit max_steps={max_steps} with "
                f"{len(pending) - i} unsubmitted and work in flight; "
                f"metrics cover a truncated run", RuntimeWarning)
        return self.metrics()

    # --------------------------------------------------------- reporting
    def metrics(self) -> tuple[RunMetrics, list[RunMetrics]]:
        per_node = [e.metrics() for e in self.engines]
        merged = merge_metrics(per_node, n_submitted=self.n_submitted)
        return merged, per_node

    def stats(self) -> dict:
        out = {
            "routed": self.routed.tolist(),
            "adapter_loads": sum(e.cache.stats.misses
                                 for e in self.engines),
            "per_engine": [e.stats() for e in self.engines],
        }
        pages = [e.kv_page_stats() for e in self.engines]
        if any(pages):
            # Cluster-wide KV page occupancy (paged replicas only).
            out["kv_pages_used"] = sum(p.get("kv_pages_used", 0)
                                       for p in pages)
            out["kv_pages_total"] = sum(p.get("kv_pages_total", 0)
                                        for p in pages)
            out["preempted"] = sum(p.get("preempted", 0) for p in pages)
        return out
