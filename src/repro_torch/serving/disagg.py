"""Disaggregated prefill/decode cluster with paged-KV handoff
(DESIGN §3.4, ROADMAP 3).

``EngineCluster`` replicas are symmetric: every node runs prefill and
decode interleaved, so one long prompt stalls that replica's in-flight
decodes for the whole monolithic prefill (or, with chunked prefill,
still steals every other step). ``DisaggCluster`` splits the fleet by
*role* instead:

- **prefill replicas** run admission + prefill and at most one decode
  step per request (the first token, produced by prefill itself);
- **decode replicas** run the steady-state continuous batch.

A request's life: route to a prefill replica (``prefix_affinity`` by
default, so warm radix trees keep working), prefill there, then its KV
pages + streamed-token state migrate to a decode replica over the
``KVHandoff`` plane and decode continues token-identically — the
shipped KV is bit-for-bit the source pages, the page-table indirection
makes physical page ids irrelevant, and greedy / position-seeded
sampling is deterministic. The handoff window is the ``MIGRATING``
request state: the source keeps the slot, pool holds and shared-page
refs (so prefix-tree eviction or cache shrink can never reclaim pages
mid-copy), and cancel / deadline expiry stay legal on both sides.

The link is modeled, not real (one host in CI): shipments serialize
over a single inter-replica link of ``link_gbps``; a shipment becomes
importable only once its modeled transfer completes on the shared
clock, so handoff cost scales with KV bytes exactly like the adapter
H2D model (``EngineConfig.h2d_gbps``).

Role-aware placement:

- decode destinations pack by *adapter rank* — an adapter's requests
  stick to one decode home (chosen resident-first, then least
  cumulative resident-rank load) so high-rank adapters spread instead
  of piling onto one replica, with a bounded least-loaded spill when
  the home is overloaded (same escape hatch as ``adapter_affinity``);
- the chosen home's histogram prefetcher is fed at *submit* time
  (``observe_arrival``), so the decode replica starts warming the
  adapter while the prompt is still prefilling — the handoff's
  adapter load overlaps prefill + link time;
- when the prefill tier saturates relative to decode
  (``spill_factor``), new requests **spill back** to a decode replica
  and run there monolithically — disaggregation degrades to the
  symmetric cluster instead of queueing behind a prefill convoy.

``RoleAutoscaler`` watches per-role token demand (queued prompt tokens
+ histogram-predicted imminent arrivals vs predicted remaining decode
tokens) and emits advisory per-role replica targets with concrete
``distributed.elastic`` mesh plans; ``autoscale_apply=True`` lets the
cluster actually move one idle replica across roles at a step boundary
(a moved prefill replica keeps its horizon-1 config — correctness is
config-independent, only its decode throughput is modest until the
next rebalance moves it back).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.request import Request, RequestState

from .cluster import Router, _SharedClock, prefix_route_key
from .handles import DRAIN_MAX_STEPS
from .metrics import RunMetrics, merge_metrics


@dataclass
class DisaggConfig:
    n_prefill: int = 1
    n_decode: int = 2
    system: str = "chameleon"            # see systems.ENGINE_SYSTEMS
    # Routing over the prefill tier (POLICIES); prefix_affinity keeps
    # warm radix trees effective even though prefill replicas hold a
    # request only briefly — the *prompt pages* stay cached there.
    prefill_policy: str = "prefix_affinity"
    affinity_overload_factor: float = 1.5
    # Modeled inter-replica link bandwidth (GB/s) the KV shipments
    # serialize over; 0 = infinitely fast (shipments land next step).
    link_gbps: float = 64.0
    # Spill-back: a new request bypasses the prefill tier when the
    # least-loaded prefill replica's pressure exceeds spill_factor x
    # the least-loaded decode replica's (>= 1; larger = stickier tiers).
    spill_factor: float = 4.0
    # Advisory per-role autoscaler (RoleAutoscaler); autoscale_apply
    # additionally lets the cluster move one idle replica across roles.
    autoscale: bool = True
    autoscale_apply: bool = False
    seed: int = 0


class KVHandoff:
    """The prefill->decode shipment plane: a single modeled link.

    ``begin`` stamps a shipment with its link-transfer completion time
    (transfers serialize: one link, FIFO); ``poll`` returns shipments
    whose modeled transfer has completed on the shared clock. The
    payload itself moved host-side at export time (``begin_migration``
    copied the pages out of the source pool), so nothing here can be
    invalidated by source-side eviction.
    """

    def __init__(self, clock, link_gbps: float):
        self._clock = clock
        self.link_gbps = link_gbps
        self.inflight: list[dict] = []
        self.n_begun = 0
        self.n_delivered = 0
        self.n_dropped = 0
        self.bytes_moved = 0
        self.waits: list[float] = []      # begin -> import latencies
        self._link_free_t = 0.0

    def begin(self, shipment: dict, src, dst) -> dict:
        now = self._clock()
        start = max(now, self._link_free_t)
        xfer = (shipment["nbytes"] / (self.link_gbps * 1e9)
                if self.link_gbps > 0 else 0.0)
        self._link_free_t = start + xfer
        entry = {"shipment": shipment, "src": src, "dst": dst,
                 "t_begin": now, "t_ready": start + xfer, "tries": 0}
        self.inflight.append(entry)
        self.n_begun += 1
        return entry

    def poll(self) -> list[dict]:
        now = self._clock()
        ready = [e for e in self.inflight if e["t_ready"] <= now]
        if ready:
            self.inflight = [e for e in self.inflight
                             if e["t_ready"] > now]
        return ready

    def drop(self, req_id: int) -> Optional[dict]:
        for i, e in enumerate(self.inflight):
            if e["shipment"]["req"].req_id == req_id:
                self.n_dropped += 1
                return self.inflight.pop(i)
        return None

    def delivered(self, entry: dict) -> None:
        self.n_delivered += 1
        self.bytes_moved += entry["shipment"]["nbytes"]
        self.waits.append(self._clock() - entry["t_begin"])

    def stats(self) -> dict:
        return {
            "handoffs": self.n_delivered,
            "handoff_gb": round(self.bytes_moved / 1e9, 6),
            "handoff_wait_s": round(float(np.mean(self.waits)), 6)
            if self.waits else 0.0,
            "handoffs_inflight": len(self.inflight),
            "handoffs_dropped": self.n_dropped,
        }


class RoleAutoscaler:
    """Advisory per-role scaling from demand signals (DESIGN §3.4).

    Tracks EWMAs of prefill-side token demand (queued + mid-chunk
    prompt tokens, plus histogram-predicted imminent arrivals — the
    same per-adapter arrival histograms the prefetcher builds) and
    decode-side demand (predicted remaining output tokens of live
    requests). ``plan`` splits the fixed fleet proportionally and
    attaches concrete ``distributed.elastic`` mesh plans for each
    role's target, so an operator (or ``autoscale_apply``) can act on
    it.
    """

    def __init__(self, alpha: float = 0.4):
        self.alpha = alpha
        self.prefill_ewma = 0.0
        self.decode_ewma = 0.0
        self.n_obs = 0

    def observe(self, prefill_tokens: float, decode_tokens: float) -> None:
        a = self.alpha if self.n_obs else 1.0
        self.prefill_ewma += a * (prefill_tokens - self.prefill_ewma)
        self.decode_ewma += a * (decode_tokens - self.decode_ewma)
        self.n_obs += 1

    def plan(self, n_prefill: int, n_decode: int) -> dict:
        total = n_prefill + n_decode
        demand = self.prefill_ewma + self.decode_ewma
        share = (self.prefill_ewma / demand) if demand > 0 else \
            n_prefill / total
        want_prefill = min(total - 1, max(1, round(total * share)))
        want_decode = total - want_prefill
        out = {"want_prefill": want_prefill, "want_decode": want_decode,
               "prefill_demand_tokens": round(self.prefill_ewma, 1),
               "decode_demand_tokens": round(self.decode_ewma, 1)}
        # Concrete reshard plans: each role is a (replicas, 1) data mesh
        # today; the elastic planner validates the resize and carries
        # the batch split an executor would apply. (Imported here so
        # ``repro.serving`` stays importable without jax.)
        from repro_torch.distributed.elastic import scale_out_plan
        out["prefill_plan"] = scale_out_plan(
            (n_prefill, 1), ("data", "model"), want_prefill,
            global_batch=want_prefill)
        out["decode_plan"] = scale_out_plan(
            (n_decode, 1), ("data", "model"), want_decode,
            global_batch=want_decode)
        return out


class DisaggCluster:
    """Prefill/decode-disaggregated engine fleet behind the standard
    ``ServingSystem`` surface (DESIGN §3.4).

    Construction mirrors ``EngineCluster``: one shared
    ``AdapterCatalog`` (host weights are never duplicated), one shared
    wall clock, per-replica device state. Prefill replicas run with
    ``max_horizon=1`` and synchronous readback so the cluster can
    harvest a finished prefill at the very next step boundary instead
    of letting the source race ahead through decode horizons.
    """

    def __init__(self, cfg, params, ecfg=None, dcfg=None, device=None):
        from .engine import AdapterCatalog, EngineConfig
        from .systems import build_engine

        self.dcfg = dcfg or DisaggConfig()
        self.ecfg = ecfg or EngineConfig()
        if self.dcfg.n_prefill < 1 or self.dcfg.n_decode < 1:
            raise ValueError("DisaggCluster needs >=1 replica per role")
        self.catalog = AdapterCatalog(cfg, self.ecfg.n_adapters,
                                      self.ecfg.r_max, device=device,
                                      seed=self.dcfg.seed)
        self._clock = _SharedClock()
        prefill_ecfg = dataclasses.replace(
            self.ecfg, max_horizon=1, pipeline_readback=False)
        self.prefill = [
            build_engine(self.dcfg.system, cfg, params, prefill_ecfg,
                         device=device,
                         catalog=self.catalog, clock=self._clock)
            for _ in range(self.dcfg.n_prefill)]
        self.decode = [
            build_engine(self.dcfg.system, cfg, params, self.ecfg,
                         device=device,
                         catalog=self.catalog, clock=self._clock)
            for _ in range(self.dcfg.n_decode)]
        self.router = Router(self.dcfg.prefill_policy,
                             self.dcfg.n_prefill,
                             self.dcfg.affinity_overload_factor,
                             seed=self.dcfg.seed)
        self.handoff = KVHandoff(self._clock, self.dcfg.link_gbps)
        self.autoscaler = (RoleAutoscaler() if self.dcfg.autoscale
                           else None)
        self.last_role_plan: Optional[dict] = None
        # Shipments delivered by the link but not yet imported (decode
        # replica had no slot/pages/adapter room; retried every step).
        self._pending: list[dict] = []
        # req_id -> engine currently responsible (for cancel routing).
        self._loc: dict[int, object] = {}
        # Rank-aware decode placement state (engine objects as keys so
        # role rebalances never invalidate them).
        self._adapter_home: dict[int, object] = {}
        self._rank_load: dict[int, float] = {}   # id(engine) -> rank sum
        self.n_submitted = 0
        self.n_spilled = 0
        self.n_rebalances = 0
        self.routed_prefill = 0

    # ------------------------------------------------------------ misc
    @property
    def engines(self) -> list:
        return self.prefill + self.decode

    def now(self) -> float:
        return self._clock()

    def _index(self, engine) -> int:
        return next(i for i, e in enumerate(self.engines) if e is engine)

    def warmup(self) -> None:
        """Force the dominant jit compiles on every replica (both
        roles), then reset stats and the shared clock — identical to
        ``EngineCluster.warmup`` so disagg-vs-monolithic A/Bs start
        from the same warm state."""
        for e in self.engines:
            e.submit(Request(input_len=8, output_len=2, adapter_id=0))
            e.drain()
            e.reset_stats()
        self._clock.reset()

    # ---------------------------------------------------------- placement
    def _decode_home(self, req: Request):
        """Rank-aware decode placement: resident replica first, then
        the sticky per-adapter home, then the replica with the least
        cumulative resident-rank load (so big adapters spread), with a
        bounded least-loaded spill when the target is overloaded."""
        aid = req.adapter_id
        least = min(self.decode, key=lambda e: e.queue_pressure())
        floor = max(1.0, least.queue_pressure())

        def overloaded(e) -> bool:
            return e.queue_pressure() \
                > self.dcfg.affinity_overload_factor * floor

        home = self._adapter_home.get(aid)
        if home is not None and any(home is e for e in self.decode) \
                and not overloaded(home):
            return home
        resident = [e for e in self.decode if e.cache.resident(aid)]
        if resident:
            home = min(resident, key=lambda e: e.queue_pressure())
        else:
            home = min(self.decode,
                       key=lambda e: (self._rank_load.get(id(e), 0.0),
                                      e.queue_pressure()))
        if overloaded(home):
            home = least
        if self._adapter_home.get(aid) is not home:
            self._rank_load[id(home)] = (
                self._rank_load.get(id(home), 0.0)
                + self.catalog.rank_of(aid))
        self._adapter_home[aid] = home
        return home

    # ------------------------------------------------------------- serve
    def submit(self, req: Request, *, sampling=None, on_token=None,
               ttl=None):
        ploads = [e.queue_pressure() for e in self.prefill]
        dst = self._decode_home(req)
        # Feed the decode home's arrival histogram now: its predictive
        # prefetcher starts warming the adapter while the prompt is
        # still queued/prefilling on the other tier.
        if dst.h_prefetch is not None:
            dst.h_prefetch.observe_arrival(req.adapter_id, self.now())
        if min(ploads) > self.dcfg.spill_factor \
                * max(1.0, min(e.queue_pressure() for e in self.decode)):
            # Prefill tier saturated: run monolithically on decode.
            target = min(self.decode, key=lambda e: e.queue_pressure())
            self.n_spilled += 1
        else:
            node = self.router.route(
                req.adapter_id, ploads,
                [e.cache.resident(req.adapter_id) for e in self.prefill],
                prefix_key=prefix_route_key(req, self.ecfg.page_size))
            target = self.prefill[node]
            self.routed_prefill += 1
        handle = target.submit(req, sampling=sampling,
                               on_token=on_token, ttl=ttl)
        handle.node = self._index(target)
        handle._system = self       # stream() pumps the whole cluster
        self._loc[req.req_id] = target
        self.n_submitted += 1
        return handle

    def cancel(self, handle) -> bool:
        req = handle.req
        if req.terminal:
            return False
        if req.state is RequestState.MIGRATING:
            return self._abort_migrating(req, RequestState.CANCELLED)
        eng = self._loc.get(req.req_id)
        return eng.cancel(handle) if eng is not None else False

    def _abort_migrating(self, req: Request, state: RequestState) -> bool:
        """Tear down a handoff from either stage (on the link, or
        delivered but awaiting import): the source finalizes with the
        shipped streamed-token records restored."""
        rid = req.req_id
        entry = self.handoff.drop(rid)
        if entry is None:
            entry = next((e for e in self._pending
                          if e["shipment"]["req"].req_id == rid), None)
            if entry is not None:
                self._pending.remove(entry)
        if entry is None:
            return False
        return entry["src"].abort_migration(
            req, state, shipment=entry["shipment"])

    # -------------------------------------------------------------- step
    def _harvest(self) -> None:
        """Export every prefill-replica request that has produced its
        first token (prefill done) into the handoff plane."""
        for e in self.prefill:
            for slot in np.where(e.active)[0]:
                req = e.slot_req[slot]
                if req is None or req.generated < 1 \
                        or req.state is not RequestState.RUNNING:
                    continue
                shipment = e.begin_migration(req)
                if shipment is None:
                    continue
                self.handoff.begin(shipment, e, self._decode_home(req))

    def _sweep_migrating(self, now: float) -> None:
        """Cancel / deadline enforcement inside the handoff window —
        MIGRATING requests belong to the cluster, not any engine's
        lifecycle sweep."""
        for entry in list(self.handoff.inflight) + list(self._pending):
            req = entry["shipment"]["req"]
            if req.cancel_requested:
                self._abort_migrating(req, RequestState.CANCELLED)
            elif req.deadline is not None and now >= req.deadline:
                self._abort_migrating(req, RequestState.EXPIRED)

    def _deliver(self) -> None:
        """Import link-completed shipments into their decode replicas;
        a replica that cannot take one yet (no slot / pages / adapter
        room) keeps it pending and it retries every step, re-targeting
        the least-loaded replica after repeated refusals."""
        self._pending.extend(self.handoff.poll())
        still = []
        for entry in self._pending:
            req = entry["shipment"]["req"]
            dst = entry["dst"]
            if entry["tries"] >= 3:
                dst = entry["dst"] = min(
                    self.decode, key=lambda e: e.queue_pressure())
            if dst.import_request_kv(entry["shipment"]):
                entry["src"].complete_migration(req)
                self._loc[req.req_id] = dst
                handle = entry["shipment"]["handle"]
                if handle is not None:
                    handle.node = self._index(dst)
                self.handoff.delivered(entry)
            else:
                entry["tries"] += 1
                still.append(entry)
        self._pending = still

    def _demand_signals(self) -> tuple[float, float]:
        pre = 0.0
        for e in self.prefill:
            pre += sum(r.input_len
                       for r in e.sched.queued_requests_in_order())
            pre += sum(len(st["prompt"]) - st["done"]
                       for st in e._chunked.values())
        # Histogram-predicted imminent arrivals (next ~2s of the same
        # per-adapter inter-arrival histograms the prefetcher uses)
        # count toward prefill demand at the fleet's mean prompt size.
        now = self.now()
        mean_in = 0.0
        n_live = 0
        dec = 0.0
        for e in self.engines:
            for r in e.slot_req:
                if r is None:
                    continue
                mean_in += r.input_len
                n_live += 1
                if r.state in (RequestState.RUNNING,
                               RequestState.MIGRATING):
                    dec += max(0, r.predicted_output - r.generated)
            dec += sum(r.predicted_output
                       for r in e.sched.queued_requests_in_order())
        mean_in = mean_in / n_live if n_live else 0.0
        seen = set()
        for e in self.prefill:
            if e.h_prefetch is None:
                continue
            for aid in e.h_prefetch._last_arrival:
                if aid in seen:
                    continue
                seen.add(aid)
                t = e.h_prefetch._predict_next(aid)
                if t is not None and now <= t <= now + 2.0:
                    pre += mean_in
        for entry in self._pending:
            req = entry["shipment"]["req"]
            dec += max(0, req.predicted_output - req.generated)
        return pre, dec

    def _maybe_rebalance(self) -> None:
        plan = self.last_role_plan
        if plan is None:
            return
        want = plan["want_prefill"]
        if want > len(self.prefill) and len(self.decode) > 1:
            src_pool, dst_pool, to_prefill = self.decode, self.prefill, True
        elif want < len(self.prefill) and len(self.prefill) > 1:
            src_pool, dst_pool, to_prefill = self.prefill, self.decode, False
        else:
            return
        dst_ids = {id(e["dst"]) for e in
                   self.handoff.inflight + self._pending}
        idle = [e for e in src_pool
                if not e.busy() and not e._migrating
                and id(e) not in dst_ids]
        if not idle:
            return
        moved = idle[0]
        src_pool.remove(moved)
        dst_pool.append(moved)
        if to_prefill:
            # Decode homes must not point at a prefill replica.
            self._adapter_home = {a: h for a, h
                                  in self._adapter_home.items()
                                  if h is not moved}
            self._rank_load.pop(id(moved), None)
        self.router = Router(self.dcfg.prefill_policy,
                             len(self.prefill),
                             self.dcfg.affinity_overload_factor,
                             seed=self.dcfg.seed)
        self.n_rebalances += 1

    def step(self) -> None:
        for e in self.prefill:
            e.step()
        self._harvest()
        now = self.now()
        self._sweep_migrating(now)
        self._deliver()
        for e in self.decode:
            e.step()
        if self.autoscaler is not None:
            pre, dec = self._demand_signals()
            self.autoscaler.observe(pre, dec)
            self.last_role_plan = self.autoscaler.plan(
                len(self.prefill), len(self.decode))
            if self.dcfg.autoscale_apply:
                self._maybe_rebalance()

    def busy(self) -> bool:
        return (any(e.busy() for e in self.engines)
                or bool(self.handoff.inflight) or bool(self._pending)
                or any(e._migrating for e in self.engines))

    def drain(self, max_steps: int = DRAIN_MAX_STEPS) -> None:
        for _ in range(max_steps):
            if not self.busy():
                break
            self.step()

    def queue_pressure(self) -> float:
        return float(sum(e.queue_pressure() for e in self.engines)
                     + len(self.handoff.inflight) + len(self._pending))

    def run(self, requests, max_steps: int = 100_000,
            ) -> tuple[RunMetrics, list[RunMetrics]]:
        """Wall-clock replay, same contract as ``EngineCluster.run``."""
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
                f"DisaggCluster.run hit max_steps={max_steps} with "
                f"{len(pending) - i} unsubmitted and work in flight; "
                f"metrics cover a truncated run", RuntimeWarning)
        return self.metrics()

    # --------------------------------------------------------- reporting
    def _role_util(self, engines) -> float:
        occ = []
        for e in engines:
            if e.batch_occupancy:
                occ.append(float(np.mean(e.batch_occupancy))
                           / e.ecfg.max_slots)
        return round(float(np.mean(occ)), 4) if occ else 0.0

    def metrics(self) -> tuple[RunMetrics, list[RunMetrics]]:
        per_node = [e.metrics() for e in self.engines]
        merged = merge_metrics(per_node, n_submitted=self.n_submitted)
        merged.sched_stats.update({
            "prefill_nodes": len(self.prefill),
            "decode_nodes": len(self.decode),
            "spilled_prefills": self.n_spilled,
            "role_rebalances": self.n_rebalances,
            "prefill_util": self._role_util(self.prefill),
            "decode_util": self._role_util(self.decode),
            **self.handoff.stats(),
        })
        return merged, per_node

    def stats(self) -> dict:
        out = {
            "prefill_nodes": len(self.prefill),
            "decode_nodes": len(self.decode),
            "routed_prefill": self.routed_prefill,
            "spilled_prefills": self.n_spilled,
            "role_rebalances": self.n_rebalances,
            "pending_imports": len(self._pending),
            "rank_load": {self._index(e): self._rank_load.get(id(e), 0.0)
                          for e in self.decode},
            "handoff": self.handoff.stats(),
            "per_engine": [e.stats() for e in self.engines],
        }
        if self.last_role_plan is not None:
            plan = dict(self.last_role_plan)
            for k in ("prefill_plan", "decode_plan"):
                p = plan[k]
                plan[k] = {"shape": list(p.shape),
                           "n_devices": p.n_devices,
                           "global_batch": p.global_batch}
            out["role_plan"] = plan
        return out
