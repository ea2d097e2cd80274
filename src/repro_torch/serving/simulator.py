"""Discrete-event simulator of one serving node (DESIGN §2, tier 3).

Replays a trace through the *real* control plane — the same
ChameleonScheduler / AdapterCache / MemoryPool objects the JAX engine
uses — while charging time from the calibrated CostModel instead of
running the model. This is how the paper's production-scale figures
(Llama-7B, 100 adapters, 6–13 RPS, minutes of wall time) are reproduced
on a CPU-only container.

The simulator implements the same ``ServingSystem`` surface as the real
engine (DESIGN §3): ``submit`` returns a ``RequestHandle``, ``step``
advances virtual time by one iteration, ``busy``/``drain`` round it
out, and cancellation/deadlines are enforced at the same points the
engine enforces them. Tokens have no content at this tier, so the
stream carries deterministic position-keyed placeholder ids — the
contract (a handle's stream equals the node's output record, positions
never re-stream after a squash) is identical across tiers.
``run(trace)`` remains the one-shot replay wrapper the benchmarks use.

Fidelity notes:
- iteration-level (continuous) batching: one decode iteration advances
  every running request by one token; finished requests leave, new ones
  are admitted every iteration boundary (Orca/S-LoRA style);
- adapter loads serialise on a FIFO host→device link (PCIe contention,
  paper Fig. 4); prefill of a request cannot start before its load
  completes; prefetches occupy the same link;
- squash path: bypassed requests that exceed their predicted length are
  squashed and re-queued (paper §4.2), keeping their streamed prefix;
- reservation growth: requests that exceed their predicted output grow
  their pool hold token-by-token, shrinking the cache on demand.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core import (AdapterCache, ChameleonScheduler, MemoryPool,
                        PoolError, QueuedRequestPrefetcher, Request,
                        RequestState, SamplingParams)
from repro_torch.core.prefetcher import HistogramPrefetcher

from .cost_model import CostModel
from .handles import DRAIN_MAX_STEPS, RequestHandle, prepare_request
from .metrics import RequestRecord, RunMetrics
from .trace import Trace


class LinkChannel:
    """FIFO host→device link: transfers serialise (PCIe contention)."""

    def __init__(self, bytes_per_s: float, latency_s: float = 150e-6):
        self.bps = bytes_per_s
        self.latency = latency_s
        self.busy_until = 0.0
        self.bytes_total = 0
        self.busy_time = 0.0

    def transfer(self, nbytes: int, now: float) -> float:
        start = max(now, self.busy_until)
        dur = self.latency + nbytes / self.bps
        self.busy_until = start + dur
        self.bytes_total += nbytes
        self.busy_time += dur
        return self.busy_until

@dataclass
class SimConfig:
    max_iters: int = 2_000_000
    prefill_chunk_tokens: int = 2048     # max tokens per prefill iteration
    drain: bool = True                   # run queue dry after last arrival
    histogram_prefetch: bool = False
    queued_prefetch: bool = True
    headroom_tokens: int = 0             # engine slack kept free in the pool
    # S-LoRA semantics (paper Fig. 1): missing adapters are loaded before
    # the batch is sent to the GPU — the *engine* stalls on the load.
    # Chameleon's cache manager is invoked at scheduling time, so loads
    # overlap with the current iteration and only the affected request
    # waits (async). Baselines set True.
    sync_adapter_load: bool = False


# Deterministic placeholder token for (request, position): the DES has
# no logits, but the streaming contract still needs concrete ids whose
# regeneration after a squash is position-stable.
def _synth_token(req: Request, pos: int, vocab: int = 50257) -> int:
    return (req.req_id * 2654435761 + pos * 40503) % vocab


class NodeSimulator:
    def __init__(self, cost_model: CostModel, pool: MemoryPool,
                 cache: AdapterCache, scheduler, adapters: dict,
                 config: SimConfig | None = None):
        self.cost = cost_model
        self.pool = pool
        self.cache = cache
        self.sched = scheduler
        self.adapters = adapters
        self.cfg = config or SimConfig()
        self.link = LinkChannel(cost_model.hw.link_bps,
                                cost_model.link_latency_us * 1e-6)
        self.now = 0.0
        self._adapter_ready: dict[int, float] = {}
        # Wire the cache's load hook to the link channel.
        cache.on_load = self._on_adapter_load
        self.q_prefetch = (QueuedRequestPrefetcher(cache)
                           if self.cfg.queued_prefetch else None)
        self.h_prefetch = (HistogramPrefetcher(cache)
                           if self.cfg.histogram_prefetch else None)
        self._tbt: dict[int, list[float]] = {}
        self._last_tok: dict[int, float] = {}
        self._isolated_cache: dict[tuple, float] = {}
        # ServingSystem state (steppable DES).
        self._pending: list[tuple[float, int, Request]] = []  # arrival heap
        self._seq = itertools.count()
        self._waiting_load: list[Request] = []   # admitted, adapter in flight
        self._prefill_pending: list[Request] = []
        self._decoding: list[Request] = []
        self._metrics = RunMetrics()
        self.handles: dict[int, RequestHandle] = {}
        self.outputs: dict[int, list[int]] = {}
        self.n_cancelled = 0
        self.n_expired = 0
        self._drain_attempts = 0
        # Lifecycle fast path: the per-step deadline/cancel sweeps are
        # skipped entirely unless some request armed them (a 2M-iter
        # DES replay must not pay an O(queue) scan per iteration).
        self._deadlines_armed = False
        self._cancel_races: list[Request] = []
        # Interactive serving keeps per-request handles/output records
        # for the caller; ``run(trace)`` replays flip this off so a
        # paper-scale replay does not retain every token of every
        # completed request for the run's lifetime.
        self._retain_records = True

    # ------------------------------------------------------------------
    def _on_adapter_load(self, info) -> None:
        self._adapter_ready[info.adapter_id] = self.link.transfer(
            info.size_bytes, self.now)

    def _adapter_ready_time(self, adapter_id: int) -> float:
        return self._adapter_ready.get(adapter_id, 0.0)

    def _rank(self, adapter_id: int) -> int:
        return self.adapters[adapter_id].rank

    def _isolated(self, req: Request) -> float:
        key = (req.input_len, req.output_len, self._rank(req.adapter_id))
        if key not in self._isolated_cache:
            self._isolated_cache[key] = self.cost.isolated_time(
                req.input_len, req.output_len, key[2])
        return self._isolated_cache[key]

    # ------------------------------------------------- serving surface
    def submit(self, req: Request, *,
               sampling: Optional[SamplingParams] = None,
               on_token=None, ttl: Optional[float] = None,
               ) -> RequestHandle:
        """Non-blocking enqueue; the request enters the scheduler once
        virtual time reaches its ``arrival_time``."""
        handle = prepare_request(req, self, self.now, sampling, on_token,
                                 ttl)
        self.handles[req.req_id] = handle
        if req.deadline is not None:
            self._deadlines_armed = True
        heapq.heappush(self._pending,
                       (req.arrival_time, next(self._seq), req))
        self._metrics.n_submitted += 1
        return handle

    def busy(self) -> bool:
        return bool(self._pending or self._waiting_load
                    or self._prefill_pending or self._decoding
                    or self.sched.pending_count())

    def queue_pressure(self) -> float:
        """Routing signal: scheduler backlog plus in-flight requests
        (due arrivals still in the heap count — a router must see load
        the instant it is submitted, not an iteration later)."""
        due = sum(1 for t, _, _ in self._pending if t <= self.now)
        return self.sched.queue_pressure() + float(
            due + len(self._decoding) + len(self._prefill_pending)
            + len(self._waiting_load))

    def cancel(self, handle) -> bool:
        """Cancel wherever the request currently is: the arrival heap
        and the wait queues resolve immediately (releasing the adapter
        pin); *admitted* requests (waiting on a load, pending prefill,
        decoding) are deferred to the next step-top sweep — resolving
        them here would mutate the very lists a cancel issued from an
        ``on_token`` callback is being iterated inside of."""
        req = handle.req if isinstance(handle, RequestHandle) else handle
        if req.terminal:
            return False
        for i, (_, _, r) in enumerate(self._pending):
            if r is req:
                del self._pending[i]
                heapq.heapify(self._pending)
                self._finalize_unplaced(req, RequestState.CANCELLED)
                return True
        if self.sched.cancel(req, self.now):
            self._finalize_unplaced(req, RequestState.CANCELLED)
            return True
        req.cancel_requested = True
        self._cancel_races.append(req)
        return True

    def _finalize_unplaced(self, req: Request,
                           state: RequestState) -> None:
        req.state = state
        req.finish_time = self.now
        if state is RequestState.CANCELLED:
            self.n_cancelled += 1
        else:
            self.n_expired += 1
        self._drop_terminal_records(req)

    def _release_running(self, req: Request, state: RequestState) -> None:
        """Terminal transition for an admitted request: ``on_finish``
        returns its quota charges, pool reservation and cache pin."""
        self.sched.on_finish(req, self.now)
        req.preserved_tbts = self._tbt.pop(req.req_id, [])
        self._last_tok.pop(req.req_id, None)
        self._finalize_unplaced(req, state)

    def _drop_terminal_records(self, req: Request) -> None:
        """Replay mode: a terminal request's handle and output record
        have no consumer — free them so a 2M-iteration replay holds
        only in-flight state (interactive submits keep both)."""
        if not self._retain_records:
            self.handles.pop(req.req_id, None)
            self.outputs.pop(req.req_id, None)

    def _sweep_lifecycle(self) -> None:
        if self._deadlines_armed:
            for req in self.sched.reap_expired(self.now):
                self._finalize_unplaced(req, RequestState.EXPIRED)
            for group in (self._waiting_load, self._prefill_pending,
                          self._decoding):
                doomed = [r for r in group
                          if r.deadline is not None
                          and r.deadline <= self.now]
                for r in doomed:
                    group.remove(r)
                    self._release_running(r, RequestState.EXPIRED)
        if self._cancel_races:
            # Deferred cancels settle here, at the step top, where no
            # list is mid-iteration: admitted requests release their
            # holds; anything that moved back to a queue (squash) or
            # is still in transition retries via cancel().
            races, self._cancel_races = self._cancel_races, []
            for req in races:
                if req.terminal:
                    continue
                for group in (self._waiting_load,
                              self._prefill_pending, self._decoding):
                    if req in group:
                        group.remove(req)
                        self._release_running(req,
                                              RequestState.CANCELLED)
                        break
                else:
                    self.cancel(req)

    def _record_token(self, req: Request, pos: int) -> None:
        out = self.outputs.setdefault(req.req_id, [])
        tok = _synth_token(req, pos)
        if pos < len(out):
            out[pos] = tok     # squash re-execution: never re-streams
            return
        out.append(tok)
        handle = self.handles.get(req.req_id)
        if handle is not None:
            handle._push(pos, tok)

    # ---------------------------------------------------------- stepping
    def step(self) -> None:
        """One DES iteration: ingest arrivals, enforce lifecycle, admit,
        prefetch, one prefill chunk, one decode iteration; advance
        virtual time to the next event when idle."""
        # 1. Ingest arrivals up to `now`.
        while self._pending and self._pending[0][0] <= self.now:
            _, _, req = heapq.heappop(self._pending)
            self.sched.submit(req, self.now)
            if self.h_prefetch:
                self.h_prefetch.observe_arrival(req.adapter_id, self.now)
        self._sweep_lifecycle()

        running = self._decoding + self._prefill_pending \
            + self._waiting_load
        # 2. Admission (scheduler owns the policy).
        admitted = self.sched.schedule(self.now, running)
        for req in admitted:
            ready = self._adapter_ready_time(req.adapter_id)
            if ready > self.now and not self.cfg.sync_adapter_load:
                req.load_wait_start = self.now   # stall begins here
                self._waiting_load.append(req)
            else:
                self._prefill_pending.append(req)

        # 3. Prefetch for queued requests (async, consumes link bw).
        if self.q_prefetch and hasattr(self.sched,
                                       "queued_requests_in_order"):
            self.q_prefetch.run(self.sched.queued_requests_in_order(),
                                self.now)
        if self.h_prefetch:
            # §4.1 second tier: a predictive prefetch must not
            # evict an adapter a queued request is about to need.
            self.h_prefetch.run(
                self.now,
                queued_protect=self.sched.queued_adapter_ids())

        # 4. Promote loads that completed. The metered load wait is
        # admission-stall -> load completion (mirrors the engine's
        # ``load_wait_start`` accounting); measuring from arrival would
        # double-count queue wait in the latency breakdown.
        still = []
        for req in self._waiting_load:
            ready = self._adapter_ready_time(req.adapter_id)
            if ready <= self.now:
                start = (req.load_wait_start
                         if req.load_wait_start is not None
                         else req.arrival_time)
                req.adapter_load_wait += max(0.0, ready - start)
                req.load_wait_start = None
                self._prefill_pending.append(req)
            else:
                still.append(req)
        self._waiting_load = still

        stepped = False
        # 5. One prefill iteration (chunked).
        if self._prefill_pending:
            chunk, tok = [], 0
            for req in list(self._prefill_pending):
                if chunk and tok + req.input_len > \
                        self.cfg.prefill_chunk_tokens:
                    break
                chunk.append(req)
                tok += req.input_len
            if self.cfg.sync_adapter_load:
                # Engine blocks until every chunk member's adapter
                # finished loading (S-LoRA batch-launch semantics).
                ready = max(self._adapter_ready_time(r.adapter_id)
                            for r in chunk)
                if ready > self.now:
                    self.now = ready
            t = self.cost.prefill_time(
                [r.input_len for r in chunk],
                [self._rank(r.adapter_id) for r in chunk])
            self.now += t
            for req in chunk:
                self._prefill_pending.remove(req)
                req.generated = 1      # prefill emits the first token
                if req.preserved_tokens:
                    # Squash survivor: streamed prefix + TBTs live on;
                    # the TBT of the first *new* token is measured from
                    # the last token the user actually saw.
                    self.outputs[req.req_id] = list(req.preserved_tokens)
                    self._tbt[req.req_id] = list(req.preserved_tbts)
                    self._last_tok[req.req_id] = (
                        req.last_stream_time if req.last_stream_time
                        is not None else self.now)
                else:
                    req.first_token_time = self.now
                    self.outputs[req.req_id] = []
                    self._tbt[req.req_id] = []
                    self._last_tok[req.req_id] = self.now
                self._record_token(req, 0)
                if req.done:
                    self._finish(req)
                else:
                    self._decoding.append(req)
            stepped = True

        # 6. One decode iteration for the running batch.
        if self._decoding:
            kv_tokens = sum(r.input_len + r.generated
                            for r in self._decoding)
            t = self.cost.decode_time(
                len(self._decoding), kv_tokens,
                [self._rank(r.adapter_id) for r in self._decoding])
            self.now += t
            finished, squashed = [], []
            for req in self._decoding:
                pos = req.generated
                req.generated += 1
                new = pos >= len(self.outputs.get(req.req_id, []))
                self._record_token(req, pos)
                if new:
                    self._tbt[req.req_id].append(
                        self.now - self._last_tok[req.req_id])
                    self._last_tok[req.req_id] = self.now
                if req.done:
                    finished.append(req)
                    continue
                if req.bypassed and req.exceeded_prediction():
                    squashed.append(req)
                    continue
                if req.generated > req.predicted_output:
                    self._grow_reservation(req, squashed)
            for req in finished:
                self._decoding.remove(req)
                self._finish(req)
            for req in squashed:
                if req in self._decoding:
                    self._decoding.remove(req)
                self._squash(req)
            stepped = True

        # 7. Advance the clock when idle.
        if not stepped:
            if self._pending:
                self.now = max(self.now, self._pending[0][0])
                return
            if not self.busy():
                return
            if self._waiting_load:
                self.now = max(self.now, min(
                    self._adapter_ready_time(r.adapter_id)
                    for r in self._waiting_load))
                return
            # Queue non-empty but nothing admitted and nothing runs:
            # nudge timers (t_refresh, aging) so admission can unblock.
            if self.sched.pending_count():
                self._force_drain_step()

    def drain(self, max_steps: int = DRAIN_MAX_STEPS) -> None:
        self._drain_attempts = 0
        for _ in range(max_steps):
            if not self.busy() or self._deadlocked():
                break
            self.step()

    # ------------------------------------------------------------------
    def run(self, trace: Trace) -> RunMetrics:
        """One-shot replay: submit the whole trace, run the DES dry
        (or to the last arrival with ``cfg.drain=False``), and return
        the metrics — the historical benchmark surface."""
        self._metrics = RunMetrics()
        self._drain_attempts = 0
        self._retain_records = False    # replay: nobody reads handles
        for req in trace.requests:
            self.submit(req)
        iters = 0
        while iters < self.cfg.max_iters and self.busy():
            if self._deadlocked():
                break
            self.step()
            iters += 1
            if not self.cfg.drain and not self._pending:
                break
        return self.metrics()

    # ------------------------------------------------------------------
    def _deadlocked(self) -> bool:
        return self._drain_attempts > 1000

    def _force_drain_step(self) -> None:
        """Nothing admitted while idle: nudge time forward so timers
        (t_refresh, aging) can unblock admission."""
        self._drain_attempts += 1
        self.now += 0.01

    def _grow_reservation(self, req: Request, squashed: list) -> None:
        """Mispredicted-long request: extend its KV hold by one token."""
        try:
            self.pool.grow_request(req.req_id, 1)
            req.reserved_tokens += 1
            return
        except PoolError:
            pass
        if self.cache.shrink_for_requests(1, self.now,
                                          self.sched.queued_adapter_ids()):
            self.pool.grow_request(req.req_id, 1)
            req.reserved_tokens += 1
            return
        # Last resort: squash *this* over-budget request (it is the one
        # whose prediction was wrong — same rule the paper applies to
        # bypassers). Extremely rare with sane pool sizes.
        squashed.append(req)

    def _squash(self, req: Request) -> None:
        # Keep the streamed prefix and its latency accounting across
        # the requeue (re-execution regenerates the same positions).
        req.stash_progress(self.outputs.pop(req.req_id, None),
                           self._tbt.pop(req.req_id, None),
                           self._last_tok.pop(req.req_id, None))
        if hasattr(self.sched, "on_squash"):
            self.sched.on_squash(req, self.now)

    def _finish(self, req: Request) -> None:
        if req.cancel_requested:
            # Cancel raced the final token: honour the cancel()
            # contract — terminate CANCELLED, no RequestRecord.
            self._release_running(req, RequestState.CANCELLED)
            return
        req.state = RequestState.FINISHED
        req.finish_time = self.now
        self.sched.on_finish(req, self.now)
        tbts = self._tbt.pop(req.req_id, [])
        req.preserved_tbts = tbts     # handle.result() reads these
        self._last_tok.pop(req.req_id, None)
        iso = self._isolated(req)
        self._metrics.records.append(RequestRecord(
            req_id=req.req_id, adapter_id=req.adapter_id,
            rank=self._rank(req.adapter_id),
            input_len=req.input_len, output_len=req.output_len,
            arrival=req.arrival_time,
            ttft=req.ttft() or 0.0, e2e=req.e2e() or 0.0,
            tbt_mean=float(np.mean(tbts)) if tbts else 0.0,
            tbt_p99=float(np.percentile(tbts, 99)) if tbts else 0.0,
            slowdown=(req.e2e() or 0.0) / max(iso, 1e-9),
            squashes=req.squash_count, bypassed=req.bypassed,
            queue_wait=req.queue_wait() or 0.0,
            load_wait=max(0.0, req.adapter_load_wait)))
        self._drop_terminal_records(req)

    # ---------------------------------------------------------- reporting
    def stats(self) -> dict:
        return {
            "completed": len(self._metrics.records),
            "cache": self.cache.stats.__dict__.copy(),
            "bypassed": getattr(self.sched, "n_bypassed", 0),
            "squashed": getattr(self.sched, "n_squashed", 0),
            "cancelled": self.n_cancelled,
            "expired": self.n_expired,
            "pool": self.pool.snapshot(),
        }

    def metrics(self) -> RunMetrics:
        m = self._metrics
        m.horizon = self.now
        m.cache_stats = {
            "hit_rate": round(self.cache.stats.hit_rate, 4),
            "hits": self.cache.stats.hits,
            "misses": self.cache.stats.misses,
            "evictions": self.cache.stats.evictions,
            "gb_loaded": round(self.cache.stats.bytes_loaded / 1e9, 3),
            "link_busy_frac": round(
                self.link.busy_time / max(self.now, 1e-9), 4),
        }
        if isinstance(self.sched, ChameleonScheduler):
            m.sched_stats = {
                "bypassed": self.sched.n_bypassed,
                "squashed": self.sched.n_squashed,
                "queues": len(self.sched.queues),
            }
        return m
