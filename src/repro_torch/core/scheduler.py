"""Chameleon Scheduler (paper §4.2) and the scheduler interface.

Non-preemptive, adapter-aware multi-level queue with:

- WRS-based queue admission (wrs.py), K-means queue/cutoff adaptation
  (kmeans.py) every ``t_refresh`` seconds, M/M/1 quotas (quotas.py);
- two-phase batch assembly (Algorithm 1): per-queue quota admission,
  then top-down redistribution of spare tokens;
- adapter-blocking bypass with squash-on-misprediction;
- quota charges returned on completion (reservation semantics).

Quota charge of a request = input + predicted output + adapter tokens
(paper: the quota "includes input tokens, output tokens, and the memory
required for the corresponding adapter"). The *pool* reservation excludes
the adapter (adapters are held once, reference-counted, by the cache).

Layering (DESIGN §3): this scheduler orders work *within one node's
continuous batch* and is deliberately tenant-blind — per-tenant
fairness, admission limits, and SLO-aware rejection live a layer up in
``serving/gateway.py``, which holds its own queue and keeps this one
shallow. Both layers price requests with the same length-prediction
hook (``predictor.predict_request``), so a gateway-degraded
``max_new_tokens`` is the number this scheduler charges quota for.
``submit`` is non-blocking (enqueue only); placement happens inside
``schedule`` on the engine's step, and deadline enforcement for queued
requests is the step loop's ``reap_expired`` sweep.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Iterable, Optional

import numpy as np

from .adapter_cache import AdapterCache
from .kmeans import choose_queues, queue_index
from .lora import AdapterInfo
from .memory_pool import MemoryPool, PoolError
from .predictor import predict_request
from .quotas import QueueStats, assign_quotas
from .request import Request, RequestState
from .wrs import WRSCalculator


class BaseScheduler:
    """Engine-facing interface shared by Chameleon and the baselines."""

    name = "base"

    # Subclasses are expected to expose ``self.cache`` (AdapterCache);
    # the unplaced-release helper below uses it to drop async-load pins.

    # Dense engines let the scheduler reserve the predicted worst case
    # (input + predicted output) in the MemoryPool at admission. The
    # paged engine flips this off: it holds exactly its allocated KV
    # pages under the same req_id and grows/releases them itself, so the
    # scheduler must neither reserve nor release request holds (a
    # release here would drop the engine's page hold).
    reserve_from_pool = True

    def submit(self, req: Request, now: float) -> None:
        raise NotImplementedError

    def schedule(self, now: float, running: list[Request]) -> list[Request]:
        """Return requests to admit to the continuous batch this iteration."""
        raise NotImplementedError

    def on_finish(self, req: Request, now: float) -> None:
        pass

    def requeue(self, req: Request, now: float) -> None:
        self.submit(req, now)

    def pending_count(self) -> int:
        raise NotImplementedError

    def queue_pressure(self) -> float:
        """Routing signal: how loaded is this scheduler's backlog
        (cluster routers rank replicas by this, DESIGN §3).

        Base implementation: queued request count. Subclasses with a
        pool add a token-backlog term normalised by capacity.
        """
        return float(self.pending_count())

    def queued_requests_in_order(self) -> list[Request]:
        return []

    def queued_adapter_ids(self) -> set[int]:
        return set()

    # -- lifecycle: cancellation and deadlines ---------------------------
    def _release_unplaced(self, req: Request, now: float) -> None:
        """Drop everything an *unplaced* request can hold: queued
        requests carry no pool reservation or quota charges, so the
        only resource is the async-load adapter pin (``adapter_ref``).
        The in-flight H2D transfer, if any, completes harmlessly — the
        entry is merely unpinned and becomes evictable."""
        if req.adapter_ref:
            self.cache.release(req.adapter_id, now)
            req.adapter_ref = False
        req.load_wait_start = None

    def cancel(self, req: Request, now: float) -> bool:
        """Remove a queued (or LOADING-deferred) request from the wait
        queues, releasing its adapter pin. Returns False when the
        request is not queued here (already placed or finished) — the
        engine then cancels it at the next step boundary."""
        return False

    def reap_expired(self, now: float) -> list[Request]:
        """Remove and return queued requests whose deadline passed.
        Called from the engine/simulator step loop; the caller marks
        the returned requests EXPIRED and notifies their handles."""
        return []

    def _gate_adapter_ready(self, req: Request, now: float) -> bool:
        """Async-load admission gate shared by every scheduler: while
        the pinned adapter's H2D transfer is in flight the request is
        *deferred* — surfaced as LOADING, its load-wait window opened
        for the latency breakdown, never placed. Returns True once the
        adapter is usable (closing the window and restoring QUEUED so
        the caller's admission can proceed)."""
        if not self.cache.is_ready(req.adapter_id):
            self.n_deferred += 1
            if req.load_wait_start is None:
                req.load_wait_start = now
            req.state = RequestState.LOADING
            return False
        if req.load_wait_start is not None:
            req.adapter_load_wait += now - req.load_wait_start
            req.load_wait_start = None
            req.state = RequestState.QUEUED
        return True


@dataclass
class _QueueState:
    cutoff_hi: float                      # WRS upper bound (inf for last)
    quota: int                            # tokens this queue may reserve
    used: int = 0                         # tokens currently reserved
    reqs: deque = field(default_factory=deque)

    @property
    def available(self) -> int:
        return max(0, self.quota - self.used)


class ChameleonScheduler(BaseScheduler):
    """The paper's adapter-aware multi-level queue (§4.2).

    Requests land in one of K WRS-cutoff queues at ``submit``
    (non-blocking; prediction via the shared ``predict_request`` hook);
    ``schedule`` assembles each batch in two phases — per-queue M/M/1
    quota admission, then top-down redistribution of spare tokens —
    with an adapter-blocking bypass lane whose mispredictors are
    squashed back to their queue. Queue count and cutoffs re-adapt by
    K-means over observed WRS every ``t_refresh`` seconds (minimum
    ``refresh_min_samples`` completions). Non-preemptive: admitted
    requests run to completion unless the paged engine preempts for
    pages or a deadline/cancel sweep removes them.
    """

    name = "chameleon"

    def __init__(self,
                 pool: MemoryPool,
                 cache: AdapterCache,
                 adapters: dict[int, AdapterInfo],
                 predictor,
                 wrs_calc: Optional[WRSCalculator] = None,
                 slo: float = 5.0,
                 k_max: int = 4,
                 t_refresh: float = 300.0,
                 max_batch_requests: int = 64,
                 bypass_window: int = 8,
                 refresh_min_samples: int = 32,
                 max_predicted_output: int = 4096,
                 seed: int = 0):
        self.pool = pool
        self.cache = cache
        self.adapters = adapters
        self.predictor = predictor
        self.wrs_calc = wrs_calc or WRSCalculator()
        self.slo = slo
        self.k_max = k_max
        self.t_refresh = t_refresh
        self.max_batch_requests = max_batch_requests
        self.bypass_window = bypass_window
        self.refresh_min_samples = refresh_min_samples
        # Clamp predictions: an unbounded mispredict reserves an
        # unadmittable quota charge and starves the request forever.
        self.max_predicted_output = max_predicted_output
        self.rng = np.random.default_rng(seed)

        # Start with a single queue holding the whole budget; the first
        # refresh (once samples accumulate) will split it.
        self.queues: list[_QueueState] = [
            _QueueState(cutoff_hi=float("inf"),
                        quota=pool.capacity_tokens)]
        self._last_refresh = 0.0

        # Telemetry for adaptation.
        self._wrs_samples: deque = deque(maxlen=4096)
        self._charge_samples: deque = deque(maxlen=4096)  # (wrs, charge_tok)
        self._arrivals: deque = deque(maxlen=4096)        # (time, queue_idx)
        self._durations: dict[int, float] = {}            # queue -> EMA secs
        self._sizes: dict[int, float] = {}                # queue -> EMA tokens
        self.n_bypassed = 0
        self.n_squashed = 0
        self.n_deferred = 0   # placements refused while the adapter loads

    # -- helpers -----------------------------------------------------------
    def _charge_tokens(self, req: Request) -> int:
        ad = self.adapters[req.adapter_id]
        return req.input_len + req.predicted_output + ad.size_tokens

    def _reserve_tokens(self, req: Request) -> int:
        return req.input_len + req.predicted_output

    def pending_count(self) -> int:
        return sum(len(q.reqs) for q in self.queues)

    def queued_adapter_ids(self) -> set[int]:
        out: set[int] = set()
        for q in self.queues:
            for r in q.reqs:
                out.add(r.adapter_id)
        return out

    def queued_requests_in_order(self) -> list[Request]:
        """Priority order: queue 0 first, FIFO within a queue (prefetcher)."""
        out = []
        for q in self.queues:
            out.extend(q.reqs)
        return out

    def queue_pressure(self) -> float:
        """Backlog signal for cluster routing: queued requests plus the
        quota tokens they would charge, expressed as a fraction of pool
        capacity (so a few huge requests weigh like many small ones)."""
        charge = sum(self._charge_tokens(r)
                     for r in self.queued_requests_in_order())
        return self.pending_count() + charge / max(1, self.pool.capacity_tokens)

    def cancel(self, req: Request, now: float) -> bool:
        for q in self.queues:
            if req in q.reqs:
                q.reqs.remove(req)
                self._release_unplaced(req, now)
                return True
        return False

    def reap_expired(self, now: float) -> list[Request]:
        expired: list[Request] = []
        for q in self.queues:
            overdue = [r for r in q.reqs
                       if r.deadline is not None and r.deadline <= now]
            for r in overdue:
                q.reqs.remove(r)
                self._release_unplaced(r, now)
                expired.append(r)
        return expired

    # -- submission ----------------------------------------------------------
    def submit(self, req: Request, now: float) -> None:
        predict_request(self.predictor, req, self.max_predicted_output)
        ad = self.adapters[req.adapter_id]
        req.wrs = self.wrs_calc.wrs(req.input_len, req.predicted_output,
                                    ad.size_tokens)
        qi = self._queue_for(req.wrs)
        req.queue_idx = qi
        self.queues[qi].reqs.append(req)
        self._wrs_samples.append(req.wrs)
        self._charge_samples.append((req.wrs, self._charge_tokens(req)))
        self._arrivals.append((now, qi))

    def requeue(self, req: Request, now: float) -> None:
        """Squashed bypasser returns to the *front* of its queue."""
        qi = min(req.queue_idx, len(self.queues) - 1)
        req.queue_idx = qi
        self.queues[qi].reqs.appendleft(req)

    def _queue_for(self, wrs: float) -> int:
        for i, q in enumerate(self.queues):
            if wrs < q.cutoff_hi:
                return i
        return len(self.queues) - 1

    # -- adaptation -----------------------------------------------------------
    def maybe_refresh(self, now: float) -> bool:
        if (now - self._last_refresh) < self.t_refresh:
            return False
        if len(self._wrs_samples) < self.refresh_min_samples:
            return False
        self.refresh(now)
        return True

    def refresh(self, now: float) -> None:
        """Recompute queue count, cutoffs and quotas from recent load."""
        samples = np.array(self._wrs_samples, dtype=np.float64)
        k, _, cutoffs = choose_queues(samples, self.k_max)
        cut_hi = list(cutoffs) + [float("inf")]

        # Per-queue arrival rates over the telemetry window.
        window = max(1e-6, now - (self._arrivals[0][0] if self._arrivals
                                  else now - 1.0))
        new_assign = [queue_index(w, cutoffs) for w in samples]
        rates = [0.0] * k
        for qi in new_assign:
            rates[qi] += 1.0
        rates = [r / window for r in rates]

        # S per new queue: the max *charge* (tokens) among recent requests
        # that map into that queue — measured, not inferred from WRS.
        charge_max = [0.0] * k
        for wrs, tok in self._charge_samples:
            qi = queue_index(wrs, cutoffs)
            charge_max[qi] = max(charge_max[qi], float(tok))

        stats = []
        for qi in range(k):
            s_tok = max(self._sizes.get(qi, 0.0), charge_max[qi], 64.0)
            d_sec = self._durations.get(qi, max(self.slo / 5.0, 0.1))
            stats.append(QueueStats(max_size=s_tok, duration=d_sec,
                                    arrival_rate=rates[qi], slo=self.slo))
        quotas = assign_quotas(stats, self.pool.capacity_tokens)

        # Rebuild queues, re-binning waiting requests.
        waiting = [r for q in self.queues for r in q.reqs]
        used_per_new_q = [0] * k
        # Keep charges consistent: move each *running* charge to the new
        # queue of the same index clamped (charges reference queue ids).
        old_used = [q.used for q in self.queues]
        for i, u in enumerate(old_used):
            used_per_new_q[min(i, k - 1)] += u
        self.queues = [
            _QueueState(cutoff_hi=cut_hi[i], quota=quotas[i],
                        used=used_per_new_q[i]) for i in range(k)]
        for r in waiting:
            qi = self._queue_for(r.wrs)
            r.queue_idx = qi
            self.queues[qi].reqs.append(r)
        self._last_refresh = now

    def note_duration(self, req: Request, now: float) -> None:
        if req.first_scheduled_time is None:
            return
        dur = max(1e-6, now - req.first_scheduled_time)
        qi = min(req.queue_idx, len(self.queues) - 1)
        prev = self._durations.get(qi, dur)
        self._durations[qi] = 0.9 * prev + 0.1 * dur
        size = float(self._charge_tokens(req))
        prev_s = self._sizes.get(qi, size)
        self._sizes[qi] = 0.9 * prev_s + 0.1 * size

    # -- batch assembly (Algorithm 1 + bypass) ---------------------------------
    def schedule(self, now: float, running: list[Request]) -> list[Request]:
        self.maybe_refresh(now)
        batch: list[Request] = []
        slots = self.max_batch_requests - len(running)
        if slots <= 0:
            return batch

        queued_protect = self.queued_adapter_ids()
        # Min predicted remaining decode tokens across running requests —
        # the token-unit proxy for "how long the blocked head would wait
        # anyway" used by the bypass rule.
        remaining = [max(0, r.predicted_output - r.generated)
                     for r in running]
        min_remaining = min(remaining) if remaining else 0

        # Phase 1: per-queue quota admission. Every queue lends whatever
        # quota it did not consume — Algorithm 1 redistributes *all*
        # unused quota top-down, including that of a queue whose head is
        # memory-blocked (it cannot use the spare itself this iteration,
        # so withholding it would just idle tokens).
        leftover = 0
        for q in self.queues:
            if len(batch) >= slots:
                break
            self._put_batch(q, q.available, batch, slots, now,
                            queued_protect, min_remaining,
                            charge_queue=self.queues.index(q))
            leftover += q.available
        # Phase 2: redistribute spare tokens top-down.
        if leftover > 0:
            for qi, q in enumerate(self.queues):
                if leftover <= 0 or len(batch) >= slots:
                    break
                if not q.reqs:
                    continue
                consumed = self._put_batch(
                    q, leftover, batch, slots, now, queued_protect,
                    min_remaining, charge_queue=None, lenders=True)
                leftover -= consumed
        return batch

    def _admit(self, req: Request, q: _QueueState, now: float,
               queued_protect: set[int]) -> bool:
        """Memory-side admission: reserve pool tokens + adapter residency.

        Paged mode keeps this worst-case check as the admission
        *throttle* (without it every request would admit and preemption
        would do all the work, wasting prefills) but rounds the demand
        up to whole pages — the engine allocates page-granular, so a
        request that passes here can always get its prompt pages.

        Async loads: the first admission attempt pins the adapter
        (``req.adapter_ref``) and starts the load; while the entry is
        LOADING the request is *deferred* — never placed, but the rest
        of the batch (and the bypass lane) proceeds, and the pin keeps
        the mid-flight entry from being evicted. Synchronous data
        planes (the simulator, ``async_load=False`` engines) mark
        entries READY inside ``on_load``, so the deferral branch never
        triggers and admission is the old single-shot path.
        """
        need = self._reserve_tokens(req)
        if not self.reserve_from_pool:
            need = self.pool.pages_for(need) * self.pool.page_size
        aid = req.adapter_id
        protect = queued_protect - {aid}
        if not req.adapter_ref:
            extra = (0 if self.cache.resident(aid)
                     else self.adapters[aid].size_tokens)
            if not self.cache.shrink_for_requests(need + extra, now,
                                                  protect):
                return False
            try:
                self.cache.acquire(aid, now, queued_protect=protect)
            except PoolError:
                return False
            req.adapter_ref = True
        elif not self.cache.shrink_for_requests(need, now, protect):
            return False
        if not self._gate_adapter_ready(req, now):
            return False
        try:
            if self.reserve_from_pool:
                self.pool.reserve_request(req.req_id, need)
        except PoolError:
            return False
        req.reserved_tokens = need if self.reserve_from_pool else 0
        return True

    def _charge(self, req: Request, need: int, charge_queue: Optional[int],
                ) -> None:
        """Record quota charges; lenders=None means spread over lenders."""
        if charge_queue is not None:
            self.queues[charge_queue].used += need
            req.charges.append((charge_queue, need))
            return
        # Phase-2 borrow: charge queues with spare capacity, top down.
        left = need
        for qi, q in enumerate(self.queues):
            spare = q.available
            if spare <= 0:
                continue
            take = min(spare, left)
            q.used += take
            req.charges.append((qi, take))
            left -= take
            if left <= 0:
                break
        if left > 0:   # over-subscription falls on the last queue
            qi = len(self.queues) - 1
            self.queues[qi].used += left
            req.charges.append((qi, left))

    def _put_batch(self, q: _QueueState, budget: int, batch: list[Request],
                   slots: int, now: float, queued_protect: set[int],
                   min_remaining: int, charge_queue: Optional[int],
                   lenders: bool = False) -> int:
        """Admit from one queue within ``budget`` tokens. Returns consumed."""
        consumed = 0
        blocked_head: Optional[Request] = None
        scanned = 0
        while q.reqs and len(batch) < slots:
            req = q.reqs[0]
            need = self._charge_tokens(req)
            if need > budget - consumed:
                break
            if self._admit(req, q, now, queued_protect):
                q.reqs.popleft()
                self._charge(req, need, charge_queue)
                consumed += need
                req.state = RequestState.RUNNING
                req.first_scheduled_time = (req.first_scheduled_time
                                            if req.first_scheduled_time
                                            is not None else now)
                batch.append(req)
                blocked_head = None
                continue
            # Head blocked on memory/adapter: try the bypass lane.
            blocked_head = req
            break
        if blocked_head is not None and len(batch) < slots:
            consumed += self._bypass(q, budget - consumed, batch, slots, now,
                                     queued_protect, min_remaining,
                                     charge_queue)
        return consumed

    def _bypass(self, q: _QueueState, budget: int, batch: list[Request],
                slots: int, now: float, queued_protect: set[int],
                min_remaining: int, charge_queue: Optional[int]) -> int:
        """Adapter-blocking bypass (paper §4.2 'Bypassing Adapter Blocking').

        Younger requests may jump the blocked head iff (a) they fit the
        remaining quota, (b) their adapter is already resident or fits in
        currently-free memory, and (c) their predicted length does not
        exceed the head's expected wait (token-unit proxy:
        predicted_output ≤ min remaining decode tokens of the running
        batch). Admitted bypassers are flagged; if they outlive their
        prediction they are squashed by the engine and re-queued.
        """
        consumed = 0
        candidates = list(q.reqs)[1:1 + self.bypass_window]
        for req in candidates:
            if len(batch) >= slots:
                break
            need = self._charge_tokens(req)
            if need > budget - consumed:
                continue
            resident = self.cache.resident(req.adapter_id)
            ad = self.adapters[req.adapter_id]
            fits_free = (self._reserve_tokens(req)
                         + (0 if resident else ad.size_tokens)
                         ) <= self.pool.free_tokens
            if not (resident or fits_free):
                continue
            # A bypasser may *start* a load only into genuinely idle
            # capacity (a free entry slot + free tokens, both checked
            # above): with async loads the candidate is deferred, not
            # placed, so letting up to bypass_window speculative loads
            # evict useful entries would churn the cache for requests
            # that may never win their seat.
            if not resident and self.cache.max_entries is not None \
                    and len(self.cache.entries) >= self.cache.max_entries:
                continue
            if min_remaining and req.predicted_output > min_remaining:
                continue
            if not self._admit(req, q, now, queued_protect):
                continue
            q.reqs.remove(req)
            self._charge(req, need, charge_queue)
            consumed += need
            req.state = RequestState.RUNNING
            req.bypassed = True
            req.first_scheduled_time = (req.first_scheduled_time
                                        if req.first_scheduled_time
                                        is not None else now)
            batch.append(req)
            self.n_bypassed += 1
        return consumed

    # -- completion -------------------------------------------------------------
    def on_finish(self, req: Request, now: float) -> None:
        self.note_duration(req, now)
        self._return_charges(req)
        if self.reserve_from_pool:
            self.pool.release_request(req.req_id)
        self.cache.release(req.adapter_id, now)

    def on_squash(self, req: Request, now: float) -> None:
        """Bypasser exceeded its prediction: release and re-queue (§4.2)."""
        self._return_charges(req)
        if self.reserve_from_pool:
            self.pool.release_request(req.req_id)
        self.cache.release(req.adapter_id, now)
        self.n_squashed += 1
        req.reset_for_requeue()
        self.requeue(req, now)

    def _return_charges(self, req: Request) -> None:
        for qi, tok in req.charges:
            qi = min(qi, len(self.queues) - 1)
            self.queues[qi].used = max(0, self.queues[qi].used - tok)
        req.charges = []
