"""Adapter prefetching (paper §4.1 'Prefetching').

Two tiers:

1. ``QueuedRequestPrefetcher`` (always on, S-LoRA-style): walk the wait
   queues in priority order and prefetch missing adapters into the cache
   while free memory allows, without evicting anything useful.
2. ``HistogramPrefetcher`` (optional, Fig. 15): histogram-based load
   prediction in the style of Serverless-in-the-Wild [46] — per adapter,
   a histogram over inter-arrival times predicts the next arrival; the
   prefetcher warms adapters whose predicted next use falls within the
   horizon, most-imminent first.
"""
from __future__ import annotations

from collections import defaultdict, deque

import numpy as np


class QueuedRequestPrefetcher:
    def __init__(self, cache, max_per_round: int = 4):
        self.cache = cache
        self.max_per_round = max_per_round

    def run(self, queued_requests, now: float,
            budget: int | None = None) -> list[int]:
        """Prefetch missing adapters of queued requests. Returns ids
        loaded. ``budget`` caps this round below ``max_per_round`` —
        engines pass their free *slot* count so prefetch can never
        trigger a slot-capacity eviction."""
        limit = (self.max_per_round if budget is None
                 else min(self.max_per_round, budget))
        loaded = []
        seen = set()
        queued_ids = {r.adapter_id for r in queued_requests}
        for req in queued_requests:
            if len(loaded) >= limit:
                break
            aid = req.adapter_id
            if aid in seen or self.cache.resident(aid):
                continue
            seen.add(aid)
            info = self.cache.catalog[aid]
            # Only use genuinely free memory: prefetching must never
            # evict (that would fight the cost-aware policy).
            if info.size_tokens <= self.cache.pool.free_tokens:
                if self.cache.prefetch(aid, now,
                                       queued_protect=queued_ids - {aid}):
                    loaded.append(aid)
        return loaded


class HistogramPrefetcher:
    """Predictive prefetch from per-adapter inter-arrival histograms.

    Buckets are logarithmic (powers of two seconds). Prediction: the
    modal inter-arrival bucket's midpoint after the adapter's last
    arrival. Accuracy is high for the paper's power-law/uniform workload
    (they report >95 %); bursty adapters predict "soon" and stay warm.
    """

    def __init__(self, cache, horizon: float = 2.0, max_history: int = 64,
                 max_per_round: int = 2):
        self.cache = cache
        self.horizon = horizon
        self.max_per_round = max_per_round
        self._last_arrival: dict[int, float] = {}
        self._inter: dict[int, deque] = defaultdict(
            lambda: deque(maxlen=max_history))

    def observe_arrival(self, adapter_id: int, now: float) -> None:
        last = self._last_arrival.get(adapter_id)
        if last is not None:
            self._inter[adapter_id].append(max(1e-3, now - last))
        self._last_arrival[adapter_id] = now

    def _predict_next(self, adapter_id: int) -> float | None:
        hist = self._inter.get(adapter_id)
        last = self._last_arrival.get(adapter_id)
        if not hist or last is None:
            return None
        buckets = defaultdict(int)
        for dt in hist:
            buckets[int(np.ceil(np.log2(dt)))] += 1
        mode = max(buckets.items(), key=lambda kv: kv[1])[0]
        midpoint = (2.0 ** (mode - 1) + 2.0 ** mode) / 2 if mode > -10 else 0.0
        return last + midpoint

    def run(self, now: float, queued_protect=(),
            budget: int | None = None) -> list[int]:
        """``queued_protect`` (adapter ids of queued requests) threads
        through to the cache so a predictive prefetch never evicts an
        adapter a queued request is about to need (§4.1 second tier);
        ``budget`` caps the round (see QueuedRequestPrefetcher.run)."""
        cands = []
        for aid in self._last_arrival:
            if self.cache.resident(aid):
                continue
            t = self._predict_next(aid)
            # Accept anything predicted inside the horizon, *including*
            # overdue predictions (t < now): an adapter whose predicted
            # arrival just slipped past is the most imminent of all, not
            # a stale entry to skip — requiring now <= t meant a
            # prefetcher tick landing one tick late never warmed it.
            # Predictions more than one horizon in the past are stale
            # (the adapter's traffic stopped), not imminent: without the
            # lower bound a dead adapter's fixed past prediction would
            # top-rank every tick forever, burning load bandwidth and a
            # cache slot.
            if t is not None and now - self.horizon <= t <= now + self.horizon:
                cands.append((t, aid))
        cands.sort()
        limit = (self.max_per_round if budget is None
                 else min(self.max_per_round, budget))
        loaded = []
        protect = set(queued_protect)
        for _, aid in cands[:limit]:
            info = self.cache.catalog[aid]
            if info.size_tokens <= self.cache.pool.free_tokens:
                if self.cache.prefetch(aid, now,
                                       queued_protect=protect - {aid}):
                    loaded.append(aid)
        return loaded
