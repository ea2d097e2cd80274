"""Baseline schedulers the paper compares against (§5).

- ``FIFOScheduler`` — S-LoRA's policy: strict arrival order, admit while
  memory fits. With ``cache.enabled = False`` this *is* the S-LoRA
  system (adapters dropped when their last request completes; queued
  adapters are asynchronously prefetched by the engine's prefetcher).
- ``SJFScheduler`` — µServe's speculative shortest-job-first over the
  predicted output length, with linear aging to mitigate starvation.

Both share Chameleon's memory plumbing (pool + cache manager) so that
the *only* experimental variable is the policy.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

from .adapter_cache import AdapterCache
from .lora import AdapterInfo
from .memory_pool import MemoryPool, PoolError
from .predictor import predict_request
from .request import Request, RequestState
from .scheduler import BaseScheduler


class _SingleQueueScheduler(BaseScheduler):
    def __init__(self, pool: MemoryPool, cache: AdapterCache,
                 adapters: dict[int, AdapterInfo], predictor,
                 max_batch_requests: int = 64,
                 max_predicted_output: int = 4096):
        self.pool = pool
        self.cache = cache
        self.adapters = adapters
        self.predictor = predictor
        self.max_batch_requests = max_batch_requests
        self.max_predicted_output = max_predicted_output
        self.reqs: deque[Request] = deque()
        self.n_deferred = 0   # placements refused while the adapter loads

    def submit(self, req: Request, now: float) -> None:
        predict_request(self.predictor, req, self.max_predicted_output)
        self.reqs.append(req)

    def requeue(self, req: Request, now: float) -> None:
        self.reqs.appendleft(req)

    def pending_count(self) -> int:
        return len(self.reqs)

    def queued_adapter_ids(self) -> set[int]:
        return {r.adapter_id for r in self.reqs}

    def queued_requests_in_order(self) -> list[Request]:
        return list(self.reqs)

    def cancel(self, req: Request, now: float) -> bool:
        if req in self.reqs:
            self.reqs.remove(req)
            self._release_unplaced(req, now)
            return True
        return False

    def reap_expired(self, now: float) -> list[Request]:
        expired = [r for r in self.reqs
                   if r.deadline is not None and r.deadline <= now]
        for r in expired:
            self.reqs.remove(r)
            self._release_unplaced(r, now)
        return expired

    def _order(self, now: float) -> None:
        """Hook: reorder self.reqs before admission."""

    def _admit(self, req: Request, now: float) -> bool:
        need = req.input_len + req.predicted_output
        if not self.reserve_from_pool:
            # Paged engine: demand is page-granular (see
            # ChameleonScheduler._admit).
            need = self.pool.pages_for(need) * self.pool.page_size
        aid = req.adapter_id
        protect = self.queued_adapter_ids() - {aid}
        # Async loads: first attempt pins + starts the load; a LOADING
        # adapter is never placed (see ChameleonScheduler._admit).
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

    def schedule(self, now: float, running: list[Request]) -> list[Request]:
        self._order(now)
        batch: list[Request] = []
        slots = self.max_batch_requests - len(running)
        while self.reqs and len(batch) < slots:
            req = self.reqs[0]
            if not self._admit(req, now):
                break   # head-of-line blocking, by design
            self.reqs.popleft()
            req.state = RequestState.RUNNING
            if req.first_scheduled_time is None:
                req.first_scheduled_time = now
            batch.append(req)
        return batch

    def on_finish(self, req: Request, now: float) -> None:
        if self.reserve_from_pool:
            self.pool.release_request(req.req_id)
        self.cache.release(req.adapter_id, now)

    def on_squash(self, req: Request, now: float) -> None:
        if self.reserve_from_pool:
            self.pool.release_request(req.req_id)
        self.cache.release(req.adapter_id, now)
        req.reset_for_requeue()
        self.requeue(req, now)


class FIFOScheduler(_SingleQueueScheduler):
    """S-LoRA: arrival order."""

    name = "fifo"


class SJFScheduler(_SingleQueueScheduler):
    """µServe: speculative SJF on predicted output length, with aging.

    priority = predicted_output − aging_rate · wait_seconds
    (lower = scheduled first). ``aging_rate`` is tokens/second of
    priority credit; the paper observes that even with aging, SJF starves
    long requests at high load — our Fig. 13 reproduction shows the same.
    """

    name = "sjf"

    def __init__(self, *args, aging_rate: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.aging_rate = aging_rate

    def _order(self, now: float) -> None:
        self.reqs = deque(sorted(
            self.reqs,
            key=lambda r: (r.predicted_output
                           - self.aging_rate * (now - r.arrival_time))))
