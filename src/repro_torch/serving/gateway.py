"""Multi-tenant gateway: admission control, weighted-fair dispatch and
SLO-aware overload behavior over any ``ServingSystem`` (DESIGN §3.3).

The engine-side scheduler (``core.scheduler``) prevents head-of-line
blocking *inside* one continuous batch, but nothing below this layer
bounds a misbehaving tenant: a single org replaying a flood of long
requests inflates every other tenant's TTFT and the overload behavior
is implicit (queues grow without bound). The gateway is the front door
that makes overload an explicit, observable policy:

- **Per-tenant limits.** Each tenant has a ``TenantPolicy`` (weight,
  max in-flight dispatched into the wrapped tier, max queued at the
  gateway). Exceeding ``max_queued`` rejects early with a retry-after
  hint instead of letting the backlog grow.
- **Two-lane weighted-fair queueing.** Admitted requests are classified
  by *predicted* decode length (``core.predictor.predict_request`` —
  the same hook the scheduler uses, so both layers agree) into a short
  and a long lane; within each lane tenants are scheduled by start-time
  fair queueing (VERONICA-style: virtual time, per-tenant finish tags,
  cost = predicted tokens / weight), and the lanes interleave by a
  configurable ratio so long requests cannot starve short ones and
  vice versa.
- **SLO-aware overload handling.** When a request carries a deadline
  (``ttl`` / ``Request.deadline``) — or ``GatewayConfig.slo_default_s``
  arms one for everything — admission projects its completion from the
  current backlog and a self-calibrating service estimate. Predicted
  TTFT past the budget rejects immediately (``retry_after`` tells the
  client when the backlog should have drained); a feasible TTFT whose
  *full* decode would bust the budget degrades ``max_new_tokens`` to
  what still fits (never below ``degrade_floor_tokens``).
- **Decision traces.** Every submit resolves to a terminal handle state
  *and* a ``GatewayDecision`` (admit/degrade/reject + lane + reason +
  the numbers the decision was made from), attached to the handle and
  kept in ``Gateway.decisions``. Rejected requests terminate in the
  ``REJECTED`` state without ever touching the wrapped tier — refusal
  is reported, never dropped.

The gateway itself implements ``ServingSystem``, so anything that can
drive an engine can drive a gated engine; ``build_system(...,
gateway=...)`` wires it over any tier. Aggregate health is exported as
``gateway_stats()`` (per-tenant counters) and as ``gw_*`` gauges merged
into ``metrics().sched_stats`` (catalogued in ``serving.metrics.GAUGES``
and docs/OPERATIONS.md).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core.predictor import HistogramPredictor, predict_request
from repro_torch.core.request import Request, RequestState
from repro_torch.core.sampling import GREEDY, SamplingParams

from .handles import DRAIN_MAX_STEPS, RequestHandle, prepare_request

LANES = ("short", "long")


# ----------------------------------------------------------------------
# Policy / configuration
# ----------------------------------------------------------------------
@dataclass
class TenantPolicy:
    """Per-tenant limits and fair-share weight.

    weight        relative service share under backlog (WFQ cost is
                  predicted tokens / weight);
    max_inflight  requests dispatched into the wrapped tier and not yet
                  terminal; the gateway holds the rest back;
    max_queued    requests the gateway will hold for this tenant before
                  rejecting new submits with a retry-after.
    """

    weight: float = 1.0
    max_inflight: int = 8
    max_queued: int = 64


@dataclass
class GatewayConfig:
    """Gateway policy knobs (per-knob guidance in docs/OPERATIONS.md)."""

    #: Policy for tenants absent from ``tenants``.
    default_policy: TenantPolicy = field(default_factory=TenantPolicy)
    #: Per-tenant overrides, keyed by ``Request.tenant``.
    tenants: dict = field(default_factory=dict)
    #: Predicted decode length at or below this goes to the short lane.
    short_lane_max_decode: int = 64
    #: Lane interleave ratio (short, long): with (3, 1) three short-lane
    #: dispatches are attempted per long-lane one when both have work.
    lane_weights: tuple = (3, 1)
    #: Stop dispatching into the wrapped tier once its
    #: ``queue_pressure()`` reaches this (keeps the engine's own queue
    #: shallow so fairness decisions stay at the gateway, where tenant
    #: identity exists).
    dispatch_pressure_max: float = 32.0
    #: Global cap on requests queued at the gateway (all tenants).
    max_queued_total: int = 512
    #: Deadline budget armed for requests submitted without one
    #: (None = no implicit SLO; only explicit ttl/deadline requests get
    #: SLO treatment).
    slo_default_s: Optional[float] = None
    #: Never degrade ``max_new_tokens`` below this; reject instead.
    degrade_floor_tokens: int = 16
    #: Fraction of the residual budget the degraded decode may consume
    #: (headroom for estimate error).
    degrade_safety: float = 0.8
    #: Floor for the retry-after hint on rejections.
    min_retry_after_s: float = 0.5
    #: Clamp on predicted output length (mirrors the scheduler's).
    max_predicted_output: int = 4096
    #: Service-time seeds for the wait model; None pulls them from the
    #: cost model when one is supplied (sim tier) else falls back to
    #: conservative constants. Self-calibrated from completions unless
    #: ``calibrate=False``.
    init_s_per_tok: Optional[float] = None
    init_ttft_s: Optional[float] = None
    #: Effective service parallelism of the wrapped tier (≈ continuous
    #: batch width): backlog drains this many streams at once.
    service_parallelism: float = 8.0
    #: EMA step for the self-calibrating service estimates.
    ema_alpha: float = 0.2
    calibrate: bool = True


@dataclass
class GatewayDecision:
    """Admission-time record of what the gateway did to one request.

    ``action`` is one of ``admit`` / ``degrade`` / ``reject``; the
    terminal *outcome* (finished / cancelled / expired / rejected) lives
    on the request/handle state. The numbers the decision was computed
    from ride along so an operator can reconstruct any admit/reject
    from the trace alone.
    """

    req_id: int
    tenant: str
    action: str                       # admit | degrade | reject
    lane: Optional[str]               # short | long | None (rejected)
    reason: str
    t: float                          # decision time (system clock)
    predicted_wait_s: float = 0.0     # backlog drain estimate at admission
    budget_s: Optional[float] = None  # deadline budget (None = no SLO)
    retry_after_s: Optional[float] = None
    max_new_tokens: Optional[int] = None       # post-degrade cap
    original_max_new_tokens: Optional[int] = None


@dataclass
class _TenantState:
    policy: TenantPolicy
    queued: int = 0
    queued_tokens: int = 0
    inflight: int = 0
    submitted: int = 0
    admitted: int = 0
    rejected: int = 0
    degraded: int = 0
    completed: int = 0      # FINISHED after dispatch
    failed: int = 0         # CANCELLED/EXPIRED after dispatch
    expired_queued: int = 0
    cancelled_queued: int = 0
    tokens_done: int = 0


class _FairLane:
    """Start-time fair queueing over tenants (one instance per lane).

    Classic SFQ: each request gets a start tag ``max(vtime,
    last_finish[tenant])`` and a finish tag ``start + cost/weight``;
    dispatch serves the smallest eligible finish tag and advances
    virtual time to the served start tag. A tenant that went idle
    re-enters at the current virtual time, so backlog built by a flood
    never counts against a light tenant's next request.
    """

    def __init__(self):
        self.queues: dict[str, deque] = {}   # tenant -> (start, fin, req)
        self.vtime = 0.0
        self._finish: dict[str, float] = {}

    def __len__(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def push(self, req: Request, weight: float, cost: float) -> None:
        start = max(self.vtime, self._finish.get(req.tenant, 0.0))
        fin = start + cost / max(weight, 1e-9)
        self._finish[req.tenant] = fin
        self.queues.setdefault(req.tenant, deque()).append((start, fin, req))

    def pop_fair(self, eligible: Callable[[str], bool]) -> Optional[Request]:
        """Serve the smallest finish tag among tenants ``eligible``
        accepts (ineligible = at max_inflight); None when no tenant
        qualifies."""
        best, best_fin = None, float("inf")
        for tenant, q in self.queues.items():
            if not q or not eligible(tenant):
                continue
            if q[0][1] < best_fin:
                best_fin, best = q[0][1], tenant
        if best is None:
            return None
        start, _, req = self.queues[best].popleft()
        self.vtime = max(self.vtime, start)
        return req

    def remove(self, req: Request) -> bool:
        q = self.queues.get(req.tenant)
        if not q:
            return False
        for item in q:
            if item[2] is req:
                q.remove(item)
                return True
        return False

    def requests(self):
        for q in self.queues.values():
            for _, _, req in q:
                yield req


# ----------------------------------------------------------------------
# The gateway
# ----------------------------------------------------------------------
class Gateway:
    """Admission/dispatch layer wrapping one ``ServingSystem``.

    ``submit`` accepts both surfaces: the ISSUE/operator shape
    ``gateway.submit(tenant_id, request)`` and the ``ServingSystem``
    protocol shape ``gateway.submit(request, sampling=..., ...)`` with
    the tenant read from ``Request.tenant``. Either way the caller gets
    a ``RequestHandle`` whose ``decision`` attribute carries the
    ``GatewayDecision`` (and ``retry_after`` on rejection); tokens
    stream through the gateway handle exactly as they would from the
    wrapped tier.

    Requests submitted with a *future* ``arrival_time`` (trace replay)
    are held and admitted when the wrapped tier's clock reaches them —
    admission control must see the backlog as of arrival, not as of the
    submit call. On DES tiers the gateway advances virtual time across
    idle gaps itself, so ``drain()`` replays a whole trace.
    """

    def __init__(self, inner, cfg: Optional[GatewayConfig] = None, *,
                 predictor=None, cost_model=None):
        self.inner = inner
        self.cfg = cfg or GatewayConfig()
        self.predictor = predictor or HistogramPredictor()
        self.cost = cost_model
        self.lanes: dict[str, _FairLane] = {ln: _FairLane() for ln in LANES}
        self.tenants: dict[str, _TenantState] = {}
        self.decisions: dict[int, GatewayDecision] = {}
        self._handles: dict[int, RequestHandle] = {}
        self._inner_handles: dict[int, RequestHandle] = {}
        self._dispatched: dict[int, Request] = {}
        self._cost_tokens: dict[int, int] = {}
        self._future: list = []                  # (arrival, seq, req) heap
        self._seq = itertools.count()
        self._queued_tokens = 0
        self._inflight_tokens = 0
        self._deadlines_armed = False
        # Weighted lane interleave pattern, e.g. (3,1) -> S,S,S,L.
        s, l = self.cfg.lane_weights
        self._lane_pattern = ["short"] * int(s) + ["long"] * int(l)
        self._lane_idx = 0
        # Aggregate counters.
        self.n_submitted = 0
        self.n_admitted = 0
        self.n_rejected = 0
        self.n_degraded = 0
        self.n_dispatched = 0
        self.n_expired_queued = 0
        self.n_cancelled_queued = 0
        # Service-time estimates for the wait model (seeded from the
        # cost model where available, then EMA-calibrated from every
        # completion the gateway observes).
        self._s_per_tok = self.cfg.init_s_per_tok
        self._ttft_est = self.cfg.init_ttft_s
        if cost_model is not None:
            if self._s_per_tok is None:
                self._s_per_tok = cost_model.decode_time(1, 512, [16])
            if self._ttft_est is None:
                self._ttft_est = cost_model.isolated_ttft(256, 16)
        if self._s_per_tok is None:
            self._s_per_tok = 0.02
        if self._ttft_est is None:
            self._ttft_est = 0.25

    # ------------------------------------------------------------- clock
    def _now(self) -> float:
        n = getattr(self.inner, "now", None)
        if callable(n):
            return float(n())
        if isinstance(n, (int, float)):
            return float(n)
        nodes = getattr(self.inner, "nodes", None)
        if nodes:
            return max(float(nd.now) for nd in nodes)
        return 0.0

    def _advance_clock(self, t: float) -> None:
        """DES tiers only: jump virtual time to the next gateway-held
        arrival when the whole stack is idle (wall-clock tiers advance
        themselves)."""
        n = getattr(self.inner, "now", None)
        if isinstance(n, (int, float)):
            self.inner.now = max(float(n), t)
            return
        nodes = getattr(self.inner, "nodes", None)
        if nodes and isinstance(getattr(nodes[0], "now", None), float):
            for nd in nodes:
                nd.now = max(nd.now, t)

    # ----------------------------------------------------------- helpers
    def _tenant(self, name: str) -> _TenantState:
        ts = self.tenants.get(name)
        if ts is None:
            policy = self.cfg.tenants.get(name, self.cfg.default_policy)
            ts = self.tenants[name] = _TenantState(policy=policy)
        return ts

    def _intended_decode(self, req: Request) -> int:
        cap = (req.sampling.max_new_tokens
               if req.sampling is not None else None)
        out = req.predicted_output
        return min(out, cap) if cap is not None else out

    def _cost_of(self, req: Request) -> int:
        return req.input_len + self._intended_decode(req)

    def predicted_wait_s(self, tenant: Optional[str] = None) -> float:
        """Backlog drain estimate over the calibrated service rate.

        Without a tenant: the global conservative view (all queued +
        in-flight predicted tokens) — the gauge the operator watches.
        With a tenant: fair-share-aware — SFQ guarantees the tenant at
        least ``weight/sum(active weights)`` of service, so only its
        *own* backlog is divided by that share; another tenant's flood
        does not count against it (that is the whole point of the
        gateway). In-flight work delays everyone and counts fully.
        """
        par = max(1.0, self.cfg.service_parallelism)
        if tenant is None:
            backlog = self._queued_tokens + self._inflight_tokens
            return backlog * self._s_per_tok / par
        ts = self._tenant(tenant)
        active_w = sum(t.policy.weight for name, t in self.tenants.items()
                       if t.queued > 0 or name == tenant)
        share = ts.policy.weight / max(active_w, 1e-9)
        backlog = self._inflight_tokens + ts.queued_tokens / max(share, 1e-9)
        return backlog * self._s_per_tok / par

    def _total_queued(self) -> int:
        return sum(len(lane) for lane in self.lanes.values())

    # ------------------------------------------------------------ submit
    def submit(self, req, maybe_req=None, *,
               sampling: Optional[SamplingParams] = None,
               on_token: Optional[Callable[[int], None]] = None,
               ttl: Optional[float] = None,
               tenant: Optional[str] = None) -> RequestHandle:
        """Admit (or refuse) one request; non-blocking.

        ``submit(tenant_id, request)`` and ``submit(request,
        tenant=...)`` both tag ``request.tenant``; plain
        ``submit(request)`` uses the tag already on the request.
        """
        if isinstance(req, str):
            tenant, req = req, maybe_req
        if req is None:
            raise TypeError("submit needs a Request")
        if tenant is not None:
            req.tenant = tenant
        now = self._now()
        # Deadlines anchor at *arrival* (a trace request submitted
        # early must not gain budget from the early submit).
        if ttl is not None and req.deadline is None:
            req.deadline = max(now, req.arrival_time) + ttl
        elif req.deadline is None and self.cfg.slo_default_s is not None:
            req.deadline = (max(now, req.arrival_time)
                            + self.cfg.slo_default_s)
        handle = prepare_request(req, self, now, sampling, on_token, None)
        self._handles[req.req_id] = handle
        if req.deadline is not None:
            self._deadlines_armed = True
        self.n_submitted += 1
        self._tenant(req.tenant).submitted += 1
        if req.arrival_time > now:
            # Trace replay: decision deferred to the arrival instant.
            heapq.heappush(self._future,
                           (req.arrival_time, next(self._seq), req))
        else:
            self._admit(req, now)
        return handle

    # The admission state machine: classify -> limit-check -> SLO
    # check -> enqueue (or reject). One GatewayDecision per request.
    def _admit(self, req: Request, now: float) -> None:
        ts = self._tenant(req.tenant)
        predict_request(self.predictor, req, self.cfg.max_predicted_output)
        lane = ("short" if self._intended_decode(req)
                <= self.cfg.short_lane_max_decode else "long")
        wait = self.predicted_wait_s(req.tenant)
        budget = (req.deadline - max(now, req.arrival_time)
                  if req.deadline is not None else None)

        if ts.queued >= ts.policy.max_queued:
            self._reject(req, ts, lane, "tenant_queue_full", now, wait,
                         budget)
            return
        if self._total_queued() >= self.cfg.max_queued_total:
            self._reject(req, ts, lane, "gateway_queue_full", now, wait,
                         budget)
            return

        action, reason = "admit", "ok"
        orig_cap = (req.sampling.max_new_tokens
                    if req.sampling is not None else None)
        new_cap = orig_cap
        if budget is not None:
            ttft_proj = wait + self._ttft_est
            if ttft_proj > budget:
                # Queue wait alone busts the deadline; shortening the
                # decode cannot help. Tell the client when to retry.
                self._reject(req, ts, lane, "predicted_slo_miss", now,
                             wait, budget,
                             retry_after=max(self.cfg.min_retry_after_s,
                                             ttft_proj - budget))
                return
            decode_proj = self._intended_decode(req) * self._s_per_tok
            if ttft_proj + decode_proj > budget:
                allowed = int((budget - ttft_proj) / self._s_per_tok
                              * self.cfg.degrade_safety)
                if allowed < self.cfg.degrade_floor_tokens:
                    self._reject(req, ts, lane, "deadline_infeasible",
                                 now, wait, budget,
                                 retry_after=max(self.cfg.min_retry_after_s,
                                                 wait))
                    return
                new_cap = (min(orig_cap, allowed) if orig_cap is not None
                           else allowed)
                req.sampling = dataclasses.replace(
                    req.sampling or GREEDY, max_new_tokens=new_cap)
                action, reason = "degrade", "predicted_slo_miss_full_decode"
                ts.degraded += 1
                self.n_degraded += 1

        cost = self._cost_of(req)
        self.lanes[lane].push(req, ts.policy.weight, float(cost))
        ts.queued += 1
        ts.queued_tokens += cost
        ts.admitted += 1
        self.n_admitted += 1
        self._queued_tokens += cost
        self._cost_tokens[req.req_id] = cost
        self._record_decision(GatewayDecision(
            req_id=req.req_id, tenant=req.tenant, action=action, lane=lane,
            reason=reason, t=now, predicted_wait_s=wait, budget_s=budget,
            max_new_tokens=new_cap, original_max_new_tokens=orig_cap))

    def _reject(self, req: Request, ts: _TenantState, lane: str,
                reason: str, now: float, wait: float,
                budget: Optional[float],
                retry_after: Optional[float] = None) -> None:
        if retry_after is None:
            retry_after = max(self.cfg.min_retry_after_s, wait)
        req.state = RequestState.REJECTED
        req.finish_time = now
        ts.rejected += 1
        self.n_rejected += 1
        handle = self._handles.get(req.req_id)
        if handle is not None:
            handle.retry_after = retry_after
        self._record_decision(GatewayDecision(
            req_id=req.req_id, tenant=req.tenant, action="reject",
            lane=None, reason=reason, t=now, predicted_wait_s=wait,
            budget_s=budget, retry_after_s=retry_after))

    def _record_decision(self, d: GatewayDecision) -> None:
        self.decisions[d.req_id] = d
        handle = self._handles.get(d.req_id)
        if handle is not None:
            handle.decision = d

    # ---------------------------------------------------------- stepping
    def step(self) -> None:
        """One gateway iteration: release due arrivals, expire stale
        queue entries, dispatch under the fairness/pressure policy, step
        the wrapped tier, account completions; advance DES time across
        idle gaps."""
        now = self._now()
        while self._future and self._future[0][0] <= now:
            _, _, req = heapq.heappop(self._future)
            if not req.terminal:            # cancelled while held
                self._admit(req, now)
        self._sweep_queued(now)
        self._dispatch()
        self.inner.step()
        self._reap_dispatched()
        if (self._future and not self.inner.busy()
                and not any(len(l) for l in self.lanes.values())):
            self._advance_clock(self._future[0][0])

    def _sweep_queued(self, now: float) -> None:
        if not self._deadlines_armed:
            return
        doomed = [r for lane in self.lanes.values() for r in lane.requests()
                  if r.deadline is not None and r.deadline <= now]
        for req in doomed:
            self._remove_queued(req)
            req.state = RequestState.EXPIRED
            req.finish_time = now
            ts = self._tenant(req.tenant)
            ts.expired_queued += 1
            self.n_expired_queued += 1

    def _remove_queued(self, req: Request) -> bool:
        for lane in self.lanes.values():
            if lane.remove(req):
                ts = self._tenant(req.tenant)
                ts.queued -= 1
                cost = self._cost_tokens.pop(req.req_id, 0)
                ts.queued_tokens -= cost
                self._queued_tokens -= cost
                return True
        return False

    def _dispatch(self) -> None:
        """Drain gateway lanes into the wrapped tier: weighted lane
        interleave on top, SFQ across tenants within a lane, stopping
        at the inner pressure ceiling / per-tenant in-flight caps."""
        while True:
            if self.inner.queue_pressure() >= self.cfg.dispatch_pressure_max:
                return

            def eligible(tenant: str) -> bool:
                ts = self._tenant(tenant)
                return ts.inflight < ts.policy.max_inflight

            req = None
            for _ in range(len(self._lane_pattern)):
                lane = self._lane_pattern[self._lane_idx]
                self._lane_idx = ((self._lane_idx + 1)
                                  % len(self._lane_pattern))
                req = self.lanes[lane].pop_fair(eligible)
                if req is not None:
                    break
            if req is None:
                return
            self._dispatch_one(req)

    def _dispatch_one(self, req: Request) -> None:
        gh = self._handles[req.req_id]
        ih = self.inner.submit(
            req, on_token=lambda tok, h=gh: h._push(len(h._tokens), tok))
        gh.node = ih.node
        self._inner_handles[req.req_id] = ih
        self._dispatched[req.req_id] = req
        ts = self._tenant(req.tenant)
        ts.queued -= 1
        ts.inflight += 1
        self.n_dispatched += 1
        cost = self._cost_tokens.get(req.req_id, 0)
        ts.queued_tokens -= cost
        self._queued_tokens -= cost
        self._inflight_tokens += cost

    def _reap_dispatched(self) -> None:
        done = [rid for rid, req in self._dispatched.items() if req.terminal]
        alpha = self.cfg.ema_alpha
        for rid in done:
            req = self._dispatched.pop(rid)
            self._inner_handles.pop(rid, None)
            self._inflight_tokens -= self._cost_tokens.pop(rid, 0)
            ts = self._tenant(req.tenant)
            ts.inflight -= 1
            if req.state is RequestState.FINISHED:
                ts.completed += 1
                ts.tokens_done += req.generated
            else:
                ts.failed += 1
            if not self.cfg.calibrate:
                continue
            # Self-calibrate the wait model from what actually happened.
            self.predictor.observe(req.adapter_id,
                                   max(1, req.generated))
            if (req.first_token_time is not None
                    and req.first_scheduled_time is not None):
                svc = req.first_token_time - req.first_scheduled_time
                if svc > 0:
                    self._ttft_est += alpha * (svc - self._ttft_est)
            if (req.state is RequestState.FINISHED
                    and req.finish_time is not None
                    and req.first_token_time is not None
                    and req.generated > 1):
                per_tok = ((req.finish_time - req.first_token_time)
                           / (req.generated - 1))
                if per_tok > 0:
                    self._s_per_tok += alpha * (per_tok - self._s_per_tok)

    # ---------------------------------------------------- serving verbs
    def busy(self) -> bool:
        return bool(self._future or self._total_queued()
                    or self.inner.busy())

    def drain(self, max_steps: int = DRAIN_MAX_STEPS) -> None:
        for _ in range(max_steps):
            if not self.busy():
                return
            self.step()

    def cancel(self, handle) -> bool:
        """Cancel wherever the request is: held (future), queued at the
        gateway, or already dispatched (delegated to the wrapped
        tier)."""
        req = handle.req if isinstance(handle, RequestHandle) else handle
        if req.terminal:
            return False
        if req.req_id in self._dispatched:
            return self.inner.cancel(self._inner_handles[req.req_id])
        for i, (_, _, r) in enumerate(self._future):
            if r is req:
                del self._future[i]
                heapq.heapify(self._future)
                req.state = RequestState.CANCELLED
                req.finish_time = self._now()
                self._tenant(req.tenant).cancelled_queued += 1
                self.n_cancelled_queued += 1
                return True
        if self._remove_queued(req):
            req.state = RequestState.CANCELLED
            req.finish_time = self._now()
            self._tenant(req.tenant).cancelled_queued += 1
            self.n_cancelled_queued += 1
            return True
        return False

    def queue_pressure(self) -> float:
        return self.inner.queue_pressure() + float(self._total_queued())

    # ------------------------------------------------------- observability
    def gateway_stats(self) -> dict:
        """The gateway's own health surface: aggregate admission
        counters, live depths, the current wait estimate, and one
        counter block per tenant."""
        return {
            "n_submitted": self.n_submitted,
            "n_admitted": self.n_admitted,
            "n_rejected": self.n_rejected,
            "n_degraded": self.n_degraded,
            "n_dispatched": self.n_dispatched,
            "n_expired_queued": self.n_expired_queued,
            "n_cancelled_queued": self.n_cancelled_queued,
            "lane_depths": {ln: len(l) for ln, l in self.lanes.items()},
            "queued_tokens": self._queued_tokens,
            "inflight_tokens": self._inflight_tokens,
            "predicted_wait_s": round(self.predicted_wait_s(), 4),
            "s_per_tok_est": round(self._s_per_tok, 6),
            "ttft_est_s": round(self._ttft_est, 4),
            "tenants": {
                name: {
                    "weight": ts.policy.weight,
                    "queued": ts.queued, "inflight": ts.inflight,
                    "submitted": ts.submitted, "admitted": ts.admitted,
                    "rejected": ts.rejected, "degraded": ts.degraded,
                    "completed": ts.completed, "failed": ts.failed,
                    "expired_queued": ts.expired_queued,
                    "cancelled_queued": ts.cancelled_queued,
                    "tokens_done": ts.tokens_done,
                } for name, ts in sorted(self.tenants.items())},
        }

    def _gauges(self) -> dict:
        n = max(1, self.n_submitted)
        return {
            "gw_submitted": self.n_submitted,
            "gw_admitted": self.n_admitted,
            "gw_rejected": self.n_rejected,
            "gw_degraded": self.n_degraded,
            "gw_queued": self._total_queued(),
            "gw_inflight": len(self._dispatched),
            "gw_reject_rate": round(self.n_rejected / n, 4),
            "gw_degrade_rate": round(self.n_degraded / n, 4),
            "gw_queue_wait_est_s": round(self.predicted_wait_s(), 4),
        }

    def stats(self) -> dict:
        s = dict(self.inner.stats())
        s["gateway"] = self.gateway_stats()
        return s

    def metrics(self):
        """Wrapped tier's metrics with the gateway's gauges merged into
        ``sched_stats`` and ``n_submitted`` widened to count *every*
        submit (the wrapped tier never saw the rejected ones)."""
        m = self.inner.metrics()
        merged = m[0] if isinstance(m, tuple) else m
        merged.n_submitted = self.n_submitted
        merged.sched_stats.update(self._gauges())
        return m
