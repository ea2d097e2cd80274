"""The unified serving surface: request handles and the ServingSystem
protocol (DESIGN §3).

Every tier — the real JAX engine (``ChameleonEngine``, single- or
mesh-sharded), the real-engine cluster (``EngineCluster``), the
discrete-event simulator (``NodeSimulator``) and its cluster
(``Cluster``), plus the multi-tenant ``Gateway`` that wraps any of
them — serves requests through the same four verbs:

    handle = system.submit(req, sampling=..., on_token=..., ttl=...)
    system.step()            # one iteration (prefill admission + decode)
    system.busy()            # work queued or in flight?
    system.drain()           # run the queue dry

``submit`` is non-blocking and returns a ``RequestHandle`` — the
caller's end of the request: streamed tokens (iterator and/or a
per-token callback), lifecycle state, ``cancel()``, and a ``result()``
carrying tokens plus the latency breakdown (queue wait, adapter-load
wait, TTFT, TBT, E2E).

Lifecycle (see ``core.request.RequestState``):

    QUEUED ──> LOADING ──> RUNNING ──> FINISHED
       │          │           │
       │          │           ├──────> EXPIRED    (deadline passed)
       └──────────┴─────────────────> CANCELLED  (handle.cancel())

REJECTED is a fourth terminal state produced only by gateway admission
control — the request never reaches a scheduler, but its handle still
resolves (with a ``decision`` trace and ``retry_after`` hint).

Every tier is single-threaded and driven by ``step()``; a handle
therefore *pumps* its owning system while the caller blocks on
``stream()`` / ``result()``. Token delivery is position-keyed so a
squash/requeue that re-executes a request's prefix never re-streams
tokens the caller already consumed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Callable, Iterator, Optional, Protocol,
                    runtime_checkable)

import numpy as np

from repro_torch.core.request import Request, RequestState
from repro_torch.core.sampling import SamplingParams

#: One drain bound for every tier. ``drain()`` exits as soon as the
#: system goes idle, so the cap only matters as a hang backstop — but
#: the historical split (DES cluster 2M, engine cluster 10k) meant a
#: long trace could silently under-drain the engine tier and report a
#: truncated run as complete. A DES step is microseconds and an engine
#: step milliseconds; 2M bounds both at minutes of wall time while
#: being unreachable by any healthy workload in this repo.
DRAIN_MAX_STEPS = 2_000_000


@dataclass
class RequestResult:
    """Terminal snapshot of one request: tokens + latency breakdown."""

    req_id: int
    adapter_id: int
    state: RequestState
    tokens: list = field(default_factory=list)
    # Latency breakdown (seconds; None where the phase never happened).
    queue_wait: Optional[float] = None      # arrival -> first admission
    adapter_load_wait: float = 0.0          # stalled on the H2D transfer
    ttft: Optional[float] = None            # arrival -> first token
    e2e: Optional[float] = None             # arrival -> terminal
    tbts: list = field(default_factory=list)
    squashes: int = 0

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    @property
    def finished(self) -> bool:
        return self.state is RequestState.FINISHED

    @property
    def tbt_mean(self) -> float:
        return float(np.mean(self.tbts)) if self.tbts else 0.0

    @property
    def tbt_p99(self) -> float:
        return float(np.percentile(self.tbts, 99)) if self.tbts else 0.0


class RequestHandle:
    """The caller's end of a submitted request.

    Created by ``ServingSystem.submit``; the system pushes tokens into
    it as they are produced (``_push``), the caller reads them via the
    ``tokens`` buffer, the blocking ``stream()`` iterator, or the
    ``on_token`` callback supplied at submit time.
    """

    def __init__(self, req: Request, system: "ServingSystem",
                 on_token: Optional[Callable[[int], None]] = None):
        self.req = req
        self._system = system
        self._on_token = on_token
        self._tokens: list[int] = []
        #: Cluster tiers set this to the replica index the request was
        #: routed to (subsumes the node index the old cluster ``submit``
        #: returned); single-node systems leave it None.
        self.node: Optional[int] = None
        #: Gateway tiers attach the admission decision
        #: (``serving.gateway.GatewayDecision``) here, and on rejection
        #: the suggested retry-after seconds; None everywhere else.
        self.decision = None
        self.retry_after: Optional[float] = None

    # -- identity / state ------------------------------------------------
    @property
    def req_id(self) -> int:
        return self.req.req_id

    @property
    def adapter_id(self) -> int:
        return self.req.adapter_id

    @property
    def state(self) -> RequestState:
        return self.req.state

    @property
    def done(self) -> bool:
        """Terminal: FINISHED, CANCELLED, EXPIRED or REJECTED."""
        return self.req.terminal

    # -- token delivery (system side) ------------------------------------
    def _push(self, pos: int, token: int) -> None:
        """Deliver the token at position ``pos`` (0-based over the
        request's output). Positions already delivered are dropped —
        that is what keeps a squashed request's re-executed prefix from
        re-streaming."""
        if pos < len(self._tokens):
            return
        self._tokens.append(int(token))
        if self._on_token is not None:
            self._on_token(int(token))

    # -- consumption (caller side) ---------------------------------------
    @property
    def tokens(self) -> list[int]:
        """Tokens streamed so far (a copy; safe to mutate)."""
        return list(self._tokens)

    def stream(self, max_steps: int = 100_000) -> Iterator[int]:
        """Yield tokens as they are produced, pumping the owning system
        (``system.step()``) while none are buffered. Ends when the
        request reaches a terminal state (or ``max_steps`` elapses,
        which raises — a stuck system should be loud)."""
        served = 0
        steps = 0
        while True:
            while served < len(self._tokens):
                yield self._tokens[served]
                served += 1
            if self.done:
                return
            if steps >= max_steps:
                raise TimeoutError(
                    f"request {self.req_id} still {self.state.value} "
                    f"after {max_steps} steps")
            self._system.step()
            steps += 1

    def __iter__(self) -> Iterator[int]:
        return self.stream()

    def cancel(self) -> bool:
        """Request cancellation. Queued/LOADING requests cancel
        immediately; RUNNING ones at the next step boundary (a jit'd
        decode cannot be interrupted mid-call). Returns True if the
        request will terminate as CANCELLED, False if it already
        reached a terminal state."""
        return self._system.cancel(self)

    def result(self, max_steps: int = 100_000) -> RequestResult:
        """Block (pumping the system) until terminal; return the final
        tokens and latency breakdown."""
        for _ in self.stream(max_steps=max_steps):
            pass
        req = self.req
        return RequestResult(
            req_id=req.req_id, adapter_id=req.adapter_id,
            state=req.state, tokens=self.tokens,
            queue_wait=req.queue_wait(),
            adapter_load_wait=req.adapter_load_wait,
            ttft=req.ttft(), e2e=req.e2e(),
            tbts=list(req.preserved_tbts), squashes=req.squash_count)


@runtime_checkable
class ServingSystem(Protocol):
    """What every serving tier implements (DESIGN §3).

    ``metrics()`` returns a ``RunMetrics`` on single-node systems and a
    ``(merged, per_node)`` tuple on clusters; everything else is
    uniform. ``build_system`` in ``serving.systems`` is the factory.
    """

    def submit(self, req: Request, *,
               sampling: Optional[SamplingParams] = None,
               on_token: Optional[Callable[[int], None]] = None,
               ttl: Optional[float] = None) -> RequestHandle: ...

    def step(self) -> None: ...

    def busy(self) -> bool: ...

    def drain(self, max_steps: int = DRAIN_MAX_STEPS) -> None: ...

    def cancel(self, handle: RequestHandle) -> bool: ...

    def queue_pressure(self) -> float: ...

    def stats(self) -> dict: ...

    def metrics(self): ...


def prepare_request(req: Request, system: "ServingSystem", now: float,
                    sampling: Optional[SamplingParams],
                    on_token: Optional[Callable[[int], None]],
                    ttl: Optional[float]) -> RequestHandle:
    """Shared submit-side plumbing: attach sampling, stamp the arrival,
    arm the deadline, build the handle. Systems call this before
    enqueueing with their scheduler."""
    if sampling is not None:
        req.sampling = sampling
    # Interactive submits (the default arrival_time=0.0) arrive *now*
    # on the system's clock — without this, queue_wait/TTFT/E2E would
    # be measured from the clock epoch (e.g. engine construction + jit
    # compiles), not from submission. Trace replays carry explicit
    # arrival times and are untouched.
    if req.arrival_time == 0.0 and now > 0.0:
        req.arrival_time = now
    if ttl is not None and req.deadline is None:
        req.deadline = now + ttl
    return RequestHandle(req, system, on_token=on_token)
