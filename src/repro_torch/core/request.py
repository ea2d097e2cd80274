"""Request lifecycle for many-adapter LLM serving.

A request arrives with a known input length (or real prompt tokens), an
(unknown at admission) true output length, and the id of the LoRA
adapter it targets. The scheduler sees only the *predicted* output
length. All timestamps are floats in seconds on an externally-supplied
clock so that the same code drives both the real engine and the
discrete-event simulator.

Lifecycle (DESIGN §3):

    QUEUED --> LOADING --> RUNNING --> FINISHED
       |          |           |  ^
       |          |           |  | (disagg: prefill done, KV in flight)
       |          |           v  |
       |          |         MIGRATING
       |          |           |
       |          |           +-----> EXPIRED   (deadline passed)
       +----------+----------------> CANCELLED  (handle.cancel())

REJECTED is a fourth terminal state reached *before* QUEUED: gateway
admission control (serving/gateway.py) refused entry, so no scheduler
ever saw the request. Its handle still resolves (state + decision
trace) — a refused submit is reported, never dropped.

MIGRATING (serving/disagg.py) is the disaggregated-cluster handoff
window: prefill completed on a prefill-role replica and the request's
KV pages are crossing the inter-replica link to a decode replica. The
request holds pool references on *both* ends (source pages are
share-pinned so eviction cannot reclaim them mid-copy); cancel and
deadline expiry remain legal and must release both sides.

LOADING is the async-adapter deferral: admission pinned the adapter and
its host->device transfer is in flight, so the request cannot be placed
yet (the rest of the batch proceeds). RUNNING requests may bounce back
to QUEUED via the squash path (bypass misprediction / page preemption);
``preserved_tokens`` keeps the already-streamed prefix across that
requeue so the user-visible stream never rewinds.
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Optional

from .sampling import SamplingParams

_req_counter = itertools.count()

#: Terminal lifecycle states: once reached, a request never leaves.
TERMINAL_STATES: frozenset = None  # filled below (needs RequestState)


class RequestState(enum.Enum):
    QUEUED = "queued"
    LOADING = "loading"       # admission pinned the adapter; H2D in flight
    RUNNING = "running"       # in the continuous batch (prefill or decode)
    MIGRATING = "migrating"   # disagg: KV handoff prefill -> decode replica
    FINISHED = "finished"
    CANCELLED = "cancelled"   # handle.cancel() before completion
    EXPIRED = "expired"       # deadline/TTL passed before completion
    SQUASHED = "squashed"     # bypasser that exceeded its predicted length
    REJECTED = "rejected"     # gateway admission control refused entry


TERMINAL_STATES = frozenset({RequestState.FINISHED, RequestState.CANCELLED,
                             RequestState.EXPIRED, RequestState.REJECTED})


@dataclass
class Request:
    """One inference request."""

    input_len: int
    output_len: int                 # ground truth (revealed token by token)
    adapter_id: int
    arrival_time: float = 0.0
    req_id: int = field(default_factory=lambda: next(_req_counter))

    # Multi-tenant serving: which tenant (org/user) submitted this.
    # Engines and schedulers ignore it; the gateway keys its per-tenant
    # limits, fair-queueing weights and decision traces on it.
    tenant: str = "default"

    # Real prompt token ids (length == input_len). None keeps the
    # synthetic arange prompt the engine historically fabricated, so
    # trace-driven workloads need no token material.
    prompt: Optional[list] = None

    # How to turn logits into tokens (engine tier). None = greedy.
    sampling: Optional[SamplingParams] = None

    # Absolute deadline on the serving system's clock; the scheduler
    # reaps queued requests past it and the engine step loop expires
    # running ones. None = no deadline.
    deadline: Optional[float] = None

    # Filled by the predictor at admission.
    predicted_output: int = 0

    # Scheduling metadata.
    wrs: float = 0.0                # weighted request size
    queue_idx: int = -1
    charges: list = field(default_factory=list)   # [(queue_idx, tokens)] quota charges
    reserved_tokens: int = 0                      # memory-pool reservation
    bypassed: bool = False                        # admitted via the bypass lane
    squash_count: int = 0
    # Async adapter loads: True once admission has pinned (and begun
    # loading) this request's adapter; placement may still be deferred
    # until the load completes, and the pin survives the deferral so
    # the mid-flight adapter cannot be evicted out from under it.
    adapter_ref: bool = False
    # Cooperative cancellation: set by RequestHandle.cancel() on a
    # RUNNING request; the engine finalises the slot at the next step
    # boundary (a jit'd decode cannot be interrupted mid-call).
    cancel_requested: bool = False

    # Progress.
    state: RequestState = RequestState.QUEUED
    generated: int = 0              # decode tokens emitted so far

    # Squash/requeue continuity: tokens already surfaced to the handle
    # (and their TBT records) survive the requeue; re-execution
    # regenerates the same prefix (greedy / position-seeded sampling is
    # deterministic) without re-streaming or re-counting it.
    preserved_tokens: list = field(default_factory=list)
    preserved_tbts: list = field(default_factory=list)
    # Engine clock time of the last token actually streamed to the
    # handle; survives requeue so the first *new* token after a squash
    # gets an honest TBT (measured from what the user last saw, not
    # from the silent re-execution of the prefix).
    last_stream_time: Optional[float] = None

    # Timestamps (seconds).
    first_scheduled_time: Optional[float] = None
    first_token_time: Optional[float] = None      # TTFT reference point
    finish_time: Optional[float] = None
    adapter_load_wait: float = 0.0  # time spent stalled on adapter loading
    load_wait_start: Optional[float] = None       # deferral began (transient)

    def __post_init__(self):
        if self.prompt is not None:
            self.prompt = list(self.prompt)
            if len(self.prompt) != self.input_len:
                # The prompt is authoritative when both are given.
                self.input_len = len(self.prompt)

    # ------------------------------------------------------------------
    @property
    def total_true_tokens(self) -> int:
        return self.input_len + self.output_len

    def predicted_total_tokens(self) -> int:
        return self.input_len + self.predicted_output

    @property
    def max_output_tokens(self) -> int:
        """Decode budget: the workload truth capped by SamplingParams."""
        if self.sampling is not None \
                and self.sampling.max_new_tokens is not None:
            return min(self.output_len, self.sampling.max_new_tokens)
        return self.output_len

    @property
    def done(self) -> bool:
        return self.generated >= self.max_output_tokens

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def exceeded_prediction(self) -> bool:
        """True when the request ran past its predicted decode length."""
        return self.generated > self.predicted_output

    # Latency metrics -----------------------------------------------------
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def e2e(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    def queue_wait(self) -> Optional[float]:
        """Arrival -> first admission into the batch."""
        if self.first_scheduled_time is None:
            return None
        return self.first_scheduled_time - self.arrival_time

    def stash_progress(self, tokens: Optional[list],
                       tbts: Optional[list],
                       last_stream_time: Optional[float]) -> None:
        """Squash/preemption: keep the already-streamed tokens, their
        TBT records and the last stream timestamp on the request so
        the requeue (and the eventual re-execution) preserves them.
        One implementation shared by every serving tier — the engine
        and the DES pop their per-request records into this."""
        if tokens is not None:
            self.preserved_tokens = tokens
        if tbts is not None:
            self.preserved_tbts = tbts
        if last_stream_time is not None:
            self.last_stream_time = last_stream_time

    def reset_for_requeue(self) -> None:
        """Squash: roll progress back so the request re-executes fully."""
        self.generated = 0
        self.state = RequestState.QUEUED
        self.charges = []
        self.reserved_tokens = 0
        self.bypassed = False
        self.adapter_ref = False     # the squash path released the pin
        self.load_wait_start = None
        self.squash_count += 1
        # TTFT is *not* reset when tokens were already streamed: the
        # user saw the preserved prefix, so the original first-token
        # timestamp is the honest one. Without streamed tokens (legacy
        # paths that never populated preserved_tokens) the first token
        # is only surfaced once prefill re-runs, so it is cleared.
        if not self.preserved_tokens:
            self.first_token_time = None
