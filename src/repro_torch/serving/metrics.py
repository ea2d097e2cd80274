"""Serving metrics: TTFT / TBT / E2E percentiles, slowdown, SLO attainment.

Definitions follow the paper (§2): TTFT = arrival → first output token
(queueing + adapter load + prefill); TBT = time between subsequent
tokens; throughput = highest load sustained without violating the TTFT
SLO; SLO = 5× the low-load latency (§2, §5.1). Slowdown = response time
/ isolated response time (Fig. 7).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


#: Registry of every gauge a serving tier can export through
#: ``metrics()`` (``cache_stats`` / ``sched_stats``) or the gateway's
#: ``_gauges()``: name -> (unit, one-line meaning). docs/OPERATIONS.md
#: documents each entry with its healthy range and the overload symptom
#: it diagnoses; ``tests/test_gateway.py`` asserts the doc covers every
#: name here and that live systems emit no gauge missing from this
#: table — add the gauge HERE and to the doc when you add one to a
#: tier.
GAUGES: dict = {
    # Adapter cache (all tiers).
    "hit_rate": ("ratio", "adapter-cache hit fraction"),
    "hits": ("count", "adapter-cache hits"),
    "misses": ("count", "adapter-cache misses (each one is an H2D load)"),
    "evictions": ("count", "adapters evicted from device"),
    "gb_loaded": ("GB", "total adapter bytes moved host->device"),
    "link_busy_frac": ("ratio", "PCIe/NVLink busy fraction (sim tier)"),
    # Scheduler / engine control plane.
    "bypassed": ("count", "requests admitted via the bypass lane"),
    "squashed": ("count", "bypassers squashed on misprediction"),
    "queues": ("count", "Chameleon MLQ queue count after adaptation"),
    "deferred": ("count", "placements deferred while the adapter loads"),
    "cancelled": ("count", "requests cancelled before completion"),
    "expired": ("count", "requests that hit their deadline"),
    "async_loads": ("count", "adapter loads overlapped with decode"),
    "pressure": ("requests", "scheduler backlog + in-flight (routing signal)"),
    "batch_occupancy_mean": ("ratio", "mean continuous-batch slot occupancy"),
    # Paged KV plane.
    "kv_pages_used": ("pages", "KV pages currently allocated"),
    "kv_pages_total": ("pages", "KV pages in the pool"),
    "kv_page_util": ("ratio", "KV page utilisation"),
    "preempted": ("count", "requests preempted out of pages"),
    # Prefix cache.
    "prefix_hit_rate": ("ratio", "prompt tokens served from the radix tree"),
    "prefix_hit_tokens": ("tokens", "prompt tokens reused"),
    "prefix_lookup_tokens": ("tokens", "prompt tokens looked up"),
    "prefix_hits": ("count", "requests with a non-empty prefix match"),
    "prefix_shared_pages": ("pages", "pages shared via refcounting"),
    "prefix_nodes": ("count", "radix-tree nodes resident"),
    "prefix_evictions": ("count", "radix-tree leaves evicted"),
    "cow_forks": ("count", "copy-on-write page forks"),
    # Sharded engine.
    "mesh_shape": ("(data,model)", "serving mesh shape"),
    "n_devices": ("count", "devices in the serving mesh"),
    "per_shard_pages_used": ("pages", "KV pages used per data shard"),
    "per_shard_pages_total": ("pages", "KV pages per data shard"),
    "per_shard_lora_slot_bytes": ("bytes", "LoRA arena bytes on one device"),
    "collective_frac": ("ratio", "wall-time fraction spent in collectives"),
    "collective_dispatches": ("count", "jit dispatches containing collectives"),
    # Disaggregated prefill/decode (serving/disagg.py). The first five
    # are per-engine (chunked prefill + KV handoff endpoints); the rest
    # are cluster-level, injected by DisaggCluster.metrics().
    "chunked_prefills": ("count", "prefill chunks executed (chunked prefill)"),
    "kv_exports": ("count", "requests whose KV was exported (handoff src)"),
    "kv_imports": ("count", "requests whose KV was imported (handoff dst)"),
    "kv_handoff_gb": ("GB", "KV bytes scattered in on the import side"),
    "migrating": ("requests", "requests currently in the MIGRATING window"),
    "prefill_nodes": ("count", "replicas currently in the prefill role"),
    "decode_nodes": ("count", "replicas currently in the decode role"),
    "spilled_prefills": ("count", "requests spilled back to decode replicas"),
    "role_rebalances": ("count", "replicas moved across roles (autoscaler)"),
    "prefill_util": ("ratio", "mean batch-slot occupancy, prefill tier"),
    "decode_util": ("ratio", "mean batch-slot occupancy, decode tier"),
    "handoffs": ("count", "KV shipments delivered prefill->decode"),
    "handoff_gb": ("GB", "KV bytes moved over the inter-replica link"),
    "handoff_wait_s": ("seconds", "mean export->import handoff latency"),
    "handoffs_inflight": ("requests", "shipments on the modeled link now"),
    "handoffs_dropped": ("count", "shipments cancelled/expired in flight"),
    # Speculative draft–verify decoding (engine, spec_decode=True).
    "spec_accept_rate": ("ratio", "draft tokens accepted by the target"),
    "spec_drafted_tokens": ("tokens", "draft tokens proposed"),
    "spec_accepted_tokens": ("tokens", "draft tokens verified accepted"),
    "spec_draft_dispatches": ("count", "draft-model forward passes"),
    "spec_verify_dispatches": ("count", "multi-token target verifies"),
    "spec_dispatches": ("count", "fused speculative blocks launched"),
    "spec_k_eff": ("tokens", "current EWMA-adapted draft length"),
    # Gateway (serving/gateway.py).
    "gw_submitted": ("count", "requests submitted through the gateway"),
    "gw_admitted": ("count", "requests admitted (incl. degraded)"),
    "gw_rejected": ("count", "requests refused by admission control"),
    "gw_degraded": ("count", "requests admitted with a reduced max_new_tokens"),
    "gw_queued": ("requests", "requests currently held in gateway lanes"),
    "gw_inflight": ("requests", "requests dispatched into the wrapped tier"),
    "gw_reject_rate": ("ratio", "rejected / submitted"),
    "gw_degrade_rate": ("ratio", "degraded / submitted"),
    "gw_queue_wait_est_s": ("seconds", "current backlog drain estimate"),
}


@dataclass
class RequestRecord:
    req_id: int
    adapter_id: int
    rank: int
    input_len: int
    output_len: int
    arrival: float
    ttft: float
    e2e: float
    tbt_mean: float
    tbt_p99: float
    slowdown: float
    squashes: int = 0
    bypassed: bool = False
    # Latency breakdown (TTFT = queue_wait + load_wait + prefill time).
    queue_wait: float = 0.0        # arrival -> first admission
    load_wait: float = 0.0         # stalled on the adapter H2D transfer


@dataclass
class RunMetrics:
    records: list[RequestRecord] = field(default_factory=list)
    horizon: float = 0.0
    n_submitted: int = 0
    cache_stats: dict = field(default_factory=dict)
    sched_stats: dict = field(default_factory=dict)

    # ------------------------------------------------------------------
    def _arr(self, attr: str) -> np.ndarray:
        return np.array([getattr(r, attr) for r in self.records],
                        dtype=np.float64)

    def percentile(self, attr: str, q: float) -> float:
        a = self._arr(attr)
        return float(np.percentile(a, q)) if len(a) else float("nan")

    def p99_ttft(self) -> float:
        return self.percentile("ttft", 99)

    def p50_ttft(self) -> float:
        return self.percentile("ttft", 50)

    def p99_tbt(self) -> float:
        a = self._arr("tbt_p99")
        return float(np.percentile(a, 99)) if len(a) else float("nan")

    def p99_slowdown(self) -> float:
        return self.percentile("slowdown", 99)

    def completed(self) -> int:
        return len(self.records)

    def goodput_tokens_per_s(self) -> float:
        if self.horizon <= 0:
            return 0.0
        tok = sum(r.input_len + r.output_len for r in self.records)
        return tok / self.horizon

    def slo_attainment(self, ttft_slo: float) -> float:
        a = self._arr("ttft")
        if not len(a):
            return 0.0
        return float((a <= ttft_slo).mean())

    def violates_slo(self, ttft_slo: float, percentile: float = 99.0) -> bool:
        return self.percentile("ttft", percentile) > ttft_slo

    def per_rank_p99_ttft(self) -> dict[int, float]:
        out: dict[int, float] = {}
        ranks = sorted({r.rank for r in self.records})
        for rk in ranks:
            vals = [r.ttft for r in self.records if r.rank == rk]
            out[rk] = float(np.percentile(vals, 99)) if vals else float("nan")
        return out

    def timeline_p99_ttft(self, bucket_s: float = 10.0,
                          ) -> list[tuple[float, float]]:
        """(bucket_end_time, p99 TTFT of requests arriving in bucket)."""
        if not self.records:
            return []
        out = []
        t_max = max(r.arrival for r in self.records)
        edges = np.arange(0.0, t_max + bucket_s, bucket_s)
        for lo, hi in zip(edges[:-1], edges[1:]):
            vals = [r.ttft for r in self.records if lo <= r.arrival < hi]
            if vals:
                out.append((float(hi), float(np.percentile(vals, 99))))
        return out

    def summary(self) -> dict:
        return {
            "completed": self.completed(),
            "submitted": self.n_submitted,
            "p50_ttft": self.p50_ttft(),
            "p99_ttft": self.p99_ttft(),
            "p99_tbt": self.p99_tbt(),
            "p99_slowdown": self.p99_slowdown(),
            "goodput_tok_s": self.goodput_tokens_per_s(),
            **{f"cache_{k}": v for k, v in self.cache_stats.items()},
            **{f"sched_{k}": v for k, v in self.sched_stats.items()},
        }


def merge_metrics(per_node: list[RunMetrics],
                  n_submitted: int | None = None) -> RunMetrics:
    """Aggregate per-node RunMetrics into one cluster-level view.

    Records concatenate (percentiles are then cluster-wide over every
    request), the horizon is the slowest node's, and cache/scheduler
    counters sum — with hit_rate recomputed from the summed hit/miss
    counts rather than averaged (nodes see different traffic volumes),
    and non-additive gauges (busy fractions, pressure) reported as the
    worst node's value instead of a meaningless sum.
    """
    # Non-additive gauges: report the worst node instead of a sum.
    # kv_page_util / batch_occupancy_mean are fractions of per-node
    # capacity; kv_pages_used/total and preempted counts stay additive.
    # collective_frac (sharded engines) is a wall-time fraction.
    ratio_gauges = ("link_busy_frac", "pressure", "kv_page_util",
                    "batch_occupancy_mean", "prefix_hit_rate",
                    "collective_frac", "gw_reject_rate",
                    "gw_degrade_rate", "gw_queue_wait_est_s",
                    "spec_accept_rate", "spec_k_eff")
    merged = RunMetrics(
        n_submitted=(n_submitted if n_submitted is not None
                     else sum(m.n_submitted for m in per_node)))
    hits = misses = 0
    summed: dict[str, float] = {}
    sched: dict[str, float] = {}
    for m in per_node:
        merged.records.extend(m.records)
        merged.horizon = max(merged.horizon, m.horizon)
        hits += int(m.cache_stats.get("hits", 0))
        misses += int(m.cache_stats.get("misses", 0))
        for k, v in m.cache_stats.items():
            if k in ("hit_rate", "hits", "misses") \
                    or not isinstance(v, (int, float)):
                continue
            summed[k] = (max(summed.get(k, 0), v) if k in ratio_gauges
                         else summed.get(k, 0) + v)
        for k, v in m.sched_stats.items():
            if not isinstance(v, (int, float)):
                continue
            sched[k] = (max(sched.get(k, 0), v) if k in ratio_gauges
                        else sched.get(k, 0) + v)
    merged.cache_stats = {
        "hit_rate": hits / max(hits + misses, 1),
        "hits": hits, "misses": misses, **summed}
    merged.sched_stats = sched
    return merged


def slo_from_lowload(cost_model, trace_like, multiplier: float = 5.0,
                     stat: float = 99.0) -> tuple[float, float]:
    """Paper SLO: 5× the low-load TTFT and TBT.

    Computed analytically from the cost model over the trace's request
    population (requests executed alone, warm adapter for TBT, cold for
    TTFT). ``stat`` picks the low-load reference percentile: the SLO is
    compared against *P99* TTFT (Fig. 10), so the reference must be the
    low-load P99 — a 5×-mean SLO would sit below the isolated latency
    of the largest requests and be unattainable at any load.
    """
    reqs = trace_like.requests if hasattr(trace_like, "requests") else trace_like
    ttfts, tbts = [], []
    for r in reqs[: min(len(reqs), 512)]:
        rank = getattr(r, "rank", None)
        if rank is None:
            rank = 32
        ttfts.append(cost_model.isolated_ttft(r.input_len, rank))
        tbts.append(cost_model.decode_time(1, r.input_len, [rank]))
    return (multiplier * float(np.percentile(ttfts, stat)),
            multiplier * float(np.percentile(tbts, stat)))
