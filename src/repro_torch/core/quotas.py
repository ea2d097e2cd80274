"""Per-queue resource-quota assignment via M/M/1 (paper §4.2).

For each queue q with max request size S (tokens), expected duration D
(seconds), arrival rate λ (req/s) and latency target SLO (seconds):

    service rate     µ = Tok / (S · D)          [requests/s the quota sustains]
    time in system   T = 1 / (µ − λ)
    SLO constraint   T ≤ SLO
    ⇒  Tok_min ≥ S · D · (1/SLO + λ)

Each queue gets its Tok_min; the remaining budget is split proportionally
to the Tok_min weights. If Σ Tok_min exceeds the budget the system is in
overload: quotas are scaled down proportionally (SLOs are best-effort
until load subsides) — the paper's model implicitly assumes feasibility,
we make the overload path explicit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class QueueStats:
    max_size: float          # S: max tokens of a request admitted to this queue
    duration: float          # D: expected seconds a request occupies resources
    arrival_rate: float      # λ: req/s entering this queue
    slo: float               # seconds


def tok_min(stats: QueueStats) -> float:
    """Paper formula with a progress guard.

    The raw formula S·D·(1/SLO + λ) can fall below S itself whenever
    D·(1/SLO + λ) < 1 (lightly-loaded queue of large requests) — a quota
    smaller than one maximal request permanently starves the queue,
    since phase-2 redistribution only lends tokens left over by *empty*
    queues. We therefore floor the quota at S: every queue must always
    be able to hold at least one of its largest requests.
    """
    raw = stats.max_size * stats.duration * (1.0 / stats.slo
                                             + stats.arrival_rate)
    return max(raw, stats.max_size)


def assign_quotas(queues: list[QueueStats], total_tokens: int,
                  ) -> list[int]:
    """Integer token quota per queue, summing to ``total_tokens``."""
    if not queues:
        return []
    mins = np.array([tok_min(q) for q in queues], dtype=np.float64)
    mins = np.maximum(mins, 1.0)
    total = float(total_tokens)
    if mins.sum() >= total:
        # Overload: proportional scale-down.
        quota = mins / mins.sum() * total
    else:
        spare = total - mins.sum()
        quota = mins + spare * (mins / mins.sum())
    out = np.floor(quota).astype(int)
    out = np.maximum(out, 1)
    # Settle the rounding residue on the largest queues while keeping
    # every quota >= 1 (hypothesis found the naive "give it to queue 0"
    # version overflowing the budget when min-bumps exceeded it).
    residue = total_tokens - int(out.sum())
    while residue != 0:
        if residue > 0:
            out[int(np.argmax(out))] += residue
            residue = 0
        else:
            i = int(np.argmax(out))
            take = min(out[i] - 1, -residue)
            if take <= 0:
                break            # budget < n queues: all floored at 1
            out[i] -= take
            residue += take
    return out.tolist()
