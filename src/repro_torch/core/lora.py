"""LoRA adapter descriptors and pool construction.

The paper's workload model (§5.1): ``N_a`` adapters, five ranks
{8, 16, 32, 64, 128} with ``N_a/5`` adapters per rank; a request picks a
*rank* by a power-law (smaller ranks more popular) and then an adapter
uniformly within the rank.

Adapter memory: LoRA adds two matrices (A: d×r, B: r×d) per adapted
projection. For a model with ``n_layers`` and ``n_proj`` adapted
projections of width ``d_model``, bytes = n_layers · n_proj · 2 · d · r ·
dtype_bytes. We express sizes in *pool tokens* (see memory_pool.py) so the
cache and the KV allocator share one currency.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

PAPER_RANKS: tuple[int, ...] = (8, 16, 32, 64, 128)


@dataclass(frozen=True)
class AdapterInfo:
    adapter_id: int
    rank: int
    size_bytes: int
    size_tokens: int      # bytes expressed in memory-pool token units

    @property
    def size(self) -> int:
        return self.size_tokens


def adapter_bytes(rank: int, d_model: int, n_layers: int,
                  n_proj: int = 4, dtype_bytes: int = 2) -> int:
    """Size of one adapter's weights (A and B for each adapted projection)."""
    return n_layers * n_proj * 2 * d_model * rank * dtype_bytes


def build_adapter_pool(n_adapters: int, d_model: int, n_layers: int,
                       token_bytes: int, ranks: Sequence[int] = PAPER_RANKS,
                       n_proj: int = 4, dtype_bytes: int = 2,
                       ) -> list[AdapterInfo]:
    """The paper's pool: equal count per rank, ranks ascending."""
    pool: list[AdapterInfo] = []
    per_rank = max(1, n_adapters // len(ranks))
    aid = 0
    for rank in ranks:
        for _ in range(per_rank):
            nbytes = adapter_bytes(rank, d_model, n_layers, n_proj, dtype_bytes)
            pool.append(AdapterInfo(
                adapter_id=aid, rank=rank, size_bytes=nbytes,
                size_tokens=max(1, -(-nbytes // token_bytes))))
            aid += 1
    return pool


def powerlaw_rank_sampler(ranks: Sequence[int] = PAPER_RANKS,
                          alpha: float = 1.0) -> np.ndarray:
    """P(rank_i) ∝ (1/rank_i)^alpha — smaller adapters more popular (§5.1)."""
    w = np.array([1.0 / (r ** alpha) for r in ranks], dtype=np.float64)
    return w / w.sum()


def assign_adapters(n_requests: int, pool: Sequence[AdapterInfo],
                    rng: np.random.Generator, alpha: float = 1.0) -> np.ndarray:
    """Draw an adapter id per request: power-law over ranks, uniform within."""
    ranks = sorted({a.rank for a in pool})
    p_rank = powerlaw_rank_sampler(ranks, alpha)
    by_rank = {r: [a.adapter_id for a in pool if a.rank == r] for r in ranks}
    rank_choice = rng.choice(len(ranks), size=n_requests, p=p_rank)
    out = np.empty(n_requests, dtype=np.int64)
    for i, rc in enumerate(rank_choice):
        out[i] = rng.choice(by_rank[ranks[rc]])
    return out
