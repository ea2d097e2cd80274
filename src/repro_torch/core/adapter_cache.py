"""Chameleon Adapter Cache (paper §4.1).

A software-managed, dynamically-sized cache of LoRA adapters in device
HBM. Backed by the unified MemoryPool: the cache owns whatever tokens
requests are not using, and shrinks on demand when the scheduler needs
memory for a new batch.

Per-entry metadata (paper list): adapter id, rank/size, last-used
timestamp, usage frequency (decayed count within a window), reference
counter. Eviction applies only to RC == 0 entries; entries needed by
*queued* requests are second-tier protected (evicted only under
pressure, paper §4.1 last paragraph).

Cost-aware eviction score (keep-value — lowest evicted):

    Score = F·Frequency + R·Recency + S·Size      F,R,S = 0.45, 0.10, 0.45

Each factor is min-max normalised over the current eviction candidates:
frequency (decayed use count, higher = keep), recency (newer = keep),
size (bigger = costlier to reload = keep).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from .lora import AdapterInfo


class AdapterState(enum.Enum):
    """Residency sub-state of a cache entry (async load state machine).

    Entries are READY by default (synchronous loads, the simulator's
    charged-latency loads). An engine whose ``on_load`` hook only
    *dispatches* the host→device slot write marks the entry LOADING and
    flips it to READY once the transfer completes; schedulers refuse to
    place a LOADING adapter into a batch (the request defers, the rest
    of the batch proceeds) and eviction never selects a mid-flight
    entry.
    """

    LOADING = "loading"
    READY = "ready"


@dataclass
class CacheEntry:
    info: AdapterInfo
    last_used: float = 0.0
    frequency: float = 0.0
    ref_count: int = 0
    state: AdapterState = AdapterState.READY

    @property
    def size_tokens(self) -> int:
        return self.info.size_tokens


@dataclass
class EvictionWeights:
    frequency: float = 0.45
    recency: float = 0.10
    size: float = 0.45


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    bytes_loaded: int = 0
    bytes_evicted: int = 0
    shrink_events: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class EvictionPolicy:
    """Base: subclass and override ``scores``. Lowest score is evicted."""

    name = "base"

    def scores(self, entries: list[CacheEntry], now: float) -> list[float]:
        raise NotImplementedError


class CostAwareEviction(EvictionPolicy):
    """The paper's compound policy (F=0.45, R=0.10, S=0.45)."""

    name = "chameleon"

    def __init__(self, weights: EvictionWeights | None = None):
        self.w = weights or EvictionWeights()

    @staticmethod
    def _norm(vals: list[float]) -> list[float]:
        """Max-normalise non-negative factors.

        Min-max normalisation is wrong here: with near-identical factor
        values it amplifies noise to full [0,1] scale and can dominate
        the compound score. Dividing by the max preserves relative
        magnitudes instead.
        """
        hi = max(vals)
        if hi < 1e-12:
            return [0.0] * len(vals)
        return [v / hi for v in vals]

    def scores(self, entries: list[CacheEntry], now: float) -> list[float]:
        freq = self._norm([e.frequency for e in entries])
        # Recency as 1/(1+age): newer = keep, bounded and positive.
        rec = self._norm([1.0 / (1.0 + max(0.0, now - e.last_used))
                          for e in entries])
        size = self._norm([float(e.size_tokens) for e in entries])
        return [self.w.frequency * f + self.w.recency * r + self.w.size * s
                for f, r, s in zip(freq, rec, size)]


class FairShareEviction(CostAwareEviction):
    """Equal weights over the same three factors (paper Fig. 14)."""

    name = "fairshare"

    def __init__(self):
        third = 1.0 / 3.0
        super().__init__(EvictionWeights(third, third, third))


class LRUEviction(EvictionPolicy):
    """Plain recency (paper Fig. 14 baseline)."""

    name = "lru"

    def scores(self, entries: list[CacheEntry], now: float) -> list[float]:
        return [-(now - e.last_used) for e in entries]


class AdapterCache:
    """Cache manager: residency, reference counts, cost-aware eviction.

    ``on_load(info)`` / ``on_evict(info)`` hooks let the engine perform
    (or the simulator charge for) the actual H2D transfer; the cache
    itself only manages metadata + pool accounting.
    """

    def __init__(self, pool, adapters: dict[int, AdapterInfo],
                 policy: EvictionPolicy | None = None,
                 freq_decay: float = 0.999,
                 on_load: Optional[Callable[[AdapterInfo], None]] = None,
                 on_evict: Optional[Callable[[AdapterInfo], None]] = None,
                 enabled: bool = True,
                 max_entries: Optional[int] = None):
        self.pool = pool
        self.catalog = adapters
        self.policy = policy or CostAwareEviction()
        self.freq_decay = freq_decay
        self.entries: dict[int, CacheEntry] = {}
        self.stats = CacheStats()
        self.on_load = on_load
        self.on_evict = on_evict
        # Hard cap on resident adapters (device slot buffers in the
        # engine are a fixed array; None = token accounting only).
        self.max_entries = max_entries
        # enabled=False reproduces the S-LoRA baseline: adapters are
        # dropped as soon as their last request finishes.
        self.enabled = enabled

    # -- residency -------------------------------------------------------
    def resident(self, adapter_id: int) -> bool:
        return adapter_id in self.entries

    def resident_ids(self) -> set[int]:
        return set(self.entries)

    def resident_tokens(self) -> int:
        return sum(e.size_tokens for e in self.entries.values())

    # -- async load state machine ------------------------------------------
    def mark_loading(self, adapter_id: int) -> None:
        """Entry's device bytes are in flight (engine ``on_load`` hooks
        that dispatch the H2D write without blocking call this)."""
        self.entries[adapter_id].state = AdapterState.LOADING

    def mark_ready(self, adapter_id: int) -> None:
        """Transfer completed; the adapter may now be placed in batches."""
        entry = self.entries.get(adapter_id)
        if entry is not None:
            entry.state = AdapterState.READY

    def is_ready(self, adapter_id: int) -> bool:
        """Resident *and* usable in a batch (not mid-load)."""
        entry = self.entries.get(adapter_id)
        return entry is not None and entry.state is AdapterState.READY

    def loading_ids(self) -> set[int]:
        return {aid for aid, e in self.entries.items()
                if e.state is AdapterState.LOADING}

    def _decay_all(self) -> None:
        for e in self.entries.values():
            e.frequency *= self.freq_decay

    # -- acquire / release -------------------------------------------------
    def acquire(self, adapter_id: int, now: float,
                queued_protect: Iterable[int] = ()) -> bool:
        """Pin an adapter for a running request.

        Returns True on a cache hit; False when the adapter had to be
        loaded (caller charges the load latency). Raises PoolError if it
        cannot fit even after evicting every unpinned adapter.

        ``queued_protect`` (adapter ids of queued requests) flows through
        to eviction so the §4.1 second-tier protection holds on the load
        path too — without it, loading a cold adapter would happily evict
        an adapter the very next admission is about to need.
        """
        self._decay_all()
        entry = self.entries.get(adapter_id)
        if entry is not None:
            entry.ref_count += 1
            entry.last_used = now
            entry.frequency += 1.0
            self.stats.hits += 1
            return True
        info = self.catalog[adapter_id]
        self._ensure_slot_capacity(now, queued_protect)
        self.make_room(info.size_tokens, now, queued_protect)
        self.pool.hold_adapter(adapter_id, info.size_tokens)
        entry = CacheEntry(info=info, last_used=now, frequency=1.0,
                           ref_count=1)
        self.entries[adapter_id] = entry
        self.stats.misses += 1
        self.stats.bytes_loaded += info.size_bytes
        if self.on_load:
            self.on_load(info)
        return False

    def release(self, adapter_id: int, now: float) -> None:
        entry = self.entries.get(adapter_id)
        if entry is None:
            return
        entry.ref_count = max(0, entry.ref_count - 1)
        entry.last_used = now
        if entry.ref_count == 0 and not self.enabled \
                and entry.state is AdapterState.READY:
            # S-LoRA baseline: discard immediately once unused (never a
            # mid-load entry — its slot write is still in flight).
            self._evict(adapter_id)

    # -- prefetch ----------------------------------------------------------
    def prefetch(self, adapter_id: int, now: float,
                 queued_protect: Iterable[int] = ()) -> bool:
        """Load without pinning (for queued requests). True if loaded.

        ``queued_protect`` keeps the §4.1 second-tier protection live on
        this load path too (see ``acquire``).
        """
        if adapter_id in self.entries:
            return False
        info = self.catalog[adapter_id]
        if info.size_tokens > self._evictable_tokens() + self.pool.free_tokens:
            return False
        if (self.max_entries is not None
                and len(self.entries) >= self.max_entries
                and not self._evictable()):
            return False
        self._ensure_slot_capacity(now, queued_protect)
        self.make_room(info.size_tokens, now, queued_protect)
        self.pool.hold_adapter(adapter_id, info.size_tokens)
        self.entries[adapter_id] = CacheEntry(info=info, last_used=now,
                                              frequency=0.5, ref_count=0)
        self.stats.bytes_loaded += info.size_bytes
        if self.on_load:
            self.on_load(info)
        return True

    def _ensure_slot_capacity(self, now: float,
                              queued_protect: Iterable[int] = ()) -> None:
        """Evict (lowest score first) until an entry slot is free.

        Same two protection tiers as ``make_room``: protected (queued)
        adapters go only when no unprotected candidate remains.
        """
        if self.max_entries is None:
            return
        while len(self.entries) >= self.max_entries:
            cands = self._evictable(queued_protect) or self._evictable()
            if not cands:
                from .memory_pool import PoolError
                raise PoolError("all adapter slots pinned")
            scores = self.policy.scores(cands, now)
            self._evict(cands[scores.index(min(scores))].info.adapter_id)

    # -- eviction ----------------------------------------------------------
    def _evictable(self, protect: Iterable[int] = ()) -> list[CacheEntry]:
        """RC == 0, unprotected, and not mid-load.

        A LOADING entry is never an eviction candidate: its H2D write is
        in flight and would land in a slot the engine had already handed
        to someone else. Loads complete within an iteration or two, so
        the protection is short-lived.
        """
        protect = set(protect)
        return [e for aid, e in self.entries.items()
                if e.ref_count == 0 and aid not in protect
                and e.state is AdapterState.READY]

    def _evictable_tokens(self, protect: Iterable[int] = ()) -> int:
        return sum(e.size_tokens for e in self._evictable(protect))

    def _evict(self, adapter_id: int) -> int:
        entry = self.entries.pop(adapter_id)
        tokens = self.pool.drop_adapter(adapter_id)
        self.stats.evictions += 1
        self.stats.bytes_evicted += entry.info.size_bytes
        if self.on_evict:
            self.on_evict(entry.info)
        return tokens

    def make_room(self, tokens_needed: int, now: float,
                  queued_protect: Iterable[int] = ()) -> int:
        """Evict lowest-score adapters until ``tokens_needed`` fit.

        Two protection tiers (paper §4.1): running adapters (RC>0) are
        untouchable; adapters of queued requests are evicted only if
        unprotected candidates do not suffice.
        """
        freed = 0
        for protect in (queued_protect, ()):
            while self.pool.free_tokens < tokens_needed:
                cands = self._evictable(protect)
                if not cands:
                    break
                scores = self.policy.scores(cands, now)
                victim = cands[scores.index(min(scores))]
                freed += self._evict(victim.info.adapter_id)
            if self.pool.free_tokens >= tokens_needed:
                return freed
        if self.pool.free_tokens < tokens_needed:
            from .memory_pool import PoolError
            raise PoolError(
                f"cannot free {tokens_needed} tokens "
                f"(free={self.pool.free_tokens}, "
                f"evictable={self._evictable_tokens()})")
        return freed

    def shrink_for_requests(self, tokens_needed: int, now: float,
                            queued_protect: Iterable[int] = ()) -> bool:
        """Dynamic downsizing: make room for a batch's memory demand.

        Returns False when the demand cannot be met even after evicting
        everything evictable (the scheduler then admits fewer requests).
        """
        if self.pool.free_tokens >= tokens_needed:
            return True
        available = (self.pool.free_tokens
                     + self._evictable_tokens())
        if available < tokens_needed:
            return False
        self.stats.shrink_events += 1
        self.make_room(tokens_needed, now, queued_protect)
        return True
