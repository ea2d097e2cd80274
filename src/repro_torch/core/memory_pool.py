"""Unified device-memory pool in token units (TPU adaptation, DESIGN §2).

The paper reuses "idle GPU memory" for the adapter cache. On TPU, XLA
owns HBM, so idleness must be made explicit: the serving engine
pre-allocates one pool and accounts *everything* in token units:

    1 token  =  bytes of one KV-cache token slot
               (2 · n_kv_heads · head_dim · n_layers · dtype_bytes)

- Running requests hold KV tokens. Dense engines reserve the predicted
  worst case (input + predicted output) up front; the paged engine holds
  exactly its allocated KV pages and grows page by page, so ``free``
  tracks *actual* HBM occupancy, not a prediction.
- Resident adapters occupy ceil(adapter_bytes / token_bytes) tokens.
- free = capacity − requests − adapters. The Chameleon cache *is* the
  adapter region; "dynamic cache resizing" = this watermark moving.

``page_size > 1`` switches the pool to page currency for requests
(S-LoRA-style unified paging): every request hold must be a whole
number of pages, enforced by ``check_invariants``. Adapter holds stay
token-granular — adapters are contiguous slot buffers, not paged.

Shared pages (prefix-cache substrate): a page can be promoted out of a
request hold into a refcounted shared ledger (``add_shared_page``),
after which any number of requests — and the prefix radix tree itself —
hold references (``share_pages``/``release_shared``). Shared pages are
charged to ``used_shared`` so they count against both request headroom
and the adapter-cache watermark: cached prefixes are *accounted* idle
memory, exactly like resident adapters, never invisible occupancy.

The pool is deliberately policy-free: eviction choices live in
adapter_cache.py / prefix_cache.py, admission choices in scheduler.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field


class PoolError(RuntimeError):
    pass


@dataclass
class MemoryPool:
    capacity_tokens: int
    page_size: int = 1                # tokens per KV page (1 = dense mode)
    n_shards: int = 1                 # devices the physical plane spans
    used_requests: int = 0
    used_adapters: int = 0
    used_shared: int = 0              # refcounted prefix-cache pages
    _request_holds: dict = field(default_factory=dict)   # req_id -> tokens
    _adapter_holds: dict = field(default_factory=dict)   # adapter_id -> tokens
    _shared_refs: dict = field(default_factory=dict)     # page_id -> refcount

    # ------------------------------------------------------------------
    @property
    def free_tokens(self) -> int:
        return (self.capacity_tokens - self.used_requests
                - self.used_adapters - self.used_shared)

    @property
    def cache_tokens(self) -> int:
        """Current adapter-cache capacity = resident adapters + free HBM."""
        return self.capacity_tokens - self.used_requests - self.used_shared

    def request_headroom(self) -> int:
        """Tokens available to requests without evicting any adapter."""
        return self.free_tokens

    # Per-shard view ----------------------------------------------------
    # When the KV plane is mesh-sharded, each device physically holds
    # capacity/n_shards tokens ("Serving Heterogeneous LoRA Adapters":
    # size the memory plane per device, not per host). The *accounting*
    # stays global — pages are a logical currency and the control plane
    # must make identical decisions at every mesh shape for token
    # parity — so these are telemetry, not gates.
    @property
    def per_shard_capacity_tokens(self) -> int:
        return self.capacity_tokens // self.n_shards

    @property
    def per_shard_free_tokens(self) -> int:
        return self.free_tokens // self.n_shards

    # Pages -------------------------------------------------------------
    def pages_for(self, tokens: int) -> int:
        """Pages needed to hold ``tokens`` KV entries."""
        return -(-tokens // self.page_size)

    @property
    def free_pages(self) -> int:
        return self.free_tokens // self.page_size

    def request_pages(self, req_id: int) -> int:
        return self._request_holds.get(req_id, 0) // self.page_size

    def reserve_request_pages(self, req_id: int, n_pages: int) -> None:
        """Page-granular hold (the paged engine's allocation unit)."""
        self.reserve_request(req_id, n_pages * self.page_size)

    # Requests ----------------------------------------------------------
    def reserve_request(self, req_id: int, tokens: int) -> None:
        if tokens < 0:
            raise PoolError("negative reservation")
        if tokens > self.free_tokens:
            raise PoolError(
                f"reserve_request({tokens}) exceeds free {self.free_tokens}")
        if self.page_size > 1 and tokens % self.page_size:
            raise PoolError(
                f"paged pool: hold of {tokens} tokens is not a multiple "
                f"of page_size={self.page_size}")
        if tokens == 0:
            # A zero-token reserve must not materialise a phantom hold
            # entry: ``req_id in _request_holds`` is how callers test
            # "does this request occupy memory".
            return
        self._request_holds[req_id] = self._request_holds.get(req_id, 0) + tokens
        self.used_requests += tokens

    def grow_request(self, req_id: int, tokens: int) -> None:
        self.reserve_request(req_id, tokens)

    def release_request(self, req_id: int) -> int:
        tokens = self._request_holds.pop(req_id, 0)
        self.used_requests -= tokens
        return tokens

    def shrink_request(self, req_id: int, tokens: int) -> None:
        """Give back part of a hold (paged engine: per-page reclaim)."""
        held = self._request_holds.get(req_id, 0)
        if tokens < 0 or tokens > held:
            raise PoolError(
                f"shrink_request({tokens}) exceeds hold {held}")
        if self.page_size > 1 and tokens % self.page_size:
            raise PoolError(
                f"paged pool: shrink of {tokens} tokens is not a "
                f"multiple of page_size={self.page_size}")
        if tokens == held:
            self._request_holds.pop(req_id, None)
        else:
            self._request_holds[req_id] = held - tokens
        self.used_requests -= tokens

    # Shared pages (prefix cache) ---------------------------------------
    def add_shared_page(self, page_id: int) -> None:
        """Admit ``page_id`` to the shared ledger with refcount 1 (the
        prefix cache's own reference). The page's tokens move to
        ``used_shared``; the caller is responsible for having given up
        (or never taken) any request hold covering them — adoption of a
        prompt page is ``shrink_request`` then ``add_shared_page``, a
        conserving transfer."""
        if self.page_size <= 1:
            raise PoolError("shared pages require a paged pool")
        if page_id in self._shared_refs:
            raise PoolError(f"page {page_id} already shared")
        if self.page_size > self.free_tokens:
            raise PoolError(
                f"add_shared_page: page_size {self.page_size} exceeds "
                f"free {self.free_tokens}")
        self._shared_refs[page_id] = 1
        self.used_shared += self.page_size

    def share_pages(self, page_ids) -> None:
        """Take one reference on each page (a request mapping them into
        its page table). All-or-nothing: unknown ids fail before any
        refcount moves."""
        for pid in page_ids:
            if pid not in self._shared_refs:
                raise PoolError(f"share_pages: page {pid} is not shared")
        for pid in page_ids:
            self._shared_refs[pid] += 1

    def release_shared(self, page_ids) -> list:
        """Drop one reference per page; pages hitting refcount zero are
        freed (tokens returned to the pool) and their ids returned so
        the engine can restore them to its physical free list."""
        for pid in page_ids:
            if self._shared_refs.get(pid, 0) < 1:
                raise PoolError(
                    f"release_shared: page {pid} has no reference")
        freed = []
        for pid in page_ids:
            self._shared_refs[pid] -= 1
            if self._shared_refs[pid] == 0:
                del self._shared_refs[pid]
                self.used_shared -= self.page_size
                freed.append(pid)
        return freed

    def shared_refcount(self, page_id: int) -> int:
        return self._shared_refs.get(page_id, 0)

    def shared_page_ids(self):
        return set(self._shared_refs)

    @property
    def n_shared_pages(self) -> int:
        return len(self._shared_refs)

    # Adapters ----------------------------------------------------------
    def hold_adapter(self, adapter_id: int, tokens: int) -> None:
        if adapter_id in self._adapter_holds:
            return
        if tokens > self.free_tokens:
            raise PoolError(
                f"hold_adapter({tokens}) exceeds free {self.free_tokens}")
        self._adapter_holds[adapter_id] = tokens
        self.used_adapters += tokens

    def drop_adapter(self, adapter_id: int) -> int:
        tokens = self._adapter_holds.pop(adapter_id, 0)
        self.used_adapters -= tokens
        return tokens

    def adapter_resident(self, adapter_id: int) -> bool:
        return adapter_id in self._adapter_holds

    # Introspection -------------------------------------------------------
    def check_invariants(self, free_page_ids=None) -> None:
        """Exact-accounting invariants; cheap enough to call per step.

        ``free_page_ids``: the engine's physical free list, when the
        caller has one — asserts no page is simultaneously free and
        shared-referenced, and that the free list has no duplicates.
        """
        assert self.used_requests == sum(self._request_holds.values())
        assert self.used_adapters == sum(self._adapter_holds.values())
        assert self.used_shared == len(self._shared_refs) * self.page_size
        assert 0 <= self.used_requests
        assert 0 <= self.used_adapters
        assert 0 <= self.used_shared
        assert (self.used_requests + self.used_adapters
                + self.used_shared) <= self.capacity_tokens
        # Conservation: free is exactly what the ledgers leave over.
        assert self.free_tokens == (
            self.capacity_tokens - self.used_requests
            - self.used_adapters - self.used_shared)
        for pid, refs in self._shared_refs.items():
            assert refs >= 1, f"shared page {pid} with refcount {refs}"
        if self.page_size > 1:
            for req_id, tokens in self._request_holds.items():
                assert tokens % self.page_size == 0, (
                    f"request {req_id} holds {tokens} tokens, not a "
                    f"multiple of page_size={self.page_size}")
        for req_id, tokens in self._request_holds.items():
            assert tokens > 0, f"phantom zero-token hold for {req_id}"
        if free_page_ids is not None:
            free = list(free_page_ids)
            assert len(free) == len(set(free)), "duplicate free page ids"
            both = set(free) & set(self._shared_refs)
            assert not both, f"pages both free and shared: {sorted(both)}"

    def snapshot(self) -> dict:
        snap = {
            "capacity": self.capacity_tokens,
            "requests": self.used_requests,
            "adapters": self.used_adapters,
            "free": self.free_tokens,
        }
        if self.page_size > 1:
            snap["page_size"] = self.page_size
            snap["pages_used"] = self.used_requests // self.page_size
            snap["pages_free"] = self.free_pages
            snap["shared"] = self.used_shared
            snap["pages_shared"] = self.n_shared_pages
        if self.n_shards > 1:
            snap["n_shards"] = self.n_shards
            snap["per_shard_capacity"] = self.per_shard_capacity_tokens
            snap["per_shard_free"] = self.per_shard_free_tokens
        return snap


def kv_token_bytes(n_layers: int, n_kv_heads: int, head_dim: int,
                   dtype_bytes: int = 2) -> int:
    """Bytes of one token's KV across all layers (the pool's currency)."""
    return 2 * n_layers * n_kv_heads * head_dim * dtype_bytes
