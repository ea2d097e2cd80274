"""Token-id-keyed radix prefix tree over the paged KV pool (ROADMAP 1).

Shared system prompts and few-shot preambles are re-prefilled on every
request in the seed engine, even though their KV is identical across
requests. This cache keeps *prompt* KV pages resident after a request
finishes and lets the next request map them straight into its page
table, prefilling only the unseen suffix — the paper's idle-memory
argument (repurpose free HBM to kill redundant work) applied one level
below the adapter cache.

Structure: a radix tree at page granularity. Each node owns exactly one
physical KV page and is keyed by the tuple of ``page_size`` token ids
written into it; a root-to-node path spells out a prompt prefix. Trees
are segregated by a *KV signature* (``sig``):

- exact mode: ``sig = adapter_id``. LoRA in this repo touches the
  q/k/v/o projections, so a page's KV depends on which adapter ran the
  prefill — only same-adapter reuse is output-identical.
- aLoRA mode: ``sig = -1`` for everyone. The engine computes prompt KV
  with the base model only (the adapter activates at generation, per
  "Activated LoRA", PAPERS.md), which makes prefix pages adapter-
  invariant and genuinely shareable *across* adapters.

A KV page's contents are a pure function of (sig, absolute positions,
token ids): two requests whose prompts agree on the first k tokens have
bit-identical KV rows for those positions. That is what makes both
whole-page reuse and the mid-page copy-on-write fork (copy the first
``rem`` rows of a cached page whose key agrees on ``rem`` tokens)
sound.

Memory safety is the pool's refcount ledger: every node holds one pool
reference on its page (taken at adoption); each request mapping the
page holds another. Eviction (`evict_lru`) only ever touches leaf nodes
whose refcount is exactly 1 — i.e. pages no live request can read — so
a stale page can never be handed to another request while mapped.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.memory_pool import MemoryPool


class PrefixNode:
    """One cached KV page: ``key`` = the page's token ids."""
    __slots__ = ("sig", "key", "page_id", "parent", "children",
                 "last_used")

    def __init__(self, sig: int, key: tuple, page_id: int,
                 parent: Optional["PrefixNode"]):
        self.sig = sig
        self.key = key
        self.page_id = page_id
        self.parent = parent
        self.children: dict = {}          # key tuple -> PrefixNode
        self.last_used = 0


class PrefixCache:
    """Radix insert/match/evict over pool-refcounted KV pages."""

    def __init__(self, pool: MemoryPool, page_size: int):
        if page_size <= 1:
            raise ValueError("prefix cache requires a paged pool")
        self.pool = pool
        self.page_size = page_size
        self._roots: dict = {}            # sig -> {key tuple: PrefixNode}
        self._nodes: dict = {}            # page_id -> PrefixNode
        self._clock = 0                   # logical LRU clock
        self.evictions = 0
        self.inserts = 0

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._nodes)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # ------------------------------------------------------------------
    def match(self, sig: int, tokens, limit: int):
        """Longest cached prefix of ``tokens`` under signature ``sig``.

        ``limit`` caps the matched length (the engine passes L-1 so at
        least one prompt token always prefills — the last-position
        logits must be computed fresh).

        Returns ``(pages, n_full_tokens, partial_page, partial_len)``:
        ``pages`` are whole shared pages covering ``n_full_tokens``;
        ``partial_page``, when not None, is a cached page whose first
        ``partial_len`` token ids extend the match mid-page — the
        copy-on-write fork source. The touched chain's LRU stamps are
        refreshed. No references are taken here; the caller must
        ``pool.share_pages(pages)`` before anything can evict them.
        """
        ps = self.page_size
        now = self._tick()
        children = self._roots.get(sig, {})
        pages: list = []
        consumed = 0
        while consumed + ps <= limit:
            key = tuple(tokens[consumed:consumed + ps])
            child = children.get(key)
            if child is None:
                break
            child.last_used = now
            pages.append(child.page_id)
            consumed += ps
            children = child.children
        partial_page, partial_len = None, 0
        rem = limit - consumed
        if rem > 0 and children:
            # Mid-page divergence: fork from the child sharing the
            # longest token run (the COW source). lcp < ps always — an
            # lcp of ps is a whole-page match the walk above took.
            want = tuple(tokens[consumed:consumed + min(rem, ps)])
            best, best_len = None, 0
            for key, child in children.items():
                lcp = 0
                for a, b in zip(key, want):
                    if a != b:
                        break
                    lcp += 1
                if lcp > best_len:
                    best, best_len = child, lcp
            if best is not None:
                best.last_used = now
                partial_page, partial_len = best.page_id, best_len
        return pages, consumed, partial_page, partial_len

    # ------------------------------------------------------------------
    def insert(self, sig: int, tokens, page_ids) -> list:
        """Adopt a request's fully-written prompt pages into the tree.

        ``tokens`` must cover ``len(page_ids)`` whole pages; pages whose
        token path is already cached are skipped (first writer wins —
        the duplicate page stays private to its request and is freed
        normally). Returns the page ids actually adopted, in order; the
        caller performs the pool accounting transfer for each
        (``shrink_request`` → ``add_shared_page`` → ``share_pages``).
        """
        ps = self.page_size
        now = self._tick()
        children = self._roots.setdefault(sig, {})
        parent: Optional[PrefixNode] = None
        adopted: list = []
        for i, pid in enumerate(page_ids):
            key = tuple(tokens[i * ps:(i + 1) * ps])
            node = children.get(key)
            if node is None:
                node = PrefixNode(sig, key, pid, parent)
                children[key] = node
                self._nodes[pid] = node
                self.inserts += 1
                adopted.append(pid)
            node.last_used = now
            parent, children = node, node.children
        return adopted

    # ------------------------------------------------------------------
    def evict_lru(self, n_pages: int = 1) -> list:
        """Reclaim up to ``n_pages`` pages under pool pressure.

        Only leaf nodes whose pool refcount is exactly 1 (the cache's
        own reference — no request is reading the page) are candidates;
        least-recently-used first. Evicting a leaf can expose its
        parent, so deep cold chains unwind across calls. Returns the
        freed physical page ids for the engine's free list.
        """
        freed: list = []
        while len(freed) < n_pages:
            victim = None
            for node in self._nodes.values():
                if node.children:
                    continue
                if self.pool.shared_refcount(node.page_id) != 1:
                    continue
                if victim is None or node.last_used < victim.last_used:
                    victim = node
            if victim is None:
                break
            self._remove(victim)
            freed.extend(self.pool.release_shared([victim.page_id]))
            self.evictions += 1
        return freed

    def _remove(self, node: PrefixNode) -> None:
        siblings = (node.parent.children if node.parent is not None
                    else self._roots.get(node.sig, {}))
        if siblings.get(node.key) is node:
            del siblings[node.key]
        del self._nodes[node.page_id]

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "nodes": len(self._nodes),
            "evictions": self.evictions,
            "inserts": self.inserts,
        }
