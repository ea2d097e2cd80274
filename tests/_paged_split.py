"""The split-and-combine arithmetic of the port's paged_attention
kernel, in plain torch (f32): the CPU tests hold it against the Pallas
kernel, the card tests hold the CUDA kernel against it.

Each of ``splits`` blocks of a cluster takes one run of whole pages
(``split_pages``) and keeps an exact softmax state over it: running max
m, denominator l and accumulator acc, with positions >= length scored
-1e30. An empty run carries m = -inf, l = 0, acc = 0 and merges with
weight 0 (never exp(-inf - -inf)). The runs merge in split order.
"""
from __future__ import annotations

import torch


def split_pages(length: int, P: int, page: int, splits: int
                ) -> list[tuple[int, int]]:
    """The kernel's runs of whole pages, [first, end) for each block of
    a cluster: the row visits ``ceil(length / page)`` pages (all ``P``
    when ``length <= 0``), cut into ``splits`` runs of
    ``ceil(visited / splits)`` pages; trailing runs may be empty."""
    n_vis = min(P, -(-length // page)) if length > 0 else P
    per = -(-n_vis // splits)
    runs = []
    for c in range(splits):
        p0 = min(n_vis, c * per)
        runs.append((p0, min(n_vis, p0 + per)))
    return runs


def split_states(q, k_pages, v_pages, page_table, lengths, splits):
    """Per (row, split): (m (Kh, G), l (Kh, G), acc (Kh, G, dh))."""
    B, Kh, G, dh = q.shape
    _, page, _, _ = k_pages.shape
    P = page_table.shape[1]
    qs = q.float() * dh ** -0.5
    states = []
    for b in range(B):
        length = int(lengths[b])
        row = []
        for p0, p1 in split_pages(length, P, page, splits):
            if p1 <= p0:
                row.append((torch.full((Kh, G), -torch.inf),
                            torch.zeros(Kh, G), torch.zeros(Kh, G, dh)))
                continue
            ids = page_table[b, p0:p1].long().clamp(0, k_pages.shape[0] - 1)
            k = k_pages[ids].float().reshape(-1, Kh, dh)     # (S, Kh, dh)
            v = v_pages[ids].float().reshape(-1, Kh, dh)
            pos = torch.arange(p0 * page, p1 * page)
            s = torch.einsum("kgd,skd->kgs", qs[b], k)
            s = torch.where(pos < length, s, torch.full_like(s, -1e30))
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            row.append((m, p.sum(-1), torch.einsum("kgs,skd->kgd", p, v)))
        states.append(row)
    return states


def combine(row_states):
    """Merge one row's split states in split order -> (Kh, G, dh)."""
    mx = torch.stack([m for m, _, _ in row_states]).amax(0)
    l_tot = torch.zeros_like(mx)
    acc = torch.zeros_like(row_states[0][2])
    for m, l, a in row_states:
        w = torch.where(m == -torch.inf, torch.zeros_like(m),
                        torch.exp(m - mx))
        l_tot = l_tot + w * l
        acc = acc + w[..., None] * a
    return acc / torch.clamp(l_tot, min=1e-30)[..., None]


def paged_attention_split(q, k_pages, v_pages, page_table, lengths,
                          splits):
    """The kernel's result, computed split by split on the CPU, in q's
    dtype."""
    args = [t.cpu() for t in (q, k_pages, v_pages, page_table, lengths)]
    rows = split_states(*args, splits)
    return torch.stack([combine(r) for r in rows]).to(q.dtype)
