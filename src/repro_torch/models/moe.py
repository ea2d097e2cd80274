"""Mixture-of-Experts: top-k routing, capacity-bucketed prefill and the
dropless expert-gather decode (PyTorch).

Port of ``src/repro/models/moe.py``. The functions compute what the JAX
ones compute; the tensors they build differ:

- ``moe_block`` (prefill, S > 1) never builds the JAX one-hot dispatch
  and combine tensors (G, Tg, K, E, C): each kept assignment's row is
  gathered into its (expert, capacity slot) bucket of an (E, G*C, D)
  tensor, the expert products run as ``torch.bmm`` against the (E, D,
  F) weights, and each token sums its kept assignments' outputs times
  their combine weights. A bucket holds at most one assignment, so the
  gather is the JAX dispatch einsum's value exactly.
- ``moe_block_gather`` (decode, S == 1) never materialises the JAX
  (T, K, D, F) gather of expert weights: the T*K assignments are sorted
  by expert, their expert ids read to the host once, and each distinct
  expert multiplies its own rows against its weights in place, so every
  expert a step needs is read once. Dropless and exact.

The expert-sharding constraints of the JAX package are the identity off
a mesh and are left out (distribution is not ported).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import einsum_f32, promoted

MOE_GROUP = 2048      # tokens per dispatch group (MaxText-style)


class MoeStats:
    """What the MoE blocks did since the last ``reset``: capacity-block
    calls, their assignments and how many were dropped over capacity
    (summed on the device; reading ``dropped`` syncs), gather-block
    calls and the distinct experts they read."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.capacity_calls = 0
        self.assignments = 0
        self._dropped = 0
        self.gather_calls = 0
        self.experts_read = 0

    def capacity_call(self, assignments: int,
                      dropped: torch.Tensor) -> None:
        self.capacity_calls += 1
        self.assignments += assignments
        self._dropped = self._dropped + dropped

    def gather_call(self, experts: int) -> None:
        self.gather_calls += 1
        self.experts_read += experts

    @property
    def dropped(self) -> int:
        return int(self._dropped)


#: Process-wide counters the MoE blocks tick (reset by the smoke run).
STATS = MoeStats()


def _capacity(tokens: int, n_experts: int, top_k: int,
              capacity_factor: float) -> int:
    cap = int(tokens * top_k * capacity_factor / n_experts)
    return max(cap, 1)


def top_k_lower_first(x: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, the lower index first among equal values (a
    stable descending sort; ``torch.topk`` makes no promise on ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x: torch.Tensor, router_w: torch.Tensor, top_k: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D); router_w: (D, E). Returns (weights (B, S, K) f32,
    idx (B, S, K) int64, the Switch aux loss). The router runs in f32;
    the selected weights are renormalised to sum to 1 (floor 1e-9)."""
    logits = einsum_f32("bsd,de->bse", x, router_w)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = top_k_lower_first(probs, top_k)
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True),
                                    min=1e-9)
    # Switch aux loss: E * sum_e f_e * p_e (f_e: top-1 fraction).
    E = router_w.shape[-1]
    me = probs.mean(dim=(0, 1))
    fe = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * fe)
    return weights, idx, aux


def capacity_slots(idx: torch.Tensor, n_experts: int, cap: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """idx: (G, N) expert of each assignment of a group, token-major
    then k. Returns (pos, keep): the assignment's rank within its
    (group, expert) bucket, counted over the flattened assignments, and
    whether it fits under the capacity ``cap``."""
    # A stable sort by expert keeps each bucket in assignment order, so
    # an assignment's rank is its sorted index less its bucket's start
    # (the JAX cumsum over a one-hot, without the (G, N, E) scan).
    G, N = idx.shape
    order = torch.argsort(idx, dim=1, stable=True)
    counts = torch.zeros((G, n_experts), dtype=torch.long,
                         device=idx.device).scatter_add_(
                             1, idx, torch.ones_like(idx))
    starts = torch.cumsum(counts, dim=1) - counts
    rank = (torch.arange(N, device=idx.device)
            - torch.gather(starts, 1, torch.gather(idx, 1, order)))
    pos = torch.empty_like(idx).scatter_(1, order, rank)
    return pos, pos < cap


def _experts(expert_in: torch.Tensor, w_gate: torch.Tensor,
             w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its rows: (E, n, D) -> (E, n, D)."""
    xi, wg, wu = promoted(expert_in, w_gate, w_up)
    g = torch.bmm(xi, wg)
    u = torch.bmm(xi, wu)
    act, wd = promoted(F.silu(g) * u, w_down)
    return torch.bmm(act, wd)


def moe_block(x: torch.Tensor, router_w: torch.Tensor,
              w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, top_k: int,
              capacity_factor: float = 1.25, group_size: int = MOE_GROUP,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bucketed MoE with group-local dispatch.

    x: (B, S, D); w_*: (E, D, F) / (E, F, D). Returns (out, aux_loss).
    Tokens split into groups of ``Tg = min(group_size, B*S)``; each
    group gives each expert ``C = Tg*K*cf/E`` slots, filled in the
    order of the group's flattened (token, k) assignments; an
    assignment past its expert's C slots is dropped (its combine
    weight is 0). The combine weights are cast to ``x.dtype``.
    """
    B, S, D = x.shape
    E = router_w.shape[-1]
    K = top_k
    weights, idx, aux = route(x, router_w, K)
    T = B * S
    Tg = min(group_size, T)
    if T % Tg:
        raise ValueError(f"{T} tokens do not split into groups of {Tg}")
    G = T // Tg
    cap = _capacity(Tg, E, K, capacity_factor)
    N = Tg * K

    flat_idx = idx.reshape(G, N)
    pos, keep = capacity_slots(flat_idx, E, cap)
    STATS.capacity_call(G * N, (~keep).sum())
    w = (weights.reshape(G, N) * keep).to(x.dtype)
    slot = flat_idx * cap + torch.clamp(pos, max=cap - 1)    # (G, N)

    # Which token fills each (expert, slot) bucket; empty buckets read a
    # zero row (index Tg), dropped assignments write a trash column.
    dev = x.device
    tok = torch.arange(N, device=dev).div(K, rounding_mode="floor")
    tok_of = torch.full((G, E * cap + 1), Tg, dtype=torch.long, device=dev)
    tok_of.scatter_(1, torch.where(keep, slot, E * cap),
                    tok.expand(G, N).contiguous())
    xg = torch.cat([x.reshape(G, Tg, D), x.new_zeros((G, 1, D))], dim=1)
    rows = torch.arange(G, device=dev)[:, None]
    expert_in = xg[rows, tok_of[:, :E * cap]]               # (G, E*C, D)
    expert_in = (expert_in.view(G, E, cap, D).transpose(0, 1)
                 .reshape(E, G * cap, D))
    out = _experts(expert_in, w_gate, w_up, w_down)
    out = (out.view(E, G, cap, D).transpose(0, 1)
           .reshape(G, E * cap, D))

    # Combine: each token's kept assignments, weighted, summed in f32.
    slot = slot.view(G, Tg, K)
    w = w.view(G, Tg, K)
    y = torch.zeros((G, Tg, D), dtype=torch.float32, device=dev)
    for k in range(K):
        y += out[rows, slot[:, :, k]].float() * w[:, :, k, None].float()
    return y.to(x.dtype).reshape(B, S, D), aux


def moe_block_gather(x: torch.Tensor, router_w: torch.Tensor,
                     w_gate: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor, top_k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dropless MoE for decode (S == 1, few tokens): each token's top-k
    experts, exact. The assignments are grouped by expert (one host
    read of the sorted expert ids), and each distinct expert runs its
    SwiGLU over its own rows with its weights read in place. Each
    token's K outputs are summed with the combine weights (cast to
    ``x.dtype``) in f32."""
    B, S, D = x.shape
    K = top_k
    weights, idx, aux = route(x, router_w, K)
    T = B * S
    xf = x.reshape(T, D)
    e_flat = idx.reshape(T * K)
    wf = weights.reshape(T, K).to(x.dtype)
    order = torch.argsort(e_flat, stable=True)
    experts, counts = torch.unique_consecutive(e_flat[order].cpu(),
                                               return_counts=True)
    STATS.gather_call(len(experts))
    xs = xf[order.div(K, rounding_mode="floor")]            # (T*K, D)
    dt = x.dtype
    for w in (w_gate, w_up, w_down):
        dt = torch.promote_types(dt, w.dtype)
    ys = xs.new_empty(xs.shape, dtype=dt)
    start = 0
    for e, n in zip(experts.tolist(), counts.tolist()):
        xe, wg, wu = promoted(xs[start:start + n], w_gate[e], w_up[e])
        act, wd = promoted(F.silu(xe @ wg) * (xe @ wu), w_down[e])
        torch.mm(act, wd, out=ys[start:start + n])
        start += n
    yk = torch.empty_like(ys)
    yk[order] = ys                                          # (t, k) order
    y = (yk.view(T, K, D).float() * wf.float()[..., None]).sum(dim=1)
    return y.to(x.dtype).reshape(B, S, D), aux
