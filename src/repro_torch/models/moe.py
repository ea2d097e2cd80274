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

On a device mesh the expert weights come as per-data-shard blocks
(lists of (E_d, D, F) tensors, each on its shard's device, in expert
order; ``distributed.sharding.MeshParams.experts``): routing and
bucketing run on the home device, ``act_sharding.constrain_expert_ecd``
moves each block of buckets (or of decode rows grouped by expert) to
its shard, each shard runs its own experts there, and
``constrain_moe_local`` gathers the outputs back in the unsharded
expert order before the combine. A batched product over a block of
experts is the unsharded one's rows, so the result has the
unsharded bits where the device type is the same.

The train step on a mesh runs ``moe_block_train`` instead: the batch
split over batch shards and the expert hidden over "model" columns
(the train rule table's split), with the aux loss and the capacity
groups of the global batch, so its result is ``moe_block``'s.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import on_device
from repro_torch.distributed import act_sharding as acts
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


def _route(x: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """(probs (B, S, E) f32, renormalised top-k weights, their expert
    ids) of ``route``."""
    logits = einsum_f32("bsd,de->bse", x, router_w)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = top_k_lower_first(probs, top_k)
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True),
                                    min=1e-9)
    return probs, weights, idx


def route(x: torch.Tensor, router_w: torch.Tensor, top_k: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D); router_w: (D, E). Returns (weights (B, S, K) f32,
    idx (B, S, K) int64, the Switch aux loss). The router runs in f32;
    the selected weights are renormalised to sum to 1 (floor 1e-9)."""
    probs, weights, idx = _route(x, router_w, top_k)
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


def expert_blocks(w) -> list:
    """Expert weights as per-data-shard blocks: a list as given, a
    whole (E, ., .) stack as one block."""
    return list(w) if isinstance(w, (list, tuple)) else [w]


def _experts_sharded(expert_in: torch.Tensor, w_gate: list, w_up: list,
                     w_down: list) -> torch.Tensor:
    """``_experts`` over per-data-shard blocks: each block of buckets
    runs on its shard's device against its weights, and the outputs
    come back to ``expert_in``'s device in expert order (one block
    stays where it is)."""
    blocks = acts.constrain_expert_ecd(
        expert_in, [w.shape[0] for w in w_gate], [w.device for w in w_gate])
    outs = []
    for xb, wg, wu, wd in zip(blocks, w_gate, w_up, w_down):
        with on_device(wg.device):
            outs.append(acts.constrain_expert_ecf(_experts(xb, wg, wu, wd)))
    return acts.constrain_moe_local(outs, expert_in.device)


def dispatch(idx: torch.Tensor, weights: torch.Tensor, pos: torch.Tensor,
             keep: torch.Tensor, grp: torch.Tensor, n_groups: int,
             n_experts: int, cap: int, dtype: torch.dtype):
    """Capacity dispatch of T tokens in row order. idx/weights (T, K):
    each assignment's expert and weight; pos/keep (T, K): its rank in
    its (group, expert) bucket and whether it fits (``capacity_slots``);
    grp (T,): each token's group among ``n_groups``. Returns (slot
    (T, K): each assignment's bucket within its group; w (T, K): its
    combine weight in ``dtype``, 0 where dropped; tok_of (n_groups,
    E*cap): the token filling each (group, expert, slot) bucket, T
    (a zero row) where empty)."""
    T, K = idx.shape
    n_slot = n_experts * cap
    dev = idx.device
    slot = idx * cap + torch.clamp(pos, max=cap - 1)
    w = (weights * keep).to(dtype)
    # Dropped assignments write each group's trash column n_slot.
    tok_of = torch.full((n_groups * (n_slot + 1),), T, dtype=torch.long,
                        device=dev)
    lin = grp[:, None] * (n_slot + 1) + torch.where(keep, slot, n_slot)
    tok_of.scatter_(0, lin.reshape(-1),
                    torch.arange(T, device=dev).repeat_interleave(K))
    return slot, w, tok_of.view(n_groups, n_slot + 1)[:, :n_slot]


def bucket(xg: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor,
           n_experts: int, cap: int):
    """Capacity buckets of one set of groups. xg: (G, Tg, D) tokens;
    idx/weights: (G, Tg, K) routing. Each group gives each expert
    ``cap`` slots, filled in the order of the group's flattened (token,
    k) assignments; an assignment past its expert's slots is dropped.
    Returns (expert_in (G, E*cap, D): the row filling each (expert,
    slot) bucket, zero where empty; slot (G, Tg, K): each assignment's
    bucket; w (G, Tg, K): its combine weight in ``xg.dtype``, 0 where
    dropped; keep (G, Tg*K))."""
    G, Tg, D = xg.shape
    K = idx.shape[-1]
    T = G * Tg
    pos, keep = capacity_slots(idx.reshape(G, Tg * K), n_experts, cap)
    grp = torch.arange(T, device=xg.device).div(Tg, rounding_mode="floor")
    slot, w, tok_of = dispatch(idx.reshape(T, K), weights.reshape(T, K),
                               pos.view(T, K), keep.view(T, K), grp, G,
                               n_experts, cap, xg.dtype)
    xz = torch.cat([xg.reshape(T, D), xg.new_zeros((1, D))])
    expert_in = xz[tok_of]                                  # (G, E*C, D)
    return expert_in, slot.view(G, Tg, K), w.view(G, Tg, K), keep


def combine(out: torch.Tensor, slot: torch.Tensor, w: torch.Tensor,
            group: torch.Tensor | None = None) -> torch.Tensor:
    """Each token's kept assignments' outputs, weighted, summed in f32:
    out (G, E*C, D), slot/w (G, Tg, K) -> (G, Tg, D) f32. ``group``:
    each token's group (its index into ``out``), for slot/w of any
    leading shape (default: their first dimension is the group)."""
    if group is None:
        group = torch.arange(slot.shape[0], device=out.device)[:, None]
    y = torch.zeros(slot.shape[:-1] + (out.shape[-1],),
                    dtype=torch.float32, device=out.device)
    for k in range(slot.shape[-1]):
        y += out[group, slot[..., k]].float() * w[..., k, None].float()
    return y


def moe_block(x: torch.Tensor, router_w: torch.Tensor,
              w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, top_k: int,
              capacity_factor: float = 1.25, group_size: int = MOE_GROUP,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bucketed MoE with group-local dispatch.

    x: (B, S, D); w_*: (E, D, F) / (E, F, D), or lists of per-data-
    shard blocks (module docstring). Returns (out, aux_loss).
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
    xg = acts.constrain_moe_groups(x.reshape(G, Tg, D))
    expert_in, slot, w, keep = bucket(xg, idx.reshape(G, Tg, K),
                                      weights.reshape(G, Tg, K), E, cap)
    STATS.capacity_call(G * Tg * K, (~keep).sum())
    expert_in = (expert_in.view(G, E, cap, D).transpose(0, 1)
                 .reshape(E, G * cap, D))
    out = _experts_sharded(expert_in, *map(expert_blocks,
                                           (w_gate, w_up, w_down)))
    out = (out.view(E, G, cap, D).transpose(0, 1)
           .reshape(G, E * cap, D))
    y = acts.constrain_moe_groups(combine(out, slot, w))
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
    ``x.dtype``) in f32. Per-data-shard weight blocks (module docstring)
    run each shard's experts on its device; the host read stays one a
    call."""
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
    w_gate, w_up, w_down = map(expert_blocks, (w_gate, w_up, w_down))
    dt = x.dtype
    for w in (w_gate, w_up, w_down):
        dt = torch.promote_types(dt, w[0].dtype)
    # The rows are sorted by expert, so each data shard's experts own
    # one run of them: split the runs to the shards, run each shard's
    # experts there, gather the runs back in order.
    experts, counts = experts.tolist(), counts.tolist()
    lo, runs, groups = 0, [], []
    for wg in w_gate:
        hi = lo + wg.shape[0]
        sel = [(e, n) for e, n in zip(experts, counts) if lo <= e < hi]
        runs.append(sum(n for _, n in sel))
        groups.append((lo, sel))
        lo = hi
    parts = acts.constrain_expert_ecd(xs, runs, [w.device for w in w_gate])
    outs = []
    for xp, (base, sel), wg, wu, wd in zip(parts, groups, w_gate, w_up,
                                           w_down):
        with on_device(wg.device):
            outs.append(acts.constrain_expert_ecf(_gather_rows(
                xp, [e for e, _ in sel], [n for _, n in sel], base, wg, wu,
                wd, dt)))
    ys = acts.constrain_moe_local(outs, xs.device)
    yk = torch.empty_like(ys)
    yk[order] = ys                                          # (t, k) order
    y = (yk.view(T, K, D).float() * wf.float()[..., None]).sum(dim=1)
    return y.to(x.dtype).reshape(B, S, D), aux


def _gather_rows(xs: torch.Tensor, experts: list, counts: list, base: int,
                 w_gate, w_up, w_down, dt) -> torch.Tensor:
    """Rows ``xs`` sorted by expert (``counts[i]`` rows of expert
    ``experts[i]``, which is row ``experts[i] - base`` of the weight
    stacks) through their experts' SwiGLU, in place of order."""
    ys = xs.new_empty(xs.shape, dtype=dt)
    start = 0
    for e, n in zip(experts, counts):
        xe, wg, wu = promoted(xs[start:start + n], w_gate[e - base],
                              w_up[e - base])
        act, wd = promoted(F.silu(xe @ wg) * (xe @ wu), w_down[e - base])
        torch.mm(act, wd, out=ys[start:start + n])
        start += n
    return ys


def moe_block_train(h: list, router: list, experts: list, top_k: int,
                    capacity_factor: float = 1.25, n_data: int = 1
                    ) -> tuple[list, torch.Tensor]:
    """``moe_block`` of the global batch, split over batch shards and
    "model" columns (the train step on a mesh, TP mode).

    ``h[b][m]``: batch shard b's normed rows (B_b, S, D) on position
    (b, m), equal B_b; ``router[b]``: (D, E) on position (b, 0);
    ``experts[b][m]``: (w_gate (E_d, D, F_m), w_up, w_down (E_d, F_m,
    D)) on position (b, m), expert block ``b % n_data`` and column m's
    block of their hidden. Returns (``ys[b][m]``: position (b, m)'s
    partial output (B_b, S, D), whose sum over the columns is
    ``moe_block``'s rows of shard b; the aux loss of the global batch).

    - Routing runs on each shard's first column. The aux loss's means
      are over the global batch: each shard's sums of ``probs`` and of
      the top-1 one-hot are added on position (0, 0), then the product
      is taken (a mean of per-shard aux terms would differ).
    - Capacity groups are ``moe_block``'s: ``Tg = min(MOE_GROUP, T)``
      over the global T, group g the global tokens [g Tg, (g+1) Tg) of
      the flattened (B, S) in row order. The ranks of every group's
      assignments are counted over the whole group on position (0, 0)
      (``capacity_slots`` of the gathered expert ids), so a group that
      straddles batch shards keeps exactly the unsharded assignments.
    - Each shard buckets its own tokens into the groups it touches
      (zero rows where another shard's token fills the slot), and the
      all-to-all over "data" (``act_sharding.moe_all_to_all``) gives
      each expert block the buckets of its pod's shards, straddled
      groups summed. Column m runs its hidden block; the rows go back
      (``moe_all_to_all_back``) and each shard combines its own.
    """
    nb, M = len(h), len(h[0])
    Bb, S, D = h[0][0].shape
    Tb, E, K = Bb * S, router[0].shape[-1], top_k
    T = nb * Tb
    Tg = min(MOE_GROUP, T)
    if T % Tg:
        raise ValueError(f"{T} tokens do not split into groups of {Tg}")
    cap = _capacity(Tg, E, K, capacity_factor)
    home = h[0][0].device
    routed, p_sum, f_sum = [], None, None
    for b in range(nb):
        x = h[b][0]
        with on_device(x.device):
            probs, weights, idx = _route(x, router[b], K)
            ps = probs.sum(dim=(0, 1)).to(home)
            fs = F.one_hot(idx[..., 0], E).float().sum(dim=(0, 1)).to(home)
        routed.append((weights.reshape(Tb, K), idx.reshape(Tb, K)))
        p_sum = ps if p_sum is None else p_sum + ps
        f_sum = fs if f_sum is None else f_sum + fs
    aux = E * torch.sum((p_sum / T) * (f_sum / T))

    flat = torch.cat([idx.to(home) for _, idx in routed])
    pos, keep = capacity_slots(flat.view(T // Tg, Tg * K), E, cap)
    STATS.capacity_call(T * K, (~keep).sum())
    pos, keep = pos.view(nb, Tb, K), keep.view(nb, Tb, K)
    spans, plans = [], []
    for b, (weights, idx) in enumerate(routed):
        dev = idx.device
        g0, g1 = b * Tb // Tg, ((b + 1) * Tb - 1) // Tg + 1
        grp = torch.arange(b * Tb, (b + 1) * Tb, device=dev) // Tg - g0
        slot, w, tok_of = dispatch(idx, weights, pos[b].to(dev),
                                   keep[b].to(dev), grp, g1 - g0, E, cap,
                                   h[b][0].dtype)
        spans.append((g0, g1))
        plans.append((grp, slot, w, tok_of))

    ys = [[None] * M for _ in range(nb)]
    for m in range(M):
        sends = []
        for b in range(nb):
            x = h[b][m]
            with on_device(x.device):
                xz = torch.cat([x.reshape(Tb, D), x.new_zeros((1, D))])
                sends.append(xz[plans[b][3].to(x.device)]
                             .view(-1, E, cap, D))
        ins = acts.moe_all_to_all(sends, spans, n_data)
        outs = []
        for b in range(nb):
            wg, wu, wd = experts[b][m]
            with on_device(wg.device):
                outs.append(acts.constrain_expert_ecf(
                    _experts(ins[b], wg, wu, wd)))
        back = acts.moe_all_to_all_back(outs, spans, n_data, cap,
                                        [h[b][m].device for b in range(nb)])
        for b in range(nb):
            grp, slot, w, _ = plans[b]
            dev = h[b][m].device
            with on_device(dev):
                y = combine(back[b], slot.to(dev), w.to(dev), grp.to(dev))
            ys[b][m] = y.to(h[b][m].dtype).view(Bb, S, D)
    return ys, aux
