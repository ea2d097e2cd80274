"""All-to-all MoE: explicit expert parallelism over the data shards
(PyTorch).

Port of ``src/repro/models/moe_shard_map.py``. The JAX layer runs under
``shard_map`` over the expert axis and exchanges buckets with
``jax.lax.all_to_all``; here one process drives every data shard (the
single-controller mesh design of ``distributed/sharding.py``), and the
exchange is per-shard copies between the shards' devices:

  for each data shard s (its batch rows, its E/n experts):
    1. route its rows (global expert ids);
    2. bucket per (group, expert) with group-local capacity
       C = Tg*K*cf/E (``moe.bucket``, the gather form of the JAX
       one-hot dispatch);
    3. the all-to-all: each expert range's buckets go to that range's
       home shard, which stacks every source shard's buckets as extra
       groups;
    4. the local expert FFN (``torch.bmm`` over its E/n experts);
    5. the inverse exchange sends each source shard its outputs back;
    6. the weighted combine, on the source shard.

The outputs are gathered back to full batch on ``x``'s device, and the
aux loss is the mean over shards (``pmean``). Used when
``act_sharding.moe_a2a_mesh()`` is set (``moe_token_parallel=True``) and
E and B divide the expert axis; requires both, as JAX does.
"""
from __future__ import annotations

import torch

from repro_torch.device import on_device
from repro_torch.distributed import act_sharding as acts
from repro_torch.models.moe import (MOE_GROUP, STATS, _capacity, _experts,
                                    bucket, combine, expert_blocks, route)


def _group_buckets(xg: torch.Tensor, idx: torch.Tensor,
                   weights: torch.Tensor, E: int, cap: int, dtype):
    """xg: (G, Tg, D); idx/weights: (G, Tg, K). -> (send (G, E, C, D),
    comb): the buckets and what the combine needs (each assignment's
    bucket and its weight in ``dtype``, 0 where dropped), plus the
    number dropped over capacity (a device scalar)."""
    G, Tg, D = xg.shape
    expert_in, slot, w, keep = bucket(xg.to(dtype), idx, weights, E, cap)
    return expert_in.view(G, E, cap, D), (slot, w, (~keep).sum())


def _shard_devices(mesh, axis: str) -> list:
    """The device of each block along ``axis``: the first position of
    every other axis."""
    k = mesh.axis_names.index(axis)
    return [mesh.devices[tuple(s if i == k else 0
                               for i in range(mesh.devices.ndim))]
            for s in range(mesh.shape[axis])]


def moe_block_a2a(x: torch.Tensor, router_w, w_gate, w_up, w_down,
                  top_k: int, capacity_factor: float, mesh,
                  expert_axis: str = "data", group_size: int = MOE_GROUP,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) whole (its batch rows are split over ``expert_axis``
    here); router_w (D, E), one copy for all shards or one a shard (on
    its device); w_gate/w_up (E_l, D, F), w_down (E_l, F, D): lists of
    the n shards' blocks of E_l = E/n experts, each on its shard's
    device (``MeshParams.experts``). Requires B % n == 0. Returns (out
    (B, S, D) on ``x``'s device, aux scalar: the shards' mean)."""
    n = mesh.shape[expert_axis]
    routers = expert_blocks(router_w)
    routers = routers * n if len(routers) == 1 else routers
    E = routers[0].shape[-1]
    B, S, D = x.shape
    if E % n or B % n:
        raise ValueError(f"moe_block_a2a needs E={E} and B={B} divisible "
                         f"by the {n} shards of {expert_axis!r}")
    E_l, Bl, K = E // n, B // n, top_k
    devs = _shard_devices(mesh, expert_axis)
    if len(w_gate) != n or any(b.shape[0] != E_l for b in w_gate):
        raise ValueError(f"expert blocks {[b.shape[0] for b in w_gate]} are "
                         f"not {n} blocks of {E_l}")
    T = Bl * S
    Tg = min(group_size, T)
    if T % Tg:
        raise ValueError(f"{T} tokens do not split into groups of {Tg}")
    G = T // Tg
    cap = _capacity(Tg, E, K, capacity_factor)

    # 1-2: each shard routes and buckets its own rows.
    xs = acts.constrain_expert_ecd(x, [Bl] * n, devs)
    sends, combs, auxes = [], [], []
    for s, dev in enumerate(devs):
        with on_device(dev):
            weights, idx, aux = route(xs[s], routers[s].to(dev), K)
            send, comb = _group_buckets(
                xs[s].reshape(G, Tg, D), idx.reshape(G, Tg, K),
                weights.reshape(G, Tg, K), E, cap, x.dtype)
        sends.append(send)
        combs.append(comb)
        auxes.append(aux)
    # 3: expert range t of every source shard's buckets to shard t.
    recv = [[] for _ in range(n)]
    for send in sends:
        parts = acts.constrain_expert_ecd(
            send.transpose(0, 1), [E_l] * n, devs)       # (E_l, G, C, D)
        for t, p in enumerate(parts):
            recv[t].append(p)
    # 4-5: each shard's experts over all sources' buckets, sent back.
    back = [[None] * n for _ in range(n)]
    for t, dev in enumerate(devs):
        with on_device(dev):
            h_in = torch.cat(recv[t], dim=1)             # (E_l, n*G, C, D)
            out = _experts(h_in.reshape(E_l, n * G * cap, D), w_gate[t],
                           w_up[t], w_down[t]).view(E_l, n, G, cap, D)
        for s in range(n):
            back[s][t] = out[:, s]
    # 6: each source combines its buckets' outputs locally.
    ys = []
    for s, dev in enumerate(devs):
        with on_device(dev):
            expert_out = acts.constrain_moe_local(back[s], dev)  # (E,G,C,D)
            slot, w, _ = combs[s]
            y = combine(expert_out.transpose(0, 1).reshape(G, E * cap, D),
                        slot, w)
        ys.append(y.to(x.dtype).reshape(Bl, S, D))
    STATS.capacity_call(B * S * K, sum(c[2].to(x.device) for c in combs))
    aux = torch.stack([a.to(x.device) for a in auxes]).mean()
    return acts.constrain_moe_local(ys, x.device), aux
