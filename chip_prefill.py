#!/usr/bin/env python3
"""Device time of one full-width prefill call of the port on one NVIDIA
GPU (H100).

Run from the root of a checkout:  python3 chip_prefill.py [--src DIR]

Times the two prefill entry points the engines call, at the default
``EngineConfig``'s largest bucket (8 rows x 256 tokens) of
``chameleon-llama-7b`` at full width: bf16 weights and 8 LoRA slots of
r_max 32 from a seeded generator, kernel LoRA, one adapter slot per
row.

- ``api.prefill``: whole-prompt prefill, the ``paged=False`` and
  ``prefix_cache=False`` engines' call (sgmv, flash_attention);
- ``api.prefill_paged`` from position 0 into f32 pages: the default
  engine's suffix prefill (sgmv; its attention is einsum).

Each is the median of ``REPS`` (10) calls after two warm-up calls, from CUDA
events around the call (its host gaps included). ``--src`` imports the
port from another tree's ``src`` (an older checkout), so two versions
can be compared in one run on one card: run them in turns. ``--mesh
D,M`` times the same calls with the weights, the LoRA slots and the
pages placed by ``ShardPlan`` on a (D, M) mesh over repeated positions
of the card (the mesh step functions; no interconnect). One JSON
line, then the ``nvidia-smi`` name and power limit. Imports nothing of
JAX; exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BUCKET = (8, 256)
REPS = 10


def median_call_ms(fn) -> float:
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose repro_torch package is timed")
    ap.add_argument("--mesh", default=None, metavar="D,M",
                    help="time the calls on a (D, M) mesh over repeated "
                         "positions of the card")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"chip_prefill: no repro_torch under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_prefill: no CUDA device", file=sys.stderr)
        return 2
    import importlib

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.models.lora_apply import init_lora_slots
    build.build_all()
    dev = torch.device("cuda")
    cfg = get_config("chameleon-llama-7b")
    params = api.init_params(cfg, seed=0, dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(1)
    lora = init_lora_slots(8, cfg.n_layers, cfg.d_model, cfg.q_dim,
                           cfg.kv_dim, 32, device=dev)
    for A, B in lora.values():
        A.copy_(torch.randn(A.shape, generator=g, device=dev)
                * A.shape[-2] ** -0.5)
        B.copy_(torch.randn(B.shape, generator=g, device=dev) * 32 ** -0.5)
    rows, S = BUCKET
    toks = torch.randint(3, cfg.vocab_size, (rows, S), generator=g,
                         device=dev).int()
    idx = torch.arange(rows, dtype=torch.int32, device=dev)
    kw = dict(lora=lora, adapter_idx=idx, lora_backend="kernel")
    last = torch.full((rows,), S - 1, dtype=torch.int32, device=dev)
    page = 16
    kv = api.init_paged_serve_state(cfg, 1 + rows * S // page, page,
                                    torch.float32, device=dev)
    table = (1 + torch.arange(rows * S // page, device=dev)).view(
        rows, -1).int()
    start = torch.zeros(rows, dtype=torch.int32, device=dev)
    seq_len = torch.full((rows,), S, dtype=torch.int32, device=dev)
    mesh_shape = None
    if args.mesh:
        import numpy as np
        from repro_torch.distributed.sharding import MeshParams
        from repro_torch.launch.mesh import Mesh
        from repro_torch.serving.shard_plan import ShardPlan
        mesh_shape = tuple(int(n) for n in args.mesh.split(","))
        grid = np.empty(mesh_shape[0] * mesh_shape[1], dtype=object)
        grid[:] = [torch.device("cuda", torch.cuda.current_device())
                   ] * grid.size
        mesh = Mesh(grid.reshape(mesh_shape), ("data", "model"))
        plan = ShardPlan(mesh, cfg)
        sh = plan.params(params)
        params = MeshParams(cfg, {k: plan.put(v, sh[k])
                                  for k, v in params.items()}, mesh)
        lsh = plan.lora_slots(lora)
        lora = {k: (plan.put(a, lsh[k][0]), plan.put(b, lsh[k][1]))
                for k, (a, b) in lora.items()}
        kv = tuple(plan.zeros_kv_pages(tuple(t.shape), t.dtype)
                   for t in kv)
        kw["lora"] = lora
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in ("sgmv", "flash_attention")}
    with torch.no_grad():
        dense_ms = median_call_ms(
            lambda: api.prefill(cfg, params, toks, last_pos=last, **kw))
        paged_ms = median_call_ms(
            lambda: api.prefill_paged(cfg, params, toks, kv, table, start,
                                      seq_len, **kw))
        for st in stats.values():
            st.reset()
        api.prefill(cfg, params, toks, last_pos=last, **kw)
        torch.cuda.synchronize()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(
        src=str(src), bucket=list(BUCKET), model=cfg.name,
        mesh_shape=mesh_shape,
        prefill_ms=dense_ms, prefill_paged_ms=paged_ms, reps=REPS,
        launches_per_prefill={
            n: getattr(st, "instances", None) or st.launches
            for n, st in stats.items()},
        device=torch.cuda.get_device_name(0))), flush=True)
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
