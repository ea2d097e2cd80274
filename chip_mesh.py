#!/usr/bin/env python3
"""The mesh-sharded serving engine and train step across several
NVIDIA cards.

Run from the root of a checkout on a host with 4 cards:
    python3 chip_mesh.py

``chip_smoke.py`` runs the mesh data plane on one card, where every
position of a split mesh is the same device. This script builds meshes
of distinct cards (``cuda:0 .. cuda:n-1`` through
``EngineConfig.mesh_shape``), so shards live on their own cards and
every gather is a copy between cards. Phases, one JSON line each:

1. ``mesh_parity`` — reduced ``chameleon-llama-7b`` in f32 (kernel
   LoRA), the mixed greedy/sampled trace of
   ``tests/test_torch_mesh_engine.py`` served by mesh engines at (1, 1),
   (2, 1), (1, 2), (2, 2) and (4, 1) and by ``EngineConfig()``
   on ``cuda:0``, paged fused, dense fused, paged seed loop and the
   prefix cache, each on a step clock with its adapter loads landed
   before every step (so the schedules agree): tokens must be identical.
2. ``mesh_engine`` — ``chameleon-llama-7b`` at full width (seeded bf16
   weights on ``cuda:0``), the ``chip_smoke.py`` phase-4 trace after its
   warm-up, served on a step clock by ``EngineConfig()`` and by mesh
   engines at (1, 1), (1, 2), (2, 2) and (1, 4), one at a time: host ms
   a step, decode tokens/s, peak memory of each card, the shard gauges
   (gathers a dispatch, gather time share), kernel launches, and greedy
   and first-token agreement with ``EngineConfig()``.
3. ``mesh_moe_parity`` — reduced ``qwen3-moe-235b-a22b`` and
   ``llama4-maverick-400b-a17b`` in f32 (kernel LoRA), the mixed trace
   fused and seed loop, served at (2, 1), (4, 1) and (2, 2) (experts
   over "data": each card runs its own experts) and by
   ``EngineConfig()`` on ``cuda:0``: tokens and prefill drops over
   capacity must be identical.
4. ``mesh_moe_a2a`` — one MoE layer of qwen3-moe at its published
   widths over (8, 256) tokens through ``moe_block_a2a`` at (4, 1),
   buckets copied between the cards, against ``moe_block`` on each
   batch shard on ``cuda:0``; timed.
5. ``mesh_moe_engine`` — qwen3-moe at its published widths cut to 8
   layers (``chip_smoke.MOE_LAYERS``, seeded bf16 weights on
   ``cuda:0``), the phase-4 trace after its warm-up served by
   ``EngineConfig()`` and by mesh engines at (4, 1) and (1, 4): host ms
   a step, decode tokens/s, peak memory of each card, gathers a
   dispatch, launches, greedy agreement with ``EngineConfig()``.

6. ``mesh_train`` — the dense train step on meshes of distinct cards:
   internlm2-1.8b at full width and depth in f32, two SyntheticLM
   (8, 512) steps at (4, 1), (2, 2) and (1, 4) against the unsharded
   step on ``cuda:0`` (loss, grad norm, params and moments, each card's
   peak memory, s/step, launches); then ``python -m
   repro_torch.launch.train --devices host`` for 5 steps over every card
   (``mesh_train_launcher``).
7. ``mesh_train_moe`` — the MoE train step on meshes of distinct cards:
   qwen3-moe-235b-a22b at full width cut to 2 layers (6.2 B params,
   99 GB of f32 state: about 25 GB a card), two SyntheticLM (4, 1024)
   steps (T = 4096: two capacity groups of 2048, each over two batch
   shards at (4, 1)) at (4, 1), (2, 2) and (1, 4), against the
   unsharded step on the host's CPU (the state fits no card; MoE drops
   equal); then ``python -m repro_torch.launch.train --arch
   qwen3-moe-235b-a22b --reduced --devices host``
   (``mesh_train_moe_launcher``).

8. ``mesh_train_families`` — the hybrid train step on meshes of
   distinct cards: zamba2-1.2b at its published widths and depth (38
   layers, six shared-block sites) in f32, two SyntheticLM (8, 512)
   steps at (4, 1), (2, 2) and (1, 4) against the unsharded step on
   ``cuda:0`` as two microbatches (the whole batch's activations do not
   fit beside the state on one card); then ``python -m
   repro_torch.launch.train --arch zamba2-1.2b --reduced --devices
   host`` (``mesh_train_families_launcher``).

``--phases`` picks phases by name (``parity``, ``full``, ``moe_parity``,
``moe_a2a``, ``moe_full``, ``train``, ``train_moe``,
``train_families``; all by default).
Then the ``nvidia-smi`` name and power limit of each card. Exits non-zero with fewer than 4 cards or
when a check fails; imports nothing of JAX.
"""
from __future__ import annotations

import gc
import importlib
import subprocess
import sys
import time

from chip_smoke import (KERNELS, MIB, MOE_LAYERS, MOE_PATH, PhaseError,
                        check, emit, greedy_agreement, greedy_requests,
                        make_trace, median_ms, phase_device, warm_up)

N_CARDS = 4
#: The reduced model has 2 KV heads, so its model axis stops at 2.
PARITY_MESHES = ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1))
PARITY_CASES = {"fused_paged": dict(paged=True),
                "fused_dense": dict(paged=False),
                "seed": dict(fused_hotloop=False),
                "prefix_off": dict(prefix_cache=False)}
FULL_MESHES = (None, (1, 1), (1, 2), (2, 2), (1, 4))
MOE_CONFIGS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")
#: The reduced MoE configs have 8 experts: up to 4 data shards.
MOE_PARITY_MESHES = ((2, 1), (4, 1), (2, 2))
MOE_FULL_MESHES = (None, (4, 1), (1, 4))


def serve_clocked(eng, requests) -> tuple:
    """Submit ``requests`` ((Request, SamplingParams) pairs) and step to
    the end on the engine's step clock, landing its side-stream loads
    before every step. Returns (handles, steps, wall seconds)."""
    import torch
    handles = [eng.submit(r, sampling=sp) for r, sp in requests]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while eng.busy() and steps < 20_000:
        for stream in eng._load_streams.values():
            stream.synchronize()
        eng.step()
        eng._clock.t += 0.01
        steps += 1
    torch.cuda.synchronize()
    check(not eng.busy(), "an engine failed to drain")
    return handles, steps, time.perf_counter() - t0


class StepClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def mixed_trace(vocab: int):
    """``tests/test_torch_mesh_engine.py``'s mixed trace: 8 requests of
    8-39 tokens over 8 adapters, every third seeded-sampled."""
    import numpy as np
    from repro_torch.core import Request, SamplingParams
    rng = np.random.default_rng(0)
    out = []
    for i in range(8):
        L, n, a = (int(rng.integers(8, 40)), int(rng.integers(4, 12)),
                   int(rng.integers(0, 8)))
        sp = (SamplingParams(temperature=0.8, top_k=8, seed=i)
              if i % 3 == 2 else None)
        out.append((Request(input_len=L, output_len=n, adapter_id=a,
                            prompt=[(7 * j + i) % vocab + 1
                                    for j in range(L)]), sp))
    return out


def phase_parity() -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving.engine import AdapterCatalog, EngineConfig
    from repro_torch.serving.systems import build_engine
    cfg = get_config("chameleon-llama-7b").reduced()
    params = api.init_params(cfg, 0, torch.float32)
    catalog = AdapterCatalog(cfg, 8, 32, seed=0)
    base = dict(max_slots=4, max_len=128, n_lora_slots=4, n_adapters=8,
                lora_backend="kernel")
    for case, knobs in PARITY_CASES.items():
        outs = {}
        for shape in (None,) + PARITY_MESHES:
            eng = build_engine("chameleon", cfg, params,
                               EngineConfig(**base, **knobs,
                                            mesh_shape=shape),
                               catalog=catalog, clock=StepClock())
            hs, steps, _ = serve_clocked(eng, mixed_trace(cfg.vocab_size))
            outs[shape] = [h.tokens for h in hs]
            del eng, hs
        line = dict(phase="mesh_parity", model=cfg.name, weights="f32",
                    case=case, knobs=knobs,
                    identical={f"{s[0]}x{s[1]}": outs[s] == outs[None]
                               for s in PARITY_MESHES})
        line["ok"] = all(line["identical"].values())
        emit(line)
        check(line["ok"], f"mesh_parity {case}: tokens differ: {line}")


def phase_full() -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import COLLECTIVE_METER
    from repro_torch.models import api
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.systems import build_engine
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in KERNELS}
    cfg = get_config("chameleon-llama-7b")
    params = api.init_params(cfg, seed=0, dtype=torch.bfloat16)
    greedy = greedy_requests(cfg)
    outs = {}
    for shape in FULL_MESHES:
        eng = build_engine("chameleon", cfg, params,
                           EngineConfig(mesh_shape=shape),
                           clock=StepClock())
        warm_up(eng, cfg.vocab_size)
        for i in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(i)
        for st in stats.values():
            st.reset()
        COLLECTIVE_METER.reset()
        trace = make_trace(cfg.vocab_size)
        hs, steps, wall = serve_clocked(eng, trace)
        toks = [h.tokens for h in hs]
        n_tok = sum(len(t) for t in toks)
        name = "none" if shape is None else f"{shape[0]}x{shape[1]}"
        outs[name] = toks
        check(all(len(t) == r.output_len for t, (r, _) in zip(toks, trace))
              and all(0 <= x < cfg.vocab_size for t in toks for x in t),
              f"mesh_engine {name}: short output or token outside the "
              f"vocabulary")
        launches = {n: st.launches for n, st in stats.items()}
        check(all(launches[n] > 0 for n in ("bgmv", "sgmv",
                                            "paged_attention"))
              and not any(st.plain for st in stats.values()),
              f"mesh_engine {name}: a kernel never launched or a plain "
              f"version ran: {launches}")
        sh = eng.shard_stats()
        emit(dict(phase="mesh_engine", model=cfg.name, weights="bf16",
                  mesh_shape=None if shape is None else list(shape),
                  steps=steps, wall_s=wall, ms_per_step=wall * 1e3 / steps,
                  tokens=n_tok,
                  decode_tok_per_s=(n_tok - len(toks)) / wall,
                  peak_mem_gb_by_card=[
                      torch.cuda.max_memory_allocated(i) / 1e9
                      for i in range(torch.cuda.device_count())],
                  gathers_per_dispatch=(
                      COLLECTIVE_METER.gathers
                      / max(COLLECTIVE_METER.dispatches, 1)),
                  shard_stats=sh, launches=launches,
                  greedy_vs_unsharded=(
                      None if shape is None else
                      greedy_agreement(toks, outs["none"], greedy))))
        del eng, hs
        gc.collect()
        torch.cuda.empty_cache()


def phase_moe_parity() -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api, moe
    from repro_torch.serving.engine import AdapterCatalog, EngineConfig
    from repro_torch.serving.systems import build_engine
    base = dict(max_slots=4, max_len=128, n_lora_slots=4, n_adapters=8,
                lora_backend="kernel")
    for name in MOE_CONFIGS:
        cfg = get_config(name).reduced()
        params = api.init_params(cfg, 0, torch.float32)
        catalog = AdapterCatalog(cfg, 8, 32, seed=0)
        for case, knobs in (("fused", {}),
                            ("seed", dict(fused_hotloop=False))):
            outs, drops = {}, {}
            for shape in (None,) + MOE_PARITY_MESHES:
                eng = build_engine("chameleon", cfg, params,
                                   EngineConfig(**base, **knobs,
                                                mesh_shape=shape),
                                   catalog=catalog, clock=StepClock())
                moe.STATS.reset()
                hs, _, _ = serve_clocked(eng, mixed_trace(cfg.vocab_size))
                outs[shape] = [h.tokens for h in hs]
                drops[shape] = moe.STATS.dropped
                if shape is not None:
                    devs = {str(b["device"]) for b in eng.params.experts}
                    check(len(devs) == shape[0],
                          f"mesh_moe_parity {shape}: experts on {devs}")
                del eng, hs
            line = dict(phase="mesh_moe_parity", model=cfg.name,
                        weights="f32", case=case,
                        identical={f"{s[0]}x{s[1]}": outs[s] == outs[None]
                                   for s in MOE_PARITY_MESHES},
                        dropped={("none" if s is None else
                                  f"{s[0]}x{s[1]}"): d
                                 for s, d in drops.items()})
            line["ok"] = (all(line["identical"].values())
                          and len(set(drops.values())) == 1)
            emit(line)
            check(line["ok"], f"mesh_moe_parity {name} {case}: tokens or "
                              f"drops differ: {line}")


def moe_full_config():
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-moe-235b-a22b"),
                               n_layers=MOE_LAYERS)


def phase_moe_a2a() -> None:
    """One MoE layer over (8, 256) tokens through ``moe_block_a2a`` at
    (4, 1) over the 4 cards against ``moe_block`` on each batch shard
    on ``cuda:0`` (within a few bf16 ulps of the largest output)."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.moe import moe_block
    from repro_torch.models.moe_shard_map import moe_block_a2a
    cfg = moe_full_config()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(99)
    E, D, Fe = cfg.n_experts, cfg.d_model, cfg.d_ff_expert

    def w(*shape):
        return (torch.randn(shape, generator=g, device=dev)
                * shape[-2] ** -0.5).to(torch.bfloat16)
    rw, wg, wu, wd = w(D, E), w(E, D, Fe), w(E, D, Fe), w(E, Fe, D)
    x = torch.randn((8, 256, D), generator=g, device=dev).to(torch.bfloat16)
    K, cf = cfg.top_k, cfg.capacity_factor
    n = N_CARDS
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device("cuda", i) for i in range(n)]
    mesh = Mesh(grid.reshape(n, 1), ("data", "model"))
    blocks = [[t.to(f"cuda:{i}") for i, t in enumerate(b.chunk(n))]
              for b in (wg, wu, wd)]
    routers = [rw.to(f"cuda:{i}") for i in range(n)]
    scratch = torch.empty(64 * MIB, dtype=torch.uint8, device=dev)

    def a2a():
        return moe_block_a2a(x, routers, *blocks, K, cf, mesh)[0]

    def per_shard():
        return torch.cat([moe_block(xs, rw, wg, wu, wd, K, cf)[0]
                          for xs in x.chunk(n)])

    def sync_all():
        for i in range(n):
            torch.cuda.synchronize(i)

    def timed(fn):
        fn()
        sync_all()
        ts = []
        for _ in range(5):
            scratch.zero_()
            sync_all()
            t0 = time.perf_counter()
            fn()
            sync_all()
            ts.append((time.perf_counter() - t0) * 1e3)
        return sorted(ts)[len(ts) // 2]
    got, want = a2a(), per_shard()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    line = dict(phase="mesh_moe_a2a", model=cfg.name, mesh_shape=[n, 1],
                devices=[str(d) for d in grid], tokens=[8, 256],
                max_abs_err=err, max_abs_want=scale, tol=2 ** -6 * scale,
                host_ms=timed(a2a), per_shard_moe_block_host_ms=timed(
                    per_shard),
                per_shard_moe_block_device_ms=median_ms(
                    per_shard, scratch.zero_, 1, 5))
    emit(line)
    check(bool(torch.isfinite(got).all()) and err <= line["tol"],
          f"mesh_moe_a2a: off the per-shard moe_block: {line}")


def phase_moe_full() -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import COLLECTIVE_METER
    from repro_torch.models import api, moe
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.systems import build_engine
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in KERNELS}
    cfg = moe_full_config()
    vocab = get_config("chameleon-llama-7b").vocab_size
    greedy = greedy_requests(get_config("chameleon-llama-7b"))
    params = api.init_params(cfg, seed=0, dtype=torch.bfloat16)
    outs = {}
    for shape in MOE_FULL_MESHES:
        eng = build_engine("chameleon", cfg, params,
                           EngineConfig(mesh_shape=shape),
                           clock=StepClock())
        warm_up(eng, vocab)
        for i in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(i)
        for st in stats.values():
            st.reset()
        COLLECTIVE_METER.reset()
        moe.STATS.reset()
        trace = make_trace(vocab)
        hs, steps, wall = serve_clocked(eng, trace)
        toks = [h.tokens for h in hs]
        n_tok = sum(len(t) for t in toks)
        name = "none" if shape is None else f"{shape[0]}x{shape[1]}"
        outs[name] = toks
        check(all(len(t) == r.output_len for t, (r, _) in zip(toks, trace))
              and all(0 <= x < cfg.vocab_size for t in toks for x in t),
              f"mesh_moe_engine {name}: short output or token outside "
              f"the vocabulary")
        launches = {n: st.launches for n, st in stats.items()}
        check(all(launches[n] > 0 for n in MOE_PATH)
              and launches["paged_attention"] == 0
              and not any(st.plain for st in stats.values()),
              f"mesh_moe_engine {name}: a kernel never launched, "
              f"paged_attention or a plain version ran: {launches}")
        emit(dict(phase="mesh_moe_engine", model=cfg.name, weights="bf16",
                  reduced=[f"n_layers 94 -> {cfg.n_layers}"],
                  mesh_shape=None if shape is None else list(shape),
                  steps=steps, wall_s=wall, ms_per_step=wall * 1e3 / steps,
                  tokens=n_tok,
                  decode_tok_per_s=(n_tok - len(toks)) / wall,
                  peak_mem_gb_by_card=[
                      torch.cuda.max_memory_allocated(i) / 1e9
                      for i in range(torch.cuda.device_count())],
                  expert_devices=(None if shape is None else
                                  [str(b["device"])
                                   for b in eng.params.experts]),
                  gathers_per_dispatch=(
                      COLLECTIVE_METER.gathers
                      / max(COLLECTIVE_METER.dispatches, 1)),
                  prefill_dropped=moe.STATS.dropped,
                  shard_stats=eng.shard_stats(), launches=launches,
                  greedy_vs_unsharded=(
                      None if shape is None else
                      greedy_agreement(toks, outs["none"], greedy))))
        del eng, hs
        gc.collect()
        torch.cuda.empty_cache()


#: The train step's meshes of distinct cards.
TRAIN_MESHES = ((4, 1), (2, 2), (1, 4))
LAUNCHER_STEPS = 5
#: The MoE train step across the cards: (arch, layers, (B, S)).
TRAIN_MOE = ("qwen3-moe-235b-a22b", 2, (4, 1024))
#: zamba2-1.2b at its published widths and depth: 38 Mamba2 layers and
#: six sites of the shared attention block (1.17 B params, 18.7 GB of
#: f32 state), SyntheticLM (8, 512). The unsharded step's activations
#: at (8, 512) do not fit beside that state on one card, so the
#: reference runs the same batch as two microbatches of (4, 512).
TRAIN_FAMILIES = ("zamba2-1.2b", None, (8, 512), 2)


def phase_train() -> None:
    """``mesh_train``: internlm2-1.8b at full width and depth in f32,
    two SyntheticLM (8, 512) steps on each of ``TRAIN_MESHES`` of
    distinct cards, held to the unsharded step on ``cuda:0``
    (``chip_smoke.train_mesh_run``: loss and grad norm, params and
    moments after the last step, launches, s/step, each card's peak
    memory); then ``python -m repro_torch.launch.train --devices host``
    for ``LAUNCHER_STEPS`` steps over every card
    (``mesh_train_launcher``)."""
    import torch
    from chip_smoke import (train_mesh_inputs, train_mesh_reference,
                            train_mesh_run)
    from repro_torch.launch.mesh import make_mesh
    cfg, init, ocfg, batches = train_mesh_inputs()
    ref = train_mesh_reference(cfg, ocfg, init, batches)
    for shape in TRAIN_MESHES:
        train_mesh_run(cfg, ocfg, init, batches,
                       make_mesh(shape, ("data", "model")), ref,
                       "mesh_train")
    del init, ref
    gc.collect()
    torch.cuda.empty_cache()
    run_launcher("mesh_train_launcher", [])


def phase_train_moe() -> None:
    """``mesh_train_moe``: ``TRAIN_MOE`` (qwen3-moe at full width, 2
    layers, f32) for two SyntheticLM steps on each of ``TRAIN_MESHES``
    of distinct cards, held to the unsharded step on the host's CPU
    (``chip_smoke.train_mesh_run``, MoE drops equal); then
    ``launch.train --arch qwen3-moe-235b-a22b --reduced --devices host``
    over every card (``mesh_train_moe_launcher``)."""
    import os

    import torch
    from chip_smoke import (train_mesh_inputs, train_mesh_reference,
                            train_mesh_run)
    from repro_torch.launch.mesh import make_mesh
    arch, n_layers, batch = TRAIN_MOE
    cfg, init, ocfg, batches = train_mesh_inputs(arch, n_layers, batch)
    torch.set_num_threads(os.cpu_count())
    t0 = time.perf_counter()
    ref = train_mesh_reference(cfg, ocfg, init, batches, device="cpu")
    emit(dict(phase="mesh_train_moe_reference", device="cpu",
              threads=torch.get_num_threads(),
              seconds=time.perf_counter() - t0, history=ref["history"]))
    for shape in TRAIN_MESHES:
        train_mesh_run(cfg, ocfg, init, batches,
                       make_mesh(shape, ("data", "model")), ref,
                       "mesh_train_moe")
    del init, ref
    gc.collect()
    torch.cuda.empty_cache()
    run_launcher("mesh_train_moe_launcher", ["--arch", arch, "--reduced"])


def phase_train_families() -> None:
    """``mesh_train_families``: ``TRAIN_FAMILIES`` (zamba2-1.2b whole,
    f32) for two SyntheticLM steps on each of ``TRAIN_MESHES`` of
    distinct cards, held to the unsharded step on ``cuda:0`` (two
    microbatches; ``chip_smoke.train_mesh_run``: loss and grad norm,
    params and moments, six flash forward and backward launches a
    position a step, each card's peak memory, s/step); then
    ``launch.train --arch zamba2-1.2b --reduced --devices host`` over
    every card (``mesh_train_families_launcher``)."""
    import torch
    from chip_smoke import (train_mesh_inputs, train_mesh_reference,
                            train_mesh_run)
    from repro_torch.launch.mesh import make_mesh
    arch, n_layers, batch, micro = TRAIN_FAMILIES
    cfg, init, ocfg, batches = train_mesh_inputs(arch, n_layers, batch)
    t0 = time.perf_counter()
    ref = train_mesh_reference(cfg, ocfg, init, batches,
                               microbatches=micro)
    emit(dict(phase="mesh_train_families_reference", device="cuda:0",
              microbatches=micro, seconds=time.perf_counter() - t0,
              peak_gb=ref["peak_gb"], history=ref["history"]))
    for shape in TRAIN_MESHES:
        train_mesh_run(cfg, ocfg, init, batches,
                       make_mesh(shape, ("data", "model")), ref,
                       "mesh_train_families")
    del init, ref
    gc.collect()
    torch.cuda.empty_cache()
    run_launcher("mesh_train_families_launcher",
                 ["--arch", arch, "--reduced"])


def run_launcher(phase: str, args: list) -> None:
    """``python -m repro_torch.launch.train --devices host`` with
    ``args`` for ``LAUNCHER_STEPS`` steps over every card: exit code 0,
    "done" last and the mesh over every card logged."""
    import os

    import torch
    from chip_smoke import ROOT
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--devices",
         "host", "--steps", str(LAUNCHER_STEPS), *args],
        capture_output=True, text=True, timeout=900, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    lines = out.stdout.splitlines()
    emit(dict(phase=phase, args=args, rc=out.returncode,
              seconds=time.perf_counter() - t0, stdout=lines[-8:],
              stderr=out.stderr.splitlines()[-8:]))
    check(out.returncode == 0 and lines and lines[-1] == "done"
          and any(f"{torch.cuda.device_count()} positions" in x
                  for x in lines),
          f"launch.train --devices host {args}: rc {out.returncode}, "
          f"{lines[-3:]}")


PHASES = {"parity": phase_parity, "full": phase_full,
          "moe_parity": phase_moe_parity, "moe_a2a": phase_moe_a2a,
          "moe_full": phase_moe_full, "train": phase_train,
          "train_moe": phase_train_moe,
          "train_families": phase_train_families}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_mesh: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < N_CARDS:
        print(f"chip_mesh: needs {N_CARDS} CUDA devices", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = list(PHASES)
    if "--phases" in sys.argv:
        names = sys.argv[sys.argv.index("--phases") + 1].split(",")
    if not set(names) <= set(PHASES):
        print(f"chip_mesh: unknown phases {names}; known: {list(PHASES)}",
              file=sys.stderr)
        return 2
    try:
        phase_device()
        for name in names:
            t0 = time.perf_counter()
            PHASES[name]()
            emit(dict(phase="phase_seconds", name=name,
                      seconds=time.perf_counter() - t0))
    except PhaseError as exc:
        print(f"chip_mesh: FAILED: {exc}", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        end="", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
