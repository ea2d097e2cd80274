#!/usr/bin/env python3
"""Device-time profile of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the root of a checkout:  python3 chip_profile.py

Builds and checks the kernels as ``chip_smoke.py`` phases 1 and 2 do,
then two torch.profiler windows, one JSON line each:

1. profile_kernel — each CUDA kernel behind a wrapper (sgmv launches
   a shrink and an expand kernel, the others one): launches and device
   µs per call at the phase-2 shapes, L2 warm; and the same for one
   draw of the seeded sampler's Gumbel noise (8 rows, V 32000), which
   is plain PyTorch.
2. profile — a few steady fused decode steps of ``chameleon-llama-7b``
   at full width under the default ``EngineConfig``, once every row of
   one wave is placed: ms per decode step, the device's busy share of
   the wall time, and the operations that take the most device time
   and the most host time.

Drives the engine through its public calls only and imports nothing of
JAX. Exits non-zero without a card or when a phase fails.
"""
from __future__ import annotations

import sys
import time

from chip_smoke import (ROOT, PhaseError, check, emit, phase_device,
                        phase_kernels, warm_up)


def _dev_us(e) -> float:
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0))


def profile_kernels(calls: dict, iters: int = 20) -> None:
    """Device time per call of each CUDA kernel behind a wrapper."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        emit(dict(phase="profile_kernel", kernel=name,
                  launches_per_call=sum(e.count for e in kernels) / iters,
                  us_per_call=sum(_dev_us(e) for e in kernels) / iters,
                  per_call=[dict(cuda_kernel=e.key[:70],
                                 us=_dev_us(e) / iters)
                            for e in kernels[:12]]))


def sampler_call():
    """One draw of the seeded sampler's noise for the engine's 8 rows
    over Llama's 32000-token vocabulary (plain PyTorch, no kernel of
    its own): its launches and device time per sampled decode step."""
    import torch
    from repro_torch.models import lm
    seeds = torch.arange(8, device="cuda") + 1000
    pos = torch.arange(8, device="cuda", dtype=torch.int32) + 40
    return lambda: lm.gumbel_noise(seeds, pos, 32000)


def _generated(eng) -> int:
    return sum(r.generated for r in eng.slot_req if r is not None)


def profile_decode(cfg, params, n_steps: int = 3, top: int = 15) -> None:
    """torch.profiler over ``n_steps`` steady steps of the fused loop.

    One wave of 8 requests (32-token prompts, 100 output tokens, one
    adapter each) fills the 8 rows. Once all are placed and no load is
    in flight, one more step runs and the card is synchronised; the
    window then holds ``n_steps`` steps and ends with a synchronise.
    With pipelined readback each step drains the previous horizon, so
    the window's host-side token count and its device work both cover
    ``n_steps`` horizons."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import Request, SamplingParams
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.systems import build_engine

    eng = build_engine("chameleon", cfg, params, EngineConfig())
    warm_up(eng, cfg.vocab_size)
    rng = np.random.default_rng(7)
    n_rows = eng.ecfg.max_slots
    for a in range(n_rows):
        sp = SamplingParams(temperature=0.8, seed=a) if a % 4 == 3 else None
        eng.submit(Request(input_len=32, output_len=100, adapter_id=a,
                           prompt=rng.integers(3, cfg.vocab_size,
                                               32).tolist()), sampling=sp)

    def placed() -> bool:
        return (int(eng.active.sum()) == n_rows
                and eng.sched.pending_count() == 0)

    for _ in range(500):
        eng.step()
        if placed():
            break
    check(placed(), "profile: never reached a steady batch")
    eng.flush_loads()
    eng.step()
    torch.cuda.synchronize()
    gen0 = _generated(eng)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    tokens = _generated(eng) - gen0
    check(tokens > 0, "profile: no token decoded in the window")
    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    ops = [e for e in avgs if e.device_type == DeviceType.CPU]
    busy_us = sum(_dev_us(e) for e in kernels)
    emit(dict(
        phase="profile", loop="fused", rows=n_rows, steps=n_steps,
        decode_tokens=tokens, wall_s=wall,
        ms_per_decode_step=wall * 1e3 / (tokens / n_rows),
        device_busy_share=busy_us * 1e-6 / wall,
        launches=sum(e.count for e in kernels),
        top_device=[dict(name=e.key[:90], calls=e.count, us=_dev_us(e))
                    for e in sorted(kernels, key=_dev_us, reverse=True)[:top]],
        top_host=[dict(name=e.key[:60], calls=e.count,
                       self_cpu_us=e.self_cpu_time_total)
                  for e in sorted(ops, key=lambda e: e.self_cpu_time_total,
                                  reverse=True)[:top]]))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_profile: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dev = phase_device()
        _, calls = phase_kernels()
        calls["gumbel_noise"] = sampler_call()
        profile_kernels(calls)
        from repro_torch.configs import get_config
        from repro_torch.models import api
        cfg = get_config("chameleon-llama-7b")
        params = api.init_params(cfg, seed=0, dtype=torch.bfloat16)
        profile_decode(cfg, params)
    except PhaseError as exc:
        print(f"chip_profile: FAILED: {exc}", file=sys.stderr)
        return 1
    print(dev["nvidia_smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
