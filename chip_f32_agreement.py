#!/usr/bin/env python3
"""Greedy agreement of the fused and the seed engine with f32 weights.

Run from the root of a checkout:  python3 chip_f32_agreement.py [--repeats N]

At full width in bf16 the port's engines agree on nearly every first
token but on fewer whole outputs (``chip_smoke.py`` phase 4,
``engine_ab``). This script serves the same trace with f32
``chameleon-llama-7b`` weights at full width (32 layers, d 4096, about
27 GB, seeded from the port's ``init_params``), TF32 off, through the
default fused engine and then the seed loop (``fused_hotloop=False``),
one engine at a time, each after ``chip_smoke.warm_up``. It prints one
``agreement`` line: greedy requests with identical whole outputs, with
identical first tokens, and the mean common prefix. If any greedy
request differs, a ``divergence`` line follows for each: the first
differing position, both tokens, and the top-two margin of the logits
at that position, recomputed by one f32 ``api.prefill`` over the prompt
and the common prefix with the request's adapter in one LoRA slot
(a near tie has a margin of the order of the f32 rounding of a
32-layer pass, far below 1e-2).

Then the ``nvidia-smi`` name and power limit line. Exits non-zero
without a card or when a phase fails; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import gc
import sys

from chip_smoke import (PhaseError, check, emit, greedy_agreement,
                        greedy_requests, make_trace, phase_device, serve,
                        warm_up)

ENGINES = {"fused": dict(), "seed": dict(fused_hotloop=False)}
#: dtype of the engines' LoRA slot buffers: the engine's own (bf16), and
#: f32, under which sgmv and bgmv round their rank-r intermediate to
#: f32 rather than bf16 (the slots hold the same bf16 adapter values).
LORA_SLOTS = ("bf16", "f32")


def agreement(cfg, params, catalog, trace, slots: str, rep: int) -> None:
    """Serve ``trace`` with each engine of ``ENGINES`` (LoRA slots in
    ``slots``), then the ``agreement`` and ``divergence`` lines."""
    import functools

    import torch
    from repro_torch.models import lora_apply
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.systems import build_engine
    dtype = torch.bfloat16 if slots == "bf16" else torch.float32
    engine_mod.init_lora_slots = functools.partial(
        lora_apply.init_lora_slots, dtype=dtype)
    outs = {}
    try:
        for name, knobs in ENGINES.items():
            eng = build_engine("chameleon", cfg, params,
                               EngineConfig(**knobs), catalog=catalog)
            check(eng.lora["q"][0].dtype == dtype,
                  f"LoRA slots are {eng.lora['q'][0].dtype}")
            warm_up(eng, cfg.vocab_size)
            torch.cuda.reset_peak_memory_stats()
            res = serve(eng, make_trace(cfg.vocab_size))
            outs[name] = [h.tokens for h in res.pop("handles")]
            check(all(len(t) == r.output_len
                      for t, (r, _) in zip(outs[name], trace)),
                  f"{name}: a request stopped short of its output length")
            emit(dict(phase="engine_f32", engine=name, knobs=knobs,
                      repeat=rep, model=cfg.name, weights="f32",
                      lora_slots=slots,
                      tf32=False,
                      peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                      **{k: v for k, v in res.items()
                         if k in ("wall_s", "steps", "tokens",
                                  "ttft_p50_s", "decode_tok_per_s")}))
            del eng, res
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        engine_mod.init_lora_slots = lora_apply.init_lora_slots
    greedy = greedy_requests(cfg)
    emit(dict(phase="agreement", model=cfg.name, weights="f32",
              lora_slots=slots, repeat=rep, greedy_requests=len(greedy),
              **greedy_agreement(outs["fused"], outs["seed"], greedy)))
    for i in greedy:
        a, b = outs["fused"][i], outs["seed"][i]
        if a == b:
            continue
        j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
        emit(dict(phase="divergence", lora_slots=slots, repeat=rep,
                  request=i,
                  position=j, fused_token=a[j], seed_token=b[j],
                  prompt_len=len(trace[i][0].prompt),
                  **margin_at(cfg, params, catalog, trace[i][0], a[:j],
                              dtype)))


def margin_at(cfg, params, catalog, req, prefix: list[int],
              dtype) -> dict:
    """Top-two logits of the next token after ``req.prompt + prefix``,
    from one whole-prompt prefill with the request's adapter in one
    LoRA slot of ``dtype``."""
    import torch
    from repro_torch.models import api
    w = catalog.weights[req.adapter_id]
    lora = {n: (a[:, None].to("cuda", dtype), b[:, None].to("cuda", dtype))
            for n, (a, b) in w.items()}
    toks = torch.tensor([list(req.prompt) + prefix], dtype=torch.int32,
                        device="cuda")
    idx = torch.zeros((1,), dtype=torch.int32, device="cuda")
    logits, _ = api.prefill(cfg, params, toks, lora=lora, adapter_idx=idx,
                            lora_backend="kernel")
    top = torch.topk(logits[0].float(), 2)
    return dict(top2_tokens=top.indices.tolist(),
                top2_logits=top.values.tolist(),
                margin=float(top.values[0] - top.values[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=1,
                    help="serve each slot dtype's pair of engines N times")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_f32_agreement: PyTorch is not installed",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_f32_agreement: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        dev = phase_device()
        from repro_torch.configs import get_config
        from repro_torch.models import api
        from repro_torch.serving.engine import AdapterCatalog, EngineConfig
        cfg = get_config("chameleon-llama-7b")
        params = api.init_params(cfg, seed=0, dtype=torch.float32)
        ecfg = EngineConfig()
        catalog = AdapterCatalog(cfg, ecfg.n_adapters, ecfg.r_max,
                                 seed=ecfg.seed)
        trace = make_trace(cfg.vocab_size)
        for rep in range(args.repeats):
            for slots in LORA_SLOTS:
                agreement(cfg, params, catalog, trace, slots, rep)
    except PhaseError as exc:
        print(f"chip_f32_agreement: FAILED: {exc}", file=sys.stderr)
        return 1
    print(dev["nvidia_smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
