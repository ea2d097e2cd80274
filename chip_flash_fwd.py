#!/usr/bin/env python3
"""Device time and precision of the flash_attention forward in f32 on
one NVIDIA GPU (H100).

Run from the root of a checkout:  python3 chip_flash_fwd.py [--src DIR]

At each of ``SHAPES`` (the f32 training shapes of ``chip_smoke.py``'s
``FWD_LSE_SHAPES`` and the reduced Llama's (1, 32) prefill bucket),
``flash_attention`` on f32 tensors, timed as ``chip_smoke.median_ms``
times a kernel (L2 flushed, CUDA events, the median of 15 calls); its
distance from the plain version in f64 on the same values (the root
mean square and the largest |got - want|, each over the mean |want|,
and the mean signed difference), beside the f32 plain version's own;
and whether it stays within the f32 gate (1e-4 + 1e-4 |want| of the f32
plain version), beside the bounds at 3xTF32 and at f32 on CUDA
cores. Then the forward library's ``-Xptxas=-v`` registers and
spills. ``--src`` imports the port from another tree's ``src`` (an
older checkout, or one with another kernel), so two versions can be
compared in one run on one card: run them in turns. One JSON line a
case, then the ``nvidia-smi`` name and power limit. Imports nothing of
JAX; exits non-zero without a card or when a case misses the gate.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke

ROOT = Path(__file__).resolve().parent
#: (label, B, S, H, Kh, dh, causal).
SHAPES = tuple((s[0], *s[1:6], s[7] if len(s) > 7 else True)
               for s in chip_smoke.FWD_LSE_SHAPES if s[6] == "f32") + (
    ("reduced llama prefill", 1, 32, 4, 2, 32, True),)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose repro_torch package is timed")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"chip_flash_fwd: no repro_torch under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_flash_fwd: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    build.build_all()
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(7)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    ok = True
    for label, B, S, H, Kh, dh, causal in SHAPES:
        q = torch.randn((B, S, H, dh), generator=g, device="cuda")
        k, v = (torch.randn((B, S, Kh, dh), generator=g, device="cuda")
                for _ in range(2))
        got = fa.flash_attention(q, k, v, causal)
        w64 = fa.flash_attention_plain(q.double(), k.double(), v.double(),
                                       causal)
        w32 = fa.flash_attention_plain(q, k, v, causal)
        mean = w64.abs().mean().item()

        def dist(x):
            d = x.double() - w64
            return dict(rms=d.pow(2).mean().sqrt().item() / mean,
                        max=d.abs().max().item() / mean,
                        mean_signed=d.mean().item() / mean)
        gate = bool(((got - w32).abs() <= 1e-4 + 1e-4 * w32.abs()).all())
        err, err_plain = dist(got), dist(w32)
        del w64, w32, got
        ms = chip_smoke.median_ms(lambda: fa.flash_attention(q, k, v, causal),
                                  scratch.zero_)
        n_bytes = chip_smoke.nbytes(q, k, v, q)
        flops = 4 * B * H * dh * (S * (S + 1) // 2 if causal else S * S)
        bound, by = chip_smoke.bound_ms(n_bytes, flops, "tf32x3")
        print(json.dumps(dict(
            src=str(src), case=label, q=[B, S, H, dh], kv_heads=Kh,
            causal=causal, instance=fa.flash_instance(q.dtype, dh), ms=ms,
            bound_ms=bound, bound_by=by,
            bound_ms_cuda_cores=chip_smoke.bound_ms(n_bytes, flops, "f32")[0],
            err_vs_f64=err, plain_f32_err_vs_f64=err_plain,
            within_gate=gate)), flush=True)
        ok &= gate
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps(dict(src=str(src), ptxas=[
        {key: u.get(key) for key in ("kernel", "registers", "spill_stores",
                                     "spill_loads")}
        for u in build.ptxas_usage("flash_attention")])), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
