#!/usr/bin/env python3
"""Device time and precision of the flash_attention backward kernel on
one NVIDIA GPU (H100).

Run from the root of a checkout:  python3 chip_flash_bwd.py [--src DIR]

At each of ``SHAPES`` and dtypes: ``flash_attention_bwd`` given the
forward's log-sum-exp, timed as ``chip_smoke.median_ms`` times a kernel
(L2 flushed, CUDA events, the median of 15 calls); the error of its dq,
dk and dv (the largest |got - want| over the largest |want|) against
the plain backward in f64 on the same values, beside the f32 plain
version's own; and whether it stays within
``chip_smoke.flash_bwd_allowance`` of the f32 plain version (the gate
of the smoke and the card tests). The long-context shape walks 2048
k-steps in the dq kernel and 4096 in the dk/dv kernel. Then the
backward library's ``-Xptxas=-v`` registers and spills of each
instance. ``--src`` imports the port from another tree's ``src`` (an
older checkout), so two versions can be compared in one run on one
card: run them in turns. One JSON line a case, then the ``nvidia-smi``
name and power limit. Imports nothing of JAX; exits non-zero without a
card or when a case misses the gate.
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
#: (label, B, S, H, Kh, dh, causal, dtypes).
SHAPES = (
    ("internlm2-1.8b", 8, 512, 16, 8, 128, True, ("f32", "bf16")),
    ("qwen3-moe (2, 1) shard, G 16", 1, 2048, 64, 4, 128, True,
     ("f32", "bf16")),
    ("long context, G 2", 1, 16384, 2, 1, 128, False, ("f32", "bf16")))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose repro_torch package is timed")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    if not (src / "repro_torch").is_dir():
        print(f"chip_flash_bwd: no repro_torch under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_flash_bwd: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    build.build_all()
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(4321)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    ok = True
    for label, B, S, H, Kh, dh, causal, names in SHAPES:
        for name in names:
            dt = dtypes[name]
            q, dout = (torch.randn((B, S, H, dh), generator=g,
                                   device="cuda").to(dt) for _ in range(2))
            k, v = (torch.randn((B, S, Kh, dh), generator=g,
                                device="cuda").to(dt) for _ in range(2))
            out, lse = fa.flash_attention(q, k, v, causal, return_lse=True)
            got = fa.flash_attention_bwd(q, k, v, out, dout, causal,
                                         lse=lse)
            want64 = fa.flash_attention_bwd_plain(
                *(t.double() for t in (q, k, v, out, dout)), causal)
            want32 = fa.flash_attention_bwd_plain(
                *(t.float() for t in (q, k, v, out, dout)), causal)
            err, err_plain = {}, {}
            for gname, gt, w64, w32 in zip(("dq", "dk", "dv"), got, want64,
                                           want32):
                top = w64.abs().max().item()
                err[gname] = (gt.double() - w64).abs().max().item() / top
                err_plain[gname] = (w32.double() - w64).abs().max().item() \
                    / top
            del want64
            bounds = chip_smoke.flash_bwd_allowance(q, k, v, out, dout,
                                                    causal, want32)
            gate = all(bool(((gt.float() - w).abs() <= bd).all())
                       for gt, w, bd in zip(got, want32, bounds))
            del want32, bounds, got
            ms = chip_smoke.median_ms(
                lambda: fa.flash_attention_bwd(q, k, v, out, dout, causal,
                                               lse=lse), scratch.zero_)
            bound, by = chip_smoke.flash_bwd_bound(q, k, v, causal)
            print(json.dumps(dict(
                src=str(src), case=label, q=[B, S, H, dh], kv_heads=Kh,
                causal=causal, dtype=name,
                instance=fa.flash_bwd_instance(dt, dh), ms=ms,
                bound_ms=bound, bound_by=by, rel_err_vs_f64=err,
                plain_f32_rel_err_vs_f64=err_plain, within_gate=gate)),
                flush=True)
            ok &= gate
            del q, k, v, out, dout, lse
            torch.cuda.empty_cache()
    print(json.dumps(dict(src=str(src), ptxas=[
        {key: u.get(key) for key in ("kernel", "registers", "spill_stores",
                                     "spill_loads")}
        for u in build.ptxas_usage("flash_attention_bwd")])), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
