#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the root of a checkout:  python3 chip_smoke.py

Drives the port (``src/repro_torch``) only; imports nothing of JAX or
of the JAX package. Phases, one JSON line each:

1. device  — the card (``nvidia-smi`` name and power limit) and the
             seconds it took to build the CUDA kernels from
             ``src/repro_torch/csrc`` (one ``nvcc`` per source, all
             started together); then one ``ptxas`` line per source:
             each kernel's registers, shared memory (static, and the
             dynamic bytes of the tensor-core instances) and spills as
             ``nvcc -Xptxas=-v`` reported them.
2. kernel  — every kernel of the main path against its plain PyTorch
             version on the same card tensors, at the main path's
             full-width Llama-7B shapes, f32 and bf16 activations:
             max error against the stated tolerance (``TOL``), the
             kernel's and
             the plain version's median ms (CUDA events, L2 flushed
             before each launch), the bound from bytes and operations,
             and a PyTorch yardstick (``library_ms``) the port never
             calls. sgmv has two instances (tensor cores for bf16,
             CUDA cores otherwise), flash_attention three (tensor cores
             for bf16 with dh % 16 == 0, CUDA cores for other bf16,
             ``tf32x3`` for f32: three TF32 products an f32 product):
             every case line names the instance that launched, and it
             must be the one the dtype and shape select; each kernel's
             timing line counts the checked cases of each instance
             (``checked_by_instance``). bgmv and paged_attention run
             over thread-block clusters: a ``kernel_sweep`` line times
             each cluster size (paged_attention's also times a PyTorch
             sum of its K and V pages, a yardstick of the memory
             rate), and paged_attention is also checked and timed at
             the trace's ragged decode lengths (32-232) on a
             ``kernel_time_ragged`` line, with SDPA over the gathered
             pages under a length mask as its library time. sgmv is
             also checked and timed at the speculative verify pass's
             shape (x (64, 4096): 8 rows of one tile of 8 tokens, dout
             4096 and 1024) on ``kernel_time_verify`` lines. The two
             instances no engine at full width runs are timed on
             ``kernel_time_instance`` lines: sgmv's ``cuda_cores`` at
             the bf16 row's shape with x in f32 (A/B bf16; gathered
             ``bmm`` x2 in f32 as library), and flash_attention's
             bf16 ``cuda_cores`` at dh 88 (BLIP-2's ViT-g head width,
             a kernel shape only: no config here has a head width
             that is not a multiple of 16), first checked at ragged S
             (5, 100, 1000; 32/32 and 32/8 heads, causal and full) and
             at (8, 256, 32, 88) causal, then timed there
             beside SDPA, with the bound at the bf16 peak and at the
             f32 CUDA-core peak.
3. parity  — reduced Llama in f32, the card (kernels) against the CPU
             (plain versions) on the same weights: ``prefill_paged``
             and one ``decode_step_paged``; the dense ``prefill``, the
             K/V slab it fills and one ``decode_step`` over the slab
             (the f32 LoRA launches sgmv's ``cuda_cores`` instance
             only; its launches are on the ``parity`` line).
             Then two engine cases, each served on the card and on the
             CPU port with the same weights and trace
             (``parity_engine``): a chunked-prefill engine (chunk 8),
             and requests exported mid-decode from one engine and
             imported into another, paged and dense. The card's tokens
             must equal the CPU port's exactly. Then six speculative
             engines (``parity_spec``): the 2-layer internlm2 draft with
             a greedy and a mixed batch, and the self-draft over zero
             adapter deltas, paged and dense; tokens and drafted and
             accepted counts must equal the CPU port's, and the verify
             pass's LoRA must run sgmv at tile 8. Then the MoE family
             (``parity_moe``): reduced qwen3-moe (8 experts, top-2, MoE
             every layer, qk-norm) and llama4 (top-1, MoE every second
             layer, shared expert) engines under ``EngineConfig()``
             (MoE serves from the dense slab), fused and seed loop;
             tokens and prefill drops over capacity must equal the CPU
             port's, bgmv, sgmv and flash_attention must launch and
             paged_attention not. And the VLM model path
             (``parity_vlm``): reduced qwen2-vl-7b prefill and one
             decode step with distinct t/h/w M-RoPE positions, logits
             and slab within 2e-4 of the CPU's. Then the families
             without an engine (``parity_family``): reduced
             falcon-mamba-7b, zamba2-1.2b (LoRA through the kernels)
             and whisper-base in f32, S = 16 (and 70 for the scans):
             ``forward``, ``train_loss``, ``prefill`` and 4
             ``decode_step``s, logits, loss and states within 1e-4 of
             the CPU's; their kernels launch, no plain version runs.
4. engine  — ``chameleon-llama-7b`` at full width (32 layers, d 4096,
             bf16 weights from a seeded generator): 16 requests over
             12 adapters from shared preambles, some seeded-sampled,
             after a three-request warm-up, served by eight engines
             built and freed one at a time: the default
             ``EngineConfig`` (paged KV, prefix cache, fused loop), the
             seed decode loop as its A/B, the dense KV slab
             (``paged=False``), the paged engine without the prefix
             cache (``prefix_cache=False``), chunked prefill
             (``prefill_chunk_tokens=64``), and two speculative engines
             (``spec_decode=True``, ``spec_k=4``; ``spec_parts``):
             ``spec``, with internlm2-1.8b at its published widths as
             the draft (vocabulary cut to 32000; acceptance near 0),
             and ``spec_self``, the shared-layer self-draft (acceptance
             near 1), beside ``fused_self``, the fused engine on
             ``spec_self``'s weights, whose greedy tokens it is held to
             (reported). Their lines add the spec gauges, draft and verify
             dispatches per token and sgmv's launches per tile; after
             the drain every page must be back in the pool and the
             draft mirror freed. Kernel launch counts are
             zeroed just before each engine's trace and read just
             after; every kernel on that engine's path must have
             launched, sgmv and flash_attention only in their
             tensor-core instances (bf16 at full width), and no plain or
             einsum path may have run. Each engine's line carries its
             TTFT p50/p99 and the device time of its prefill calls
             (CUDA events around each ``api.prefill[_paged]`` call).
5. tiers   — the same model, warm-up and trace through
             ``build_system``: ``tier="disagg"`` (one prefill and one
             decode replica, KV shipped between them) and
             ``tier="cluster"`` (two replicas, adapter affinity), each
             built and freed in turn. Each line carries TTFT p50/p99,
             decode tokens/s, KV exports and imports, GB shipped, the
             median host ms of ``begin_migration`` and
             ``import_request_kv`` beside the modeled link's ms, spilled
             requests, peak memory and greedy agreement with the fused
             engine. Every request must complete; on the disagg tier
             exports must equal imports and be above 0; every replica
             must read the caller's weight tensors (no copy), and peak
             memory must stay under the fused engine's peak + 8 GB.
   mesh    — the mesh data plane on the one card, where every position
             of a split mesh is the same device (so no interconnect is
             measured): reduced Llama in f32 through the step functions
             (``prefill_paged``, two fused paged horizons, whole-prompt
             ``prefill``) with weights, LoRA arena and pages placed by
             ``ShardPlan`` on meshes (1, 1), (1, 2) and (2, 2) over
             repeated positions (``mesh_steps`` lines: (1, 1) bit-exact
             against the unsharded functions, the split meshes within
             1e-4, prefill and decode logits); reduced granite-34b
             (MQA) at (1, 2) and (1, 4) and reduced Llama at (1, 4),
             whose KV heads do not divide the columns (same gates);
             bgmv, sgmv, paged_attention and flash_attention at a
             2-way column's Llama-7B shapes (LoRA dout 2048, 16 heads)
             against their plain versions, timed beside their bounds
             (``kernel_time_mesh``); the same sweep at full width in
             bf16 on the first 8 trace prompts (first-token and greedy
             agreement, logits error, decode ms a step, peak memory);
             then the phase-4 trace through ``EngineConfig()``,
             ``EngineConfig(mesh_shape=(1, 1))`` and ``EngineConfig()``
             again, each on a step clock with loads landed before each
             step (``mesh_engine``: tokens must be identical; ms a step,
             peak memory, shard gauges). Each run's kernel launches are
             counted from zero and every kernel of its path must launch.
   examples — the port's serving examples on the same weights
             (``phase_examples``), one ``example`` line a run, each
             through its ``main`` with the weights handed over and freed
             after: ``examples/torch_quickstart.py`` (streaming, seeded
             sampling, a cancel), ``torch_serve_manyadapter.py`` in its
             three modes (the DES head-to-head, ``--engine``,
             ``--cluster``: two replicas sharing the weights),
             ``torch_disagg_cluster.py`` (three replicas, a KV handoff,
             a cancel during it) and ``torch_gateway_multitenant.py``
             (admission over the DES node). Each example asserts its
             own contract and, on the card, that bgmv, sgmv and
             paged_attention launched in its served run (counts zeroed
             after any warm-up) with no plain version and no einsum
             LoRA (the default ``EngineConfig``'s prefix cache
             sends prefill through the suffix path: flash_attention is
             not on it); each line carries seconds, requests finished
             and cancelled, TTFT p50/p99 (engine clock), cache hits,
             misses and evictions, handoffs and GB shipped, launches
             and peak memory, gated at the fused peak + 8 GB.
   engine  — (MoE) with Llama's weights freed (under 1 GB may stay
             allocated): ``qwen3-moe-235b-a22b`` at its published widths
             cut to 8 layers (42.3 GB of seeded bf16 weights drawn on
             the card). bgmv, sgmv and flash_attention are first checked
             against their plain versions at its widths
             (``kernel_time_moe`` lines) and one (8, 256) prefill call
             is timed and profiled, then the phase-4 trace is
             served by ``moe`` (``EngineConfig()``) and ``moe_seed``
             (``fused_hotloop=False``), one at a time
             (``engine_moe`` lines): ``paged`` false, TTFT, decode
             tokens/s, dispatches per token, peak memory, prefill
             assignments dropped over capacity, distinct experts read
             per layer per decode step, launches; then a steady 8-row
             decode window (``decode_window``): ms per decode step,
             device busy share under torch.profiler and the step's
             bytes bound. Every request must complete within the
             vocabulary; bgmv, sgmv (tensor cores) and flash_attention
             (tensor cores) must launch, paged_attention not, and no
             plain or einsum path run. ``engine_moe_ab`` reports greedy
             agreement between the two (not gated: bf16, and the
             capacity drops depend on which requests share a bucket).
   mesh    — (MoE, ``phase_mesh_moe``) with the same weights loaded, the
             experts over "data": bgmv, sgmv and flash_attention at one
             column's shapes of a (·, 2) mesh (LoRA dout 4096 and 256,
             32 of 64 heads over 2 KV heads; ``kernel_time_mesh_moe``);
             the step functions (whole-prompt (8, 256) ``prefill``, one
             ``decode_step`` and two fused horizons over the slab) at
             (1, 1), (2, 1), (1, 2) and (2, 2) over repeated positions
             (``mesh_moe_steps``: (1, 1) and (2, 1) bit-exact in
             prefill, decode and every greedy token, the column splits'
             prefill logits within 2**-4, first-token and greedy
             agreement reported); one MoE layer through
             ``moe_block_a2a`` at (2, 1) and (4, 1) against ``moe_block``
             on each batch shard, timed (``mesh_moe_a2a``); the phase-4
             trace through ``EngineConfig()``, ``EngineConfig(mesh_shape=
             (1, 1))`` and ``(2, 1)`` on a step clock (``mesh_moe_engine``:
             (1, 1) and (2, 1) tokens identical, ms a step, peak memory, shard
             gauges). bgmv, sgmv and flash_attention launch on tensor
             cores; paged_attention, plain versions and the einsum LoRA
             never run. A ``phase_mesh_moe`` line gives each part's
             seconds.

6. family  — with the MoE model freed, the families served by model
             functions only, at their published widths, bf16 weights
             from the port's ``init_params``, one at a time: falcon-
             mamba-7b (64 layers; prefill (4, 2048), 32 decode steps,
             serve-state bytes at S 64 and 2048, decode against
             ``forward`` over S + 1), zamba2-1.2b (prefill (8, 512), 32
             decode steps, 8 adapters through sgmv and bgmv, then the
             einsum LoRA on the same tokens) and whisper-base (1500
             frames, a 32-token prompt, 32 decode steps). Before each,
             its kernels at its shapes against their plain versions
             (``kernel_time_family``). Gates: finite logits, constant
             state shapes, the kernels' outputs, and the launches of
             each model's path (counts zeroed just before it).
7. train   — with the families freed: the flash_attention backward
             kernel (``csrc/flash_attention_bwd.cu``, given the
             forward's log-sum-exp) against its plain version (autograd
             through ``flash_attention_plain`` on the same values in
             f32; in bf16 one ulp plus what the bf16 output moves D by)
             at internlm2-1.8b's (8, 512, 16/8, 128), Llama's (8, 256)
             and (1, 2048), whisper's encoder (8, 1500, 8, 64, full) and
             zamba2's block (8, 512, 32, 64), f32 (``tf32x3``) and bf16
             (``tensor_cores``), timed beside the plain version,
             autograd through SDPA and the bound of the route's
             arithmetic, with the CUDA-core f32 bound beside it
             (``kernel_time_train`` lines); the forward with and
             without the log-sum-exp at the f32 training shapes
             (``tf32x3``: internlm2's, qwen3-moe's (2, 1) shard,
             qwen2-vl's whole block, zamba2's and whisper's shards)
             and at (8, 256, 32, 128) bf16, the same bits twice and
             either way, timed beside SDPA and the bound of the route's
             arithmetic (f32 rows also the CUDA-core bound)
             (``kernel_time_train_fwd``); two
             train steps of one reduced config a family in f32, card
             against CPU (``parity_train``: loss, grad norm, moments
             and params within 1e-4, forward and backward flash
             launches equal, no plain version); a reduced checkpoint
             of params and bf16 moments restored bit-exact; then
             internlm2-1.8b at full width and depth (24 layers, V
             92544, f32 params as the launcher keeps them) through the
             launcher's loop (``launch.train.train``) for 5 steps of
             SyntheticLM (8, 512) (``train``: losses, s/step,
             tokens/s, peak memory; the published config rematerialises
             each layer, so the flash forward launches 48 times a step
             (the forward and the backward's recompute, all
             ``tf32x3``) and its backward 24, nothing else, no plain
             version), one
             step with ``microbatches=2``, one step under
             torch.profiler (device busy share), the remat A/B
             (``train_remat_ab``: two steps from the trained state
             with ``remat`` off, then the same two with it on, the
             published setting; loss, grad norm and params
             bit-identical; s/step and peak memory both ways), the
             7.6 GB params
             checkpoint saved, restored bit-exact and deleted, and
             ``examples/torch_train_with_recovery.py`` (two injected
             failures, final loss below the first).
8. train   — (mesh, ``phase_train_mesh``) with phase 7 freed: the
             flash forward and backward in f32 at the per-shard
             shapes of each model's split meshes below against their
             plain versions, timed (``kernel_time_train_mesh[_fwd]``);
             reduced llama4 (dense layers between MoE layers, a shared
             expert) at (2, 2) against the CPU (``parity_train_mesh``);
             then for internlm2-1.8b (full width, 12 of its 24 layers
             since PR 29, (8, 512)), qwen2-vl-7b
             (full width, 2 layers, (8, 512), M-RoPE positions),
             qwen3-moe (full width, 1 layer, (2, 2048)), falcon-mamba-7b
             (full width, 2 layers, (2, 1024)), zamba2-1.2b (full
             width, 12 layers: two shared-block sites, (8, 512)) and
             whisper-base (whole, (8, 256) tokens over 1500 frames of
             seeded noise), one at a time and each freed after: the
             unsharded step from seeded f32 params (kept on the host),
             then the state placed by the train rule table on (1, 1),
             (2, 1), (1, 2) and (2, 2) (qwen3-moe: the first three;
             qwen2-vl also (1, 8), whose 8 columns do not divide its 28
             heads: the attention whole on the first column) over
             repeated positions of the card and two steps each
             (``train_mesh``): loss and grad norm within 1e-4
             relative of the unsharded step's (whether (1, 1) is
             bit-identical is reported, with the leaves that are
             not), params within lr a step and moments within 1e-4
             relative after the second, MoE capacity drops equal,
             flash backward once an attention layer an attention
             position a step and the forward twice (every model runs
             its published remat: the backward recomputes each layer)
             (counts zeroed just before each mesh's steps), no plain
             version; s/step, peak memory, gathers, reduce-scatters and
             MoE all-to-alls a step.
9. serve   — (mesh, ``phase_serve_mesh``) the VLM, SSM, hybrid and
             enc-dec families served on meshes, each model's prefill
             and decode cases built by ``launch.cases.build_case``:
             qwen2-vl-7b (full width, 4 layers, (8, 512), 8 adapters,
             M-RoPE positions of text, a 16x16 patch grid, text),
             falcon-mamba-7b (full width, 4 layers, (4, 1024)),
             zamba2-1.2b (12 layers, (8, 512), 8 adapters) and
             whisper-base (whole, 8 rows, a 32-token prompt over 1500
             frames of seeded noise), one at a time and each freed
             after. First flash_attention, sgmv and bgmv at the column
             shapes of (2, 2) and (1, 4) against their plain versions,
             timed beside their bounds and a PyTorch call
             (``kernel_time_serve_mesh``; for qwen2-vl at (1, 8) and
             whisper at (1, 16), whose columns do not divide the heads,
             at the whole block's shapes). Then in f32 the unsharded
             cases and the same on (1, 1), (2, 1), (1, 2), (2, 2) and
             (1, 4) (qwen2-vl also (1, 8), whisper (1, 16): the
             attention whole on each row's first column) over
             repeated positions of the card, batch rows
             over "data" (``serve_mesh``): greedy tokens over 16
             decode steps equal, logits within 1e-4 relative, the
             prefill's state in the layout of ``kv_cache_spec``,
             ``ssm_state_spec`` and ``conv_state_spec``, each kernel
             launched the counted number of times (counts zeroed just
             before each mesh's run; sgmv's by instance on the line),
             no plain version; whether (1, 1)
             is bit-identical is reported. Then in bf16 ms a prefill
             call, ms a decode step and peak memory unsharded, at
             (1, 1), at (2, 2) and at the whole-head mesh.
10. dryrun — (``phase_dryrun``) the dry-run against measured steps:
             internlm2-1.8b at full width cut to ``DRYRUN_LAYERS``
             layers, its train, prefill and decode cases built by
             ``launch.cases.build_case`` at (1, 1) on the card in the
             cases' dtypes (bf16, bf16 moments), each counted by the
             dry-run's counter on ``meta`` (``launch.dryrun``) and
             timed on the card (CUDA events, median of
             ``DRYRUN_REPS`` calls): a ``dryrun_vs_step`` line with
             the counted FLOPs and bytes, the roofline bound at the
             H100 datasheet constants of ``roofline/analysis.py``
             (FLOPs over the bf16 peak, or the bytes the step cannot
             avoid, the weights it reads (and, training, the params
             and moments AdamW reads and writes), over the HBM rate),
             the measured seconds and their ratio, which must be at
             least 1. Then the train step at (1, 2) over repeated
             positions of the card with ``seq_shard_boundary`` off
             and on (``seq_shard_ab``): two steps each from the same
             state, loss, grad norm and every parameter and moment
             bit-identical (gated), s/step and peak GB each way.
11. uneven — (``phase_uneven``) configs on meshes whose "model" axis
             divides none of their blocks, each block whole on each
             batch row's first column (``sharding.whole_blocks``):
             internlm2-1.8b at full width cut to 4 layers and
             zamba2-1.2b cut to 6 (the shared block's one site and
             Mamba2), each at (1, 3) and (2, 3) over repeated
             positions of the card. In f32 a prefill of (4, 512) with
             8 adapters through ``launch.cases.build_case`` and 8
             greedy decode steps (``uneven_serve``): tokens equal to
             the unsharded case's, logits within 1e-4 relative, the
             state in the rule table's layout, flash_attention, sgmv
             and bgmv launched as often as the unsharded case a batch
             row (the whole column's; none on the others; sgmv's by
             instance on the line) and no plain version; ms a
             prefill, ms a decode step and peak memory beside the
             unsharded case's. Then one train step under the
             published remat on (4, 512) (``uneven_train``, as
             phase 8's ``train_mesh``): loss and grad norm within
             1e-4, params within lr, moments within 1e-4 of the
             unsharded step, flash forward and backward launched on
             each batch row's first column only; s/step and peak GB
             beside the unsharded step's.

A device-time profile of the same path is ``chip_profile.py``.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
before the last line.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"bf16": 989e12,      # dense tensor-core bf16
              "f32": 67e12,        # f32 outside the tensor cores
              # f32 as 3xTF32: three TF32 tensor-core products (495
              # TFLOP/s dense) an f32 product
              "tf32x3": 495e12 / 3}
# (atol, rtol): |got - want| <= atol + rtol * |want| elementwise.
TOL = {
    # Every rounding in f32: only the order of the f32 sums differs.
    "f32": (1e-4, 1e-4),
    # bgmv/sgmv with bf16 operands: the rank-r intermediate is rounded
    # to bf16 from two f32 sums taken in another order, so it can land
    # one bf16 ulp apart and carry that through the expand.
    "lora_bf16": (2e-2, 2e-2),
    # A bf16 output computed in f32: the two f32 results round to the
    # same bf16 value or to neighbours, one ulp <= 2**-7 of |want| apart.
    "bf16_out": (1e-4, 2 ** -7),
}
# flash_attention in bf16 adds to "bf16_out", per element,
# 2**-8 * sum_s p_s |v_s|: its plain version rounds each probability to
# bf16 (at most 2**-8 relative, bf16's unit roundoff) before the
# product with V, the kernel keeps them in f32.
FLASH_P_ROUNDING = 2 ** -8
MIB = 1 << 20


class PhaseError(RuntimeError):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


# ----------------------------------------------------------- timing
def median_ms(fn, flush, warmup: int = 3, iters: int = 15) -> float:
    """Median device time of one call, from CUDA events around it. The
    L2 is flushed before every call (the engine finds these operands
    cold), then the card spins for about a millisecond, so the host
    has enqueued the whole call before the first event is reached and
    the time excludes the wrapper's host work."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound_ms(n_bytes: float, flops: float, op_type: str) -> tuple:
    t_mem = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[op_type]
    return (max(t_mem, t_ops) * 1e3,
            "bytes" if t_mem >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def op_type(*ts) -> str:
    import torch
    return "bf16" if all(t.dtype == torch.bfloat16 for t in ts) else "f32"


# ------------------------------------------------------------ phase 1
def phase_device() -> dict:
    import torch
    from repro_torch.kernels import build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    took = build.build_all()
    build_s = time.perf_counter() - t0
    info = dict(phase="device", nvidia_smi=smi_line,
                name=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count(),
                capability=list(torch.cuda.get_device_capability(0)),
                torch=torch.__version__, cuda=torch.version.cuda,
                build_s=build_s, built={k: round(v, 2)
                                        for k, v in took.items()})
    emit(info)
    for name, usage in kernel_resources().items():
        emit(dict(phase="ptxas", source=name, kernels=usage))
    return info


def kernel_resources() -> dict:
    """{source: [per kernel: registers, static and dynamic shared
    memory, stack and spill bytes]} from the build's ``-Xptxas=-v``
    log; the dynamic bytes of the tensor-core instances come from the
    libraries' own size functions."""
    import importlib
    from repro_torch.kernels import build
    sg = build.library("sgmv", importlib.import_module(
        "repro_torch.kernels.sgmv")._ARGTYPES)
    fa = build.library("flash_attention", importlib.import_module(
        "repro_torch.kernels.flash_attention")._ARGTYPES)
    dynamic = {}
    for rp in (32, 64, 128):
        dynamic[f"shrink_tc<{rp}>"] = sg.sgmv_tc_smem_bytes(rp, 0)
        dynamic[f"expand_tc<{rp}>"] = sg.sgmv_tc_smem_bytes(rp, 1)
    for dh in (32, 64, 128, 256):
        dynamic[f"flash_tc<{dh}>"] = fa.flash_attention_tc_smem_bytes(dh)
        dynamic[f"flash_tf32x3<{dh}>"] = \
            fa.flash_attention_tf32x3_smem_bytes(dh)
    fb = build.library("flash_attention_bwd", importlib.import_module(
        "repro_torch.kernels.flash_attention")._BWD_ARGTYPES)
    for ops, code in (("Bf16Ops", 1), ("Tf32x3Ops", 0)):
        for dh in (32, 64, 128, 256):
            for kern, which in (("flash_bwd_dq", 0), ("flash_bwd_dkdv", 1)):
                dynamic[f"{kern}<{ops}, {dh}>"] = \
                    fb.flash_attention_bwd_smem_bytes(dh, code, which)
    out = {}
    for name in build.SOURCES:
        usage = build.ptxas_usage(name)
        for u in usage:
            kname = u["kernel"].removeprefix("void ")
            if kname in dynamic:
                u["smem_dynamic"] = dynamic[kname]
        out[name] = usage
    return out


# ------------------------------------------------------------ phase 2
def phase_kernels() -> dict:
    """Each kernel at the main path's full-width shapes (Llama-7B under
    the default EngineConfig) against its plain version. Returns the
    rows of the ``kernels`` line and, per kernel, a call that launches
    it on the timed operands."""
    import importlib

    import torch
    import torch.nn.functional as F
    bgmv = importlib.import_module("repro_torch.kernels.bgmv")
    sgmv = importlib.import_module("repro_torch.kernels.sgmv")
    pa = importlib.import_module("repro_torch.kernels.paged_attention")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    scratch = torch.empty(64 * MIB, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(dtype)

    # Llama-7B, default EngineConfig: 8 batch slots, 8 LoRA slots of
    # r_max 32, d_model = q_dim = kv_dim = 4096, 16-token pages over
    # 256 positions (16 pages a row), 161 physical pages.
    d, r, n_slots, Bt = 4096, 32, 8, 8
    A = randn(n_slots, d, r, dtype=torch.bfloat16, scale=d ** -0.5)
    Bw = randn(n_slots, r, d, dtype=torch.bfloat16, scale=r ** -0.5)
    rows = {}

    def record(name, case, got, want, tol, extra=None, **info):
        """``extra``: a per-element allowance added to the tolerance;
        ``info``: further readings for the case's line."""
        atol, rtol = TOL[tol]
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        bound = atol + rtol * want.float().abs()
        if extra is not None:
            bound = bound + extra
        ok = bool((diff <= bound).all())
        emit(dict(phase="kernel", kernel=name, case=case,
                  max_abs_err=err, atol=atol, rtol=rtol,
                  extra=extra is not None, ok=ok, **info))
        check(ok, f"{name} [{case}] disagrees with its plain version: "
                  f"max abs err {err}, atol {atol}, rtol {rtol}")
        row = rows.setdefault(name, dict(max_abs_err=0.0,
                                         checked_by_instance={}))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        # bgmv and paged_attention have one instance, the CUDA-core one.
        inst = info.get("instance", "cuda_cores")
        row["checked_by_instance"][inst] = (
            row["checked_by_instance"].get(inst, 0) + 1)

    # bgmv: decode LoRA, one token per batch slot, q/k/v/o widths.
    idx = torch.randperm(n_slots, generator=g, device=dev)[:Bt].int()
    for xdt, tname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x = randn(Bt, d, dtype=xdt)
        got = bgmv.bgmv(x, A, Bw, idx)
        torch.cuda.synchronize()
        record("bgmv", f"x {tname}, A/B bf16, x {tuple(x.shape)}", got,
               bgmv.bgmv_plain(x, A, Bw, idx), "lora_bf16")
    x = x_bgmv = randn(Bt, d, dtype=torch.bfloat16)  # the engine's dtype
    ms = median_ms(lambda: bgmv.bgmv(x, A, Bw, idx), flush)
    plain = median_ms(lambda: bgmv.bgmv_plain(x, A, Bw, idx), flush)
    lib = median_ms(lambda: torch.bmm(torch.bmm(x[:, None], A[idx.long()]),
                                      Bw[idx.long()]), flush)
    used = idx.unique().numel()
    b, by = bound_ms(nbytes(x, idx) + used * nbytes(A[0], Bw[0])
                     + Bt * d * x.element_size(),
                     2 * Bt * r * (d + d), op_type(x, A))
    rows["bgmv"].update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                        library_ms=lib, instance="cuda_cores",
                        shape=f"x {tuple(x.shape)} bf16, r {r}",
                        splits=bgmv.SPLITS)
    # Cluster sizes: blocks per token row (16 is non-portable).
    emit(dict(phase="kernel_sweep", kernel="bgmv", shape=rows["bgmv"][
        "shape"], bound_ms=b, ms_by_splits={
            n: median_ms(lambda n=n: bgmv.bgmv(x, A, Bw, idx, splits=n),
                         flush) for n in (4, 8, 16)}))

    # sgmv: prefill LoRA, the full (8, 256) prefill bucket, tile 128.
    S, tile = 256, 128
    T = Bt * S
    ts = torch.randint(0, n_slots, (T // tile,), generator=g,
                       device=dev).int()
    for xdt, tname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x = randn(T, d, dtype=xdt)
        sgmv.STATS.reset()
        got = sgmv.sgmv(x, A, Bw, ts, tile)
        torch.cuda.synchronize()
        record("sgmv", f"x {tname}, A/B bf16, x {tuple(x.shape)}", got,
               sgmv.sgmv_plain(x, A, Bw, ts, tile), "lora_bf16",
               instance=launched(sgmv, sgmv.sgmv_instance(
                   xdt, A.dtype, r, tile)))
        if xdt == torch.float32:
            sgmv_cuda_cores_time(flush, sgmv, x, A, Bw, ts, tile, r)
    x = x_sgmv = randn(T, d, dtype=torch.bfloat16)
    ms = median_ms(lambda: sgmv.sgmv(x, A, Bw, ts, tile), flush)
    plain = median_ms(lambda: sgmv.sgmv_plain(x, A, Bw, ts, tile), flush)
    xt = x.view(T // tile, tile, d)
    lib = median_ms(lambda: torch.bmm(torch.bmm(xt, A[ts.long()]),
                                      Bw[ts.long()]), flush)
    used = ts.unique().numel()
    b, by = bound_ms(nbytes(x, ts) + used * nbytes(A[0], Bw[0])
                     + T * d * x.element_size(),
                     2 * T * r * (d + d), op_type(x, A))
    rows["sgmv"].update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                        library_ms=lib,
                        instance=sgmv.sgmv_instance(x.dtype, A.dtype, r,
                                                    tile),
                        shape=f"x {tuple(x.shape)} bf16, tile {tile}")
    sgmv_verify_shape(record, randn, flush, sgmv, A, n_slots, d, r)

    # paged_attention: decode over f32 KV pages (the engine's), Kh 32,
    # G 1, dh 128; random lengths for the check, full rows for timing.
    Kh, G, dh, page, P, n_pages = 32, 1, 128, 16, 16, 161
    kp = randn(n_pages, page, Kh, dh)
    vp = randn(n_pages, page, Kh, dh)
    table = (1 + torch.randperm(n_pages - 1, generator=g, device=dev)
             )[:Bt * P].view(Bt, P).int()
    lens = torch.randint(1, P * page + 1, (Bt,), generator=g,
                         device=dev).int()
    for qdt, tname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        q = randn(Bt, Kh, G, dh, dtype=qdt)
        for kv_name, k_, v_ in (("f32", kp, vp),
                                ("bf16", kp.bfloat16(), vp.bfloat16())):
            got = pa.paged_attention(q, k_, v_, table, lens)
            torch.cuda.synchronize()
            # Both sides read the same page values and compute in f32;
            # only the output's rounding to q's dtype differs by case.
            record("paged_attention", f"q {tname}, pages {kv_name}", got,
                   pa.paged_attention_plain(q, k_, v_, table, lens),
                   "f32" if tname == "f32" else "bf16_out")
    q = randn(Bt, Kh, G, dh, dtype=torch.bfloat16)
    full = torch.full((Bt,), P * page, dtype=torch.int32, device=dev)
    ms = median_ms(lambda: pa.paged_attention(q, kp, vp, table, full),
                   flush)
    plain = median_ms(
        lambda: pa.paged_attention_plain(q, kp, vp, table, full), flush)

    def sdpa(lengths=None):
        """SDPA over the gathered pages; ``lengths`` masks each row's
        positions past its length."""
        k = kp[table.long()].permute(0, 3, 1, 2, 4).reshape(
            Bt, Kh, P * page, dh)
        v = vp[table.long()].permute(0, 3, 1, 2, 4).reshape(
            Bt, Kh, P * page, dh)
        mask = None
        if lengths is not None:
            mask = (torch.arange(P * page, device=dev)[None, :]
                    < lengths[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(q.float(), k, v,
                                              attn_mask=mask)
    lib = median_ms(sdpa, flush)
    n_tok = int(full.sum().item())
    b, by = bound_ms(nbytes(q, table, full) + 2 * n_tok * Kh * dh * 4
                     + nbytes(q), 4 * n_tok * Kh * G * dh, "f32")
    rows["paged_attention"].update(
        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by, library_ms=lib,
        instance="cuda_cores",
        shape=f"q {tuple(q.shape)} bf16, f32 pages, {Bt} rows x "
              f"{P * page} tokens", splits=pa.SPLITS)
    # Yardstick of the card's memory rate on the same pages: a PyTorch
    # sum reads all of K and V once.
    emit(dict(phase="kernel_sweep", kernel="paged_attention",
              shape=rows["paged_attention"]["shape"], bound_ms=b,
              ms_by_splits={n: median_ms(lambda n=n: pa.paged_attention(
                  q, kp, vp, table, full, splits=n), flush)
                  for n in (1, 2, 4, 8)},
              torch_sum_pages_ms=median_ms(lambda: kp.sum() + vp.sum(),
                                           flush),
              pages_bytes=nbytes(kp, vp)))
    # The phase-4 trace's decode rows: 32-232 tokens each.
    ragged = torch.randint(32, 233, (Bt,), generator=g, device=dev).int()
    got = pa.paged_attention(q, kp, vp, table, ragged)
    torch.cuda.synchronize()
    record("paged_attention", "q bf16, pages f32, ragged 32-232", got,
           pa.paged_attention_plain(q, kp, vp, table, ragged), "bf16_out")
    n_rag = int(ragged.sum().item())
    lib_rag_err = (sdpa(ragged) - pa.paged_attention_plain(
        q.float(), kp, vp, table, ragged)).abs().max().item()
    b_rag, by_rag = bound_ms(nbytes(q, table, ragged)
                             + 2 * n_rag * Kh * dh * 4 + nbytes(q),
                             4 * n_rag * Kh * G * dh, "f32")
    emit(dict(phase="kernel_time_ragged", kernel="paged_attention",
              shape=f"q {tuple(q.shape)} bf16, f32 pages, lengths "
                    f"{ragged.tolist()}",
              ms=median_ms(lambda: pa.paged_attention(q, kp, vp, table,
                                                      ragged), flush),
              plain_ms=median_ms(lambda: pa.paged_attention_plain(
                  q, kp, vp, table, ragged), flush),
              bound_ms=b_rag, bound_by=by_rag,
              library_ms=median_ms(lambda: sdpa(ragged), flush),
              library="SDPA over gathered pages, length mask",
              library_max_abs_err_vs_plain=lib_rag_err,
              ms_by_splits={n: median_ms(lambda n=n: pa.paged_attention(
                  q, kp, vp, table, ragged, splits=n), flush)
                  for n in (1, 2, 4, 8)}))
    flash_calls = phase_flash(record, rows, randn, flush)
    for name, row in rows.items():
        emit(dict(phase="kernel_time", kernel=name, **row))
    calls = {"bgmv": lambda: bgmv.bgmv(x_bgmv, A, Bw, idx),
             "sgmv": lambda: sgmv.sgmv(x_sgmv, A, Bw, ts, tile),
             "paged_attention": lambda: pa.paged_attention(
                 q, kp, vp, table, full),
             **flash_calls}
    return rows, calls


def sgmv_cuda_cores_time(flush, sgmv, x, A, Bw, ts, tile, r) -> None:
    """sgmv's ``cuda_cores`` instance (any f32 operand; here x f32, A/B
    bf16) timed at the bf16 row's shape, just checked by the caller:
    one ``kernel_time_instance`` line with its bound (bytes at the HBM
    rate, operations at the f32 CUDA-core peak), its plain version and
    two gathered ``bmm``s in f32 (A and B cast outside the timed
    call)."""
    import torch
    T, d = x.shape
    inst = sgmv.sgmv_instance(x.dtype, A.dtype, r, tile)
    check(inst == "cuda_cores", f"sgmv x f32 selects {inst}")
    xt = x.view(T // tile, tile, d)
    A32, B32 = A.float(), Bw.float()
    used = ts.unique().numel()
    b, by = bound_ms(nbytes(x, ts) + used * nbytes(A[0], Bw[0])
                     + T * Bw.shape[-1] * x.element_size(),
                     2 * T * r * (d + Bw.shape[-1]), op_type(x, A))
    sgmv.STATS.reset()
    ms = median_ms(lambda: sgmv.sgmv(x, A, Bw, ts, tile), flush)
    timed = dict(sgmv.STATS.instances)
    check(set(timed) == {inst}, f"sgmv timed launches {timed}")
    emit(dict(phase="kernel_time_instance", kernel="sgmv", instance=inst,
              shape=f"x {tuple(x.shape)} f32, A/B bf16, r {r}, tile "
                    f"{tile}, {A.shape[0]} slots",
              ms=ms,
              plain_ms=median_ms(lambda: sgmv.sgmv_plain(x, A, Bw, ts,
                                                         tile), flush),
              bound_ms=b, bound_by=by,
              library_ms=median_ms(lambda: torch.bmm(
                  torch.bmm(xt, A32[ts.long()]), B32[ts.long()]), flush),
              library="gathered bmm x2 in f32"))


def sgmv_verify_shape(record, randn, flush, sgmv, A, n_slots, d, r):
    """sgmv at the speculative verify pass's shape: 8 rows of S 8 (a
    verify of kk + 1 <= 5 tokens pads each row to one tile of 8), tile
    8, r 32, 8 slots; dout 4096 (q, o) and 1024 (an 8-kv-head k, v, as
    at dout 1024 the widths of a GQA model). Checked against the plain
    version at the bf16 LoRA tolerance, then timed beside its bound and
    two gathered ``bmm``s; one ``kernel_time_verify`` line each."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(77)
    T, tile = 64, 8
    ts = torch.randint(0, n_slots, (T // tile,), generator=g,
                       device="cuda").int()
    x = randn(T, d, dtype=torch.bfloat16)
    for dout in (4096, 1024):
        Bw = randn(n_slots, r, dout, dtype=torch.bfloat16, scale=r ** -0.5)
        sgmv.STATS.reset()
        got = sgmv.sgmv(x, A, Bw, ts, tile)
        torch.cuda.synchronize()
        check(sgmv.STATS.tiles == {tile: 1},
              f"sgmv verify shape launched tiles {sgmv.STATS.tiles}")
        inst = launched(sgmv, sgmv.sgmv_instance(x.dtype, A.dtype, r, tile))
        record("sgmv", f"verify shape, x {tuple(x.shape)} bf16, tile "
                       f"{tile}, dout {dout}", got,
               sgmv.sgmv_plain(x, A, Bw, ts, tile), "lora_bf16",
               instance=inst)
        xt = x.view(T // tile, tile, d)
        used = ts.unique().numel()
        b, by = bound_ms(nbytes(x, ts) + used * nbytes(A[0], Bw[0])
                         + T * dout * x.element_size(),
                         2 * T * r * (d + dout), op_type(x, A))
        emit(dict(
            phase="kernel_time_verify", kernel="sgmv", instance=inst,
            shape=f"x {tuple(x.shape)} bf16, tile {tile}, r {r}, "
                  f"{n_slots} slots, dout {dout}",
            ms=median_ms(lambda: sgmv.sgmv(x, A, Bw, ts, tile), flush),
            plain_ms=median_ms(lambda: sgmv.sgmv_plain(x, A, Bw, ts, tile),
                               flush),
            bound_ms=b, bound_by=by,
            library_ms=median_ms(lambda: torch.bmm(
                torch.bmm(xt, A[ts.long()]), Bw[ts.long()]), flush),
            library="gathered bmm x2"))


def launched(mod, want: str) -> str:
    """The instance the kernel of ``mod`` launched since its counts were
    reset: exactly one launch, of instance ``want``."""
    check(mod.STATS.instances == {want: 1},
          f"{mod.__name__}: launched {mod.STATS.instances}, expected one "
          f"launch of {want}")
    return want


def flash_bound(q, k, v, causal: bool, op: str | None = None) -> tuple:
    """Bytes of q, k, v and the output once; 4 * dh operations per
    (query head, query, key) pair the mask keeps, at the peak of the
    operands' type or of ``op``."""
    B, S, H, dh = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    return bound_ms(nbytes(q, k, v) + nbytes(q), 4 * B * H * dh * pairs,
                    op or op_type(q, k, v))


def flash_case(record, randn, fa, B, S, H, Kh, dh, dt, causal) -> None:
    """One flash_attention case on fresh operands against its plain
    version: the instance that launched must be the one dtype and dh
    select, and a bf16 output must also be within one ulp of the all-f32
    plain version rounded once."""
    import torch
    tname = "f32" if dt == torch.float32 else "bf16"
    q = randn(B, S, H, dh, dtype=dt)
    k = randn(B, S, Kh, dh, dtype=dt)
    v = randn(B, S, Kh, dh, dtype=dt)
    fa.STATS.reset()
    got = fa.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, causal)
    extra = None
    info = dict(instance=launched(fa, fa.flash_instance(dt, dh)))
    if dt == torch.bfloat16:
        extra = FLASH_P_ROUNDING * fa.flash_attention_plain(
            q.float(), k.float(), v.float().abs(), causal)
        # Why the extra term: without it the plain version fails one
        # ulp; the all-f32 plain version, rounded once, holds the kernel
        # to it.
        atol, rtol = TOL["bf16_out"]
        diff = (got.float() - want.float()).abs()
        w32 = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                       causal).to(dt)
        d32 = (got.float() - w32.float()).abs()
        info.update(
            one_ulp_ok=bool((diff <= atol + rtol * want.float().abs())
                            .all()),
            max_abs_err_vs_f32_plain=d32.max().item(),
            one_ulp_ok_vs_f32_plain=bool(
                (d32 <= atol + rtol * w32.float().abs()).all()))
    record("flash_attention",
           f"{'causal' if causal else 'full'}, H {H}/Kh {Kh}, {tname}, "
           f"B {B}, S {S}" + ("" if dh == 128 else f", dh {dh}"), got,
           want, "f32" if tname == "f32" else "bf16_out", extra, **info)
    check(info.get("one_ulp_ok_vs_f32_plain", True),
          f"flash_attention [{H}/{Kh}, S {S}, dh {dh}] is more than one "
          f"bf16 ulp from the all-f32 plain version")


#: flash_attention's bf16 ``cuda_cores`` instance runs at a head width
#: that is not a multiple of 16; no config here has one. 88 is the head
#: width of BLIP-2's ViT-g vision encoder (hf: Salesforce/blip2-opt-2.7b,
#: vision hidden 1408, 16 heads), named as a kernel shape only. (phi-2's
#: 80 is 5 * 16: it runs the ``tensor_cores`` instance.)
FLASH_CUDA_CORES_DH = 88


def flash_cuda_cores(record, randn, flush, fa) -> None:
    """The bf16 ``cuda_cores`` instance at dh 88: checked against its
    plain version at ragged S (5, 100, 1000), MHA 32/32 and GQA 32/8,
    causal and full, and at (8, 256, 32, 88) causal; then timed there
    beside its plain version and SDPA, with the bound at the bf16 peak
    (the operands' type) and at the f32 CUDA-core peak beside it (one
    ``kernel_time_instance`` line)."""
    import torch
    import torch.nn.functional as F
    dh, dt = FLASH_CUDA_CORES_DH, torch.bfloat16
    for causal in (True, False):
        for H, Kh in ((32, 32), (32, 8)):
            for S in (5, 100, 1000):
                flash_case(record, randn, fa, 2, S, H, Kh, dh, dt, causal)
    B, S, H = 8, 256, 32
    flash_case(record, randn, fa, B, S, H, H, dh, dt, True)
    q, k, v = (randn(B, S, H, dh, dtype=dt) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    inst = fa.flash_instance(dt, dh)
    fa.STATS.reset()
    ms = median_ms(lambda: fa.flash_attention(q, k, v), flush)
    check(set(fa.STATS.instances) == {inst} == {"cuda_cores"},
          f"flash dh {dh} timed launches {fa.STATS.instances}")
    b, by = flash_bound(q, k, v, True)
    emit(dict(phase="kernel_time_instance", kernel="flash_attention",
              instance=inst, shape=f"q/k/v {tuple(q.shape)} bf16, causal",
              ms=ms,
              plain_ms=median_ms(lambda: fa.flash_attention_plain(q, k, v),
                                 flush),
              bound_ms=b, bound_by=by,
              bound_ms_cuda_cores=flash_bound(q, k, v, True, "f32")[0],
              library_ms=median_ms(lambda: F.scaled_dot_product_attention(
                  qt, kt, vt, is_causal=True), flush),
              library="SDPA, causal"))


def phase_flash(record, rows, randn, flush) -> dict:
    """flash_attention against its plain version: causal and not, MHA
    32/32/128 (Llama-7B), GQA 40/8/128 (qwen2.5-32b) and MQA 8/1/128,
    f32 (``tf32x3``) and bf16 (``tensor_cores``), ragged S (5, 100,
    1000) and block multiples (256, 2048); then timed at the main
    path's largest prefill bucket
    (8, 256, 32, 128) and at (1, 2048, 32, 128), bf16 causal. Returns
    the calls that launch it on the timed operands."""
    import importlib

    import torch
    import torch.nn.functional as F
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    dh = 128
    for causal in (True, False):
        for H, Kh in ((32, 32), (40, 8), (8, 1)):
            for dt in (torch.float32, torch.bfloat16):
                for S in (5, 100, 1000, 256, 2048):
                    flash_case(record, randn, fa, 2 if S <= 1000 else 1, S,
                               H, Kh, dh, dt, causal)
    flash_cuda_cores(record, randn, flush, fa)
    calls = {}
    for B, S in ((8, 256), (1, 2048)):
        q, k, v = (randn(B, S, 32, dh, dtype=torch.bfloat16)
                   for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = median_ms(lambda: fa.flash_attention(q, k, v), flush)
        plain = median_ms(lambda: fa.flash_attention_plain(q, k, v), flush)
        lib = median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush)
        b, by = flash_bound(q, k, v, True)
        row = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                   library_ms=lib, instance=fa.flash_instance(q.dtype, dh),
                   shape=f"q/k/v {tuple(q.shape)} bf16, causal")
        if B == 8:          # the main path's bucket: the kernels line
            rows["flash_attention"].update(row)
            calls["flash_attention"] = lambda q=q, k=k, v=v: \
                fa.flash_attention(q, k, v)
        else:
            emit(dict(phase="kernel_time", kernel="flash_attention",
                      max_abs_err=rows["flash_attention"]["max_abs_err"],
                      **row))
    return calls


# ------------------------------------------------------------ phase 3
def phase_parity() -> None:
    """Reduced Llama, f32: the card's kernels against the CPU's plain
    versions on the same weights. Paged: suffix prefill then one decode
    step. Dense: whole-prompt prefill (flash_attention), its K/V copied
    into an f32 slab as the engine does, then one decode step. The f32
    LoRA runs sgmv's ``cuda_cores`` instance (its launches are on the
    line)."""
    import importlib

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.lora_apply import (init_lora_slots,
                                               random_lora_weights,
                                               write_adapter_to_slot)
    tol = 2e-4     # f32 sums in another order, 4 layers deep
    cfg = get_config("chameleon-llama-7b").reduced()
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    slots = init_lora_slots(3, cfg.n_layers, cfg.d_model, cfg.q_dim,
                            cfg.kv_dim, 32, dtype=torch.float32,
                            device="cpu")
    gen = torch.Generator().manual_seed(5)
    for i, rank in enumerate((8, 16, 32)):
        write_adapter_to_slot(slots, random_lora_weights(
            gen, rank, 32, cfg.n_layers, cfg.d_model, cfg.q_dim,
            cfg.kv_dim, dtype=torch.float32), i)
    rng = torch.Generator().manual_seed(6)
    B, S, P, page = 3, 32, 4, 16
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=rng).int()
    table = (1 + torch.arange(B * P)).view(B, P).int()
    start = torch.tensor([0, 0, 0], dtype=torch.int32)
    seq_len = torch.tensor([32, 17, 5], dtype=torch.int32)
    tok1 = torch.randint(0, cfg.vocab_size, (B, 1), generator=rng).int()
    idx = torch.tensor([2, 0, 1], dtype=torch.int32)
    sgmv_stats = importlib.import_module("repro_torch.kernels.sgmv").STATS
    sgmv_stats.reset()          # the CPU pass counts plain calls only
    out = {}
    for dev in ("cpu", "cuda"):
        mv = {k: v.to(dev) for k, v in params.items()}
        lr = {k: (a.to(dev), b.to(dev)) for k, (a, b) in slots.items()}
        kv = api.init_paged_serve_state(cfg, 1 + B * P, page,
                                        torch.float32, device=dev)
        kw = dict(lora=lr, adapter_idx=idx.to(dev), lora_backend="kernel")
        lp, kv = api.prefill_paged(cfg, mv, toks.to(dev), kv, table.to(dev),
                                   start.to(dev), seq_len.to(dev), **kw)
        ld, kv = api.decode_step_paged(cfg, mv, tok1.to(dev), kv,
                                       table.to(dev), seq_len.to(dev), **kw)
        dense_p, (k_new, v_new) = api.prefill(
            cfg, mv, toks.to(dev), last_pos=(seq_len - 1).to(dev), **kw)
        slab = api.init_serve_state(cfg, B, 48, torch.float32, device=dev)
        for b, L in enumerate(seq_len.tolist()):
            for c, n in zip(slab, (k_new, v_new)):
                c[:, b, :L] = n[:, b, :L]
        dense_d, slab = api.decode_step(cfg, mv, tok1.to(dev), slab,
                                        seq_len.to(dev), **kw)
        out[dev] = [t.cpu() for t in (lp, ld, kv[0][:, 1:], kv[1][:, 1:],
                                      dense_p, slab[0], slab[1], dense_d)]
    errs = [(a - b).abs().max().item()
            for a, b in zip(out["cpu"], out["cuda"])]
    ok = all(e <= tol for e in errs) and all(
        torch.isfinite(t).all() for t in out["cuda"])
    emit(dict(phase="parity", prefill_logits_err=errs[0],
              decode_logits_err=errs[1], k_pages_err=errs[2],
              v_pages_err=errs[3], dense_prefill_logits_err=errs[4],
              k_slab_err=errs[5], v_slab_err=errs[6],
              dense_decode_logits_err=errs[7], tol=tol, ok=ok,
              sgmv_launches_by_instance=dict(sgmv_stats.instances)))
    check(ok, f"card vs CPU step parity failed: {errs} (tol {tol})")
    check(set(sgmv_stats.instances) == {"cuda_cores"},
          f"f32 parity launched sgmv {sgmv_stats.instances}")


#: (input_len, output_len, adapter) of the reduced engine cases.
PARITY_SPEC = [(25, 8, 0), (6, 5, 1), (40, 6, 2), (10, 4, 0), (33, 7, 3)]


def phase_parity_engines() -> None:
    """Reduced Llama, f32, on the card and on the CPU port with the
    same weights, adapters and trace: a chunked-prefill engine (chunk
    8), and a request exported after 3 tokens from a horizon-1 engine
    and imported into a default one, paged and dense. Tokens must be
    equal; the payloads are compared at the phase's tolerance."""
    import importlib

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import Request
    from repro_torch.models import api
    from repro_torch.serving.engine import AdapterCatalog, EngineConfig
    from repro_torch.serving.systems import build_engine
    tol = 2e-4
    cfg = get_config("chameleon-llama-7b").reduced()
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    catalog = AdapterCatalog(cfg, 8, 32, seed=0, device="cpu")
    base = dict(max_slots=4, max_len=128, n_lora_slots=4, n_adapters=8,
                lora_backend="kernel")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 200, L).tolist() for L, _, _ in PARITY_SPEC]
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in KERNELS}

    def engine(dev, **kw):
        clock = [0.0]
        eng = build_engine("chameleon", cfg, params,
                           EngineConfig(**base, **kw), catalog=catalog,
                           clock=lambda: clock[0], device=dev)
        return eng, clock

    def step(eng, clock):
        for stream in eng._load_streams.values():
            # Land slot copies before the step polls them, as the CPU's
            # synchronous copies are: the schedules then agree.
            stream.synchronize()
        eng.step()
        clock[0] += 0.01

    def drain(eng, clock):
        for _ in range(5000):
            if not eng.busy():
                return
            step(eng, clock)
        raise PhaseError("parity_engine: an engine failed to drain")

    out = {}
    for dev in ("cpu", "cuda"):
        for st in stats.values():
            st.reset()
        eng, clock = engine(dev, prefill_chunk_tokens=8)
        hs = [eng.submit(Request(input_len=L, output_len=O, adapter_id=a,
                                 prompt=list(p)))
              for (L, O, a), p in zip(PARITY_SPEC, prompts)]
        drain(eng, clock)
        res = dict(chunked=[h.tokens for h in hs],
                   chunked_prefills=eng.stats().get("chunked_prefills", 0))
        for paged in (True, False):
            src, c_src = engine(dev, paged=paged, max_horizon=1,
                                pipeline_readback=False)
            dst, c_dst = engine(dev, paged=paged)
            req = Request(input_len=25, output_len=10, adapter_id=1,
                          prompt=list(prompts[0]))
            h = src.submit(req)
            while len(h.tokens) < 3 and src.busy():
                step(src, c_src)
            ship = src.begin_migration(req)
            check(ship is not None and dst.import_request_kv(ship),
                  f"parity_engine: migration on {dev} was refused")
            src.complete_migration(req)
            h._system = dst
            drain(dst, c_dst)
            res[f"migrated_{'paged' if paged else 'dense'}"] = dict(
                tokens=h.tokens, k=ship["k"], v=ship["v"],
                nbytes=ship["nbytes"])
        # The phase's launches: the dense source prefills with
        # flash_attention, the rest runs the paged path.
        res.update(launches={n: st.launches for n, st in stats.items()},
                   plain={n: st.plain for n, st in stats.items()})
        out[dev] = res
    cpu, card = out["cpu"], out["cuda"]
    payload_err = max((card[m][kv] - cpu[m][kv]).abs().max().item()
                      for m in ("migrated_paged", "migrated_dense")
                      for kv in ("k", "v"))
    line = dict(phase="parity_engine", chunk=8,
                chunked_tokens_equal=card["chunked"] == cpu["chunked"],
                chunked_prefills=card["chunked_prefills"],
                launches=card["launches"],
                migrated_tokens_equal={
                    m: card[m]["tokens"] == cpu[m]["tokens"]
                    for m in ("migrated_paged", "migrated_dense")},
                payload_bytes={m: card[m]["nbytes"]
                               for m in ("migrated_paged", "migrated_dense")},
                payload_max_abs_err=payload_err, tol=tol)
    line["ok"] = ok = (line["chunked_tokens_equal"]
                       and all(line["migrated_tokens_equal"].values())
                       and payload_err <= tol
                       and card["chunked_prefills"] > 0
                       and all(card["launches"][n] > 0 for n in KERNELS)
                       and not any(card["plain"].values()))
    emit(line)
    check(ok, f"card vs CPU engine parity failed: {line}")


def phase_parity_spec() -> None:
    """Speculative engines at reduced width, f32, on the card and on the
    CPU port with the same weights, adapters and trace: the 2-layer
    internlm2 draft (its vocabulary cut to the target's) with a greedy
    batch and a mixed one (every second request seeded), and the
    target drafting for itself over zero LoRA deltas; paged and
    ``paged=False``. Tokens and the drafted and accepted counts must be
    equal; on the card the verify pass's LoRA must run sgmv at tile 8
    and no plain version may run."""
    import importlib

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import Request, SamplingParams
    from repro_torch.models import api
    from repro_torch.serving.engine import (AdapterCatalog, ChameleonEngine,
                                            EngineConfig)
    cfg = get_config("chameleon-llama-7b").reduced()
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    dcfg = get_config("internlm2-1.8b").reduced(n_layers=2,
                                                vocab_size=cfg.vocab_size)
    drafts = {"other": (dcfg, api.init_params(dcfg, 7, torch.float32,
                                              device="cpu")),
              "self": (cfg, params)}
    catalogs = {"random": AdapterCatalog(cfg, 8, 32, seed=0, device="cpu"),
                "zero": AdapterCatalog(cfg, 8, 32, seed=0, device="cpu")}
    for w in catalogs["zero"].weights.values():
        for a, b in w.values():
            a.zero_()
            b.zero_()
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, 200, L).tolist() for L, _, _ in PARITY_SPEC]
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in KERNELS}
    cases = {f"{draft}_{batch}_{'paged' if paged else 'dense'}":
             (draft, batch, paged)
             for paged in (True, False)
             for draft, batch in (("other", "greedy"), ("other", "mixed"),
                                  ("self", "greedy"))}
    lines = []
    for name, (draft, batch, paged) in cases.items():
        out = {}
        for dev in ("cpu", "cuda"):
            for st in stats.values():
                st.reset()
            clock = [0.0]
            eng = ChameleonEngine(
                cfg, params, EngineConfig(
                    max_slots=4, max_len=128, n_lora_slots=4, n_adapters=8,
                    lora_backend="kernel", paged=paged, spec_decode=True),
                catalog=catalogs["zero" if draft == "self" else "random"],
                clock=lambda: clock[0], draft=drafts[draft], device=dev)
            hs = [eng.submit(
                Request(input_len=L, output_len=O + 8, adapter_id=a,
                        prompt=list(p)),
                sampling=(SamplingParams(temperature=0.8, top_k=20,
                                         seed=100 + i)
                          if batch == "mixed" and i % 2 else None))
                for i, ((L, O, a), p) in enumerate(zip(PARITY_SPEC,
                                                       prompts))]
            for _ in range(5000):
                if not eng.busy():
                    break
                for stream in eng._load_streams.values():
                    stream.synchronize()
                eng.step()
                clock[0] += 0.01
            check(not eng.busy(), f"parity_spec {name}: failed to drain")
            st = eng.spec_stats()
            out[dev] = dict(
                tokens=[h.tokens for h in hs],
                drafted=st["spec_drafted_tokens"],
                accepted=st["spec_accepted_tokens"],
                sgmv_tiles=dict(stats["sgmv"].tiles),
                launches={n: s.launches for n, s in stats.items()},
                plain={n: s.plain for n, s in stats.items()})
            del eng, hs
        cpu, card = out["cpu"], out["cuda"]
        line = dict(phase="parity_spec", case=name,
                    tokens_equal=card["tokens"] == cpu["tokens"],
                    drafted=[card["drafted"], cpu["drafted"]],
                    accepted=[card["accepted"], cpu["accepted"]],
                    sgmv_tiles=card["sgmv_tiles"],
                    launches=card["launches"])
        line["ok"] = (line["tokens_equal"]
                      and card["drafted"] == cpu["drafted"] > 0
                      and card["accepted"] == cpu["accepted"]
                      and (draft != "self"
                           or card["accepted"] == card["drafted"])
                      and card["sgmv_tiles"].get(8, 0) > 0
                      and not any(card["plain"].values()))
        emit(line)
        lines.append(line)
    bad = [ln["case"] for ln in lines if not ln["ok"]]
    check(not bad, f"card vs CPU speculative parity failed: {bad}")


#: Reduced MoE configs of phase 3: qwen3-moe (E 8, top-2, MoE every
#: layer, qk-norm) and llama4 (top-1, MoE every second layer, shared
#: expert).
MOE_PARITY = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")
#: The kernels of an MoE engine's path (it serves from the dense slab).
MOE_PATH = ("bgmv", "sgmv", "flash_attention")


def phase_parity_moe() -> None:
    """Reduced MoE engines in f32, on the card and on the CPU port with
    the same weights, adapters and trace (``PARITY_SPEC``, 6 more output
    tokens a request): ``EngineConfig()`` (MoE serves from the dense
    slab) with the fused and the seed loop. Tokens and prefill drops
    over capacity must be equal; on the card bgmv, sgmv and
    flash_attention launch, paged_attention never, and no plain or
    einsum path runs."""
    import importlib

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import Request
    from repro_torch.models import api, moe
    from repro_torch.models.lora_apply import EINSUM
    from repro_torch.serving.engine import AdapterCatalog, EngineConfig
    from repro_torch.serving.systems import build_engine
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in KERNELS}
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, 200, L).tolist() for L, _, _ in PARITY_SPEC]
    bad = []
    for name in MOE_PARITY:
        cfg = get_config(name).reduced()
        params = api.init_params(cfg, 0, torch.float32, device="cpu")
        catalog = AdapterCatalog(cfg, 8, 32, seed=0, device="cpu")
        out = {}
        for dev, fused in (("cpu", True), ("cpu", False), ("cuda", True),
                           ("cuda", False)):
            for st in stats.values():
                st.reset()
            EINSUM.reset()
            moe.STATS.reset()
            clock = [0.0]
            eng = build_engine("chameleon", cfg, params, EngineConfig(
                max_slots=4, max_len=128, n_lora_slots=4, n_adapters=8,
                lora_backend="kernel", fused_hotloop=fused),
                catalog=catalog, clock=lambda: clock[0], device=dev)
            check(not eng.paged, f"parity_moe {name}: engine is paged")
            hs = [eng.submit(Request(input_len=L, output_len=O + 6,
                                     adapter_id=a, prompt=list(p)))
                  for (L, O, a), p in zip(PARITY_SPEC, prompts)]
            for _ in range(5000):
                if not eng.busy():
                    break
                for stream in eng._load_streams.values():
                    stream.synchronize()
                eng.step()
                clock[0] += 0.01
            check(not eng.busy(), f"parity_moe {name}: failed to drain")
            out[(dev, fused)] = dict(
                tokens=[h.tokens for h in hs], dropped=moe.STATS.dropped,
                assignments=moe.STATS.assignments,
                launches={n: s.launches for n, s in stats.items()},
                plain={n: s.plain for n, s in stats.items()},
                einsum=EINSUM.calls)
            del eng, hs
        for fused in (True, False):
            cpu, card = out[("cpu", fused)], out[("cuda", fused)]
            line = dict(phase="parity_moe", model=name, fused=fused,
                        n_layers=cfg.n_layers, n_experts=cfg.n_experts,
                        top_k=cfg.top_k, moe_every=cfg.moe_every,
                        weights="f32",
                        tokens_equal=card["tokens"] == cpu["tokens"],
                        dropped=[card["dropped"], cpu["dropped"]],
                        assignments=card["assignments"],
                        launches=card["launches"])
            line["ok"] = (line["tokens_equal"]
                          and card["dropped"] == cpu["dropped"]
                          and all(card["launches"][n] > 0 for n in MOE_PATH)
                          and card["launches"]["paged_attention"] == 0
                          and not any(card["plain"].values())
                          and card["einsum"] == 0)
            emit(line)
            if not line["ok"]:
                bad.append((name, fused))
    check(not bad, f"card vs CPU MoE engine parity failed: {bad}")


def mrope_positions(B: int, S: int, start: int = 0, image: bool = False):
    """(3, B, S) int32 M-RoPE positions from ``start`` with distinct
    axes: t counts, h and w walk a 4x4 grid (a patch raster). ``image``:
    a text-image-text prompt instead: text positions on all three axes,
    then a square patch grid from S/4 to 3S/4 (t fixed, h and w its
    rows and columns), then text again after the grid's largest
    position."""
    import torch
    t = start + torch.arange(S)
    if not image:
        pos = torch.stack([t, t // 4, t % 4])
    else:
        pos = torch.stack([t, t, t])
        lo, hi = S // 4, 3 * S // 4
        side = int((hi - lo) ** 0.5)
        grid = torch.arange(hi - lo)
        pos[0, lo:hi] = start + lo
        pos[1, lo:hi] = start + lo + torch.clamp(grid // side, max=side - 1)
        pos[2, lo:hi] = start + lo + grid % side
        pos[:, hi:] = start + lo + side + torch.arange(S - hi)
    return pos[:, None].expand(3, B, S).int()


def phase_parity_vlm() -> None:
    """Reduced ``qwen2-vl-7b`` (M-RoPE, sections rescaled 2:3:3) in f32,
    LoRA on q/k/v/o through the kernels: whole-prompt ``prefill`` with
    distinct t/h/w positions, its K/V into a slab, one ``decode_step``;
    logits and slab on the card within 2e-4 of the CPU port's (f32 sums
    in another order, 4 layers deep, as ``phase_parity``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.lora_apply import (init_lora_slots,
                                               random_lora_weights,
                                               write_adapter_to_slot)
    tol = 2e-4
    cfg = get_config("qwen2-vl-7b").reduced()
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    slots = init_lora_slots(3, cfg.n_layers, cfg.d_model, cfg.q_dim,
                            cfg.kv_dim, 32, dtype=torch.float32,
                            device="cpu")
    gen = torch.Generator().manual_seed(5)
    for i, rank in enumerate((8, 16, 32)):
        write_adapter_to_slot(slots, random_lora_weights(
            gen, rank, 32, cfg.n_layers, cfg.d_model, cfg.q_dim,
            cfg.kv_dim, dtype=torch.float32), i)
    rng = torch.Generator().manual_seed(6)
    B, S, Smax = 3, 32, 48
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=rng).int()
    tok1 = torch.randint(0, cfg.vocab_size, (B, 1), generator=rng).int()
    idx = torch.tensor([2, 0, 1], dtype=torch.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        mv = {k: v.to(dev) for k, v in params.items()}
        lr = {k: (a.to(dev), b.to(dev)) for k, (a, b) in slots.items()}
        kw = dict(lora=lr, adapter_idx=idx.to(dev), lora_backend="kernel")
        lp, (k_new, v_new) = api.prefill(
            cfg, mv, toks.to(dev), mrope_pos=mrope_positions(B, S).to(dev),
            **kw)
        slab = api.init_serve_state(cfg, B, Smax, torch.float32, device=dev)
        for c, n in zip(slab, (k_new, v_new)):
            c[:, :, :S] = n
        ld, slab = api.decode_step(
            cfg, mv, tok1.to(dev), slab,
            torch.full((B,), S, dtype=torch.int32, device=dev),
            mrope_pos=mrope_positions(B, 1, start=S).to(dev), **kw)
        out[dev] = [t.cpu() for t in (lp, ld, *slab)]
    errs = [(a - b).abs().max().item()
            for a, b in zip(out["cpu"], out["cuda"])]
    ok = all(e <= tol for e in errs) and all(
        torch.isfinite(t).all() for t in out["cuda"])
    emit(dict(phase="parity_vlm", model=cfg.name,
              mrope_sections=list(cfg.mrope_sections),
              prefill_logits_err=errs[0], decode_logits_err=errs[1],
              k_slab_err=errs[2], v_slab_err=errs[3], tol=tol, ok=ok))
    check(ok, f"card vs CPU VLM parity failed: {errs} (tol {tol})")


# ------------------------------------------------------------ phase 4
def make_trace(vocab: int, n_req: int = 16, n_adapters: int = 12,
               out_len: int = 32, seed: int = 0):
    """Prompts of 32-200 tokens from three shared preambles; request i
    uses adapter i % n_adapters and preamble (adapter % 3), so repeats
    of an adapter repeat its preamble; every fourth request samples
    with a fixed seed."""
    import numpy as np
    from repro_torch.core import Request, SamplingParams
    rng = np.random.default_rng(seed)
    pres = [rng.integers(3, vocab, size=n).tolist() for n in (24, 64, 120)]
    trace = []
    for i in range(n_req):
        a = i % n_adapters
        pre = pres[a % 3]
        n_suffix = int(rng.integers(max(8, 32 - len(pre)),
                                    200 - len(pre) + 1))
        prompt = pre + rng.integers(3, vocab, size=n_suffix).tolist()
        sp = (SamplingParams(temperature=0.8, top_k=50, top_p=0.9,
                             seed=1000 + i) if i % 4 == 3 else None)
        trace.append((Request(input_len=len(prompt), output_len=out_len,
                              adapter_id=a, prompt=prompt), sp))
    return trace


class PrefillTimer:
    """CUDA events around every prefill call an engine makes
    (``api.prefill`` / ``api.prefill_paged``, patched for the duration
    of a ``with`` block): the device time from the call's first launch
    to its last, host gaps between them included. Recording events does
    not synchronise, so the engine's schedule is unchanged."""

    NAMES = ("prefill", "prefill_paged")

    def __init__(self) -> None:
        self.calls = []            # (bucket (B, S), start, end)

    def __enter__(self):
        from repro_torch.models import api
        self.saved = {n: getattr(api, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            setattr(api, n, self._timed(fn))
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.models import api
        for n, fn in self.saved.items():
            setattr(api, n, fn)

    def _timed(self, fn):
        import torch

        def call(cfg, params, tokens, *args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(cfg, params, tokens, *args, **kwargs)
            end.record()
            self.calls.append((tuple(tokens.shape), start, end))
            return out
        return call

    def summary(self) -> dict:
        """Calls, total and median ms, and per (B, S) bucket the number
        of calls and their median ms."""
        import torch
        torch.cuda.synchronize()
        ms = [(b, s.elapsed_time(e)) for b, s, e in self.calls]
        buckets = {}
        for b, t in ms:
            buckets.setdefault(f"{b[0]}x{b[1]}", []).append(t)
        return dict(prefill_calls=len(ms),
                    prefill_ms_total=sum(t for _, t in ms),
                    prefill_ms_p50=(statistics.median(t for _, t in ms)
                                    if ms else None),
                    prefill_ms_by_bucket={
                        k: dict(calls=len(v), p50=statistics.median(v))
                        for k, v in sorted(buckets.items())})


def serve(eng, trace) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels.ops import DISPATCH_METER
    DISPATCH_METER.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [eng.submit(req, sampling=sp) for req, sp in trace]
    steps = 0
    while eng.busy() and steps < 20_000:
        eng.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(not eng.busy(), "engine failed to drain")
    ttft = np.array([r.ttft for r in eng.records])
    n_tok = sum(len(h.tokens) for h in handles)
    decode_tok = n_tok - len(handles)
    first = min(r.arrival + r.ttft for r in eng.records)
    last = max(r.arrival + r.e2e for r in eng.records)
    return dict(
        handles=handles, wall_s=wall, steps=steps, tokens=n_tok,
        ttft_p50_s=float(np.percentile(ttft, 50)),
        ttft_p99_s=float(np.percentile(ttft, 99)),
        decode_tok_per_s=decode_tok / max(last - first, 1e-9),
        dispatches_per_token=DISPATCH_METER.dispatches / max(decode_tok, 1),
        draft_dispatches_per_token=(DISPATCH_METER.draft_dispatches
                                    / max(decode_tok, 1)),
        verify_dispatches_per_token=(DISPATCH_METER.verify_dispatches
                                     / max(decode_tok, 1)),
        host_sync_s=DISPATCH_METER.sync_seconds)


def warm_up(eng, vocab: int) -> None:
    """Three short requests on adapters the trace never uses, one of
    them sampled: the first calls of every kernel, of cuBLAS and of the
    allocator happen here, not in the timed run. Stats are reset after;
    the adapter cache and prefix tree keep what the warm-up left."""
    import numpy as np
    from repro_torch.core import Request, SamplingParams
    rng = np.random.default_rng(99)
    for a in (13, 14, 15):
        sp = SamplingParams(temperature=0.7, seed=5) if a == 15 else None
        eng.submit(Request(input_len=40, output_len=9, adapter_id=a,
                           prompt=rng.integers(3, vocab, 40).tolist()),
                   sampling=sp)
    eng.run_until_drained()
    check(not eng.busy(), "warm-up failed to drain")
    eng.reset_stats()


# name: (EngineConfig overrides, kernels on that engine's path)
ENGINES = {
    "fused": (dict(), ("bgmv", "sgmv", "paged_attention")),
    "seed": (dict(fused_hotloop=False), ("bgmv", "sgmv", "paged_attention")),
    "dense": (dict(paged=False), ("bgmv", "sgmv", "flash_attention")),
    "no_prefix": (dict(prefix_cache=False),
                  ("bgmv", "sgmv", "paged_attention", "flash_attention")),
    # Prompts over 64 tokens prefill a 64-token chunk a step (B=1 suffix
    # prefills) and skip the prefix tree.
    "chunked": (dict(prefill_chunk_tokens=64),
                ("bgmv", "sgmv", "paged_attention")),
    # Speculative decoding (``spec_parts``): an unrelated internlm2-1.8b
    # draft at its published widths, and the shared-layer self-draft.
    # The K=1 demotions run bgmv and paged_attention; the verify pass's
    # LoRA runs sgmv at tile 8.
    "spec": (dict(spec_decode=True, spec_k=4),
             ("bgmv", "sgmv", "paged_attention")),
    # The fused engine on spec_self's weights: the greedy tokens
    # spec_self must keep.
    "fused_self": (dict(), ("bgmv", "sgmv", "paged_attention")),
    "spec_self": (dict(spec_decode=True, spec_k=4),
                  ("bgmv", "sgmv", "paged_attention")),
}
#: Engines of ``ENGINES`` built from ``spec_parts``.
SPEC_PARTS = ("spec", "fused_self", "spec_self")


def spec_parts(name: str, cfg, params) -> dict:
    """The target weights, adapter catalog and draft of an engine of
    ``SPEC_PARTS``, and what was cut from the published configurations.

    ``spec``: ``internlm2-1.8b`` at its published widths (24 layers, d
    2048, 16/8 heads, Dh 128, ff 8192; arXiv:2403.17297), seeded bf16
    weights, its vocabulary cut from 92544 to the target's 32000 (the
    engine's vocabulary check). Its proposals are unrelated to the
    target's, so acceptance is near 0: rejection, rollback and the
    shrinking of ``spec_k`` at scale.

    ``spec_self`` (and ``fused_self``, the same weights and catalog with
    no draft): the shared-layer pair of
    ``benchmarks/decode_hotloop.py`` rebuilt here: the target's ``o``
    and ``down`` zeroed in layers 1-31 (new tensors, about 4 GB), a
    1-layer draft sharing layer 0, the embeddings and the head, adapter
    deltas zero. Its logits equal the target's up to the rounding of
    GEMMs of other shapes, so acceptance is near 1: what speculation
    does to decode tokens/s. The zeroed weights change values, not
    shapes or launches."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving.engine import AdapterCatalog, EngineConfig
    if name == "spec":
        dcfg = dataclasses.replace(get_config("internlm2-1.8b"),
                                   vocab_size=cfg.vocab_size)
        return dict(params=params, catalog=None,
                    draft=(dcfg, api.init_params(dcfg, seed=1,
                                                 dtype=torch.bfloat16)),
                    reduced=["draft vocab_size 92544 -> "
                             f"{cfg.vocab_size}"])
    tparams = dict(params)
    for k in ("layers/o", "layers/down"):
        t = params[k].clone()
        t[1:].zero_()
        tparams[k] = t
    dcfg = dataclasses.replace(cfg, n_layers=1)
    dparams = {k: (v[:1] if k.startswith("layers/") else v)
               for k, v in tparams.items()}
    e = EngineConfig()
    catalog = AdapterCatalog(cfg, e.n_adapters, e.r_max, seed=e.seed)
    for w in catalog.weights.values():
        for a, b in w.values():
            a.zero_()
            b.zero_()
    draft = (dcfg, dparams) if name == "spec_self" else None
    return dict(params=tparams, catalog=catalog, draft=draft,
                reduced=["target o and down zeroed in layers 1-31",
                         "draft: target layer 0, embeddings and head",
                         "adapter deltas zero"])


def phase_engine(cfg, params) -> dict:
    """Each engine of ``ENGINES`` over the same trace, one at a time.
    Returns {engine: its line's readings, with ``outputs`` (tokens per
    request) and ``launches`` ({kernel: launches in its trace})}."""
    import importlib

    import torch
    from repro_torch.models.lora_apply import EINSUM
    from repro_torch.serving.engine import ChameleonEngine, EngineConfig
    from repro_torch.serving.systems import build_engine
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in KERNELS}
    ecfg = EngineConfig()
    results = {}
    for name, (knobs, path) in ENGINES.items():
        spec = knobs.get("spec_decode", False)
        parts = spec_parts(name, cfg, params) if name in SPEC_PARTS else None
        if parts is not None:
            eng = ChameleonEngine(cfg, parts["params"],
                                  EngineConfig(**knobs),
                                  catalog=parts["catalog"],
                                  draft=parts["draft"])
            check(eng.spec == spec, f"{name}: spec is {eng.spec}")
        else:
            eng = build_engine("chameleon", cfg, params,
                               EngineConfig(**knobs))
        warm_up(eng, cfg.vocab_size)
        trace = make_trace(cfg.vocab_size)
        torch.cuda.reset_peak_memory_stats()
        for st in stats.values():
            st.reset()
        EINSUM.reset()
        with PrefillTimer() as timer:
            res = serve(eng, trace)                   # this engine's path
        launches = {n: st.launches for n, st in stats.items()}
        instances = {n: dict(st.instances) for n, st in stats.items()}
        plain = {n: st.plain for n, st in stats.items()}
        est = eng.stats()
        res.update(timer.summary())
        res.update(launches=launches, launches_by_instance=instances,
                   plain_calls=plain, einsum_calls=EINSUM.calls,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   **{k: v for k, v in est.items()
                      if k in ("completed", "prefix_hit_tokens",
                               "prefix_hits", "cow_forks", "async_loads",
                               "preempted", "chunked_prefills")},
                   cache=est["cache"])
        toks = [h.tokens for h in res.pop("handles")]
        res["outputs"] = toks
        check(res["completed"] == len(trace),
              f"{name}: {res['completed']}/{len(trace)} requests completed")
        check(all(len(t) == r.output_len for t, (r, _) in zip(toks, trace)),
              f"{name}: a request stopped short of its output length")
        check(all(0 <= x < cfg.vocab_size for t in toks for x in t),
              f"{name}: token id outside the vocabulary")
        if eng.prefix is not None and "prefill_chunk_tokens" not in knobs:
            check(res["prefix_hit_tokens"] > 0,
                  f"{name}: the prefix cache never hit")
        if knobs.get("prefill_chunk_tokens"):
            check(res.get("chunked_prefills", 0) > 0,
                  f"{name}: no prompt was prefilled in chunks")
        if spec:
            res.update(eng.spec_stats(), sgmv_tiles=dict(stats["sgmv"].tiles),
                       draft=dict(name=parts["draft"][0].name,
                                  n_layers=parts["draft"][0].n_layers,
                                  d_model=parts["draft"][0].d_model),
                       draft_len_after=[int(x) for x in eng._draft_len],
                       pages_back=(eng.pool.used_requests == 0
                                   and len(eng.free_pages)
                                   + eng.pool.n_shared_pages
                                   == eng.n_pages - 1))
            check(res["pages_back"],
                  f"{name}: pages not back in the pool after the drain")
            check(not any(res["draft_len_after"]),
                  f"{name}: draft-KV mirror not freed: "
                  f"{res['draft_len_after']}")
            check(res["sgmv_tiles"].get(8, 0) > 0,
                  f"{name}: the verify pass never ran sgmv at tile 8: "
                  f"{res['sgmv_tiles']}")
            check(res["spec_verify_dispatches"] > 0,
                  f"{name}: no speculative round ran")
        if parts is not None:
            res["reduced"] = parts["reduced"]
        check(all(launches[n] > 0 for n in path),
              f"{name}: a kernel of its path never launched: {launches}")
        # bf16 weights give bf16 activations: every sgmv and
        # flash_attention launch must be the tensor-core instance.
        for n in ("sgmv", "flash_attention"):
            check(set(instances[n]) <= {"tensor_cores"},
                  f"{name}: {n} launched {instances[n]}, expected the "
                  f"tensor-core instance only")
        check(launches["flash_attention"] % cfg.n_layers == 0,
              f"{name}: flash_attention launches are not a whole number "
              f"of prefill calls ({cfg.n_layers} layers): {launches}")
        check(not any(plain.values()) and res["einsum_calls"] == 0,
              f"{name}: a plain/einsum path ran on the card: {plain}, "
              f"einsum {res['einsum_calls']}")
        results[name] = res
        emit(dict(phase="engine", engine=name, knobs=knobs, model=cfg.name,
                  n_layers=cfg.n_layers, d_model=cfg.d_model,
                  weights="bf16",
                  ecfg=dict(max_slots=ecfg.max_slots,
                            max_len=ecfg.max_len,
                            n_lora_slots=ecfg.n_lora_slots,
                            r_max=ecfg.r_max, n_adapters=ecfg.n_adapters,
                            max_horizon=ecfg.max_horizon),
                  **{k: v for k, v in res.items() if k != "outputs"}))
        # Requests' handles point back at their engine: collect the
        # cycle so the next engine's peak does not hold this one.
        del eng, est, parts
        gc.collect()
        torch.cuda.empty_cache()
    greedy = greedy_requests(cfg)

    def agreement(a: str, b: str) -> dict:
        return greedy_agreement(results[a]["outputs"], results[b]["outputs"],
                                greedy)

    emit(dict(phase="engine_ab", greedy_requests=len(greedy),
              greedy_vs_fused={name: agreement(name, "fused")
                               for name in results if name != "fused"},
              greedy_dense_vs_no_prefix=agreement("dense", "no_prefix"),
              # spec_self serves other weights than fused: held to the
              # fused engine on the same weights.
              greedy_spec_self_vs_fused_self=agreement("spec_self",
                                                       "fused_self"),
              decode_tok_per_s={name: res["decode_tok_per_s"]
                                for name, res in results.items()},
              ttft_s={name: dict(p50=res["ttft_p50_s"],
                                 p99=res["ttft_p99_s"])
                      for name, res in results.items()},
              prefill_ms={name: dict(p50=res["prefill_ms_p50"],
                                     total=res["prefill_ms_total"],
                                     calls=res["prefill_calls"])
                          for name, res in results.items()}))
    return results


def greedy_requests(cfg) -> list[int]:
    return [i for i, (_, sp) in enumerate(make_trace(cfg.vocab_size))
            if sp is None]


def greedy_agreement(outs_a, outs_b, greedy) -> dict:
    """Greedy requests with identical outputs, identical first tokens,
    and the mean length of the common output prefix."""
    pairs = [(outs_a[i], outs_b[i]) for i in greedy]
    common = [next((j for j, (x, y) in enumerate(zip(u, w)) if x != y),
                   min(len(u), len(w))) for u, w in pairs]
    return dict(identical=sum(u == w for u, w in pairs),
                first_token_identical=sum(u[:1] == w[:1] for u, w in pairs),
                mean_common_prefix=sum(common) / len(common))


# ------------------------------------------------------------ phase 5
class HostTimer:
    """Host ms of the named methods of each engine, patched on the
    instances for the duration of a ``with`` block. ``import_request_kv``
    counts only the calls that imported (a refusal returns at once)."""

    def __init__(self, engines, names) -> None:
        self.engines, self.names = engines, names
        self.ms = {n: [] for n in names}

    def __enter__(self):
        for e in self.engines:
            for n in self.names:
                setattr(e, n, self._timed(n, getattr(e, n)))
        return self

    def __exit__(self, *exc) -> None:
        for e in self.engines:
            for n in self.names:
                delattr(e, n)
        self.engines = []       # hold no replica past the block

    def _timed(self, name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if out is not None and out is not False:
                self.ms[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    def medians(self) -> dict:
        return {n: statistics.median(v) if v else None
                for n, v in self.ms.items()}


#: tier: build_system options (two replicas on the one card).
TIERS = {
    "disagg": dict(tier="disagg", n_nodes=2),
    "cluster": dict(tier="cluster", n_nodes=2, policy="adapter_affinity"),
}
TIER_PATH = ("bgmv", "sgmv", "paged_attention")
#: Peak memory a tier may hold beyond the fused engine's: one more KV
#: pool and LoRA slots fit, a second copy of the 13.5 GB of weights
#: does not.
TIER_MEM_SLACK_GB = 8.0


def phase_tiers(cfg, params, fused: dict) -> None:
    """Each tier of ``TIERS`` over the phase-4 trace, one at a time,
    built by ``build_system`` on the card. Kernel counts are taken
    around the whole tier (the counters are shared by its replicas)."""
    import importlib

    import torch
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in KERNELS}
    greedy = greedy_requests(cfg)
    for name, opts in TIERS.items():
        # One function call a tier: every reference to its replicas
        # (handles point back at the tier) dies with the call.
        run_tier(name, opts, cfg, params, fused, stats, greedy)
        gc.collect()
        torch.cuda.empty_cache()


def run_tier(name, opts, cfg, params, fused, stats, greedy) -> None:
    """Build one tier, warm each replica, serve the trace (kernel counts
    zeroed just before, read just after), emit its line, check it."""
    import numpy as np
    import torch
    from repro_torch.kernels.ops import DISPATCH_METER
    from repro_torch.models.lora_apply import EINSUM
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.systems import build_system
    sys_ = build_system("chameleon", model_cfg=cfg, params=params,
                        ecfg=EngineConfig(), **opts)
    engines = sys_.engines
    check(all(e.params[k].data_ptr() == v.data_ptr()
              for e in engines for k, v in params.items()),
          f"{name}: a replica copied the weights")
    for e in engines:
        warm_up(e, cfg.vocab_size)
    sys_._clock.reset()
    trace = make_trace(cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for st in stats.values():
        st.reset()
    EINSUM.reset()
    DISPATCH_METER.reset()
    t0 = time.perf_counter()
    with HostTimer(engines, ("begin_migration",
                             "import_request_kv")) as timer:
        handles = [sys_.submit(req, sampling=sp) for req, sp in trace]
        steps = 0
        while sys_.busy() and steps < 20_000:
            sys_.step()
            steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(not sys_.busy(), f"{name}: the tier failed to drain")
    merged, _ = sys_.metrics()
    recs = merged.records
    per = [e.stats() for e in engines]
    toks = [h.tokens for h in handles]
    launches = {n: st.launches for n, st in stats.items()}
    plain = {n: st.plain for n, st in stats.items()}
    ttft = np.array([r.ttft for r in recs])
    first = min(r.arrival + r.ttft for r in recs)
    last = max(r.arrival + r.e2e for r in recs)
    exports = sum(p.get("kv_exports", 0) for p in per)
    imports = sum(p.get("kv_imports", 0) for p in per)
    shipped = sum(p.get("kv_handoff_gb", 0.0) for p in per)
    link_gbps = getattr(getattr(sys_, "dcfg", None), "link_gbps", None)
    peak = torch.cuda.max_memory_allocated() / 1e9
    res = dict(
        phase="tier", tier=name, options=opts, model=cfg.name,
        replicas=len(engines), wall_s=wall, steps=steps,
        completed=sum(h.state.name == "FINISHED" for h in handles),
        requests=len(trace),
        ttft_p50_s=float(np.percentile(ttft, 50)),
        ttft_p99_s=float(np.percentile(ttft, 99)),
        decode_tok_per_s=(sum(map(len, toks)) - len(toks))
        / max(last - first, 1e-9),
        kv_exports=exports, kv_imports=imports, gb_shipped=shipped,
        begin_migration_host_ms_p50=timer.medians()["begin_migration"],
        import_request_kv_host_ms_p50=timer.medians()[
            "import_request_kv"],
        shipments_ms=timer.ms,
        link_gbps=link_gbps,
        link_ms_per_shipment=(shipped / max(exports, 1)
                              / link_gbps * 1e3
                              if link_gbps and exports else None),
        spilled=getattr(sys_, "n_spilled", None),
        completed_by_replica=[p["completed"] for p in per],
        peak_mem_gb=peak, fused_peak_mem_gb=fused["peak_mem_gb"],
        dispatches=DISPATCH_METER.dispatches,
        launches=launches, plain_calls=plain,
        einsum_calls=EINSUM.calls,
        greedy_vs_fused=greedy_agreement(toks, fused["outputs"],
                                         greedy))
    emit(res)
    check(res["completed"] == len(trace)
          and all(len(t) == r.output_len
                  for t, (r, _) in zip(toks, trace)),
          f"{name}: a request did not complete to its output length")
    check(all(0 <= x < cfg.vocab_size for t in toks for x in t),
          f"{name}: token id outside the vocabulary")
    if name == "disagg":
        check(exports == imports > 0,
              f"{name}: kv_exports {exports}, kv_imports {imports}")
    check(all(launches[n] > 0 for n in TIER_PATH),
          f"{name}: a kernel of its path never launched: {launches}")
    check(set(stats["sgmv"].instances) <= {"tensor_cores"},
          f"{name}: sgmv launched {stats['sgmv'].instances}")
    check(not any(plain.values()) and EINSUM.calls == 0,
          f"{name}: a plain/einsum path ran on the card")
    check(peak < fused["peak_mem_gb"] + TIER_MEM_SLACK_GB,
          f"{name}: peak memory {peak:.2f} GB against the fused "
          f"engine's {fused['peak_mem_gb']:.2f} GB")


# ------------------------- phase 5c, examples (after the mesh phase)
def load_example(script: str):
    """``examples/<script>`` as a module, its ``main`` not run."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        Path(script).stem, ROOT / "examples" / script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: (script, arguments, serves the model) of each run of the examples
#: phase, in order; the DES runs (serve_manyadapter's default, the
#: gateway) serve no model and get no weights.
EXAMPLE_RUNS = (("torch_quickstart.py", (), True),
                ("torch_serve_manyadapter.py", (), False),
                ("torch_serve_manyadapter.py", ("--engine",), True),
                ("torch_serve_manyadapter.py", ("--cluster",), True),
                ("torch_disagg_cluster.py", (), True),
                ("torch_gateway_multitenant.py", (), False))


def phase_examples(cfg, params, fused: dict) -> None:
    """The port's four serving examples on the card (``EXAMPLE_RUNS``),
    each through its ``main``, the runs that serve the model with the
    full-width weights handed over (the replicas of a tier share them),
    one at a time and freed after. Each example asserts its own contract
    and, on the card, that bgmv, sgmv and paged_attention launched in
    its served run (counts zeroed after any warm-up) with no plain
    version and no einsum LoRA (``example_support.counted_launches``:
    the example raises, and the phase fails); its line carries seconds,
    requests finished and cancelled, TTFT p50/p99 (the engine clock:
    monotonic seconds since the engine, or the tier's shared clock,
    last started or reset), the adapter cache's hits, misses and
    evictions, handoffs and GB shipped (disagg), each kernel's
    launches and peak memory against the fused engine's."""
    import torch
    t0 = time.perf_counter()
    secs = {}
    for script, argv, serves in EXAMPLE_RUNS:
        name = " ".join((Path(script).stem, *argv))
        weights = dict(model_cfg=cfg, params=params) if serves else {}
        secs[name] = run_example(script, argv, weights, fused)
        gc.collect()
        torch.cuda.empty_cache()
    emit(dict(phase="phase_examples", seconds=secs,
              total_s=time.perf_counter() - t0))


def run_example(script: str, argv: tuple, weights: dict,
                fused: dict) -> float:
    """One example run on the card (``weights``: the ``main`` keywords
    that hand over the model): its line, its checks; the seconds it
    took. The example's own printout goes to stderr."""
    import io

    import torch
    mod = load_example(script)
    name = " ".join((Path(script).stem, *argv))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = mod.main(list(argv), **weights)
        torch.cuda.synchronize()
    except (AssertionError, RuntimeError) as exc:
        raise PhaseError(f"example {name}: its contract failed: "
                         f"{type(exc).__name__}: {exc}") from exc
    finally:
        sys.stderr.write(buf.getvalue())
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    printed = buf.getvalue().strip().splitlines()
    res = dict(phase="example", example=name, seconds=secs,
               **{k: v for k, v in out.items()
                  if k not in ("streamed", "sampled")},
               peak_mem_gb=peak, fused_peak_mem_gb=fused["peak_mem_gb"],
               last_line=printed[-1] if printed else None)
    emit(res)
    check(out["finished"] > 0 and out["finished"] + out.get("cancelled", 0)
          + out.get("rejected", 0) == out["requests"],
          f"example {name}: {out['finished']} finished of "
          f"{out['requests']}")
    if weights:                 # it served the model on the card
        check(peak < fused["peak_mem_gb"] + TIER_MEM_SLACK_GB,
              f"example {name}: peak memory {peak:.2f} GB against the "
              f"fused engine's {fused['peak_mem_gb']:.2f} GB")
    return secs


# ------------------------------------------------- phase 5b, meshes
#: Mesh shapes of the step-function sweep, over repeated positions of
#: the one card (the fake-mesh pattern): (1, 1) must equal the
#: unsharded functions bit for bit; (1, 2) and (2, 2) split heads, FFN
#: and vocabulary into two columns, and (2, 2) splits pages over two
#: data shards as well.
MESH_SHAPES = ((1, 1), (1, 2), (2, 2))
#: Kernels of the mesh paths: the paged step functions and the (1, 1)
#: engine run bgmv, sgmv and paged_attention; the whole-prompt prefill
#: runs flash_attention.
MESH_PATH = ("bgmv", "sgmv", "paged_attention", "flash_attention")
#: Reduced configs whose KV heads do not divide the model axis: MQA
#: granite-34b (1 KV head) and Llama (2) on 4 columns. Columns that
#: share a KV head read it whole from the pages, or from the slab's
#: positions split over "model".
UNEVEN_MESHES = {"granite-34b": ((1, 1), (1, 2), (1, 4)),
                 "chameleon-llama-7b": ((1, 4),)}


def repeated_mesh(shape, dev):
    """A ("data", "model") mesh of ``shape`` whose every position is
    ``dev``."""
    import numpy as np
    from repro_torch.launch.mesh import Mesh
    grid = np.empty(shape[0] * shape[1], dtype=object)
    grid[:] = [dev] * grid.size
    return Mesh(grid.reshape(shape), ("data", "model"))


def mesh_inputs(cfg, prompts, dev, seed: int, dtype):
    """The step functions' inputs: right-padded prompts, a LoRA slot
    arena holding 8 seeded adapters (one a row), and a page table of 16
    pages a row drawn from a permutation of the pool, so every row's
    pages lie on both data shards of a 2-way data axis."""
    import torch
    from repro_torch.models.lora_apply import (init_lora_slots,
                                               random_lora_weights,
                                               write_adapter_to_slot)
    B = len(prompts)
    S = 1 << max(3, (max(len(p) for p in prompts) - 1).bit_length())
    toks = torch.zeros((B, S), dtype=torch.int32, device=dev)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
    seq_len = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                           device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    lora = init_lora_slots(8, cfg.n_layers, cfg.d_model, cfg.q_dim,
                           cfg.kv_dim, 32, dtype, device=dev)
    for s in range(8):
        write_adapter_to_slot(lora, random_lora_weights(
            g, 32, 32, cfg.n_layers, cfg.d_model, cfg.q_dim, cfg.kv_dim,
            dtype), s)
    P = 16
    n_pages = B * P + 2                      # page 0 trash, even count
    table = (1 + torch.randperm(n_pages - 1, generator=g, device=dev)
             )[:B * P].view(B, P).int()
    return dict(toks=toks, seq_len=seq_len, lora=lora, table=table,
                n_pages=n_pages, aidx=torch.arange(B, dtype=torch.int32,
                                                   device=dev) % 8)


def mesh_steps(cfg, params, inp, shape, n_steps: int = 8) -> dict:
    """``prefill_paged`` of the prompts, two fused greedy horizons of
    ``n_steps`` decode steps over the pages (the second timed), and a
    whole-prompt ``prefill``: unsharded (``shape`` None) or with the
    weights, LoRA arena and pages placed by ``ShardPlan`` on a mesh of
    ``shape`` over repeated positions of the card."""
    import torch
    from repro_torch.distributed.sharding import MeshParams
    from repro_torch.models import api
    from repro_torch.serving.shard_plan import ShardPlan
    dev = inp["toks"].device
    B = inp["toks"].shape[0]
    kv_shape = (cfg.n_layers, inp["n_pages"], 16, cfg.n_kv_heads,
                cfg.head_dim)
    if shape is None:
        p, lora = params, inp["lora"]
        kv = api.init_paged_serve_state(cfg, inp["n_pages"], 16,
                                        torch.float32, device=dev)
    else:
        mesh = repeated_mesh(shape, dev)
        plan = ShardPlan(mesh, cfg)
        sh = plan.params(params)
        p = MeshParams(cfg, {k: plan.put(v, sh[k])
                             for k, v in params.items()}, mesh)
        lsh = plan.lora_slots(inp["lora"])
        lora = {k: (plan.put(a, lsh[k][0]), plan.put(b, lsh[k][1]))
                for k, (a, b) in inp["lora"].items()}
        kv = tuple(plan.zeros_kv_pages(kv_shape, torch.float32)
                   for _ in range(2))
    kw = dict(lora=lora, adapter_idx=inp["aidx"], lora_backend="kernel")
    i32 = torch.int32
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, kv = api.prefill_paged(
        cfg, p, inp["toks"], kv, inp["table"],
        torch.zeros(B, dtype=i32, device=dev), inp["seq_len"], **kw)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tokens = torch.argmax(logits, dim=-1).to(i32)[:, None]
    first = tokens[:, 0].clone()
    # One decode step's logits from the prefilled state (the horizon
    # below rewrites the same position with the same K/V).
    step, kv = api.decode_step_paged(cfg, p, tokens, kv, inp["table"],
                                     inp["seq_len"], **kw)
    state = dict(cache_len=inp["seq_len"].clone(),
                 active=torch.ones(B, dtype=torch.bool, device=dev),
                 positions=torch.ones(B, dtype=i32, device=dev))
    fixed = (torch.full((B,), 1 << 20, dtype=i32, device=dev),
             torch.zeros((B, 0), dtype=i32, device=dev),
             torch.zeros(B, device=dev), torch.zeros(B, dtype=i32,
                                                     device=dev),
             torch.ones(B, device=dev),
             torch.zeros(B, dtype=torch.int64, device=dev))
    blocks, ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, toks, _ = api.decode_fused_paged(
            cfg, p, tokens, kv, inp["table"], state["cache_len"],
            state["active"], state["positions"], *fixed, n_steps=n_steps,
            all_greedy=True, max_ctx=1 << 20, **kw)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / n_steps)
        tokens, kv, state["cache_len"], state["active"], \
            state["positions"] = carry
        blocks.append(toks)
    dense, _ = api.prefill(cfg, p, inp["toks"],
                           last_pos=(inp["seq_len"] - 1), **kw)
    torch.cuda.synchronize()
    return dict(logits=logits.float(), first=first, step=step.float(),
                toks=torch.cat(blocks).T.cpu(), dense=dense.float(),
                prefill_ms=prefill_ms, decode_ms_per_step=ms[1])


def mesh_sweep(cfg, params, inp, tag: str, tol: float,
               shapes: tuple = MESH_SHAPES) -> dict:
    """``mesh_steps`` unsharded, then at each of ``shapes``, then
    unsharded again (host times vary from run to run: both unsharded
    times are reported). (1, 1) must equal the unsharded run bit for
    bit (same shapes, same kernels); the split meshes must hold the
    prefill logits within ``tol`` of it (column GEMMs of other widths
    may round differently), in f32 the decode logits too, and are read
    for greedy and first-token agreement. Each run's kernel launches
    are counted from zero and every kernel of ``MESH_PATH`` must
    launch; its peak memory is read."""
    import importlib

    import torch
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in KERNELS}
    base = mesh_steps(cfg, params, inp, None)
    runs = {}
    for shape in shapes:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for st in stats.values():
            st.reset()
        runs[shape] = got = mesh_steps(cfg, params, inp, shape)
        runs[shape]["launches"] = {n: st.launches for n, st in stats.items()}
        runs[shape]["instances"] = {n: dict(st.instances)
                                    for n, st in stats.items()}
        runs[shape]["plain"] = {n: st.plain for n, st in stats.items()}
        runs[shape]["peak"] = torch.cuda.max_memory_allocated() / 1e9
    again = mesh_steps(cfg, params, inp, None)
    out = {}
    for shape, got in runs.items():
        launches = got["launches"]
        err = max((got[k] - base[k]).abs().max().item()
                  for k in ("logits", "dense"))
        step_err = (got["step"] - base["step"]).abs().max().item()
        rows = base["toks"].shape[0]
        line = dict(
            phase="mesh_steps", model=cfg.name, weights=tag,
            mesh_shape=list(shape), n_layers=cfg.n_layers,
            d_model=cfg.d_model, rows=rows,
            logits_max_abs_err=err, tol=0.0 if shape == (1, 1) else tol,
            decode_logits_max_abs_err=step_err,
            first_token_identical=int((got["first"] == base["first"])
                                      .sum().item()),
            greedy_identical=sum(bool(torch.equal(a, b)) for a, b in
                                 zip(got["toks"], base["toks"])),
            finite=bool(torch.isfinite(got["logits"]).all()
                        and torch.isfinite(got["dense"]).all()),
            prefill_ms=got["prefill_ms"],
            prefill_ms_unsharded=[base["prefill_ms"], again["prefill_ms"]],
            decode_ms_per_step=got["decode_ms_per_step"],
            decode_ms_per_step_unsharded=[base["decode_ms_per_step"],
                                          again["decode_ms_per_step"]],
            peak_mem_gb=got["peak"], launches=launches,
            launches_by_instance=got["instances"],
            plain_calls=got["plain"])
        emit(line)
        check(line["finite"], f"mesh_steps {tag} {shape}: non-finite logits")
        if shape == (1, 1):
            check(err == 0.0 and step_err == 0.0
                  and line["greedy_identical"] == rows,
                  f"mesh_steps {tag} (1, 1) differs from the unsharded "
                  f"step functions: {line}")
        else:
            check(err <= tol, f"mesh_steps {tag} {shape}: logits off by "
                              f"{err} > {tol}")
            if tag == "f32":
                check(step_err <= tol, f"mesh_steps {tag} {shape}: decode "
                                       f"logits off by {step_err} > {tol}")
        check(all(launches[n] > 0 for n in MESH_PATH)
              and not any(line["plain_calls"].values()),
              f"mesh_steps {tag} {shape}: a kernel of the path never "
              f"launched or a plain version ran: {line}")
        out[shape] = line
    return out


def mesh_kernel_checks(cfg, record_to: dict,
                       phase: str = "kernel_time_mesh",
                       projs: tuple | None = None,
                       paged: bool = True) -> None:
    """bgmv, sgmv, paged_attention and flash_attention at the shapes one
    "model" column of a (·, 2) mesh gives them: at Llama-7B width LoRA
    dout 2048 (q/k/v heads, o's output columns, the default ``projs``),
    16 of 32 heads, bf16 activations, f32 pages; held to their plain
    versions at phase 2's tolerances and timed beside their bounds,
    plain versions and a PyTorch call (``phase`` lines). ``projs``:
    (name, din, dout) of the LoRA cases; ``paged``: also
    paged_attention (not on the MoE path, which decodes from the
    slab)."""
    import importlib

    import torch
    import torch.nn.functional as F
    bgmv = importlib.import_module("repro_torch.kernels.bgmv")
    sgmv = importlib.import_module("repro_torch.kernels.sgmv")
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2020)
    scratch = torch.empty(64 * MIB, dtype=torch.uint8, device=dev)
    M = 2

    def flush():
        scratch.zero_()

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(dtype)

    def checked(*args, **kw):
        checked_and_timed(phase, flush, record_to, *args,
                          mesh_model=M, **kw)

    d, r, n_slots, Bt, S, tile = cfg.d_model, 32, 8, 8, 256, 128
    idx = torch.randperm(n_slots, generator=g, device=dev)[:Bt].int()
    ts = torch.randint(0, n_slots, (Bt * S // tile,), generator=g,
                       device=dev).int()
    for proj, din, dout in projs or (("q/k/v", d, cfg.q_dim // M),
                                     ("o", cfg.q_dim, d // M)):
        A = randn(n_slots, din, r, scale=din ** -0.5)
        Bw = randn(n_slots, r, dout, scale=r ** -0.5)
        x = randn(Bt, din)
        checked("bgmv", f"{proj}: x {tuple(x.shape)}, dout {dout}",
                lambda: bgmv.bgmv(x, A, Bw, idx),
                lambda: bgmv.bgmv_plain(x, A, Bw, idx),
                lambda: torch.bmm(torch.bmm(x[:, None], A[idx.long()]),
                                  Bw[idx.long()]), "lora_bf16",
                bound_ms(nbytes(x, idx) + idx.unique().numel()
                         * nbytes(A[0], Bw[0]) + Bt * dout * 2,
                         2 * Bt * r * (din + dout), "bf16"))
        x = randn(Bt * S, din)
        xt = x.view(-1, tile, din)
        sgmv.STATS.reset()
        sgmv.sgmv(x, A, Bw, ts, tile)
        inst = launched(sgmv, sgmv.sgmv_instance(x.dtype, A.dtype, r, tile))
        checked("sgmv", f"{proj}: x {tuple(x.shape)}, dout {dout}",
                lambda: sgmv.sgmv(x, A, Bw, ts, tile),
                lambda: sgmv.sgmv_plain(x, A, Bw, ts, tile),
                lambda: torch.bmm(torch.bmm(xt, A[ts.long()]),
                                  Bw[ts.long()]), "lora_bf16",
                bound_ms(nbytes(x, ts) + ts.unique().numel()
                         * nbytes(A[0], Bw[0]) + Bt * S * dout * 2,
                         2 * Bt * S * r * (din + dout), "bf16"),
                instance=inst)
    Kh, dh = cfg.n_kv_heads // M, cfg.head_dim
    if paged:
        mesh_paged_check(cfg, checked, randn, g, dev, Bt, Kh, dh)
    H = cfg.n_heads // M
    q = randn(Bt, S, H, dh)
    k, v = randn(Bt, S, Kh, dh), randn(Bt, S, Kh, dh)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fa.STATS.reset()
    fa.flash_attention(q, k, v, True)
    inst = launched(fa, fa.flash_instance(q.dtype, dh))
    checked("flash_attention", f"causal, H {H}/Kh {Kh}, q {tuple(q.shape)}",
            lambda: fa.flash_attention(q, k, v, True),
            lambda: fa.flash_attention_plain(q, k, v, True),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), "bf16_out",
            flash_bound(q, k, v, True),
            extra=FLASH_P_ROUNDING * fa.flash_attention_plain(
                q.float(), k.float(), v.float().abs(), True),
            instance=inst)


def mesh_paged_check(cfg, checked, randn, g, dev, Bt, Kh, dh) -> None:
    """paged_attention at one column's KV heads over the phase-2
    pool."""
    import importlib

    import torch
    import torch.nn.functional as F
    pa = importlib.import_module("repro_torch.kernels.paged_attention")
    page, P, n_pages = 16, 16, 161
    G = cfg.n_heads // cfg.n_kv_heads
    kp = randn(n_pages, page, Kh, dh, dtype=torch.float32)
    vp = randn(n_pages, page, Kh, dh, dtype=torch.float32)
    table = (1 + torch.randperm(n_pages - 1, generator=g, device=dev)
             )[:Bt * P].view(Bt, P).int()
    lens = torch.randint(32, P * page + 1, (Bt,), generator=g,
                         device=dev).int()
    q = randn(Bt, Kh, G, dh)

    def sdpa():
        k = kp[table.long()].permute(0, 3, 1, 2, 4).reshape(
            Bt, Kh, P * page, dh)
        v = vp[table.long()].permute(0, 3, 1, 2, 4).reshape(
            Bt, Kh, P * page, dh)
        mask = (torch.arange(P * page, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        return F.scaled_dot_product_attention(
            q.float().reshape(Bt, Kh * G, 1, dh), k, v, attn_mask=mask)
    n_tok = int(lens.sum().item())
    checked("paged_attention",
            f"q {tuple(q.shape)} bf16, f32 pages, lengths 32-256",
            lambda: pa.paged_attention(q, kp, vp, table, lens),
            lambda: pa.paged_attention_plain(q, kp, vp, table, lens),
            sdpa, "bf16_out",
            bound_ms(nbytes(q, table, lens) + 2 * n_tok * Kh * dh * 4
                     + nbytes(q), 4 * n_tok * Kh * G * dh, "f32"))


def gemm_column_probe() -> dict:
    """Whether a column block of a GEMM equals the same columns of the
    whole GEMM on this card (cuBLAS may pick another kernel, and with it
    another summation order, for the narrower output): bf16 x (rows,
    4096) @ W (4096, 4096)[:, :2048] at decode (8 rows) and prefill
    (2048 rows) shapes, and f32 at decode."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for rows, dtype, name in ((8, torch.bfloat16, "bf16_rows8"),
                              (2048, torch.bfloat16, "bf16_rows2048"),
                              (8, torch.float32, "f32_rows8")):
        x = torch.randn(rows, 4096, generator=g, device=dev).to(dtype)
        w = (torch.randn(4096, 4096, generator=g, device=dev)
             * 4096 ** -0.5).to(dtype)
        whole = x @ w
        half = x @ w[:, :2048].contiguous()
        out[name] = (half.float() - whole[:, :2048].float()).abs().max(
            ).item()
    return out


def phase_mesh(cfg, params) -> dict:
    """The mesh data plane on one card (no interconnect: every position
    of a split mesh is the same card, so gathers are device copies).
    First reduced Llama in f32 through the step functions
    (``mesh_sweep``: (1, 1) bit-exact, split meshes within 1e-4); then
    the kernels at a 2-way column's shapes (``mesh_kernel_checks``);
    then full-width Llama-7B: the step functions on the first 8 trace
    prompts at each mesh shape against the unsharded functions, and the
    phase-4 trace served by ``EngineConfig()``, then
    ``EngineConfig(mesh_shape=(1, 1))``, then ``EngineConfig()`` again
    (host ms a step varies from run to run), each on a step clock with
    its adapter loads landed before each step, so the schedules and
    (same shapes, same kernels) the tokens are identical. Returns the
    mesh engine's launches on its trace."""
    import importlib

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.systems import build_engine
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    small = get_config("chameleon-llama-7b").reduced()
    sparams = api.init_params(small, 0, torch.float32, device=dev)
    rng_prompts = [[int(t) % small.vocab_size for t in r.prompt[:40]]
                   for r, _ in make_trace(small.vocab_size)[:8]]
    mesh_sweep(small, sparams, mesh_inputs(small, rng_prompts, dev, 7,
                                           torch.float32), "f32", 1e-4)
    del sparams
    t_uneven = time.perf_counter()
    for name, shapes in UNEVEN_MESHES.items():
        c = get_config(name).reduced()
        p = api.init_params(c, 0, torch.float32, device=dev)
        mesh_sweep(c, p, mesh_inputs(c, [[t % c.vocab_size for t in pr]
                                         for pr in rng_prompts], dev, 7,
                                     torch.float32), "f32", 1e-4, shapes)
        del p
    emit(dict(phase="mesh_uneven_heads",
              seconds=time.perf_counter() - t_uneven))
    record = {}
    mesh_kernel_checks(cfg, record)
    trace = make_trace(cfg.vocab_size)
    prompts = [r.prompt for r, _ in trace[:8]]
    # bf16: a layout fault moves logits by their own scale (about 1).
    full = mesh_sweep(cfg, params, mesh_inputs(cfg, prompts, dev, 8,
                                               torch.bfloat16),
                      "bf16", 2 ** -4)
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in KERNELS}
    served = {}
    for name, shape in (("fused", None), ("mesh_1x1", (1, 1)),
                        ("fused_again", None)):
        clock = [0.0]
        eng = build_engine("chameleon", cfg, params,
                           EngineConfig(mesh_shape=shape),
                           clock=lambda: clock[0])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for st in stats.values():
            st.reset()
        handles = [eng.submit(r, sampling=sp) for r, sp in
                   make_trace(cfg.vocab_size)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = 0
        while eng.busy() and steps < 20_000:
            for stream in eng._load_streams.values():
                stream.synchronize()
            eng.step()
            clock[0] += 0.01
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(not eng.busy(), f"mesh engine {name} failed to drain")
        toks = [h.tokens for h in handles]
        served[name] = dict(
            outputs=toks, steps=steps, wall_s=wall,
            ms_per_step=wall * 1e3 / steps,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches={n: st.launches for n, st in stats.items()},
            plain={n: st.plain for n, st in stats.items()},
            shard_stats=eng.shard_stats())
        check(all(len(t) == r.output_len for t, (r, _) in zip(toks, trace))
              and all(0 <= x < cfg.vocab_size for t in toks for x in t),
              f"mesh engine {name}: short output or token outside the "
              f"vocabulary")
        del eng, handles
        gc.collect()
        torch.cuda.empty_cache()
    mesh, base, again = (served[n] for n in ("mesh_1x1", "fused",
                                             "fused_again"))
    agree = greedy_agreement(mesh["outputs"], base["outputs"],
                             greedy_requests(cfg))
    line = dict(phase="mesh_engine", model=cfg.name, mesh_shape=[1, 1],
                weights="bf16", requests=len(trace),
                all_identical=(mesh["outputs"] == base["outputs"]
                               == again["outputs"]),
                greedy_vs_unsharded=agree,
                steps=mesh["steps"], steps_unsharded=base["steps"],
                ms_per_step=mesh["ms_per_step"],
                ms_per_step_unsharded=[base["ms_per_step"],
                                       again["ms_per_step"]],
                peak_mem_gb=mesh["peak_mem_gb"],
                peak_mem_gb_unsharded=base["peak_mem_gb"],
                launches=mesh["launches"], shard_stats=mesh["shard_stats"],
                steps_by_mesh={f"{s[0]}x{s[1]}": dict(
                    decode_ms_per_step=v["decode_ms_per_step"],
                    decode_ms_per_step_unsharded=v[
                        "decode_ms_per_step_unsharded"],
                    greedy_identical=v["greedy_identical"],
                    decode_logits_max_abs_err=v["decode_logits_max_abs_err"],
                    first_token_identical=v["first_token_identical"],
                    logits_max_abs_err=v["logits_max_abs_err"],
                    peak_mem_gb=v["peak_mem_gb"])
                    for s, v in full.items()},
                gemm_column_max_abs_err=gemm_column_probe(),
                phase_s=time.perf_counter() - t_phase)
    emit(line)
    check(line["all_identical"],
          f"mesh engine (1, 1) tokens differ from EngineConfig()'s: {agree}")
    check(all(mesh["launches"][n] > 0
              for n in ("bgmv", "sgmv", "paged_attention"))
          and not any(mesh["plain"].values()),
          f"mesh engine (1, 1): a kernel of its path never launched or a "
          f"plain version ran: {mesh['launches']}, {mesh['plain']}")
    return mesh["launches"]


# ------------------------------------------------- phase 4, MoE engines
def _generated(eng) -> int:
    return sum(r.generated for r in eng.slot_req if r is not None)


def dev_us(e) -> float:
    """Device µs of a torch.profiler average (the name differs across
    PyTorch versions)."""
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0))


def decode_window(eng, vocab: int, n_steps: int = 3, top: int = 15,
                  adapters: int | None = None,
                  patience: int | None = None) -> dict:
    """Steady decode of one wave on a warmed, drained engine: one
    request a batch row (32-token prompts, 100 output tokens, every
    fourth seeded-sampled), on adapters 0 .. ``adapters`` - 1 in turn
    (default: one adapter a row). The engine steps until all are
    placed or, given ``patience``, until that many steps pass with no
    placement and no load in flight; requests the scheduler leaves
    queued then (the dense slab reserves each request's predicted
    length from the memory pool) are cancelled, so the window runs the
    fused horizon, not the horizon 1 of an engine with work queued. Every batch row decodes each step
    (rows without a request too), and ``rows_active`` of them emit.
    Once no load is in flight, one more step runs and the card is
    synchronised; then ``n_steps`` steps on the host clock, ending in a
    synchronise (``ms_per_decode_step``: wall over the tokens an active
    row decoded), and ``n_steps`` more under torch.profiler: the
    device's busy share of that window's wall time, launches, and the
    operations with the most device and host time. With pipelined
    readback each step drains the previous horizon, so a window's token
    count and its device work both cover ``n_steps`` horizons."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import Request, SamplingParams
    rng = np.random.default_rng(7)
    n_rows = eng.ecfg.max_slots
    handles = []
    for a in range(n_rows):
        sp = SamplingParams(temperature=0.8, seed=a) if a % 4 == 3 else None
        handles.append(eng.submit(
            Request(input_len=32, output_len=100,
                    adapter_id=a % (adapters or n_rows),
                    prompt=rng.integers(3, vocab, 32).tolist()),
            sampling=sp))
    last, stuck = -1, 0
    for _ in range(500):
        eng.step()
        if eng.sched.pending_count() == 0:
            break
        active = int(eng.active.sum())
        stuck = (stuck + 1 if active == last and not eng._pending_loads
                 else 0)
        last = active
        if patience is not None and stuck >= patience:
            break
    for h in handles:
        if not any(r is h.req for r in eng.slot_req):
            eng.cancel(h)
    active = int(eng.active.sum())
    check(active > 0 and eng.sched.pending_count() == 0,
          f"decode window: never reached a steady batch ({active} of "
          f"{n_rows} rows active, {eng.sched.pending_count()} pending)")
    eng.flush_loads()
    eng.step()
    torch.cuda.synchronize()
    gen0 = _generated(eng)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gen1 = _generated(eng)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    ptokens = _generated(eng) - gen1
    check(gen1 > gen0 and ptokens > 0,
          "decode window: no token decoded in a window")
    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    ops = [e for e in avgs if e.device_type == DeviceType.CPU]
    busy_us = sum(dev_us(e) for e in kernels)
    check(int(eng.active.sum()) == active,
          "decode window: a request finished inside the window")
    steps = ptokens / active
    return dict(
        rows=n_rows, rows_active=active, steps=n_steps,
        decode_tokens=gen1 - gen0, wall_s=wall,
        ms_per_decode_step=wall * 1e3 / ((gen1 - gen0) / active),
        profiled_decode_tokens=ptokens, profiled_wall_s=pwall,
        profiled_ms_per_decode_step=pwall * 1e3 / steps,
        device_busy_share=busy_us * 1e-6 / pwall,
        device_ms_per_decode_step=busy_us * 1e-3 / steps,
        launches=sum(e.count for e in kernels),
        top_device=[dict(name=e.key[:90], calls=e.count, us=dev_us(e))
                    for e in sorted(kernels, key=dev_us, reverse=True)[:top]],
        top_host=[dict(name=e.key[:60], calls=e.count,
                       self_cpu_us=e.self_cpu_time_total)
                  for e in sorted(ops, key=lambda e: e.self_cpu_time_total,
                                  reverse=True)[:top]])


#: qwen3-moe's 94 layers cut to 8 for one card: 42.3 GB of bf16
#: weights (142.6 MB of attention and 4.83 GB of experts a layer, 2.49
#: GB of embedding and head); every width is the published one.
MOE_LAYERS = 8
#: name: EngineConfig overrides of the MoE engines (``EngineConfig()``
#: serves MoE from the dense slab, so neither runs paged_attention).
MOE_ENGINES = {"moe": dict(), "moe_seed": dict(fused_hotloop=False)}


def moe_kernel_checks(cfg, record_to: dict) -> None:
    """bgmv, sgmv and flash_attention at the widths the MoE engine
    gives them (d 4096, q 8192 over 64 heads, k/v 512 over 4, so
    flash_attention groups 16 query heads a KV head), bf16, against
    their plain versions at phase 2's tolerances, then timed beside
    their bounds, their plain versions and a PyTorch call
    (``kernel_time_moe`` lines: gathered ``bmm`` pairs for the LoRA
    kernels, SDPA for flash_attention)."""
    import importlib

    import torch
    import torch.nn.functional as F
    bgmv = importlib.import_module("repro_torch.kernels.bgmv")
    sgmv = importlib.import_module("repro_torch.kernels.sgmv")
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    scratch = torch.empty(64 * MIB, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(torch.bfloat16)

    def checked(*args, **kw):
        checked_and_timed("kernel_time_moe", flush, record_to, *args, **kw)

    d, r, n_slots, Bt, S, tile = cfg.d_model, 32, 8, 8, 256, 128
    idx = torch.randperm(n_slots, generator=g, device=dev)[:Bt].int()
    ts = torch.randint(0, n_slots, (Bt * S // tile,), generator=g,
                       device=dev).int()
    for proj, din, dout in (("q", d, cfg.q_dim), ("k/v", d, cfg.kv_dim),
                            ("o", cfg.q_dim, d)):
        A = randn(n_slots, din, r, scale=din ** -0.5)
        Bw = randn(n_slots, r, dout, scale=r ** -0.5)
        x = randn(Bt, din)
        checked("bgmv", f"{proj}: x {tuple(x.shape)}, dout {dout}",
                lambda: bgmv.bgmv(x, A, Bw, idx),
                lambda: bgmv.bgmv_plain(x, A, Bw, idx),
                lambda: torch.bmm(torch.bmm(x[:, None], A[idx.long()]),
                                  Bw[idx.long()]), "lora_bf16",
                bound_ms(nbytes(x, idx) + idx.unique().numel()
                         * nbytes(A[0], Bw[0]) + Bt * dout * 2,
                         2 * Bt * r * (din + dout), "bf16"))
        x = randn(Bt * S, din)
        xt = x.view(-1, tile, din)
        sgmv.STATS.reset()
        sgmv.sgmv(x, A, Bw, ts, tile)
        inst = launched(sgmv, sgmv.sgmv_instance(x.dtype, A.dtype, r, tile))
        checked("sgmv", f"{proj}: x {tuple(x.shape)}, dout {dout}",
                lambda: sgmv.sgmv(x, A, Bw, ts, tile),
                lambda: sgmv.sgmv_plain(x, A, Bw, ts, tile),
                lambda: torch.bmm(torch.bmm(xt, A[ts.long()]),
                                  Bw[ts.long()]), "lora_bf16",
                bound_ms(nbytes(x, ts) + ts.unique().numel()
                         * nbytes(A[0], Bw[0]) + Bt * S * dout * 2,
                         2 * Bt * S * r * (din + dout), "bf16"),
                instance=inst)
    H, Kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = randn(Bt, S, H, dh)
    k, v = randn(Bt, S, Kh, dh), randn(Bt, S, Kh, dh)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fa.STATS.reset()
    fa.flash_attention(q, k, v, True)
    inst = launched(fa, fa.flash_instance(q.dtype, dh))
    checked("flash_attention", f"causal, H {H}/Kh {Kh}, q {tuple(q.shape)}",
            lambda: fa.flash_attention(q, k, v, True),
            lambda: fa.flash_attention_plain(q, k, v, True),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), "bf16_out",
            flash_bound(q, k, v, True),
            extra=FLASH_P_ROUNDING * fa.flash_attention_plain(
                q.float(), k.float(), v.float().abs(), True),
            instance=inst)


def checked_and_timed(phase: str, flush, record_to: dict, name: str,
                      case: str, call, plain, library, tol: str,
                      bound: tuple, extra=None, **info) -> dict:
    """One kernel call held to its plain version (``TOL[tol]``, plus a
    per-element ``extra`` allowance), then timed beside its plain
    version, a PyTorch call (``library``) and its ``bound``; one
    ``phase`` line. ``record_to[name]`` keeps the largest error.
    Returns the line."""
    import torch
    got = call()
    torch.cuda.synchronize()
    want = plain()
    atol, rtol = TOL[tol]
    diff = (got.float() - want.float()).abs()
    allowed = atol + rtol * want.float().abs()
    if extra is not None:
        allowed = allowed + extra
    err = diff.max().item()
    ok = bool((diff <= allowed).all())
    line = dict(phase=phase, kernel=name, case=case, max_abs_err=err,
                atol=atol, rtol=rtol, ok=ok, ms=median_ms(call, flush),
                plain_ms=median_ms(plain, flush),
                library_ms=median_ms(library, flush),
                bound_ms=bound[0], bound_by=bound[1], **info)
    emit(line)
    check(ok, f"{name} [{case}] disagrees with its plain version: max "
              f"abs err {err}")
    record_to[name] = max(record_to.get(name, 0.0), err)
    return line


def decode_step_bound(cfg, params, experts_per_layer: float) -> tuple:
    """Least time of one decode step by bytes: every attention, norm
    and router weight, ``experts_per_layer`` experts of each MoE layer
    and the head read once (the embedding rows, KV and LoRA slots are
    under 1 % and left out). Returns (bound ms, GB)."""
    n_moe = params["moe/w_gate"].shape[0]
    expert = sum(params[f"moe/{w}"][0, 0].numel()
                 for w in ("w_gate", "w_up", "w_down")) * 2
    dense = sum(nbytes(v) for k, v in params.items()
                if not k.startswith("moe/w_") and k != "embed/tok")
    if cfg.tie_embeddings:
        dense += nbytes(params["embed/tok"])
    total = dense + n_moe * experts_per_layer * expert
    return total / HBM_BYTES_PER_S * 1e3, total / 1e9


def prefill_bound(cfg, params, B: int, S: int) -> tuple:
    """Least time of one (B, S) whole-prompt prefill call: every weight
    read once against the operations of the projections, the capacity
    buckets' expert products (E x C rows a layer), causal attention and
    the head on the last positions, at the bf16 peak. Returns (ms,
    bound_by, GB, TFLOP)."""
    from repro_torch.models.moe import _capacity
    T = B * S
    E, F, D = cfg.n_experts, cfg.d_ff_expert, cfg.d_model
    Tg = min(2048, T)
    cap = _capacity(Tg, E, cfg.top_k, cfg.capacity_factor)
    per_layer = (2 * T * D * (2 * cfg.q_dim + 2 * cfg.kv_dim)
                 + 2 * 3 * E * (T // Tg) * cap * D * F
                 + 4 * B * cfg.n_heads * cfg.head_dim * S * (S + 1) // 2)
    flops = cfg.n_layers * per_layer + 2 * B * D * cfg.vocab_size
    n_bytes = sum(nbytes(v) for v in params.values())
    ms, by = bound_ms(n_bytes, flops, "bf16")
    return ms, by, n_bytes / 1e9, flops / 1e12


def time_prefill_moe(cfg, params, reps: int = 5) -> dict:
    """One whole-prompt (8, 256) ``api.prefill`` call with kernel LoRA
    over 8 bf16 adapter slots, every position a random token (no
    padding): median ms of ``reps`` calls after one warm-up (CUDA
    events, card idle before each), the share of its assignments
    dropped over capacity, and one more call under torch.profiler: its
    device time, launches and the kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import api, moe
    from repro_torch.models.lora_apply import (init_lora_slots,
                                               random_lora_weights,
                                               write_adapter_to_slot)
    B, S, r = 8, 256, 32
    gen = torch.Generator(device="cuda").manual_seed(17)
    slots = init_lora_slots(B, cfg.n_layers, cfg.d_model, cfg.q_dim,
                            cfg.kv_dim, r)
    for i in range(B):
        write_adapter_to_slot(slots, random_lora_weights(
            gen, r, r, cfg.n_layers, cfg.d_model, cfg.q_dim, cfg.kv_dim),
            i)
    toks = torch.randint(3, min(32000, cfg.vocab_size), (B, S),
                         generator=gen, device="cuda").int()
    kw = dict(lora=slots, adapter_idx=torch.arange(B, device="cuda").int(),
              last_pos=torch.full((B,), S - 1, device="cuda").int(),
              lora_backend="kernel")
    api.prefill(cfg, params, toks, **kw)
    times = []
    for _ in range(reps):
        moe.STATS.reset()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        api.prefill(cfg, params, toks, **kw)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    dropped_share = moe.STATS.dropped / moe.STATS.assignments
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        api.prefill(cfg, params, toks, **kw)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    return dict(ms=statistics.median(times), ms_all=times,
                dropped_share=dropped_share,
                profiled_device_ms=sum(dev_us(e) for e in kernels) / 1e3,
                profiled_launches=sum(e.count for e in kernels),
                top_device=[dict(name=e.key[:90], calls=e.count,
                                 us=dev_us(e))
                            for e in sorted(kernels, key=dev_us,
                                            reverse=True)[:12]])


def phase_engine_moe(trace_vocab: int, greedy: list) -> None:
    """``qwen3-moe-235b-a22b`` at its published widths (d 4096, 64/4
    heads, Dh 128, 128 experts top-8, d_ff_expert 1536, V 151936,
    qk-norm, rope theta 1e6), ``MOE_LAYERS`` layers, seeded bf16
    weights drawn on the card, served by each engine of
    ``MOE_ENGINES`` in turn over the phase-4 trace (its token ids lie
    in the first ``trace_vocab`` ids). The kernels are first checked at
    the MoE widths (``moe_kernel_checks``) and one (8, 256) prefill
    call timed (``time_prefill_moe``)."""
    import dataclasses
    import importlib

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api, moe
    from repro_torch.models.lora_apply import EINSUM
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.systems import build_engine
    full = get_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    errs = {}
    moe_kernel_checks(cfg, errs)
    prefill_call = time_prefill_moe(cfg, params)
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in KERNELS}
    ecfg = EngineConfig()
    results = {}
    for name, knobs in MOE_ENGINES.items():
        eng = build_engine("chameleon", cfg, params, EngineConfig(**knobs))
        check(not eng.paged and eng.kv_pages is None and eng.prefix is None,
              f"{name}: an MoE engine must serve from the dense slab")
        warm_up(eng, trace_vocab)
        trace = make_trace(trace_vocab)
        torch.cuda.reset_peak_memory_stats()
        for st in stats.values():
            st.reset()
        EINSUM.reset()
        moe.STATS.reset()
        with PrefillTimer() as timer:
            res = serve(eng, trace)                   # this engine's path
        launches = {n: st.launches for n, st in stats.items()}
        instances = {n: dict(st.instances) for n, st in stats.items()}
        plain = {n: st.plain for n, st in stats.items()}
        ms = moe.STATS
        res.update(timer.summary())
        res.update(
            paged=eng.paged, launches=launches,
            launches_by_instance=instances, plain_calls=plain,
            einsum_calls=EINSUM.calls,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            prefill_assignments=ms.assignments,
            prefill_dropped=ms.dropped,
            prefill_dropped_share=ms.dropped / max(ms.assignments, 1),
            experts_per_layer_per_decode_step=(
                ms.experts_read / max(ms.gather_calls, 1)),
            completed=eng.stats()["completed"])
        toks = [h.tokens for h in res.pop("handles")]
        res["outputs"] = toks
        check(res["completed"] == len(trace)
              and all(len(t) == r.output_len
                      for t, (r, _) in zip(toks, trace)),
              f"{name}: a request did not complete to its output length")
        check(all(0 <= x < cfg.vocab_size for t in toks for x in t),
              f"{name}: token id outside the vocabulary")
        check(all(launches[n] > 0 for n in MOE_PATH)
              and launches["paged_attention"] == 0,
              f"{name}: launches {launches}: bgmv, sgmv and "
              f"flash_attention must launch, paged_attention not")
        for n in ("sgmv", "flash_attention"):
            check(set(instances[n]) == {"tensor_cores"},
                  f"{name}: {n} launched {instances[n]}, expected the "
                  f"tensor-core instance only")
        check(not any(plain.values()) and res["einsum_calls"] == 0,
              f"{name}: a plain/einsum path ran on the card: {plain}, "
              f"einsum {res['einsum_calls']}")
        # The steady window: its own routing counts, after the trace's.
        moe.STATS.reset()
        # The pool holds about four of this model's adapters beside the
        # requests (4 KV heads and 8 layers make a token's KV small
        # against an adapter's 17 MB): two adapters for the 8 rows, and
        # the rows the slab's reservation admits.
        win = decode_window(eng, trace_vocab, adapters=2, patience=8)
        win["experts_per_layer_per_decode_step"] = (
            moe.STATS.experts_read / max(moe.STATS.gather_calls, 1))
        win["bound_ms"], win["bound_gb"] = decode_step_bound(
            cfg, params, win["experts_per_layer_per_decode_step"])
        res["decode_window"] = win
        results[name] = res
        pb = prefill_bound(cfg, params, 8, 256)
        emit(dict(phase="engine_moe", engine=name, knobs=knobs,
                  model=cfg.name, n_layers=cfg.n_layers,
                  d_model=cfg.d_model, n_experts=cfg.n_experts,
                  top_k=cfg.top_k, d_ff_expert=cfg.d_ff_expert,
                  vocab_size=cfg.vocab_size, weights="bf16",
                  weights_gb=sum(nbytes(v) for v in params.values()) / 1e9,
                  init_params_s=init_s,
                  reduced=[f"n_layers {full.n_layers} -> {cfg.n_layers}"],
                  ecfg=dict(max_slots=ecfg.max_slots, max_len=ecfg.max_len,
                            n_lora_slots=ecfg.n_lora_slots,
                            r_max=ecfg.r_max, n_adapters=ecfg.n_adapters,
                            max_horizon=ecfg.max_horizon),
                  prefill_8x256=dict(prefill_call, bound_ms=pb[0],
                                     bound_by=pb[1], bound_gb=pb[2],
                                     bound_tflop=pb[3]),
                  kernel_max_abs_err_at_moe_widths=errs,
                  **{k: v for k, v in res.items() if k != "outputs"}))
        del eng, trace, toks
        gc.collect()
        torch.cuda.empty_cache()
    emit(dict(phase="engine_moe_ab", greedy_requests=len(greedy),
              greedy_moe_vs_moe_seed=greedy_agreement(
                  results["moe"]["outputs"], results["moe_seed"]["outputs"],
                  greedy),
              decode_tok_per_s={n: r["decode_tok_per_s"]
                                for n, r in results.items()},
              ms_per_decode_step={
                  n: r["decode_window"]["ms_per_decode_step"]
                  for n, r in results.items()}))
    del results
    gc.collect()
    torch.cuda.empty_cache()
    phase_mesh_moe(cfg, params, trace_vocab, greedy)


# --------------------------------------------- phase 4b, MoE on meshes
#: Mesh shapes of the MoE step-function sweep, over repeated positions
#: of the card: (1, 1) must equal the unsharded functions bit for bit;
#: (2, 1) splits the experts over two data shards, (1, 2) the heads,
#: the shared FFN and the vocabulary over two columns, (2, 2) both.
MOE_MESH_SHAPES = ((1, 1), (2, 1), (1, 2), (2, 2))
#: Data-shard counts of the all-to-all layer check.
MOE_A2A_SHAPES = ((2, 1), (4, 1))
#: Engines of the MoE mesh trace: name -> mesh_shape.
MOE_MESH_ENGINES = {"fused": None, "mesh_1x1": (1, 1), "mesh_2x1": (2, 1)}


def write_prompt_slab(kv, k, v, mp) -> None:
    """The whole-prompt prefill's K/V (unsharded stacks, or the mesh's
    placed stacks) into the first positions of every row of the slab
    ``kv`` (plain tensors, or sharded in ``ShardPlan`` placement)."""
    S = k.shape[2]
    for st, new in zip(kv, (k, v)):
        if mp is None:
            st[:, :, :S] = new.to(st.dtype)
            continue
        full = st.full()
        full[:, :, :S] = new.full().to(full.device, full.dtype)
        st.copy_(full)


def moe_mesh_steps(cfg, params, inp, shape, n_steps: int = 8) -> dict:
    """The MoE step functions as the engine runs them: a whole-prompt
    ``prefill`` of the right-padded prompts (flash_attention, sgmv,
    capacity buckets), its K/V copied into an f32 slab, one
    ``decode_step`` and two fused greedy horizons of ``n_steps`` steps
    over the slab (the second timed): unsharded (``shape`` None) or with
    the weights, the LoRA arena and the slab placed by ``ShardPlan`` on
    a mesh of ``shape`` over repeated positions of the card."""
    import torch
    from repro_torch.distributed.sharding import MeshParams
    from repro_torch.models import api
    from repro_torch.serving.shard_plan import ShardPlan
    dev = inp["toks"].device
    B, S = inp["toks"].shape
    Smax = S + 4 * n_steps
    slab = (cfg.n_layers, B, Smax, cfg.n_kv_heads, cfg.head_dim)
    if shape is None:
        p, lora, mp = params, inp["lora"], None
        kv = api.init_serve_state(cfg, B, Smax, torch.float32, device=dev)
    else:
        mesh = repeated_mesh(shape, dev)
        plan = ShardPlan(mesh, cfg)
        sh = plan.params(params)
        p = mp = MeshParams(cfg, {k: plan.put(v, sh[k])
                                  for k, v in params.items()}, mesh)
        lsh = plan.lora_slots(inp["lora"])
        lora = {k: (plan.put(a, lsh[k][0]), plan.put(b, lsh[k][1]))
                for k, (a, b) in inp["lora"].items()}
        kv = tuple(plan.zeros_kv_dense(slab, torch.float32)
                   for _ in range(2))
    kw = dict(lora=lora, adapter_idx=inp["aidx"], lora_backend="kernel")
    i32 = torch.int32
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, (k, v) = api.prefill(cfg, p, inp["toks"],
                                 last_pos=inp["seq_len"] - 1, **kw)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    write_prompt_slab(kv, k, v, mp)
    del k, v
    tokens = torch.argmax(logits, dim=-1).to(i32)[:, None]
    first = tokens[:, 0].clone()
    step, kv = api.decode_step(cfg, p, tokens, kv, inp["seq_len"], **kw)
    state = dict(cache_len=inp["seq_len"].clone(),
                 active=torch.ones(B, dtype=torch.bool, device=dev),
                 positions=torch.ones(B, dtype=i32, device=dev))
    fixed = (torch.full((B,), 1 << 20, dtype=i32, device=dev),
             torch.zeros((B, 0), dtype=i32, device=dev),
             torch.zeros(B, device=dev), torch.zeros(B, dtype=i32,
                                                     device=dev),
             torch.ones(B, device=dev),
             torch.zeros(B, dtype=torch.int64, device=dev))
    blocks, ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, toks, _ = api.decode_fused(
            cfg, p, tokens, kv, state["cache_len"], state["active"],
            state["positions"], *fixed, n_steps=n_steps, all_greedy=True,
            max_ctx=Smax, **kw)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / n_steps)
        tokens, kv, state["cache_len"], state["active"], \
            state["positions"] = carry
        blocks.append(toks)
    return dict(logits=logits.float(), first=first, step=step.float(),
                toks=torch.cat(blocks).T.cpu(), prefill_ms=prefill_ms,
                decode_ms_per_step=ms[1])


def moe_mesh_sweep(cfg, params, inp, tol: float) -> None:
    """``moe_mesh_steps`` unsharded, at each of ``MOE_MESH_SHAPES``, and
    unsharded again (``mesh_moe_steps`` lines). The meshes with whole
    columns, (1, 1) and (2, 1) (experts split over "data", the same
    products a block of experts at a time), must equal the unsharded
    functions bit for bit: prefill and decode logits and every greedy
    token. The column splits must hold the prefill logits within
    ``tol`` and are read for first-token and greedy agreement and the
    decode logits' error. bgmv, sgmv and
    flash_attention must launch, on tensor cores, and no plain
    version, einsum LoRA or paged_attention may run."""
    import importlib

    import torch
    from repro_torch.models import moe
    from repro_torch.models.lora_apply import EINSUM
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in KERNELS}
    base = moe_mesh_steps(cfg, params, inp, None)
    runs = {}
    for shape in MOE_MESH_SHAPES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for st in stats.values():
            st.reset()
        EINSUM.reset()
        moe.STATS.reset()
        got = moe_mesh_steps(cfg, params, inp, shape)
        got.update(launches={n: st.launches for n, st in stats.items()},
                   instances={n: dict(st.instances)
                              for n, st in stats.items()},
                   plain={n: st.plain for n, st in stats.items()},
                   einsum=EINSUM.calls, dropped=moe.STATS.dropped,
                   peak=torch.cuda.max_memory_allocated() / 1e9)
        runs[shape] = got
    again = moe_mesh_steps(cfg, params, inp, None)
    rows = base["toks"].shape[0]
    for shape, got in runs.items():
        err = (got["logits"] - base["logits"]).abs().max().item()
        step_err = (got["step"] - base["step"]).abs().max().item()
        launches = got["launches"]
        line = dict(
            phase="mesh_moe_steps", model=cfg.name, weights="bf16",
            mesh_shape=list(shape), n_layers=cfg.n_layers,
            reduced=[f"n_layers 94 -> {cfg.n_layers}"],
            prefill_shape=list(inp["toks"].shape), rows=rows,
            logits_max_abs_err=err, tol=0.0 if shape[1] == 1 else tol,
            decode_logits_max_abs_err=step_err,
            first_token_identical=int((got["first"] == base["first"])
                                      .sum().item()),
            greedy_identical=sum(bool(torch.equal(a, b)) for a, b in
                                 zip(got["toks"], base["toks"])),
            greedy_tokens_identical=int((got["toks"] == base["toks"])
                                        .sum().item()),
            greedy_tokens=int(base["toks"].numel()),
            finite=bool(torch.isfinite(got["logits"]).all()),
            prefill_ms=got["prefill_ms"],
            prefill_ms_unsharded=[base["prefill_ms"], again["prefill_ms"]],
            decode_ms_per_step=got["decode_ms_per_step"],
            decode_ms_per_step_unsharded=[base["decode_ms_per_step"],
                                          again["decode_ms_per_step"]],
            prefill_dropped=got["dropped"], peak_mem_gb=got["peak"],
            launches=launches, launches_by_instance=got["instances"],
            plain_calls=got["plain"], einsum_calls=got["einsum"])
        emit(line)
        check(line["finite"], f"mesh_moe_steps {shape}: non-finite logits")
        if shape[1] == 1:
            check(err == 0.0 and step_err == 0.0
                  and line["greedy_identical"] == rows,
                  f"mesh_moe_steps {shape} differs from the unsharded step "
                  f"functions: {line}")
        else:
            check(err <= tol, f"mesh_moe_steps {shape}: prefill logits off "
                              f"by {err} > {tol}")
        check(all(launches[n] > 0 for n in MOE_PATH)
              and launches["paged_attention"] == 0
              and all(set(got["instances"][n]) == {"tensor_cores"}
                      for n in ("sgmv", "flash_attention"))
              and not any(got["plain"].values()) and got["einsum"] == 0,
              f"mesh_moe_steps {shape}: a kernel of the path never "
              f"launched, or another instance, a plain version, the "
              f"einsum LoRA or paged_attention ran: {line}")


def moe_a2a_layer(cfg, params) -> None:
    """One MoE layer (layer 0's router and experts) over (8, 256)
    tokens of normal hidden states, bf16: ``moe_block_a2a`` at each of
    ``MOE_A2A_SHAPES`` over repeated positions of the card against
    ``moe_block`` run on each batch shard (the same group-local
    capacity, so the same drops), within a few bf16 ulps of the largest
    output; timed beside the per-shard blocks and the unsharded
    ``moe_block`` (``mesh_moe_a2a`` lines)."""
    import torch
    from repro_torch.models.moe import moe_block
    from repro_torch.models.moe_shard_map import moe_block_a2a
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(99)
    x = torch.randn((8, 256, cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    w = [params[f"moe/{n}"][0] for n in ("router", "w_gate", "w_up",
                                         "w_down")]
    K, cf = cfg.top_k, cfg.capacity_factor
    scratch = torch.empty(64 * MIB, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    whole_ms = median_ms(lambda: moe_block(x, *w, K, cf), flush, 1, 5)
    for shape in MOE_A2A_SHAPES:
        n = shape[0]
        mesh = repeated_mesh(shape, dev)

        blocks = [list(t.chunk(n)) for t in w[1:]]

        def a2a():
            return moe_block_a2a(x, w[0], *blocks, K, cf, mesh)[0]

        def per_shard():
            return torch.cat([moe_block(xs, *w, K, cf)[0]
                              for xs in x.chunk(n)])
        got, want = a2a(), per_shard()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = 2 ** -6 * scale
        line = dict(phase="mesh_moe_a2a", model=cfg.name,
                    mesh_shape=list(shape), tokens=[8, 256],
                    max_abs_err=err, max_abs_want=scale, tol=tol,
                    bitwise_equal=bool(torch.equal(got, want)),
                    ms=median_ms(a2a, flush, 1, 5),
                    per_shard_moe_block_ms=median_ms(per_shard, flush, 1, 5),
                    unsharded_moe_block_ms=whole_ms)
        emit(line)
        check(bool(torch.isfinite(got).all()) and err <= tol,
              f"mesh_moe_a2a {shape}: off the per-shard moe_block: {line}")


@contextlib.contextmanager
def repeated_positions():
    """Engines built inside resolve ``EngineConfig.mesh_shape`` to a mesh
    over repeated positions of the card (``repeated_mesh``), so a
    split mesh fits on one card; the engine code is unchanged."""
    import torch
    from repro_torch.serving import engine
    make = engine.make_serving_mesh
    card = torch.device("cuda", torch.cuda.current_device())
    engine.make_serving_mesh = lambda n, m, device=None: repeated_mesh(
        (n // m, m), card)
    try:
        yield
    finally:
        engine.make_serving_mesh = make


def moe_mesh_engines(cfg, params, trace_vocab: int, greedy: list) -> None:
    """The phase-4 trace served by ``EngineConfig()`` and by
    ``EngineConfig(mesh_shape=...)`` at each of ``MOE_MESH_ENGINES`` on
    one step clock, adapter loads landed before each step, so the
    schedules agree (one ``mesh_moe_engine`` line): (1, 1) and (2, 1)
    must give ``EngineConfig()``'s tokens; (2, 1) splits the experts
    over two data shards at repeated positions of the card
    (``repeated_positions``). Host ms a
    step, peak memory, shard gauges and launches; bgmv, sgmv and
    flash_attention must launch on tensor cores, and no plain version,
    einsum LoRA or paged_attention may run."""
    import importlib

    import torch
    from repro_torch.kernels.ops import COLLECTIVE_METER
    from repro_torch.models import moe
    from repro_torch.models.lora_apply import EINSUM
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.systems import build_engine
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in KERNELS}
    served = {}
    trace = make_trace(trace_vocab)
    for name, shape in MOE_MESH_ENGINES.items():
        clock = [0.0]
        with repeated_positions():
            eng = build_engine("chameleon", cfg, params,
                               EngineConfig(mesh_shape=shape),
                               clock=lambda: clock[0])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for st in stats.values():
            st.reset()
        EINSUM.reset()
        moe.STATS.reset()
        COLLECTIVE_METER.reset()
        handles = [eng.submit(r, sampling=sp) for r, sp in
                   make_trace(trace_vocab)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = 0
        while eng.busy() and steps < 20_000:
            for stream in eng._load_streams.values():
                stream.synchronize()
            eng.step()
            clock[0] += 0.01
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(not eng.busy(), f"MoE mesh engine {name} failed to drain")
        toks = [h.tokens for h in handles]
        launches = {n: st.launches for n, st in stats.items()}
        instances = {n: dict(st.instances) for n, st in stats.items()}
        plain = {n: st.plain for n, st in stats.items()}
        served[name] = dict(
            outputs=toks, steps=steps, wall_s=wall,
            ms_per_step=wall * 1e3 / steps,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=launches, instances=instances, plain=plain,
            einsum=EINSUM.calls, dropped=moe.STATS.dropped,
            gathers_per_dispatch=(COLLECTIVE_METER.gathers
                                  / max(COLLECTIVE_METER.dispatches, 1)),
            shard_stats=eng.shard_stats())
        check(all(len(t) == r.output_len for t, (r, _) in zip(toks, trace))
              and all(0 <= x < cfg.vocab_size for t in toks for x in t),
              f"MoE mesh engine {name}: short output or token outside "
              f"the vocabulary")
        check(all(launches[n] > 0 for n in MOE_PATH)
              and launches["paged_attention"] == 0
              and all(set(instances[n]) == {"tensor_cores"}
                      for n in ("sgmv", "flash_attention"))
              and not any(plain.values()) and EINSUM.calls == 0,
              f"MoE mesh engine {name}: a kernel of the path never "
              f"launched, or another instance, a plain version, the "
              f"einsum LoRA or paged_attention ran: {launches}, "
              f"{instances}, {plain}, einsum {EINSUM.calls}")
        del eng, handles
        gc.collect()
        torch.cuda.empty_cache()
    base = served["fused"]
    line = dict(phase="mesh_moe_engine", model=cfg.name, weights="bf16",
                requests=len(trace),
                reduced=[f"n_layers 94 -> {cfg.n_layers}"],
                identical_1x1=(served["mesh_1x1"]["outputs"]
                               == base["outputs"]),
                identical_2x1=(served["mesh_2x1"]["outputs"]
                               == base["outputs"]),
                greedy_vs_unsharded={
                    n: greedy_agreement(r["outputs"], base["outputs"],
                                        greedy)
                    for n, r in served.items() if n != "fused"},
                **{n: {k: v for k, v in r.items() if k != "outputs"}
                   for n, r in served.items()})
    emit(line)
    check(line["identical_1x1"] and line["identical_2x1"],
          f"MoE mesh engine (1, 1) or (2, 1) tokens differ from "
          f"EngineConfig()'s: {line['greedy_vs_unsharded']}")


def phase_mesh_moe(cfg, params, trace_vocab: int, greedy: list) -> None:
    """The MoE family on meshes over repeated positions of the card,
    while ``qwen3-moe`` (``MOE_LAYERS`` layers, published widths) is
    loaded: the kernels at one column's shapes
    (``kernel_time_mesh_moe``), the step functions
    (``moe_mesh_sweep``), the all-to-all layer (``moe_a2a_layer``) and
    the trace through the engine (``moe_mesh_engines``); one
    ``phase_mesh_moe`` line with each part's seconds."""
    import torch
    secs = {}
    t = time.perf_counter()
    errs = {}
    M = 2
    mesh_kernel_checks(cfg, errs, phase="kernel_time_mesh_moe",
                       projs=(("q", cfg.d_model, cfg.q_dim // M),
                              ("k/v", cfg.d_model, cfg.kv_dim // M)),
                       paged=False)
    secs["kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    prompts = [r.prompt for r, _ in make_trace(trace_vocab)[:8]]
    # bf16: a layout fault moves logits by their own scale (about 1).
    moe_mesh_sweep(cfg, params, mesh_inputs(cfg, prompts,
                                            torch.device("cuda"), 9,
                                            torch.bfloat16), 2 ** -4)
    secs["steps"] = time.perf_counter() - t
    t = time.perf_counter()
    moe_a2a_layer(cfg, params)
    secs["a2a"] = time.perf_counter() - t
    t = time.perf_counter()
    moe_mesh_engines(cfg, params, trace_vocab, greedy)
    secs["engines"] = time.perf_counter() - t
    emit(dict(phase="phase_mesh_moe", seconds=secs,
              kernel_max_abs_err_at_column_shapes=errs))


# ------------------------------------------- phases 3 and 6, families
#: Configs of the families served by model functions only (no engine),
#: and the kernels each one's model path runs on the card: the SSM's
#: scans are plain PyTorch (no TPU kernel), the hybrid's shared block
#: runs flash_attention and its LoRA sgmv (prefill) and bgmv (decode),
#: whisper's encoder and decoder prefill run flash_attention.
FAMILIES = {"falcon-mamba-7b": (),
            "zamba2-1.2b": ("flash_attention", "sgmv", "bgmv"),
            "whisper-base": ("flash_attention",)}


def family_lora(cfg, n_slots: int, r_max: int, dtype, device, seed: int):
    """LoRA slots of the hybrid's shared block, stacks of (n_sites,
    n_slots, din, r_max), each slot one random adapter of rank
    ``cfg.lora_ranks[i % ...]`` (zero-padded to ``r_max``)."""
    import torch
    from repro_torch.models import hybrid
    from repro_torch.models.lora_apply import (init_lora_slots,
                                               random_lora_weights,
                                               write_adapter_to_slot)
    n_sites = len(hybrid.attn_sites(cfg))
    slots = init_lora_slots(n_slots, n_sites, cfg.d_model, cfg.q_dim,
                            cfg.kv_dim, r_max, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for i in range(n_slots):
        rank = min(cfg.lora_ranks[i % len(cfg.lora_ranks)], r_max)
        write_adapter_to_slot(slots, random_lora_weights(
            gen, rank, r_max, n_sites, cfg.d_model, cfg.q_dim, cfg.kv_dim,
            dtype=dtype), i)
    return slots


def family_inputs(cfg, B: int, S: int, seed: int, dtype, device):
    """(tokens (B, S) int32, extra model kwargs): enc-dec takes
    ``frames`` (B, enc_ctx, D) of random encoder embeddings."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=device).int()
    kw = {}
    if cfg.family.name == "ENCDEC":
        kw["frames"] = torch.randn((B, cfg.enc_ctx, cfg.d_model),
                                   generator=gen, device=device).to(dtype)
    return toks, kw


def serve_family(cfg, params, toks, kw, n_decode: int, feed=None,
                 lora=None, idx=None, backend: str = "einsum"):
    """Prefill ``toks``, then ``n_decode`` decode steps, each fed the
    next token of ``feed`` (B, n_decode) or, without it, the argmax of
    the last logits. K/V slabs get ``n_decode`` free positions. Returns
    dict(last, state (prefill), steps [logits], state (after), fed)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import api
    B, S = toks.shape
    pkw = dict(kw)
    if cfg.family.name == "HYBRID":
        pkw.update(kv_max_len=S + n_decode, lora=lora, adapter_idx=idx,
                   lora_backend=backend)
    with torch.no_grad():
        last, state = api.prefill(cfg, params, toks, **pkw)
        pre = [t.clone() for t in flat(state)]
        if cfg.family.name == "ENCDEC":
            (k, v), cross = state
            state = ((F.pad(k, (0, 0, 0, 0, 0, n_decode)),
                      F.pad(v, (0, 0, 0, 0, 0, n_decode))), cross)
        dkw = (dict(lora=lora, adapter_idx=idx, lora_backend=backend)
               if cfg.family.name == "HYBRID" else {})
        logits, steps, fed = last, [], []
        for i in range(n_decode):
            tok = (feed[:, i:i + 1] if feed is not None
                   else logits.argmax(-1)[:, None].int())
            fed.append(tok)
            clen = torch.full((B,), S + i, dtype=torch.int32,
                              device=toks.device)
            logits, state = api.decode_step(cfg, params, tok, state, clen,
                                            **dkw)
            steps.append(logits)
    return dict(last=last, prefill_state=pre, steps=steps,
                state=flat(state), fed=torch.cat(fed, 1))


def flat(state) -> list:
    """The tensors of a serve state, depth first."""
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in flat(s)]
    return [state]


def phase_parity_families() -> None:
    """The families without an engine at ``.reduced()`` in f32, the card
    (kernels) against the CPU (plain versions) on the same weights:
    ``forward`` logits, ``train_loss``, ``prefill`` last logits and
    state, 4 ``decode_step``s fed the CPU's greedy tokens (logits and
    state); S = 16 and, for the scans, S = 70 (three chunks of 32, the
    last padded). The hybrid's LoRA runs through the kernels
    (``lora_backend="kernel"``). Within 1e-4 (``TOL["f32"]``); on the
    card each family's kernels launch and no plain version runs."""
    import importlib

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in KERNELS}
    atol, rtol = TOL["f32"]
    bad = []
    for name, path in FAMILIES.items():
        cfg = get_config(name).reduced()
        params = api.init_params(cfg, 0, torch.float32, device="cpu")
        lora = (family_lora(cfg, 3, 8, torch.float32, "cpu", 5)
                if path and "sgmv" in path else None)
        for S in ((16, 70) if cfg.ssm_version else (16,)):
            toks, kw = family_inputs(cfg, 2, S, 6, torch.float32, "cpu")
            idx = torch.tensor([2, 0], dtype=torch.int32)
            labels = toks.roll(-1, 1)
            out, feed = {}, None
            for dev in ("cpu", "cuda"):
                mv = {k: v.to(dev) for k, v in params.items()}
                lr = ({k: (a.to(dev), b.to(dev)) for k, (a, b) in
                       lora.items()} if lora is not None else None)
                t, k = toks.to(dev), {n: v.to(dev) for n, v in kw.items()}
                for st in stats.values():
                    st.reset()
                with torch.no_grad():
                    logits = api.forward(cfg, mv, t, **k)
                    loss = api.train_loss(cfg, mv, t, labels.to(dev), **k)
                res = serve_family(cfg, mv, t, k, 4, feed=feed, lora=lr,
                                   idx=idx.to(dev), backend="kernel")
                feed = res["fed"].to("cuda")
                out[dev] = dict(
                    tensors=[x.cpu() for x in (
                        logits, loss, res["last"], *res["prefill_state"],
                        *res["steps"], *res["state"])],
                    launches={n: s.launches for n, s in stats.items()},
                    plain={n: s.plain for n, s in stats.items()})
            cpu, card = out["cpu"], out["cuda"]
            errs, ok = [], True
            for a, b in zip(card["tensors"], cpu["tensors"]):
                diff = (a.float() - b.float()).abs()
                errs.append(diff.max().item() if diff.numel() else 0.0)
                ok &= bool(torch.isfinite(a).all()) and bool(
                    (diff <= atol + rtol * b.float().abs()).all())
            ok &= (all(card["launches"][n] > 0 for n in path)
                   and not any(card["plain"].values()))
            line = dict(phase="parity_family", model=name, S=S,
                        weights="f32", lora="kernel" if lora else None,
                        forward_logits_err=errs[0], train_loss_err=errs[1],
                        prefill_logits_err=errs[2],
                        max_state_and_decode_err=max(errs[3:]),
                        atol=atol, rtol=rtol, launches=card["launches"],
                        ok=ok)
            emit(line)
            if not ok:
                bad.append((name, S))
    check(not bad, f"card vs CPU family parity failed: {bad}")


def state_bytes(state, rows: int) -> dict:
    """Bytes of a serve state's tensors per batch row, by kind."""
    return {k: nbytes(t) / rows for k, t in state.items()}


def decode_timed(cfg, params, tok, state, S: int, n: int, dkw: dict,
                 n_prof: int = 3):
    """``n`` greedy decode steps from ``tok`` on the host clock (one
    synchronise at the end), then ``n_prof`` more under torch.profiler.
    Returns (ms a step, step logits list (the first ``n``), final state,
    tokens (B, n), profile: launches, device ms and busy share a step,
    the operations with the most device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import api
    B = tok.shape[0]
    steps, toks = [], []

    def run(i, tok, state):
        clen = torch.full((B,), S + i, dtype=torch.int32, device="cuda")
        logits, state = api.decode_step(cfg, params, tok, state, clen,
                                        **dkw)
        return logits, state, logits.argmax(-1)[:, None].int()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(n):
            toks.append(tok)
            logits, state, tok = run(i, tok, state)
            steps.append(logits)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as pr:
        t0 = time.perf_counter()
        for i in range(n, n + n_prof):
            logits, state, tok = run(i, tok, state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in pr.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in kernels)
    prof = dict(steps=n_prof, ms_per_step=wall * 1e3 / n_prof,
                launches_per_step=sum(e.count for e in kernels) / n_prof,
                device_ms_per_step=busy_us * 1e-3 / n_prof,
                device_busy_share=busy_us * 1e-6 / wall,
                top_device=[dict(name=e.key[:70], calls=e.count,
                                 us=dev_us(e))
                            for e in sorted(kernels, key=dev_us,
                                            reverse=True)[:6]])
    return ms, steps, state, torch.cat(toks, 1), prof


def timed_call(fn):
    """(result, ms on the host clock with the card synchronised before
    and after, ms between CUDA events around the call)."""
    import torch
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, s.elapsed_time(e)


def family_params(name: str):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    cfg = get_config(name)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n = sum(v.numel() for v in params.values())
    return cfg, params, dict(
        model=name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        vocab_size=cfg.vocab_size, weights="bf16", params_b=n / 1e9,
        weights_gb=sum(nbytes(v) for v in params.values()) / 1e9,
        init_params_s=time.perf_counter() - t0)


def run_falcon_mamba(stats) -> None:
    """falcon-mamba-7b, all 64 layers: prefill (4, 2048) (and (4, 64)
    first, which also warms the card up), 32 greedy decode steps; the
    serve state's bytes at both lengths; the first decode step's logits
    against ``forward`` over the S + 1 tokens (top-1 agreement and max
    abs difference, reported)."""
    import torch
    from repro_torch.models import api
    cfg, params, info = family_params("falcon-mamba-7b")
    B, S, n_dec = 4, 2048, 32
    toks, _ = family_inputs(cfg, B, S, 11, torch.bfloat16, "cuda")
    with torch.no_grad():
        _, st64 = api.prefill(cfg, params, toks[:, :64])
    for st in stats.values():
        st.reset()
    torch.cuda.reset_peak_memory_stats()
    (last, state), host_ms, dev_ms = timed_call(
        lambda: api.prefill(cfg, params, toks))
    prefill_peak = torch.cuda.max_memory_allocated() / 1e9
    sizes = {S: state_bytes(dict(ssm=state[0], conv=state[1]), B),
             64: state_bytes(dict(ssm=st64[0], conv=st64[1]), B)}
    tok = last.argmax(-1)[:, None].int()
    ms_step, steps, new_state, fed, prof = decode_timed(
        cfg, params, tok, state, S, n_dec, {})
    with torch.no_grad():
        full = api.forward(cfg, params, torch.cat([toks, tok], 1))[:, -1]
    launches = {n: s.launches for n, s in stats.items()}
    finite = all(bool(torch.isfinite(t).all())
                 for t in (last, full, *steps))
    same_state = ([tuple(t.shape) for t in new_state]
                  == [tuple(t.shape) for t in state]
                  == [tuple(t.shape) for t in st64]
                  and sizes[S] == sizes[64])
    w_bytes = sum(nbytes(v) for v in params.values())
    st_bytes = nbytes(*state)
    b_ms, b_by = bound_ms(w_bytes + 2 * st_bytes, 0.0, "bf16")
    emit(dict(phase="family", **info, B=B, S=S,
              prefill_ms=host_ms, prefill_device_ms=dev_ms,
              prefill_peak_gb=prefill_peak,
              decode_steps=n_dec, ms_per_decode_step=ms_step,
              decode_profile=prof,
              decode_bound_ms=b_ms, decode_bound_by=b_by,
              decode_bound_gb=(w_bytes + 2 * st_bytes) / 1e9,
              state_bytes_per_row=sizes, state_constant=same_state,
              top1_decode_vs_forward=int((steps[0].argmax(-1)
                                          == full.argmax(-1)).sum()),
              rows=B, max_abs_decode_vs_forward=(
                  steps[0] - full).abs().max().item(),
              finite=finite, launches=launches,
              tokens_in_vocab=bool(((fed >= 0) & (fed < cfg.vocab_size))
                                   .all())))
    check(finite, "falcon-mamba-7b: non-finite logits")
    check(same_state, f"falcon-mamba-7b: serve state changed: {sizes}")


def run_zamba2(stats, flush, errs: dict) -> None:
    """zamba2-1.2b at full width: the kernels at its shapes (flash
    causal at (8, 512, 32, 64), sgmv at x (4096, 2048), bgmv at x (8,
    2048)) held to their plain versions and timed; then prefill (8, 512)
    and 32 greedy decode steps with 8 adapters through sgmv and bgmv,
    and the same steps fed the same tokens with the plain LoRA (einsum).
    The two routes' logits are compared at the LoRA kernels' bf16
    tolerance and reported, not gated: 38 layers of bf16 activations
    carry one-ulp differences of the LoRA sums further than one
    kernel's tolerance (0.048 at reduced width on the CPU, where both
    routes are plain PyTorch)."""
    import importlib

    import torch
    import torch.nn.functional as F
    bgmv = importlib.import_module("repro_torch.kernels.bgmv")
    sgmv = importlib.import_module("repro_torch.kernels.sgmv")
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    cfg, params, info = family_params("zamba2-1.2b")
    B, S, n_dec, n_slots, r_max, tile = 8, 512, 32, 8, 32, 128
    lora = family_lora(cfg, n_slots, r_max, torch.bfloat16, "cuda", 21)
    idx = torch.arange(n_slots, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(22)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    # The kernels at the shapes this path gives them.
    A, Bw = lora["q"][0][0], lora["q"][1][0]        # site 0, q
    x = randn(B, cfg.d_model)
    rows = {}
    rows["bgmv"] = checked_and_timed(
        "kernel_time_family", flush, errs, "bgmv",
        f"zamba2 q: x {tuple(x.shape)} bf16, r {r_max}, {n_slots} slots",
        lambda: bgmv.bgmv(x, A, Bw, idx),
        lambda: bgmv.bgmv_plain(x, A, Bw, idx),
        lambda: torch.bmm(torch.bmm(x[:, None], A[idx.long()]),
                          Bw[idx.long()]), "lora_bf16",
        bound_ms(nbytes(x, idx) + n_slots * nbytes(A[0], Bw[0])
                 + nbytes(x), 2 * B * r_max * 2 * cfg.d_model, "bf16"))
    xs = randn(B * S, cfg.d_model)
    ts = idx.repeat_interleave(S // tile)
    xt = xs.view(-1, tile, cfg.d_model)
    sgmv.STATS.reset()
    sgmv.sgmv(xs, A, Bw, ts, tile)
    rows["sgmv"] = checked_and_timed(
        "kernel_time_family", flush, errs, "sgmv",
        f"zamba2 q: x {tuple(xs.shape)} bf16, r {r_max}, tile {tile}",
        lambda: sgmv.sgmv(xs, A, Bw, ts, tile),
        lambda: sgmv.sgmv_plain(xs, A, Bw, ts, tile),
        lambda: torch.bmm(torch.bmm(xt, A[ts.long()]), Bw[ts.long()]),
        "lora_bf16",
        bound_ms(nbytes(xs, ts) + n_slots * nbytes(A[0], Bw[0])
                 + nbytes(xs), 2 * B * S * r_max * 2 * cfg.d_model,
                 "bf16"),
        instance=launched(sgmv, sgmv.sgmv_instance(xs.dtype, A.dtype,
                                                   r_max, tile)))
    H, Kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = randn(B, S, H, dh), randn(B, S, Kh, dh), randn(B, S, Kh, dh)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fa.STATS.reset()
    fa.flash_attention(q, k, v, True)
    rows["flash_attention"] = checked_and_timed(
        "kernel_time_family", flush, errs, "flash_attention",
        f"zamba2 causal, H {H}/Kh {Kh}, q {tuple(q.shape)} bf16",
        lambda: fa.flash_attention(q, k, v, True),
        lambda: fa.flash_attention_plain(q, k, v, True),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True),
        "bf16_out", flash_bound(q, k, v, True),
        extra=FLASH_P_ROUNDING * fa.flash_attention_plain(
            q.float(), k.float(), v.float().abs(), True),
        instance=launched(fa, fa.flash_instance(q.dtype, dh)))
    del q, k, v, qt, kt, vt, xs, xt

    toks, _ = family_inputs(cfg, B, S, 23, torch.bfloat16, "cuda")
    from repro_torch.models import api
    from repro_torch.models.lora_apply import EINSUM
    for st in stats.values():
        st.reset()
    EINSUM.reset()
    kw = dict(lora=lora, adapter_idx=idx)
    (last, state), host_ms, dev_ms = timed_call(lambda: api.prefill(
        cfg, params, toks, kv_max_len=S + n_dec, lora_backend="kernel",
        **kw))
    prefill_launches = {n: s.launches for n, s in stats.items()}
    shapes0 = [tuple(t.shape) for t in flat(state)]
    bytes0 = nbytes(*flat(state))
    tok = last.argmax(-1)[:, None].int()
    ms_step, steps, new_state, fed, prof = decode_timed(
        cfg, params, tok, state, S, n_dec, dict(lora_backend="kernel", **kw))
    launches = {n: s.launches for n, s in stats.items()}
    instances = {n: dict(s.instances) for n, s in stats.items()}
    plain = {n: s.plain for n, s in stats.items()}
    einsum_calls = EINSUM.calls
    # The plain LoRA (einsum) on the same tokens.
    plain_run = serve_family(cfg, params, toks, {}, n_dec, feed=fed,
                             lora=lora, idx=idx, backend="einsum")
    atol, rtol = TOL["lora_bf16"]
    pairs = [(last, plain_run["last"])] + list(zip(steps,
                                                   plain_run["steps"]))
    lerr = max((a - b).abs().max().item() for a, b in pairs)
    logits_ok = all(bool(((a - b).abs() <= atol + rtol * b.abs()).all())
                    for a, b in pairs)
    top1 = sum(int((a.argmax(-1) == b.argmax(-1)).sum()) for a, b in pairs)
    finite = all(bool(torch.isfinite(t).all()) for t in (last, *steps))
    same_state = ([tuple(t.shape) for t in flat(new_state)] == shapes0
                  and nbytes(*flat(new_state)) == bytes0)
    n_sites = cfg.n_layers // cfg.attn_every
    w_bytes = sum(nbytes(v) for v in params.values())
    kv_bytes = nbytes(*flat(state)[2:])
    b_ms, b_by = bound_ms(w_bytes + 2 * nbytes(*flat(state)[:2])
                          + kv_bytes + n_slots * sum(
                              nbytes(a[0, 0], b[0, 0]) for a, b in
                              lora.values()) * n_sites, 0.0, "bf16")
    emit(dict(phase="family", **info, B=B, S=S, n_sites=n_sites,
              tail_layers=cfg.n_layers - n_sites * cfg.attn_every,
              adapters=n_slots, r_max=r_max, lora="kernel",
              prefill_ms=host_ms, prefill_device_ms=dev_ms,
              decode_steps=n_dec, ms_per_decode_step=ms_step,
              decode_profile=prof,
              decode_bound_ms=b_ms, decode_bound_by=b_by,
              state_bytes=bytes0, state_constant=same_state,
              finite=finite, prefill_launches=prefill_launches,
              launches=launches, launches_by_instance=instances,
              plain_calls=plain, einsum_calls=einsum_calls,
              einsum_route_max_abs_err=lerr, einsum_route_atol=atol,
              einsum_route_rtol=rtol, einsum_route_ok=logits_ok,
              einsum_route_top1=top1, einsum_route_rows=len(pairs) * B,
              kernel_rows={n: {k: r[k] for k in ("ms", "plain_ms",
                                                  "library_ms", "bound_ms",
                                                  "bound_by")}
                           for n, r in rows.items()}))
    check(finite, "zamba2-1.2b: non-finite logits")
    check(same_state, "zamba2-1.2b: serve state changed shape")
    check(prefill_launches["sgmv"] == 4 * n_sites
          and prefill_launches["flash_attention"] == n_sites
          and launches["bgmv"] == 4 * n_sites * (n_dec + prof["steps"]),
          f"zamba2-1.2b: launches {prefill_launches} / {launches}, expected "
          f"{4 * n_sites} sgmv and {n_sites} flash a prefill, "
          f"{4 * n_sites} bgmv a decode step")
    check(set(instances["sgmv"]) == set(instances["flash_attention"])
          == {"tensor_cores"},
          f"zamba2-1.2b: instances {instances}, expected tensor cores")
    check(not any(plain.values()) and einsum_calls == 0,
          f"zamba2-1.2b: a plain/einsum path ran on the kernel route: "
          f"{plain}, einsum {einsum_calls}")


def run_whisper(stats, flush, errs: dict) -> None:
    """whisper-base at full width: 1500 encoder frames a row, 8 rows.
    flash_attention full (non-causal) at the encoder's (8, 1500, 8, 64)
    held to its plain version and timed; then prefill (the encoder, the
    cross K/V and a 32-token decoder prompt) and 32 greedy decode
    steps."""
    import importlib

    import torch
    import torch.nn.functional as F
    from repro_torch.models import api
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    cfg, params, info = family_params("whisper-base")
    B, S, n_dec = 8, 32, 32
    H, Kh, dh, Se = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.enc_ctx
    g = torch.Generator(device="cuda").manual_seed(31)
    q, k, v = (torch.randn((B, Se, h, dh), generator=g, device="cuda")
               .bfloat16() for h in (H, Kh, Kh))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fa.STATS.reset()
    fa.flash_attention(q, k, v, False)
    row = checked_and_timed(
        "kernel_time_family", flush, errs, "flash_attention",
        f"whisper encoder, full, H {H}/Kh {Kh}, q {tuple(q.shape)} bf16",
        lambda: fa.flash_attention(q, k, v, False),
        lambda: fa.flash_attention_plain(q, k, v, False),
        lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                               enable_gqa=True),
        "bf16_out", flash_bound(q, k, v, False),
        extra=FLASH_P_ROUNDING * fa.flash_attention_plain(
            q.float(), k.float(), v.float().abs(), False),
        instance=launched(fa, fa.flash_instance(q.dtype, dh)))
    del q, k, v, qt, kt, vt
    toks, kw = family_inputs(cfg, B, S, 32, torch.bfloat16, "cuda")
    for st in stats.values():
        st.reset()
    (last, state), host_ms, dev_ms = timed_call(
        lambda: api.prefill(cfg, params, toks, **kw))
    prefill_launches = {n: s.launches for n, s in stats.items()}
    (kself, vself), cross = state
    state = ((F.pad(kself, (0, 0, 0, 0, 0, n_dec)),
              F.pad(vself, (0, 0, 0, 0, 0, n_dec))), cross)
    shapes0 = [tuple(t.shape) for t in flat(state)]
    tok = last.argmax(-1)[:, None].int()
    ms_step, steps, new_state, fed, prof = decode_timed(
        cfg, params, tok, state, S, n_dec, {})
    launches = {n: s.launches for n, s in stats.items()}
    instances = {n: dict(s.instances) for n, s in stats.items()}
    finite = all(bool(torch.isfinite(t).all()) for t in (last, *steps))
    same_state = [tuple(t.shape) for t in flat(new_state)] == shapes0
    w_bytes = sum(nbytes(v) for v in params.values())
    b_ms, b_by = bound_ms(w_bytes - nbytes(params["enc_pos"])
                          + nbytes(*flat(state)), 0.0, "bf16")
    n_fa = cfg.n_enc_layers + cfg.n_layers
    emit(dict(phase="family", **info, B=B, S=S, enc_ctx=Se,
              n_enc_layers=cfg.n_enc_layers, prefill_ms=host_ms,
              prefill_device_ms=dev_ms, decode_steps=n_dec,
              ms_per_decode_step=ms_step, decode_profile=prof,
              decode_bound_ms=b_ms,
              decode_bound_by=b_by, state_bytes=nbytes(*flat(state)),
              state_constant=same_state, finite=finite,
              prefill_launches=prefill_launches, launches=launches,
              launches_by_instance=instances,
              kernel_rows={"flash_attention": {
                  k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by")}}))
    check(finite, "whisper-base: non-finite logits")
    check(same_state, "whisper-base: serve state changed shape")
    check(prefill_launches["flash_attention"] == n_fa
          and set(instances["flash_attention"]) == {"tensor_cores"},
          f"whisper-base: flash_attention launches {prefill_launches}, "
          f"{instances}: expected {n_fa} tensor-core launches a prefill")


def phase_families() -> None:
    """The families without an engine at full published width on the
    card, bf16 weights from the port's ``init_params``, one model at a
    time, each freed before the next: ``run_falcon_mamba``,
    ``run_zamba2``, ``run_whisper`` (one ``family`` line each, the
    kernels at their shapes on ``kernel_time_family`` lines). Kernel
    counts are zeroed just before each model's path and read just
    after."""
    import importlib

    import torch
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in KERNELS}
    scratch = torch.empty(64 * MIB, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    errs = {}
    for run in (lambda: run_falcon_mamba(stats),
                lambda: run_zamba2(stats, flush, errs),
                lambda: run_whisper(stats, flush, errs)):
        torch.cuda.reset_peak_memory_stats()
        run()
        emit(dict(phase="family_memory",
                  peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        check(held < 1e9, f"{held / 1e9:.2f} GB still allocated after a "
                          f"family was freed")


# ------------------------------------------------------------ phase 7
#: The flash backward's shapes on the training paths: internlm2-1.8b's
#: attention at the launcher's full-width batch (the kernels line), the
#: Llama prefill buckets, whisper's encoder (full attention) and
#: zamba2's shared block.
BWD_SHAPES = (("internlm2-1.8b", 8, 512, 16, 8, 128, True),
              ("llama (8, 256)", 8, 256, 32, 32, 128, True),
              ("llama (1, 2048)", 1, 2048, 32, 32, 128, True),
              ("whisper encoder", 8, 1500, 8, 8, 64, False),
              ("zamba2 shared block", 8, 512, 32, 32, 64, True))
#: One reduced config a family for the card-against-CPU train steps.
TRAIN_PARITY = ("internlm2-1.8b", "qwen3-moe-235b-a22b", "falcon-mamba-7b",
                "zamba2-1.2b", "whisper-base", "qwen2-vl-7b")
#: Train-step comparisons across backends, all f32 (TF32 off): loss,
#: grad norm and lr of each step relative. Params after the first step
#: absolute where f32 resolves the gradient element (|g| >=
#: ``UNRESOLVED``): Adam's first step moves an element by
#: lr * g / (|g| + eps), which depends on g only through eps / |g|;
#: below it g's sign is rounding noise (the port's f32 step differs
#: from its own f64 step by 2e-4 at |g| = 2e-8, reduced falcon-mamba,
#: lr 1e-3) and the element may differ by lr. Later steps divide m by
#: sqrt(v), which cancels where the steps' gradients do: params within
#: lr a step, moments relative.
TRAIN_TOL, UNRESOLVED = 1e-4, 1e-6
#: The full-width run: internlm2-1.8b (24 layers, d 2048, 16/8 heads,
#: ff 8192, V 92544; the JAX launcher's default arch) in f32 as the
#: launcher keeps it, SyntheticLM batches of 8 x 512.
FULL_ARCH, FULL_STEPS, FULL_BATCH, FULL_SEQ = "internlm2-1.8b", 5, 8, 512


def flash_bwd_allowance(q, k, v, out, dout, causal, want) -> list:
    """Per-gradient bound |got - want| may reach, ``want`` the plain
    backward on the same values in f32 (bf16 widens exactly): 1e-4 +
    1e-4 |want| in f32 (f32 sums in another order); in bf16 one ulp of
    the gradient (2**-7 |want| + 1e-4) plus what the bf16 rounding of
    ``out`` moves D = rowsum(dO * out) by, carried into dq
    (scale * r * sum_j P |k_j|) and dk (scale * P^T (r |q|)), with
    r = sum_d |dO| |out - out32| per query row."""
    import importlib
    import torch
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    if q.dtype == torch.float32:
        return [1e-4 + 1e-4 * w.abs() for w in want]
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, dout))
    scale = q.shape[-1] ** -0.5
    o32 = fa.flash_attention_plain(q32, k32, v32, causal)
    r = (do32.abs() * (out.float() - o32).abs()).sum(-1, keepdim=True)
    extra_dq = scale * r * fa.flash_attention_plain(q32, k32, k32.abs(),
                                                    causal)
    _, _, extra_dk = fa.flash_attention_bwd_plain(q32, k32, v32, o32,
                                                  r * q32.abs(), causal)
    extra = [extra_dq, scale * extra_dk, 0.0]
    return [1e-4 + 2 ** -7 * w.abs() + e for w, e in zip(want, extra)]


def flash_bwd_bound(q, k, v, causal: bool, route: str | None = None
                    ) -> tuple:
    """Bytes of q, k, v, out and dO read once and dq, dk, dv written
    once; operations 2.5 times the forward's 4 * dh a (query head,
    query, key) pair the mask keeps, at the peak of ``route``: by
    default the arithmetic the kernel uses (bf16 tensor cores, f32 as
    3xTF32), "f32" for f32 on CUDA cores."""
    B, S, H, dh = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    if route is None:
        route = "bf16" if op_type(q, k, v) == "bf16" else "tf32x3"
    return bound_ms(2 * nbytes(q, k, v) + 2 * nbytes(q),
                    2.5 * 4 * B * H * dh * pairs, route)


def phase_train_kernels(flush, shapes=None, dtypes=("f32", "bf16"),
                        phase: str = "kernel_time_train",
                        fwd_shapes=None) -> dict:
    """flash_attention_bwd, given the forward's log-sum-exp, against its
    plain version at ``shapes`` (``BWD_SHAPES``) in ``dtypes`` on the
    same card tensors (``flash_bwd_allowance``), launching the instance
    ``flash_bwd_instance`` names and the same bits twice, then timed
    beside the plain version, autograd through SDPA on the same tensors
    (``library_ms``, never called by the port) and its bound (the
    route's arithmetic; f32 rows also carry the CUDA-core bound); one
    ``phase`` line each. Then ``time_forward_lse`` at ``fwd_shapes``
    (``FWD_LSE_SHAPES``). Returns the kernels-line row (internlm2,
    f32), with the forward's line at that shape under ``forward``."""
    import importlib

    import torch
    import torch.nn.functional as F
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    g = torch.Generator(device="cuda").manual_seed(4321)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    row = None
    for label, B, S, H, Kh, dh, causal in shapes or BWD_SHAPES:
        for dt, tname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            if tname not in dtypes:
                continue
            q, dout = randn(B, S, H, dh, dtype=dt), randn(B, S, H, dh,
                                                         dtype=dt)
            k, v = randn(B, S, Kh, dh, dtype=dt), randn(B, S, Kh, dh,
                                                       dtype=dt)
            out, lse = fa.flash_attention(q, k, v, causal, return_lse=True)
            inst = fa.flash_bwd_instance(dt, dh)
            fa.BWD_STATS.reset()
            got = fa.flash_attention_bwd(q, k, v, out, dout, causal, lse=lse)
            again = fa.flash_attention_bwd(q, k, v, out, dout, causal,
                                           lse=lse)
            torch.cuda.synchronize()
            check(fa.BWD_STATS.instances == {inst: 2}
                  and fa.BWD_STATS.plain == 0,
                  f"flash_attention_bwd [{label}] launched "
                  f"{fa.BWD_STATS.instances}, not {inst} twice")
            same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
            del again
            want = fa.flash_attention_bwd_plain(
                *(t.float() for t in (q, k, v, out, dout)), causal)
            bounds = flash_bwd_allowance(q, k, v, out, dout, causal, want)
            errs, ok = {}, True
            for name, gt, w, bd in zip(("dq", "dk", "dv"), got, want,
                                       bounds):
                diff = (gt.float() - w).abs()
                errs[name] = diff.max().item()
                ok &= bool(torch.isfinite(gt).all() and (diff <= bd).all())
            # The plain version in the working dtype (bf16 rounds P, dP
            # and the products): reported beside the gate.
            same = fa.flash_attention_bwd_plain(q, k, v, out, dout, causal)
            err_same = max((a.float() - b.float()).abs().max().item()
                           for a, b in zip(got, same))
            del same, want, bounds
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v))
            lo = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                enable_gqa=True)
            dot = dout.transpose(1, 2)
            b_ms, by = flash_bwd_bound(q, k, v, causal)
            extra = {}
            if tname == "f32":
                extra["bound_ms_cuda_cores"] = flash_bwd_bound(
                    q, k, v, causal, "f32")[0]
            line = dict(
                phase=phase, kernel="flash_attention_bwd",
                case=f"{label}, q {tuple(q.shape)}, Kh {Kh}, {tname}, "
                     f"{'causal' if causal else 'full'}",
                instance=inst, same_bits_twice=same_bits,
                max_abs_err=max(errs.values()), errs=errs,
                max_abs_err_vs_same_dtype_plain=err_same, ok=ok,
                ms=median_ms(lambda: fa.flash_attention_bwd(
                    q, k, v, out, dout, causal, lse=lse), flush),
                plain_ms=median_ms(lambda: fa.flash_attention_bwd_plain(
                    q, k, v, out, dout, causal), flush),
                library_ms=median_ms(lambda: torch.autograd.grad(
                    lo, (qt, kt, vt), dot, retain_graph=True), flush),
                library="autograd through SDPA (enable_gqa)",
                bound_ms=b_ms, bound_by=by, **extra)
            emit(line)
            check(ok, f"flash_attention_bwd [{line['case']}] disagrees "
                      f"with its plain version: {errs}")
            check(same_bits, f"flash_attention_bwd [{line['case']}] gave "
                             f"other bits on a second call")
            if label == FULL_ARCH and tname == "f32":
                row = line
            del q, k, v, out, dout, got, qt, kt, vt, lo, lse
    fwd = time_forward_lse(flush, randn, fwd_shapes or FWD_LSE_SHAPES,
                           phase + "_fwd")
    return dict(row, forward=fwd.get(FULL_ARCH)) if row else row


#: The forward with and without its log-sum-exp: the f32 training
#: shapes (the ``tf32x3`` instance): internlm2-1.8b's step (the kernels
#: line), qwen3-moe's (2, 2048) batch split over 2 data shards (64/4
#: heads, G 16), qwen2-vl-7b's whole block (28/4 heads), zamba2's
#: shared block and whisper's encoder (full) and decoder split over 2
#: data shards; and the dense prefill's bf16 bucket (the tensor-core
#: instance).
FWD_LSE_SHAPES = (("internlm2-1.8b", 8, 512, 16, 8, 128, "f32"),
                  ("qwen3-moe shard", 1, 2048, 64, 4, 128, "f32"),
                  ("qwen2-vl block", 8, 512, 28, 4, 128, "f32"),
                  ("zamba2 shard", 4, 512, 32, 32, 64, "f32"),
                  ("whisper encoder shard", 4, 1500, 8, 8, 64, "f32",
                   False),
                  ("whisper decoder shard", 4, 256, 8, 8, 64, "f32"),
                  ("llama (8, 256)", 8, 256, 32, 32, 128, "bf16"))


def time_forward_lse(flush, randn, shapes, phase: str) -> dict:
    """flash_attention at ``shapes`` (label, B, S, H, Kh, dh, dtype[,
    causal]; causal unless it says otherwise), with ``return_lse`` off
    (twice) and on: three launches of the instance ``flash_instance``
    names and no plain version, the output against its plain version
    (f32 1e-4; bf16 one ulp plus ``FLASH_P_ROUNDING``), the same bits
    each time, the log-sum-exp within 1e-5 of
    ``flash_attention_lse_plain``, and both timed beside SDPA and the
    bound of the instance's arithmetic (bf16 tensor cores, f32 as
    3xTF32; f32 rows also ``bound_ms_cuda_cores``); one ``phase`` line
    a shape. Returns the lines by label."""
    import importlib

    import torch
    import torch.nn.functional as F
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    lines = {}
    for label, B, S, H, Kh, dh, tname, *rest in shapes:
        causal = rest[0] if rest else True
        dt = torch.float32 if tname == "f32" else torch.bfloat16
        q = randn(B, S, H, dh, dtype=dt)
        k, v = randn(B, S, Kh, dh, dtype=dt), randn(B, S, Kh, dh, dtype=dt)
        inst = fa.flash_instance(dt, dh)
        fa.STATS.reset()
        out = fa.flash_attention(q, k, v, causal)
        again = fa.flash_attention(q, k, v, causal)
        out2, lse = fa.flash_attention(q, k, v, causal, return_lse=True)
        torch.cuda.synchronize()
        launched_ok = (fa.STATS.instances == {inst: 3}
                       and fa.STATS.plain == 0)
        want = fa.flash_attention_plain(q, k, v, causal)
        atol, rtol = TOL["f32" if tname == "f32" else "bf16_out"]
        bound = atol + rtol * want.float().abs()
        if tname == "bf16":
            bound = bound + FLASH_P_ROUNDING * fa.flash_attention_plain(
                q.float(), k.float(), v.float().abs(), causal)
        diff = (out.float() - want.float()).abs()
        lse_want = fa.flash_attention_lse_plain(q, k, causal)
        lse_err = (lse - lse_want).abs()
        same_bits = bool(torch.equal(out, again) and torch.equal(out, out2))
        ok = bool((diff <= bound).all() and same_bits and launched_ok
                  and (lse_err <= 1e-5 + 1e-5 * lse_want.abs()).all())
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = S * (S + 1) // 2 if causal else S * S
        flops = 4 * B * H * dh * pairs
        fb = bound_ms(nbytes(q, k, v) + nbytes(q), flops,
                      "bf16" if tname == "bf16" else "tf32x3")
        extra = {}
        if tname == "f32":
            extra["bound_ms_cuda_cores"] = bound_ms(
                nbytes(q, k, v) + nbytes(q), flops, "f32")[0]
        line = dict(phase=phase, kernel="flash_attention",
                    case=f"{label}, q {tuple(q.shape)}, Kh {Kh}, {tname}, "
                         f"{'causal' if causal else 'full'}",
                    instance=inst, launches=dict(fa.STATS.instances),
                    same_bits=same_bits, max_abs_err=diff.max().item(),
                    lse_max_abs_err=lse_err.max().item(), ok=ok,
                    ms=median_ms(lambda: fa.flash_attention(q, k, v, causal),
                                 flush),
                    ms_with_lse=median_ms(lambda: fa.flash_attention(
                        q, k, v, causal, return_lse=True), flush),
                    plain_ms=median_ms(lambda: fa.flash_attention_plain(
                        q, k, v, causal), flush),
                    library_ms=median_ms(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=causal, enable_gqa=True),
                        flush),
                    bound_ms=fb[0], bound_by=fb[1], **extra)
        emit(line)
        lines[label] = line
        check(ok, f"flash_attention forward [{label}, {tname}]: launches "
                  f"{line['launches']} (want {inst} 3 times), same bits "
                  f"{same_bits}, or with its log-sum-exp it disagrees "
                  f"with its plain version")
        del q, k, v, out, again, out2, lse, want, bound, diff, qt, kt, vt
    return lines


def _train_stats() -> dict:
    import importlib
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in KERNELS}
    stats["flash_attention_bwd"] = importlib.import_module(
        "repro_torch.kernels.flash_attention").BWD_STATS
    return stats


def train_batch(cfg, i: int, B: int = 4, S: int = 16) -> dict:
    """Batch ``i`` of the parity steps as numpy: tokens/labels (B, S),
    ``frames`` (enc-dec), distinct t/h/w ``mrope_pos`` (VLM)."""
    import numpy as np
    rng = np.random.default_rng(1000 + i)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family.name == "ENCDEC":
        b["frames"] = rng.standard_normal(
            (B, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None, None],
                              (3, B, S)).copy()
        pos[1, :, S // 4:] += 2
        pos[2, :, S // 2:] += 5
        b["mrope_pos"] = pos
    return b


def first_step_close(ref, got, ocfg, m1) -> dict:
    """Params (numpy) after one step from equal states: the largest
    difference where the gradient, m1 / (1 - b1) from the reference's
    f32 first moments, is resolved; the count of unresolved elements
    past ``TRAIN_TOL`` and whether one differs by more than lr."""
    import numpy as np
    out = dict(param=0.0, unresolved=0, unresolved_over_lr=False)
    for k in ref:
        bad = np.abs(m1[k]) / (1 - ocfg.b1) < UNRESOLVED
        d = np.abs(ref[k].astype(np.float64) - got[k])
        if (~bad).any():
            out["param"] = max(out["param"], float(d[~bad].max()))
        out["unresolved"] += int(((d > TRAIN_TOL) & bad).sum())
        out["unresolved_over_lr"] |= bool((d[bad] > ocfg.lr).any())
    return out


def final_close(ref, got, ocfg, steps: int) -> dict:
    """After ``steps`` steps: the largest param difference in units of
    lr a step, the largest relative moment difference."""
    import numpy as np
    (rp, ro), (gp, go) = ref, got
    d = max(float(np.abs(rp[k].astype(np.float64) - gp[k]).max())
            for k in rp)
    opt = max(float((np.abs(ro[k].astype(np.float64) - go[k])
                     / (1 + np.abs(ro[k]))).max()) for k in ro)
    return dict(param_in_lr=d / (ocfg.lr * steps), opt=opt)


def phase_train_parity() -> None:
    """Two train steps of one reduced config a family (``TRAIN_PARITY``)
    in f32 on the card and on the CPU port from the same seeded params
    and numpy batches, f32 moments, clipping on, within ``TRAIN_TOL``:
    loss, grad norm and lr of each step; params after the first
    (``first_step_close``), params and moments after the second
    (``final_close``); on the card every flash forward launch had its
    backward launch (none for falcon-mamba) and no plain version ran."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.training import (AdamWConfig, init_opt_state,
                                      make_train_step)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                       clip_norm=0.5)
    stats = _train_stats()
    bad = []

    def host(tree):
        return {k: v.detach().float().cpu().numpy().copy()
                for k, v in tree.items()}

    for name in TRAIN_PARITY:
        cfg = get_config(name).reduced()
        cpu = api.init_params(cfg, 0, torch.float32, device="cpu")
        states = {"cpu": (cpu, init_opt_state(cpu, ocfg))}
        card = {k: v.to("cuda") for k, v in cpu.items()}
        states["cuda"] = (card, init_opt_state(card, ocfg))
        step = make_train_step(cfg, ocfg)
        metrics, after1 = {}, {}
        for dev, (p, o) in states.items():
            for st in stats.values():
                st.reset()
            metrics[dev] = []
            for i in range(2):
                b = {k: torch.from_numpy(v).to(dev)
                     for k, v in train_batch(cfg, i).items()}
                metrics[dev].append({k: float(v) for k, v in
                                     step(p, o, b)[2].items()})
                if i == 0:
                    after1[dev] = (host(p), {k[2:]: v for k, v in
                                             host(o).items()
                                             if k.startswith("m/")})
        metrics_err = max(abs(a[k] - b[k]) / max(abs(a[k]), 1.0)
                          for a, b in zip(metrics["cpu"], metrics["cuda"])
                          for k in a)
        first = first_step_close(after1["cpu"][0], after1["cuda"][0], ocfg,
                                 after1["cpu"][1])
        final = final_close([host(t) for t in states["cpu"]],
                            [host(t) for t in states["cuda"]], ocfg, 2)
        launches = {n: st.launches for n, st in stats.items()}
        plain = {n: st.plain for n, st in stats.items() if st.plain}
        finite = all(torch.isfinite(v).all() for v in card.values())
        # Every forward launch under grad has its backward launch (no
        # second forward); only the SSM has no attention.
        attn = launches["flash_attention_bwd"]
        ok = (finite and metrics_err <= TRAIN_TOL
              and first["param"] <= TRAIN_TOL
              and not first["unresolved_over_lr"]
              and final["param_in_lr"] <= 1.0 and final["opt"] <= TRAIN_TOL
              and not plain and attn == launches["flash_attention"]
              and (attn > 0) == (cfg.family.name != "SSM"))
        emit(dict(phase="parity_train", model=name, steps=2, weights="f32",
                  losses=[m["loss"] for m in metrics["cuda"]],
                  metrics_err=metrics_err, first_step=first, final=final,
                  tol=TRAIN_TOL, launches=launches, plain=plain, ok=ok))
        if not ok:
            bad.append(name)
    check(not bad, f"card vs CPU train-step parity failed: {bad}")


def check_reduced_checkpoint() -> None:
    """The optimizer tree at reduced size: reduced internlm2 on the
    card, one step with bf16 moments, then params (f32), moments (bf16)
    and the int32 step saved and restored bit-exact."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step, restore_checkpoint,
                                      save_checkpoint)
    cfg = get_config(FULL_ARCH).reduced()
    ocfg = AdamWConfig(moment_dtype="bfloat16", warmup_steps=0)
    params, opt = init_train_state(cfg, ocfg, 0, torch.float32)
    b = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
         for k, v in train_batch(cfg, 0).items()}
    make_train_step(cfg, ocfg)(params, opt, b)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        save_checkpoint(tmp, 1, {"params": params, "opt": opt})
        step, trees = restore_checkpoint(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    exact = step == 1 and all(
        trees[t][k].dtype == v.dtype and torch.equal(trees[t][k], v)
        for t, tree in (("params", params), ("opt", opt))
        for k, v in tree.items())
    emit(dict(phase="train_checkpoint", model=cfg.name, size="reduced",
              trees=["params", "opt"],
              dtypes=sorted({str(v.dtype) for v in (*params.values(),
                                                    *opt.values())}),
              bit_exact=exact))
    check(exact, "reduced checkpoint (params + bf16 moments) did not "
                 "restore bit-exact")


def phase_train_full() -> dict:
    """internlm2-1.8b at full width and depth, f32 params, through the
    port's launcher loop (``launch.train.train``): ``FULL_STEPS`` steps
    of SyntheticLM (8, 512), then one step with ``microbatches=2``, then
    one step under torch.profiler (device busy share), then the params
    tree (7.6 GB) saved to a temporary directory, restored bit-exact and
    deleted. Kernel counts are zeroed just before the launcher's steps
    and read just after: the flash backward must launch once a layer a
    step and the forward ``fwd_runs`` times (twice under the published
    config's remat: the backward recomputes each layer), every forward
    launch of the ``tf32x3`` instance, nothing else and no plain
    version. Between the profile and the checkpoint, the remat A/B
    (``train_remat_ab``). Returns the backward's and the forward's
    launches on the launcher's run."""
    import importlib
    import shutil
    import tempfile

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher
    from repro_torch.training import (DataConfig, SyntheticLM,
                                      make_train_step, restore_checkpoint,
                                      save_checkpoint)
    cfg = get_config(FULL_ARCH)
    stats = _train_stats()
    tokens = FULL_BATCH * FULL_SEQ
    for st in stats.values():
        st.reset()
    torch.cuda.reset_peak_memory_stats()
    res = launcher.train(cfg, steps=FULL_STEPS, batch=FULL_BATCH,
                         seq=FULL_SEQ, log=lambda s: None)
    torch.cuda.synchronize()
    launches = {n: st.launches for n, st in stats.items()}
    plain = {n: st.plain for n, st in stats.items() if st.plain}
    hist = res["history"]
    params, opt, ocfg = res["params"], res["opt"], res["opt_cfg"]
    steady = statistics.median(h["seconds"] for h in hist[1:])
    want = {n: 0 for n in stats}
    want["flash_attention"] = fwd_runs(cfg) * cfg.n_layers * FULL_STEPS
    want["flash_attention_bwd"] = cfg.n_layers * FULL_STEPS
    finite = all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                 for h in hist)
    emit(dict(phase="train", model=cfg.name, n_layers=cfg.n_layers,
              d_model=cfg.d_model, vocab_size=cfg.vocab_size,
              params_b=sum(v.numel() for v in params.values()) / 1e9,
              params_gb=sum(nbytes(v) for v in params.values()) / 1e9,
              state_gb=sum(nbytes(v) for v in opt.values()) / 1e9,
              weights="f32", batch=FULL_BATCH, seq=FULL_SEQ,
              steps=len(hist), losses=[h["loss"] for h in hist],
              grad_norms=[h["grad_norm"] for h in hist],
              lrs=[h["lr"] for h in hist],
              s_per_step=[h["seconds"] for h in hist],
              s_per_step_steady=steady, tokens_per_s=tokens / steady,
              peak_gb=torch.cuda.max_memory_allocated() / 1e9,
              launches=launches, plain=plain, remat=cfg.remat,
              tf32=torch.backends.cuda.matmul.allow_tf32))
    check(finite, f"{cfg.name}: non-finite loss or grad norm {hist}")
    fwd_inst = dict(stats["flash_attention"].instances)
    check(launches == want and not plain
          and fwd_inst == {"tf32x3": want["flash_attention"]},
          f"{cfg.name}: launches {launches} (want {want}), plain {plain}, "
          f"flash forward instances {fwd_inst} (want tf32x3 only)")

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=FULL_SEQ, global_batch=FULL_BATCH))

    def batch(i):
        return {k: torch.from_numpy(v).cuda()
                for k, v in data.batch(i).items()}

    for st in stats.values():
        st.reset()
    torch.cuda.reset_peak_memory_stats()
    step2 = make_train_step(cfg, ocfg, microbatches=2)
    b = batch(FULL_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, m = step2(params, opt, b)
    loss2 = float(m["loss"])
    s2 = time.perf_counter() - t0
    mb_launches = {n: st.launches for n, st in stats.items()}
    emit(dict(phase="train_microbatches", model=cfg.name, microbatches=2,
              loss=loss2, grad_norm=float(m["grad_norm"]), s_per_step=s2,
              tokens_per_s=tokens / s2,
              peak_gb=torch.cuda.max_memory_allocated() / 1e9,
              launches=mb_launches))
    check(math.isfinite(loss2) and mb_launches["flash_attention"]
          == fwd_runs(cfg) * 2 * cfg.n_layers
          and mb_launches["flash_attention_bwd"] == 2 * cfg.n_layers
          and not any(st.plain for st in stats.values()),
          f"{cfg.name} microbatches=2: loss {loss2}, launches "
          f"{mb_launches}")

    step1 = make_train_step(cfg, ocfg)
    b = batch(FULL_STEPS + 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, m = step1(params, opt, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in kernels)
    emit(dict(phase="train_profile", model=cfg.name, wall_s=wall,
              device_busy_share=busy_us * 1e-6 / wall,
              device_ms=busy_us * 1e-3,
              launches=sum(e.count for e in kernels),
              loss=float(m["loss"]),
              top_device=[dict(name=e.key[:90], calls=e.count, us=dev_us(e))
                          for e in sorted(kernels, key=dev_us,
                                          reverse=True)[:12]]))
    check(busy_us > 0, "train step: the profiler saw no device time")

    train_remat_ab(cfg, params, opt, ocfg, batch, FULL_STEPS + 2)

    need = sum(nbytes(v) for v in params.values())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(tmp).free
        check(free > 1.2 * need, f"checkpoint: {free / 1e9:.1f} GB free "
                                 f"under {tmp}, {need / 1e9:.1f} GB needed")
        t0 = time.perf_counter()
        save_checkpoint(tmp, FULL_STEPS, {"params": params})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        step, trees = restore_checkpoint(tmp)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        exact = step == FULL_STEPS and all(
            torch.equal(trees["params"][k], v) for k, v in params.items())
        del trees
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(dict(phase="train_checkpoint", model=cfg.name, size="full",
              trees=["params"], gb=need / 1e9, save_s=save_s,
              restore_s=load_s, bit_exact=exact,
              deleted=not Path(tmp).exists()))
    check(exact, f"{cfg.name}: the params checkpoint did not restore "
                 f"bit-exact")
    return dict(launches=launches["flash_attention_bwd"],
                fwd_launches=launches["flash_attention"])


def fwd_runs(cfg) -> int:
    """flash forward launches a layer a step: the forward's, and under
    ``cfg.remat`` the backward's recompute of the layer."""
    return 2 if cfg.remat else 1


#: Steps of each side of the remat A/B (the last one timed as steady).
REMAT_AB_STEPS = 2


def train_remat_ab(cfg, params: dict, opt: dict, ocfg, batch,
                   first: int) -> None:
    """The remat A/B (``train_remat_ab``): from the trained state,
    ``REMAT_AB_STEPS`` steps of ``cfg`` with remat off, then the same
    steps from the same state (kept on the host) with remat on, the
    published setting. Loss, grad norm and params must be bit-identical;
    s/step (each step and the last) and the peak memory of each side,
    and the flash launches of each, are reported."""
    import dataclasses

    import torch
    from repro_torch.training import make_train_step
    stats = _train_stats()
    saved = [{k: v.to("cpu", copy=True) for k, v in t.items()}
             for t in (params, opt)]
    batches = [batch(first + i) for i in range(REMAT_AB_STEPS)]
    sides = {}
    for remat in (False, True):
        for tree, host in zip((params, opt), saved):
            for k, v in tree.items():
                v.copy_(host[k])
        step = make_train_step(dataclasses.replace(cfg, remat=remat), ocfg)
        for st in stats.values():
            st.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hist = []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, m = step(params, opt, b)
            loss, gn = float(m["loss"]), float(m["grad_norm"])
            hist.append((loss, gn, time.perf_counter() - t0))
        sides[remat] = dict(
            hist=hist, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches={n: st.launches for n, st in stats.items()
                      if st.launches},
            params={k: v.to("cpu", copy=True) for k, v in params.items()})
    off, on = sides[False], sides[True]
    differ = [k for k in off["params"]
              if not torch.equal(off["params"][k], on["params"][k])]
    n = REMAT_AB_STEPS * cfg.n_layers
    line = dict(
        phase="train_remat_ab", model=cfg.name, weights="f32",
        batch=FULL_BATCH, seq=FULL_SEQ, steps=REMAT_AB_STEPS,
        losses_off=[h[0] for h in off["hist"]],
        losses_on=[h[0] for h in on["hist"]],
        grad_norms_off=[h[1] for h in off["hist"]],
        grad_norms_on=[h[1] for h in on["hist"]],
        s_per_step_off=[h[2] for h in off["hist"]],
        s_per_step_on=[h[2] for h in on["hist"]],
        s_steady_off=off["hist"][-1][2], s_steady_on=on["hist"][-1][2],
        step_ratio=on["hist"][-1][2] / off["hist"][-1][2],
        peak_gb_off=off["peak_gb"], peak_gb_on=on["peak_gb"],
        peak_saved_gb=off["peak_gb"] - on["peak_gb"],
        launches_off=off["launches"], launches_on=on["launches"],
        params_differ=differ[:8], bit_identical=not differ and all(
            a[:2] == b[:2] for a, b in zip(off["hist"], on["hist"])))
    emit(line)
    check(line["bit_identical"],
          f"remat A/B: remat on and off part: {line}")
    check(off["launches"].get("flash_attention") == n
          and on["launches"].get("flash_attention") == 2 * n
          and off["launches"].get("flash_attention_bwd")
          == on["launches"].get("flash_attention_bwd") == n,
          f"remat A/B: flash launches off {off['launches']}, on "
          f"{on['launches']} (want {n} and {2 * n} forward, {n} "
          f"backward)")
    del saved, sides, off, on


def run_train_example() -> None:
    """``examples/torch_train_with_recovery.py`` on the card with its
    defaults (200 steps, failures injected at 60 and 140): both
    recoveries taken, the final loss below the first."""
    mod = load_example("torch_train_with_recovery.py")
    t0 = time.perf_counter()
    out = mod.main([])
    losses = out["losses"]
    emit(dict(phase="train_example", steps_done=out["steps_done"],
              recoveries=out["recoveries"], first_loss=losses[0],
              final_loss=losses[-1], seconds=time.perf_counter() - t0))
    check(out["steps_done"] == 200 and out["recoveries"] == 2
          and losses[-1] < losses[0],
          f"train example: {out['steps_done']} steps, "
          f"{out['recoveries']} recoveries, loss {losses[0]} -> "
          f"{losses[-1]}")


def phase_train() -> dict:
    """Phase 7: the backward kernel at its shapes, the families' reduced
    train steps card against CPU, the reduced checkpoint, the full-width
    run and the example. Returns the kernels-line row of
    flash_attention_bwd, with the f32 forward's line under ``forward``
    and its launches on the full-width run under ``fwd_launches``."""
    import torch
    scratch = torch.empty(64 * MIB, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    row = phase_train_kernels(flush)
    del scratch
    phase_train_parity()
    check_reduced_checkpoint()
    full = phase_train_full()
    gc.collect()
    torch.cuda.empty_cache()
    run_train_example()
    return dict(row, launches=full["launches"],
                fwd_launches=full["fwd_launches"])


# ------------------------------------------------------------ phase 8
#: The meshes of the sharded train step on one card (repeated positions
#: of ``cuda:0``), each held to the unsharded step; two steps each.
TRAIN_MESHES = ((1, 1), (2, 1), (1, 2), (2, 2))
TRAIN_MESH_STEPS = 2
#: internlm2-1.8b's depth in phase 8 (phase 7 trains all 24 layers): cut
#: to keep the smoke inside its time limit as phases were added.
TRAIN_MESH_FULL_LAYERS = 12
#: The MoE and VLM families at their published widths, depth cut so
#: that the unsharded f32 step (params, gradients and two moments, then
#: the activations) fits one card: (arch, layers, (B, S), meshes).
#: qwen3-moe: one layer is 2.49 B params (3.73 B with the untied
#: embedding and head, 59.7 GB of f32 state); (2, 2048) makes T = 4096,
#: two capacity groups of 2048, one a data shard at (2, 1). Its peak on
#: an 80 GB card (79.2 GB at (1, 1)) is the state's, not the batch's:
#: (2, 1024) peaked 0.1 GB higher. qwen2-vl-7b: two layers, 1.56 B
#: params, 24.9 GB of state; also at (1, 8), whose 8 columns do not
#: divide its 28 heads (the attention whole on the first column).
TRAIN_MESH_MODELS = (
    ("qwen3-moe-235b-a22b", 1, (2, 2048), ((1, 1), (2, 1), (1, 2))),
    ("qwen2-vl-7b", 2, (8, 512), TRAIN_MESHES + ((1, 8),)))
#: The SSM, hybrid and enc-dec families at their published widths, after
#: ``TRAIN_MESH_MODELS``: falcon-mamba-7b cut to 2 layers (0.743 B
#: params, 11.9 GB of f32 state), zamba2-1.2b cut to 12 layers (two
#: sites of the shared block; 0.505 B, 8.1 GB), whisper-base whole (6 +
#: 6 layers, V 51865, 1500 frames; 2.0 GB).
TRAIN_MESH_FAMILIES = (
    ("falcon-mamba-7b", 2, (2, 1024), TRAIN_MESHES),
    ("zamba2-1.2b", 12, (8, 512), TRAIN_MESHES),
    ("whisper-base", None, (8, 256), TRAIN_MESHES))


def attention_layers(cfg) -> int:
    """flash_attention calls of one forward of ``cfg``: a layer each for
    the decoder-only families, the shared block's sites (hybrid), the
    encoder and decoder layers (enc-dec), none for the SSM family."""
    family = cfg.family.name
    if family == "SSM":
        return 0
    if family == "HYBRID":
        return cfg.n_layers // cfg.attn_every
    if family == "ENCDEC":
        return cfg.n_enc_layers + cfg.n_layers
    return cfg.n_layers


def train_mesh_shapes(cfg, batch: tuple, meshes) -> tuple:
    """flash_attention's per-shard shapes of ``cfg``'s train step at
    ``batch`` (B, S) on each split mesh: (B / d, S, H / m, dh) over the
    column's KV heads (heads m does not divide: every head, on the
    first column), causal; enc-dec: the encoder's over ``enc_ctx``
    frames (full) and the decoder's (causal); none for the SSM
    family."""
    from repro_torch.distributed.sharding import (kv_heads_of_column,
                                                  whole_blocks)
    B, S = batch
    parts = {"SSM": (), "ENCDEC": ((" encoder", cfg.enc_ctx, False),
                                   (" decoder", S, True))}.get(
        cfg.family.name, (("", S, True),))
    out = []
    for d, m in meshes:
        if d * m == 1:
            continue
        whole = "attn" in whole_blocks(cfg, m, d, train=True)
        lo, hi = ((0, cfg.n_kv_heads) if whole
                  else kv_heads_of_column(cfg.n_kv_heads, m, 0))
        for part, s, causal in parts:
            out.append((f"{cfg.name}{part} shard of ({d}, {m})", B // d, s,
                        cfg.n_heads // (1 if whole else m), hi - lo,
                        cfg.head_dim, causal))
    return tuple(out)


def attention_positions(cfg, mesh) -> int:
    """The positions that compute attention: every one, or when the
    "model" axis does not divide the heads (the attention block whole),
    each batch row's first."""
    from repro_torch.distributed.sharding import whole_blocks
    M = mesh.shape["model"]
    return mesh.size // M if "attn" in whole_blocks(cfg, M) else mesh.size


def train_mesh_inputs(arch: str = FULL_ARCH, n_layers: int | None = None,
                      batch: tuple = (FULL_BATCH, FULL_SEQ)):
    """``arch`` at full width (depth ``n_layers``, all when None), its
    seeded f32 params (drawn on ``cuda:0``) on the host, the optimizer
    config and ``TRAIN_MESH_STEPS`` SyntheticLM ``batch`` batches on
    ``cuda:0`` (with ``mrope_positions`` of an image prompt for an
    M-RoPE config, seeded ``enc_ctx`` frames of noise for enc-dec)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.training import AdamWConfig, DataConfig, SyntheticLM
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    init = {k: v.cpu() for k, v in api.init_params(
        cfg, 0, torch.float32, device="cuda:0").items()}
    torch.cuda.empty_cache()
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=0,
                       total_steps=TRAIN_MESH_STEPS)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=batch[1], global_batch=batch[0]))
    batches = []
    for i in range(TRAIN_MESH_STEPS):
        b = {k: torch.from_numpy(v).cuda()
             for k, v in data.batch(i).items()}
        if cfg.mrope:
            b["mrope_pos"] = mrope_positions(*batch, image=True).cuda()
        if cfg.family.name == "ENCDEC":
            g = torch.Generator(device="cuda").manual_seed(1000 + i)
            b["frames"] = torch.randn((batch[0], cfg.enc_ctx, cfg.d_model),
                                      generator=g, device="cuda")
        batches.append(b)
    return cfg, init, ocfg, batches


def train_mesh_reference(cfg, ocfg, init: dict, batches: list,
                         device="cuda:0", microbatches: int = 1) -> dict:
    """The unsharded step on ``device`` from ``init`` (host tensors),
    over ``microbatches`` microbatches a step: each step's loss, grad
    norm, MoE capacity drops and seconds, the card's peak memory, and
    the params and moments after the last step, on the host."""
    import torch
    from repro_torch.models import moe
    from repro_torch.training import init_opt_state, make_train_step
    # A copy even on the host: the step updates its params in place.
    params = {k: v.to(device, copy=True) for k, v in init.items()}
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, ocfg, microbatches)
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    hist = []
    for b in batches:
        b = {k: v.to(device) for k, v in b.items()}
        if device != "cpu":
            torch.cuda.synchronize()
        moe.STATS.reset()
        t0 = time.perf_counter()
        _, _, m = step(params, opt, b)
        hist.append(dict(loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]),
                         dropped=moe.STATS.dropped,
                         seconds=time.perf_counter() - t0))
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device != "cpu" else None)
    out = dict(history=hist, peak_gb=peak,
               params={k: v.cpu() for k, v in params.items()},
               opt={k: v.cpu() for k, v in opt.items()})
    del params, opt
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return out


def train_mesh_run(cfg, ocfg, init: dict, batches: list, mesh, ref: dict,
                   phase: str) -> dict:
    """``init`` placed on ``mesh`` by the train rule table, then the
    sharded step on ``batches`` with the kernel counts zeroed just
    before and read just after: each step's loss and grad norm against
    ``ref``'s (``TRAIN_TOL`` relative), the largest param difference
    after the last step within lr a step and the largest moment
    difference within ``TRAIN_TOL`` relative (``final_close``), the
    flash backward once an attention layer (``attention_layers``) an
    attention position (``attention_positions``) a step, its forward
    ``fwd_runs`` times, and no plain version, the MoE capacity drops of
    each step equal to ``ref``'s;
    s/step, peak memory of each card,
    placed bytes, gathers, reduce-scatters and MoE all-to-alls a step.
    One ``phase`` line."""
    import torch
    from repro_torch.distributed.sharding import (device_put,
                                                  param_shardings)
    from repro_torch.kernels.ops import COLLECTIVE_METER
    from repro_torch.models import moe
    from repro_torch.training import init_opt_state, make_train_step
    cards = sorted({d.index for d in mesh.devices.flat})
    params = device_put(init, param_shardings(cfg, init, mesh, "train"))
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, ocfg)
    stats = _train_stats()
    for i in cards:
        torch.cuda.synchronize(i)
        torch.cuda.reset_peak_memory_stats(i)
    for st in stats.values():
        st.reset()
    COLLECTIVE_METER.reset()
    hist = []
    for b in batches:
        moe.STATS.reset()
        t0 = time.perf_counter()
        _, _, m = step(params, opt, b)
        hist.append(dict(loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]),
                         dropped=moe.STATS.dropped,
                         seconds=time.perf_counter() - t0))
    for i in cards:
        torch.cuda.synchronize(i)
    launches = {n: st.launches for n, st in stats.items()}
    plain = {n: st.plain for n, st in stats.items() if st.plain}
    peak = [torch.cuda.max_memory_allocated(i) / 1e9 for i in cards]
    gathers, reduces = COLLECTIVE_METER.gathers, COLLECTIVE_METER.reduces
    a2a = COLLECTIVE_METER.all_to_alls
    metric_err = max(abs(g[k] - r[k]) / max(abs(r[k]), 1.0)
                     for g, r in zip(hist, ref["history"])
                     for k in ("loss", "grad_norm"))
    home = mesh.devices.flat[0]
    d_param = d_opt = 0.0
    inexact = []
    for tree, want in ((params, ref["params"]), (opt, ref["opt"])):
        for k, st in tree.items():
            got = st.full(home).float()
            w = want[k].to(home).float()
            diff = (got - w).abs()
            if not torch.equal(got, w):
                inexact.append(k)
            if tree is params:
                d_param = max(d_param, diff.max().item())
            else:
                d_opt = max(d_opt, (diff / (1 + w.abs())).max().item())
            del got, w, diff
    n_steps = len(batches)
    positions = mesh.size
    want = {n: 0 for n in stats}
    want["flash_attention_bwd"] = (attention_layers(cfg)
                                   * attention_positions(cfg, mesh) * n_steps)
    want["flash_attention"] = fwd_runs(cfg) * want["flash_attention_bwd"]
    drops = [h["dropped"] for h in hist]
    ref_drops = [h["dropped"] for h in ref["history"]]
    B, S = batches[0]["tokens"].shape
    line = dict(
        phase=phase, model=cfg.name, n_layers=cfg.n_layers, weights="f32",
        mesh_shape=[mesh.shape[a] for a in mesh.axis_names],
        cards=cards, batch=B, seq=S, steps=n_steps, remat=cfg.remat,
        attention_positions=attention_positions(cfg, mesh),
        losses=[h["loss"] for h in hist],
        grad_norms=[h["grad_norm"] for h in hist],
        ref_losses=[h["loss"] for h in ref["history"]],
        ref_grad_norms=[h["grad_norm"] for h in ref["history"]],
        metrics_rel_err=metric_err, max_param_err=d_param,
        param_err_in_lr=d_param / (ocfg.lr * n_steps),
        max_moment_rel_err=d_opt, bit_exact=not inexact,
        inexact_leaves=inexact[:8] if positions == 1 else None,
        moe_dropped=drops, ref_moe_dropped=ref_drops,
        s_per_step=[h["seconds"] for h in hist],
        ref_s_per_step=[h["seconds"] for h in ref["history"]],
        peak_gb_by_card=peak, ref_peak_gb=ref.get("peak_gb"),
        placed_gb=sum(t.numel() * t.element_size() for tree in (params, opt)
                      for st in tree.values() for _, t in st.unique()) / 1e9,
        launches_per_step={n: v / n_steps for n, v in launches.items()},
        plain=plain, gathers_per_step=gathers / n_steps,
        reduce_scatters_per_step=reduces / n_steps,
        moe_all_to_alls_per_step=a2a / n_steps)
    emit(line)
    check(all(math.isfinite(h["loss"]) for h in hist)
          and metric_err <= TRAIN_TOL,
          f"{phase} {cfg.name} {line['mesh_shape']}: losses "
          f"{line['losses']} / grad norms {line['grad_norms']} against the "
          f"unsharded {line['ref_losses']} / {line['ref_grad_norms']}")
    check(d_param <= ocfg.lr * n_steps and d_opt <= TRAIN_TOL,
          f"{phase} {cfg.name} {line['mesh_shape']}: params {d_param} (lr "
          f"a step {ocfg.lr}), moments {d_opt} apart from the unsharded "
          f"step")
    check(launches == want and not plain,
          f"{phase} {cfg.name} {line['mesh_shape']}: launches {launches} "
          f"(want {want}), plain {plain}")
    check(drops == ref_drops,
          f"{phase} {cfg.name} {line['mesh_shape']}: MoE drops {drops} "
          f"against the unsharded {ref_drops}")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return line


def train_mesh_model(arch: str, n_layers, batch: tuple, meshes,
                     phase: str = "train_mesh") -> None:
    """``arch`` at full width: its unsharded step on ``cuda:0``
    (``train_mesh_reference``), then each of ``meshes`` over repeated
    positions of ``cuda:0`` held to it (``train_mesh_run``); the model
    freed after, under 1 GB left allocated."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import Mesh
    t0 = time.perf_counter()
    cfg, init, ocfg, batches = train_mesh_inputs(arch, n_layers, batch)
    ref = train_mesh_reference(cfg, ocfg, init, batches)
    card = torch.device("cuda", 0)
    for shape in meshes:
        grid = np.empty(int(np.prod(shape)), dtype=object)
        grid[:] = [card] * grid.size
        train_mesh_run(cfg, ocfg, init, batches,
                       Mesh(grid.reshape(shape), ("data", "model")), ref,
                       phase)
    del init, ref, batches
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < 1e9, f"{held / 1e9:.2f} GB still allocated after the "
                      f"{arch} train steps were freed")
    emit(dict(phase="train_mesh_seconds", model=arch,
              seconds=time.perf_counter() - t0))


def train_parity_mesh(name: str, shape: tuple) -> None:
    """Two steps of reduced ``name`` in f32 with the state placed on a
    ``shape`` mesh over repeated positions of the card, against the
    unsharded step on the CPU (``parity_train_mesh``: ``TRAIN_TOL`` on
    loss, grad norm and moments, params within lr a step, equal MoE
    drops, flash forward and backward once a layer a position a step)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import api
    from repro_torch.training import AdamWConfig
    cfg = get_config(name).reduced()
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                       clip_norm=0.5)
    init = api.init_params(cfg, 0, torch.float32, device="cpu")
    batches = [{k: torch.from_numpy(v) for k, v in
                train_batch(cfg, i).items()} for i in range(2)]
    ref = train_mesh_reference(cfg, ocfg, init, batches, device="cpu")
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = [torch.device("cuda", 0)] * grid.size
    train_mesh_run(cfg, ocfg, init, [{k: v.cuda() for k, v in b.items()}
                                     for b in batches],
                   Mesh(grid.reshape(shape), ("data", "model")), ref,
                   "parity_train_mesh")


def phase_train_mesh() -> None:
    """Phase 8: the train step on meshes over repeated positions of
    ``cuda:0`` (one card: no interconnect measured). flash_attention and
    its backward at the per-shard shapes against their plain versions
    (``kernel_time_train_mesh``, f32), then for internlm2-1.8b at full
    width (``TRAIN_MESH_FULL_LAYERS`` layers), for
    ``TRAIN_MESH_MODELS`` (qwen3-moe, one layer; qwen2-vl-7b, two) and
    for ``TRAIN_MESH_FAMILIES`` (falcon-mamba-7b,
    zamba2-1.2b, whisper-base) the unsharded step and each mesh held to
    it (``train_mesh`` lines), one model at a time, and reduced llama4
    (dense layers between MoE layers, a shared expert) at (2, 2) against
    the CPU (``parity_train_mesh``)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    scratch = torch.empty(64 * MIB, dtype=torch.uint8, device="cuda")

    def flush():
        scratch.zero_()

    shapes = train_mesh_shapes(get_config(FULL_ARCH),
                               (FULL_BATCH, FULL_SEQ), TRAIN_MESHES)
    for arch, n_layers, batch, meshes in (TRAIN_MESH_MODELS
                                          + TRAIN_MESH_FAMILIES):
        cfg = get_config(arch)
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        shapes += train_mesh_shapes(cfg, batch, meshes)
    phase_train_kernels(flush, shapes, ("f32",), "kernel_time_train_mesh",
                        [s[:6] + ("f32", s[6]) for s in shapes])
    del scratch
    train_parity_mesh("llama4-maverick-400b-a17b", (2, 2))
    train_mesh_model(FULL_ARCH, TRAIN_MESH_FULL_LAYERS,
                     (FULL_BATCH, FULL_SEQ), TRAIN_MESHES)
    for arch, n_layers, batch, meshes in (TRAIN_MESH_MODELS
                                          + TRAIN_MESH_FAMILIES):
        train_mesh_model(arch, n_layers, batch, meshes)


# ------------------------------------------------------------ phase 9
#: The families the serving mesh added, each built through
#: ``launch.cases.build_case``: (arch, layers kept (None: all), batch,
#: prompt length). qwen2-vl and falcon-mamba at their published widths
#: cut to 4 layers, zamba2 to 12 (two shared-block sites), whisper whole
#: (1500 frames of seeded noise).
SERVE_MESH_MODELS = (("qwen2-vl-7b", 4, 8, 512),
                     ("falcon-mamba-7b", 4, 4, 1024),
                     ("zamba2-1.2b", 12, 8, 512),
                     ("whisper-base", None, 8, 32))
SERVE_MESHES = ((1, 1), (2, 1), (1, 2), (2, 2), (1, 4))
#: Meshes whose "model" axis does not divide a model's heads (qwen2-vl's
#: 28 on 8 columns, whisper's 8 on 16): the attention whole on each
#: batch row's first column. Run after ``SERVE_MESHES``, in f32 and bf16.
SERVE_WHOLE_HEADS = {"qwen2-vl-7b": (1, 8), "whisper-base": (1, 16)}
SERVE_STEPS = 16
#: Mesh logits against the unsharded step's, relative to the largest
#: |logit|, in f32 (TF32 off).
SERVE_TOL = 1e-4
SERVE_KERNELS = ("flash_attention", "sgmv", "bgmv")


def serve_mesh_counts(cfg, M: int, rows: int,
                      steps: int = SERVE_STEPS) -> dict:
    """Launches of the path's kernels in one prefill and ``steps``
    decode steps with ``rows`` batch rows of ``M`` columns: flash per
    attention layer an attention position (every position, or each
    row's first when the attention block is whole), sgmv per LoRA
    projection a position that computes it (prefill: q/k/v on the
    attention positions, o there too unless a D the columns do not
    divide makes it whole on each row's first), bgmv likewise each
    decode step."""
    from repro_torch.distributed.sharding import whole_blocks
    from repro_torch.models.hybrid import attn_sites
    fam = cfg.family.name
    attn = {"ENCDEC": cfg.n_enc_layers + cfg.n_layers, "SSM": 0}.get(
        fam, cfg.n_layers) if fam != "HYBRID" else len(attn_sites(cfg))
    whole = whole_blocks(cfg, M)
    pos = (1 if "attn" in whole else M) * rows
    o_pos = (1 if {"attn", "out"} & whole else M) * rows
    lora = attn * (3 * pos + o_pos) if fam in ("DENSE", "VLM",
                                               "HYBRID") else 0
    return {"flash_attention": attn * pos, "sgmv": lora,
            "bgmv": lora * steps}


def serve_mesh_args(cfg, B: int, S: int, dtype, dev, seed: int = 0):
    """The prefill case's arguments on the card from a seed: params,
    tokens, a LoRA arena of 8 random adapters at the case's rank (the
    hybrid's over its sites), one adapter a row, M-RoPE positions of a
    text-image-text prompt (a 16x16 patch grid at S 512), frames of
    seeded noise."""
    import torch
    from repro_torch.launch import cases
    from repro_torch.models import api, hybrid
    from repro_torch.models.lora_apply import (init_lora_slots,
                                               random_lora_weights,
                                               write_adapter_to_slot)
    params = api.init_params(cfg, seed, dtype, device=dev)
    toks, kw = family_inputs(cfg, B, S, seed + 1, dtype, dev)
    if cfg.mrope:
        kw["mrope_pos"] = mrope_positions(B, S, image=True).to(dev)
    lora, idx = (), ()
    if cfg.family.name in ("DENSE", "VLM", "HYBRID"):
        n = (len(hybrid.attn_sites(cfg)) if cfg.family.name == "HYBRID"
             else cfg.n_layers)
        r = cases.LORA_RMAX
        lora = init_lora_slots(cases.LORA_SLOTS, n, cfg.d_model, cfg.q_dim,
                               cfg.kv_dim, r, dtype, device=dev)
        g = torch.Generator(device=dev).manual_seed(seed + 2)
        for i in range(cases.LORA_SLOTS):
            write_adapter_to_slot(lora, random_lora_weights(
                g, 16 << (i % 3), r, n, cfg.d_model, cfg.q_dim, cfg.kv_dim,
                dtype), i)
        idx = torch.arange(B, dtype=torch.int32, device=dev) % 8
    return params, toks, lora, idx, kw


def _decode_state(state, dec_sds, dec_sh):
    """The prefill's state as the decode case takes it: each stack
    gathered, its positions zero-padded to the case's slab, placed as
    the case's sharding says (``dec_sh`` None: whole)."""
    import torch.nn.functional as F
    from repro_torch.distributed.sharding import ShardedTensor
    from repro_torch.launch.cases import _placed
    if isinstance(state, (tuple, list)):
        return tuple(_decode_state(s, d, None if dec_sh is None else h)
                     for s, d, h in zip(state, dec_sds,
                                        dec_sh or [None] * len(state)))
    t = state.full() if isinstance(state, ShardedTensor) else state
    if t.dim() == 5 and t.shape[2] < dec_sds.shape[2]:
        t = F.pad(t, (0, 0, 0, 0, 0, dec_sds.shape[2] - t.shape[2]))
    return t if dec_sh is None else _placed(t, dec_sh)


def serve_mesh_run(cfg, arch: str, args: tuple, mesh, B: int,
                   S: int, steps: int = SERVE_STEPS) -> dict:
    """The prefill case and ``steps`` greedy steps of the decode case
    (``build_case``, a slab of S + steps positions) on ``mesh``
    (None: unsharded, the closures on the unplaced arguments), under the
    dry-run's scope (batch rows over "data", exact reductions,
    token-parallel MoE)."""
    import contextlib

    import torch
    from repro_torch.distributed import act_sharding as acts
    from repro_torch.launch import cases
    dev = args[1].device
    shape = None if mesh is None else tuple(mesh.shape.values())
    mesh = mesh or repeated_mesh((1, 1), dev)
    fn_p, _, sh_p = cases.build_case(arch, "prefill_32k", mesh, B,
                                     config=cfg, seq_override=S)
    fn_d, sds_d, sh_d = cases.build_case(arch, "decode_32k", mesh, B,
                                         config=cfg,
                                         seq_override=S + steps)
    if shape is None:
        placed, scope = args, contextlib.nullcontext()
    else:
        placed = cases.place(cfg, "prefill", args, sh_p)
        scope = acts.activation_sharding(("data",), mesh=mesh,
                                         exact_reductions=True,
                                         moe_token_parallel=True)
    p, toks, lora, idx, extra = placed

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    with torch.no_grad(), scope:
        sync()
        t0 = time.perf_counter()
        logits, state = fn_p(*placed)
        sync()
        pre_ms = (time.perf_counter() - t0) * 1e3
        specs = [tuple(t.sharding.spec) for t in flat(state)
                 if hasattr(t, "sharding")]
        dstate = _decode_state(state, sds_d[2],
                               None if shape is None else sh_d[2])
        del state
        out, toks_out, ms = [logits.float()], [], []
        start = (int(extra["mrope_pos"].max()) + 1 if cfg.mrope else S)
        for i in range(steps):
            tok = logits.argmax(-1)[:, None].int()
            toks_out.append(tok)
            clen = torch.full((B,), S + i, dtype=torch.int32, device=dev)
            dx = ({"mrope_pos": torch.full((3, B, 1), start + i,
                                           dtype=torch.int32, device=dev)}
                  if cfg.mrope else {})
            sync()
            t0 = time.perf_counter()
            logits, dstate = fn_d(p, tok, dstate, clen, lora, idx, dx)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(logits.float())
    return dict(logits=out, tokens=torch.cat(toks_out, 1).cpu(),
                prefill_ms=pre_ms, decode_ms=statistics.median(ms[1:]),
                specs=specs)


def serve_mesh_state_specs(cfg, B: int, S: int, shape) -> list:
    """The rule table's specs of the prefill's state stacks on a mesh of
    ``shape``: ``kv_cache_spec`` for K/V, ``ssm_state_spec`` and
    ``conv_state_spec`` for the SSM state."""
    from repro_torch.distributed import sharding as shp
    from repro_torch.models.hybrid import attn_sites
    mesh = repeated_mesh(shape, "cpu")
    L, fam = cfg.n_layers, cfg.family.name
    kv = (L, B, S, cfg.n_kv_heads, cfg.head_dim)
    if fam in ("DENSE", "MOE", "VLM"):
        return [shp.kv_cache_spec(mesh, kv)] * 2
    if fam == "ENCDEC":
        xkv = (L, B, cfg.enc_ctx, cfg.n_kv_heads, cfg.head_dim)
        return ([shp.kv_cache_spec(mesh, kv)] * 2
                + [shp.kv_cache_spec(mesh, xkv)] * 2)
    if fam == "SSM":
        return [shp.ssm_state_spec(mesh, (L, B, cfg.d_inner, cfg.d_state)),
                shp.conv_state_spec(mesh, (L, B, cfg.d_conv - 1,
                                           cfg.d_inner))]
    n = len(attn_sites(cfg))
    return [shp.ssm_state_spec(mesh, (L, B, cfg.n_ssm_heads,
                                      cfg.ssm_head_dim, cfg.d_state)),
            shp.conv_state_spec(mesh, (L, B, cfg.d_conv - 1,
                                       cfg.d_inner + 2 * cfg.d_state))] + [
        shp.kv_cache_spec(mesh, (n, B, S, cfg.n_kv_heads,
                                 cfg.head_dim))] * 2


def serve_mesh_kernels(cfg, B: int, S: int, record: dict,
                       meshes=((2, 2), (1, 4))) -> None:
    """The model's kernels at the column shapes of ``meshes`` against
    their plain versions, timed beside their bounds and a PyTorch call
    (``kernel_time_serve_mesh`` lines): flash_attention over a batch
    row's rows and a column's heads (causal; whisper's encoder full over
    its 1500 frames), sgmv and bgmv at a column's LoRA dout (the case's
    rank 64, 8 slots); on a mesh whose columns do not divide the heads,
    at the whole attention block's shapes (its first column's)."""
    import importlib

    import torch
    import torch.nn.functional as F
    from repro_torch.launch import cases
    bgmv = importlib.import_module("repro_torch.kernels.bgmv")
    sgmv = importlib.import_module("repro_torch.kernels.sgmv")
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2626)
    scratch = torch.empty(64 * MIB, dtype=torch.uint8, device=dev)

    def flush():
        scratch.zero_()

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(torch.bfloat16)

    from repro_torch.distributed.sharding import whole_blocks
    fam, dh = cfg.family.name, cfg.head_dim
    if not cfg.n_heads:          # attention-free: no kernel on its path
        return
    for d, M in meshes:
        Br = B // d
        whole = whole_blocks(cfg, M)
        Mh = 1 if "attn" in whole else M           # the heads' columns
        Mo = 1 if {"attn", "out"} & whole else M   # o's output columns
        cases_fa = ([(Br, cfg.enc_ctx, False), (Br, S, True)]
                    if fam == "ENCDEC" else [(Br, S, True)])
        for Bt, T, causal in cases_fa:
            H, Kh = cfg.n_heads // Mh, max(cfg.n_kv_heads // Mh, 1)
            q = randn(Bt, T, H, dh)
            k, v = randn(Bt, T, Kh, dh), randn(Bt, T, Kh, dh)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            fa.STATS.reset()
            fa.flash_attention(q, k, v, causal)
            inst = launched(fa, fa.flash_instance(q.dtype, dh))
            checked_and_timed(
                "kernel_time_serve_mesh", flush, record, "flash_attention",
                f"{cfg.name} ({d}, {M}): {'causal' if causal else 'full'}"
                f", H {H}/Kh {Kh}, q {tuple(q.shape)}",
                lambda: fa.flash_attention(q, k, v, causal),
                lambda: fa.flash_attention_plain(q, k, v, causal),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True),
                "bf16_out", flash_bound(q, k, v, causal),
                extra=FLASH_P_ROUNDING * fa.flash_attention_plain(
                    q.float(), k.float(), v.float().abs(), causal),
                instance=inst, model=cfg.name, mesh_shape=[d, M])
        if fam not in ("VLM", "HYBRID"):
            continue
        n, r, tile = cases.LORA_SLOTS, cases.LORA_RMAX, 128
        idx = torch.arange(Br, device=dev).int() % n
        ts = torch.randint(0, n, (Br * S // tile,), generator=g,
                           device=dev).int()
        projs = {("q", cfg.d_model, cfg.q_dim // Mh),
                 ("k/v", cfg.d_model, max(cfg.kv_dim // Mh, dh)),
                 ("o", cfg.q_dim, cfg.d_model // Mo)}
        for proj, din, dout in sorted(projs):
            A = randn(n, din, r, scale=din ** -0.5)
            Bw = randn(n, r, dout, scale=r ** -0.5)
            x = randn(Br, din)
            checked_and_timed(
                "kernel_time_serve_mesh", flush, record, "bgmv",
                f"{cfg.name} ({d}, {M}) {proj}: x {tuple(x.shape)}, "
                f"dout {dout}",
                lambda: bgmv.bgmv(x, A, Bw, idx),
                lambda: bgmv.bgmv_plain(x, A, Bw, idx),
                lambda: torch.bmm(torch.bmm(x[:, None], A[idx.long()]),
                                  Bw[idx.long()]), "lora_bf16",
                bound_ms(nbytes(x, idx) + idx.unique().numel()
                         * nbytes(A[0], Bw[0]) + Br * dout * 2,
                         2 * Br * r * (din + dout), "bf16"),
                model=cfg.name, mesh_shape=[d, M])
            x = randn(Br * S, din)
            xt = x.view(-1, tile, din)
            sgmv.STATS.reset()
            sgmv.sgmv(x, A, Bw, ts, tile)
            inst = launched(sgmv, sgmv.sgmv_instance(x.dtype, A.dtype, r,
                                                     tile))
            checked_and_timed(
                "kernel_time_serve_mesh", flush, record, "sgmv",
                f"{cfg.name} ({d}, {M}) {proj}: x {tuple(x.shape)}, "
                f"dout {dout}",
                lambda: sgmv.sgmv(x, A, Bw, ts, tile),
                lambda: sgmv.sgmv_plain(x, A, Bw, ts, tile),
                lambda: torch.bmm(torch.bmm(xt, A[ts.long()]),
                                  Bw[ts.long()]), "lora_bf16",
                bound_ms(nbytes(x, ts) + ts.unique().numel()
                         * nbytes(A[0], Bw[0]) + Br * S * dout * 2,
                         2 * Br * S * r * (din + dout), "bf16"),
                instance=inst, model=cfg.name, mesh_shape=[d, M])


def serve_mesh_model(arch: str, n_layers, B: int, S: int,
                     stats: dict) -> dict:
    """One model of phase 9: its kernels at the column shapes, then the
    f32 gates (each mesh's greedy tokens equal to the unsharded case's
    over ``SERVE_STEPS`` steps, logits within ``SERVE_TOL``, the state
    in the rule table's layout, the kernels launched the counted number
    of times and no plain version), then bf16 ms a prefill, ms a decode
    step and peak memory unsharded (first and last), at (1, 1), (2, 2)
    and its ``SERVE_WHOLE_HEADS`` mesh. One ``serve_mesh`` line a mesh
    and dtype."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t_start = time.perf_counter()
    errs: dict = {}
    extra = ((SERVE_WHOLE_HEADS[arch],) if arch in SERVE_WHOLE_HEADS
             else ())
    serve_mesh_kernels(cfg, B, S, errs, ((2, 2), (1, 4)) + extra)
    dev = torch.device("cuda")
    args = serve_mesh_args(cfg, B, S, torch.float32, dev)
    base = serve_mesh_run(cfg, arch, args, None, B, S)
    for shape in SERVE_MESHES + extra:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for st in stats.values():
            st.reset()
        got = serve_mesh_run(cfg, arch, args, repeated_mesh(shape, dev),
                             B, S)
        launches = {n: st.launches for n, st in stats.items()}
        plain = {n: st.plain for n, st in stats.items()}
        want = serve_mesh_counts(cfg, shape[1], shape[0] if B % shape[0]
                                 == 0 else 1)
        err = max(((g - w).abs().max() / w.abs().max().clamp(min=1.0))
                  .item() for g, w in zip(got["logits"], base["logits"]))
        line = dict(
            phase="serve_mesh", model=cfg.name, weights="f32",
            mesh_shape=list(shape), n_layers=cfg.n_layers, batch=[B, S],
            steps=SERVE_STEPS, logits_max_rel_err=err, tol=SERVE_TOL,
            bit_identical=all(torch.equal(g, w) for g, w in
                              zip(got["logits"], base["logits"])),
            tokens_identical=bool(torch.equal(got["tokens"],
                                              base["tokens"])),
            state_specs_ok=[tuple(s) for s in serve_mesh_state_specs(
                cfg, B, S, shape)] == got["specs"],
            launches=launches, launches_expected=want, plain_calls=plain,
            sgmv_launches_by_instance=dict(stats["sgmv"].instances),
            prefill_ms=got["prefill_ms"], decode_ms_per_step=got["decode_ms"],
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        emit(line)
        check(line["tokens_identical"] and err <= SERVE_TOL
              and line["state_specs_ok"],
              f"serve_mesh {cfg.name} {shape}: {line}")
        check(all(launches[n] == want[n] for n in SERVE_KERNELS)
              and not any(plain.values()),
              f"serve_mesh {cfg.name} {shape}: kernel launches {launches} "
              f"(want {want}) or a plain version ran {plain}")
    del args, base
    gc.collect()
    torch.cuda.empty_cache()
    args = serve_mesh_args(cfg, B, S, torch.bfloat16, dev)
    # The unsharded case first and last: host times vary run to run.
    for shape in (None, (1, 1), (2, 2)) + extra + (None,):
        torch.cuda.reset_peak_memory_stats()
        got = serve_mesh_run(cfg, arch, args, shape and repeated_mesh(
            shape, dev), B, S)
        emit(dict(phase="serve_mesh", model=cfg.name, weights="bf16",
                  mesh_shape=list(shape) if shape else None,
                  n_layers=cfg.n_layers, batch=[B, S],
                  prefill_ms=got["prefill_ms"],
                  decode_ms_per_step=got["decode_ms"],
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                  finite=all(bool(torch.isfinite(x).all())
                             for x in got["logits"])))
    del args
    return dict(seconds=time.perf_counter() - t_start, errs=errs)


def phase_serve_mesh() -> None:
    """Phase 9: the VLM, SSM, hybrid and enc-dec families served on
    meshes over repeated positions of the card, through
    ``launch.cases.build_case`` (``SERVE_MESH_MODELS``, one at a time,
    each freed before the next), with a ``phase_serve_mesh`` line of
    each model's seconds."""
    import importlib

    import torch
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in SERVE_KERNELS}
    secs = {}
    for arch, n_layers, B, S in SERVE_MESH_MODELS:
        secs[arch] = serve_mesh_model(arch, n_layers, B, S,
                                      stats)["seconds"]
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        check(held < 1e9, f"{held / 1e9:.2f} GB still allocated after "
                          f"{arch} was freed")
    emit(dict(phase="phase_serve_mesh", seconds=secs))


DRYRUN_ARCH = "internlm2-1.8b"
DRYRUN_LAYERS = 4
# (batch, sequence): the train and prefill cases' rows, and the decode
# case's rows and slab positions
DRYRUN_SHAPES = {"train_4k": (4, 2048), "prefill_32k": (4, 2048),
                 "decode_32k": (16, 4096)}
DRYRUN_REPS = 3


def dryrun_inputs(cfg, kind: str, args: tuple, dev, seed: int) -> tuple:
    """A case's arguments (``build_case``'s meta tensors) drawn on
    ``dev`` from a seed in their dtypes: weights N(0, 0.02), zero
    moments, tokens in the vocabulary, adapter slots below the arena's,
    cache lengths inside the slab, LoRA and slab N(0, 1) scaled."""
    import torch
    from repro_torch.launch import cases
    g = torch.Generator(device=dev).manual_seed(seed)

    def fill(t, name=""):
        shape = tuple(t.shape)
        if t.dtype == torch.int32:
            hi = cases.LORA_SLOTS if name == "adapter" else cfg.vocab_size
            return torch.randint(0, hi, shape, generator=g, device=dev,
                                 dtype=torch.int32)
        return (torch.randn(shape, generator=g, device=dev) * 0.02) \
            .to(t.dtype)

    def tree(x, name=""):
        if isinstance(x, dict):
            return {k: tree(v, k) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(tree(v, name) for v in x)
        return fill(x, name)

    if kind == "train":
        return (tree(args[0]), {k: torch.zeros(tuple(v.shape), dtype=v.dtype,
                                               device=dev)
                                for k, v in args[1].items()}, tree(args[2]))
    if kind == "prefill":
        params, tok, lora, idx, extra = args
        return (tree(params), fill(tok), tree(lora), fill(idx, "adapter"),
                tree(extra))
    params, tok, state, clen, lora, idx, extra = args
    S = state[0].shape[2]
    clen = torch.randint(S // 2, S - 1, tuple(clen.shape), generator=g,
                         device=dev, dtype=torch.int32)
    return (tree(params), fill(tok), tree(state), clen, tree(lora),
            fill(idx, "adapter"), tree(extra))


def step_bytes_lb(kind: str, placed: tuple) -> int:
    """Bytes the step cannot avoid: every weight read once (the
    embedding table only where training updates it: serving looks up
    rows), and in training the params and both moments AdamW reads and
    writes back."""
    def leaves(tree):
        return [t for _, t in tree.unique()] if hasattr(tree, "unique") \
            else [tree]
    if kind == "train":
        params, opt, _ = placed
        return 2 * sum(nbytes(*leaves(v)) for v in params.values()) + \
            2 * sum(nbytes(*leaves(v)) for k, v in opt.items()
                    if k != "step")
    mp = placed[0]
    return sum(nbytes(*leaves(st)) for k, st in mp.placed.items()
               if k != "embed/tok")


def phase_dryrun() -> None:
    """Phase 10 (module docstring): the dry-run's count against the
    measured step, and the sequence-parallel boundary A/B."""
    import dataclasses
    import torch
    from repro_torch.configs import SHAPE_BY_NAME, get_config
    from repro_torch.distributed import act_sharding as acts
    from repro_torch.launch import cases, dryrun
    from repro_torch.roofline import analysis
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config(DRYRUN_ARCH),
                              n_layers=DRYRUN_LAYERS)
    mesh = repeated_mesh((1, 1), dev)
    for shape, (B, S) in DRYRUN_SHAPES.items():
        kind = SHAPE_BY_NAME[shape].kind
        rec = dryrun.count_cell(DRYRUN_ARCH, shape,
                                dryrun.meta_mesh((1, 1), ("data", "model")),
                                config=cfg, seq_override=S,
                                batch_override=B, depth="full")
        fn, args, sh = cases.build_case(DRYRUN_ARCH, shape, mesh, B,
                                        config=cfg, seq_override=S)
        placed = cases.place(cfg, kind, dryrun_inputs(cfg, kind, args,
                                                      dev, 0), sh)
        lb = step_bytes_lb(kind, placed)
        grad = contextlib.nullcontext() if kind == "train" \
            else torch.no_grad()

        def call():
            with dryrun.scope(mesh, kind), grad:
                return fn(*placed)

        call()
        times = []
        for _ in range(DRYRUN_REPS):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            call()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e) / 1e3)
        step_s = statistics.median(times)
        flops = rec["cost"]["flops"]
        bound = max(flops / analysis.PEAK_FLOPS, lb / analysis.HBM_BPS)
        emit(dict(phase="dryrun_vs_step", arch=DRYRUN_ARCH, shape=shape,
                  kind=kind, layers=DRYRUN_LAYERS, batch=B, seq=S,
                  flops=flops, bytes_accessed=rec["cost"]["bytes_accessed"],
                  bytes_lb=lb, bound_s=bound,
                  bound_by="operations" if flops / analysis.PEAK_FLOPS
                  >= lb / analysis.HBM_BPS else "bytes",
                  step_s=step_s, ratio=step_s / bound,
                  flops_by_op=rec["cost"]["flops_by_op"],
                  count_s=rec["count_s"]))
        check(step_s >= bound, f"dryrun_vs_step {shape}: the measured "
                               f"{step_s:.4g} s is below the bound "
                               f"{bound:.4g} s: the count misses work")
        del placed, fn
        gc.collect()
        torch.cuda.empty_cache()
    # seq_shard_boundary A/B at (1, 2) over repeated positions
    B, S = DRYRUN_SHAPES["train_4k"]
    mesh = repeated_mesh((1, 2), dev)
    fn, args, sh = cases.build_case(DRYRUN_ARCH, "train_4k", mesh, B,
                                    config=cfg, seq_override=S)
    runs = {}
    for seq in (False, True):
        params, opt, batch = cases.place(
            cfg, "train", dryrun_inputs(cfg, "train", args, dev, 0), sh)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        metrics, secs = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            with acts.activation_sharding(("data",), mesh=mesh,
                                          seq_shard_boundary=seq):
                _, _, m = fn(params, opt, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - ts)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[seq] = dict(
            metrics=metrics, s_per_step=secs,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            state={k: v.full().cpu()
                   for k, v in {**params, **opt}.items()})
        del params, opt, batch
    same = runs[False]["metrics"] == runs[True]["metrics"] and all(
        torch.equal(a, runs[True]["state"][k])
        for k, a in runs[False]["state"].items())
    emit(dict(phase="seq_shard_ab", arch=DRYRUN_ARCH, mesh=[1, 2],
              layers=DRYRUN_LAYERS, batch=B, seq=S, bit_identical=same,
              **{f"{'on' if k else 'off'}_{f}": runs[k][f]
                 for k in runs for f in ("metrics", "s_per_step",
                                         "peak_gb")}))
    check(same, "seq_shard_ab: the train step with seq_shard_boundary "
                "is not bit-identical to the step without it")
    emit(dict(phase="phase_dryrun", seconds=time.perf_counter() - t0))


# ----------------------------------------------------------- phase 11
#: Configs on meshes whose "model" axis divides none of their blocks
#: (``sharding.whole_blocks``): internlm2-1.8b (d_model 2048, d_ff 8192,
#: 16 heads, 8 KV heads; its vocabulary of 92544 splits) cut to 4
#: layers and zamba2-1.2b (d_inner 4096, 64 Mamba2 heads, 32 heads,
#: d_ff 8192; vocabulary 32000 whole) cut to 6, so that the shared
#: block's one site and Mamba2 both run: (arch, layers, serving (B, S),
#: train (B, S)).
UNEVEN_SPLIT_MODELS = (("internlm2-1.8b", 4, (4, 512), (4, 512)),
                       ("zamba2-1.2b", 6, (4, 512), (4, 512)))
UNEVEN_SPLIT_MESHES = ((1, 3), (2, 3))
UNEVEN_SPLIT_STEPS = 8


def phase_uneven() -> None:
    """Phase 11 (module docstring): ``UNEVEN_SPLIT_MODELS`` served and
    trained on ``UNEVEN_SPLIT_MESHES`` over repeated positions of the
    card against the unsharded step, one model at a time. The unsharded
    case and step run once before their timed run, so that neither
    times a first call's set-up; the rule table's warning for each
    weight it leaves whole is silenced."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="fit_spec")
        _phase_uneven()


def _phase_uneven() -> None:
    import dataclasses
    import importlib

    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import whole_blocks
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in SERVE_KERNELS}
    steps = UNEVEN_SPLIT_STEPS
    secs = {}
    for arch, n_layers, (B, S), train_batch_shape in UNEVEN_SPLIT_MODELS:
        t1 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        args = serve_mesh_args(cfg, B, S, torch.float32, dev)
        serve_mesh_run(cfg, arch, args, None, B, S, steps)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for st in stats.values():
            st.reset()
        base = serve_mesh_run(cfg, arch, args, None, B, S, steps)
        base_peak = torch.cuda.max_memory_allocated() / 1e9
        one = {n: st.launches for n, st in stats.items()}
        check(one == serve_mesh_counts(cfg, 1, 1, steps),
              f"uneven_serve {cfg.name} unsharded: launches {one}")
        for shape in UNEVEN_SPLIT_MESHES:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for st in stats.values():
                st.reset()
            got = serve_mesh_run(cfg, arch, args, repeated_mesh(shape, dev),
                                 B, S, steps)
            launches = {n: st.launches for n, st in stats.items()}
            plain = {n: st.plain for n, st in stats.items()}
            rows = shape[0] if B % shape[0] == 0 else 1
            want = serve_mesh_counts(cfg, shape[1], rows, steps)
            err = max(((g - w).abs().max() / w.abs().max().clamp(min=1.0))
                      .item() for g, w in zip(got["logits"], base["logits"]))
            line = dict(
                phase="uneven_serve", model=cfg.name, weights="f32",
                mesh_shape=list(shape), n_layers=cfg.n_layers,
                batch=[B, S], steps=steps,
                whole=sorted(whole_blocks(cfg, shape[1])),
                logits_max_rel_err=err, tol=SERVE_TOL,
                tokens_identical=bool(torch.equal(got["tokens"],
                                                  base["tokens"])),
                state_specs_ok=[tuple(x) for x in serve_mesh_state_specs(
                    cfg, B, S, shape)] == got["specs"],
                launches=launches, launches_expected=want,
                launches_unsharded=one, plain_calls=plain,
                sgmv_launches_by_instance=dict(stats["sgmv"].instances),
                prefill_ms=got["prefill_ms"],
                decode_ms_per_step=got["decode_ms"],
                ref_prefill_ms=base["prefill_ms"],
                ref_decode_ms_per_step=base["decode_ms"],
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                ref_peak_mem_gb=base_peak)
            emit(line)
            check(line["tokens_identical"] and err <= SERVE_TOL
                  and line["state_specs_ok"],
                  f"uneven_serve {cfg.name} {shape}: {line}")
            # every block whole: each batch row's first column launches
            # what the unsharded step does, the other columns nothing
            check(launches == want and want == {n: rows * v for n, v in
                                                one.items()}
                  and not any(plain.values()),
                  f"uneven_serve {cfg.name} {shape}: kernel launches "
                  f"{launches} (want {want}), plain {plain}")
        del args, base
        gc.collect()
        torch.cuda.empty_cache()
        tcfg, init, ocfg, batches = train_mesh_inputs(arch, n_layers,
                                                      train_batch_shape)
        batches = batches[:1]
        train_mesh_reference(tcfg, ocfg, init, batches)
        ref = train_mesh_reference(tcfg, ocfg, init, batches)
        for shape in UNEVEN_SPLIT_MESHES:
            train_mesh_run(tcfg, ocfg, init, batches,
                           repeated_mesh(shape, dev), ref, "uneven_train")
        del init, ref, batches
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        check(held < 1e9, f"{held / 1e9:.2f} GB still allocated after "
                          f"{arch} was freed")
        secs[arch] = time.perf_counter() - t1
    emit(dict(phase="phase_uneven", seconds=secs,
              total_s=time.perf_counter() - t0))


KERNELS = {
    "bgmv": ("src/repro_torch/csrc/bgmv.cu", "src/repro/kernels/bgmv.py:39"),
    "sgmv": ("src/repro_torch/csrc/sgmv.cu", "src/repro/kernels/sgmv.py:37"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:67"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:67"),
}
# The engine whose trace gives a kernel's ``launches`` in the kernels
# line: the default path for the decode-path kernels, the dense slab
# for flash_attention (the default path never runs it).
LAUNCHES_FROM = {"bgmv": "fused", "sgmv": "fused",
                 "paged_attention": "fused", "flash_attention": "dense"}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs "
              "the GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    try:
        dev = phase_device()
        rows, _ = phase_kernels()
        phase_parity()
        phase_parity_engines()
        phase_parity_spec()
        phase_parity_moe()
        phase_parity_vlm()
        phase_parity_families()
        from repro_torch.configs import get_config
        from repro_torch.models import api
        cfg = get_config("chameleon-llama-7b")
        params = api.init_params(cfg, seed=0, dtype=torch.bfloat16)
        engines = phase_engine(cfg, params)
        phase_tiers(cfg, params, engines["fused"])
        phase_mesh(cfg, params)
        phase_examples(cfg, params, engines["fused"])
        # Free Llama's 13.5 GB before the 42.3 GB of the MoE model.
        del params
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        check(held < 1e9, f"{held / 1e9:.2f} GB still allocated after "
                          f"the Llama engines and tiers were freed")
        phase_engine_moe(cfg.vocab_size, greedy_requests(cfg))
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        check(held < 1e9, f"{held / 1e9:.2f} GB still allocated after "
                          f"the MoE engines were freed")
        phase_families()
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        check(held < 1e9, f"{held / 1e9:.2f} GB still allocated after "
                          f"the families were freed")
        bwd = phase_train()
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        check(held < 1e9, f"{held / 1e9:.2f} GB still allocated after "
                          f"the training phase")
        phase_train_mesh()
        gc.collect()
        torch.cuda.empty_cache()
        phase_serve_mesh()
        gc.collect()
        torch.cuda.empty_cache()
        phase_dryrun()
        gc.collect()
        torch.cuda.empty_cache()
        phase_uneven()
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    emit({"kernels": [
        dict(name=n, route="cuda", source=KERNELS[n][0],
             replaces=KERNELS[n][1],
             launches=engines[LAUNCHES_FROM[n]]["launches"][n],
             max_abs_err=rows[n]["max_abs_err"], ms=rows[n]["ms"],
             plain_ms=rows[n]["plain_ms"], bound_ms=rows[n]["bound_ms"],
             bound_by=rows[n]["bound_by"], library_ms=rows[n]["library_ms"])
        for n in KERNELS] + [
        dict(name="flash_attention_bwd", route="cuda",
             instance=bwd["instance"],
             source="src/repro_torch/csrc/flash_attention_bwd.cu",
             replaces=KERNELS["flash_attention"][1],
             launches=bwd["launches"], max_abs_err=bwd["max_abs_err"],
             ms=bwd["ms"], plain_ms=bwd["plain_ms"],
             bound_ms=bwd["bound_ms"], bound_by=bwd["bound_by"],
             library_ms=bwd["library_ms"]),
        dict(name="flash_attention_tf32x3", route="cuda", instance="tf32x3",
             source=KERNELS["flash_attention"][0],
             replaces=KERNELS["flash_attention"][1],
             launches=bwd["fwd_launches"],
             max_abs_err=bwd["forward"]["max_abs_err"],
             ms=bwd["forward"]["ms"], plain_ms=bwd["forward"]["plain_ms"],
             bound_ms=bwd["forward"]["bound_ms"],
             bound_by=bwd["forward"]["bound_by"],
             library_ms=bwd["forward"]["library_ms"])]})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
