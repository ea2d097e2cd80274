"""Roofline analysis over the port's dry-run records, at H100 constants.

Port of ``src/repro/roofline/analysis.py``. Three terms per (arch ×
shape × mesh), all in seconds per step:

    compute    = FLOPs            / (peak FLOP/s per GPU)
    memory     = bytes            / (HBM bytes/s per GPU)
    collective = collective_bytes / (link bytes/s per GPU)

The port's dry-run (``launch/dryrun.py``) records the busiest position's
FLOPs and bytes and its collectives' per-device wire bytes, so no
further division by the device count is needed. The counts span the
whole step (the port runs no layer scan whose body a compiler counts
once), so ``analyze_cell`` multiplies by no trip count; ``scan_trips``
is kept for comparison with the reference's rows. The dominant term is
the bottleneck.

MODEL_FLOPS (usefulness check):
    train:   6·N·D      (N params — active for MoE; D tokens processed)
    prefill: 2·N·D
    decode:  2·N·B      (one token per request) + 2·B·KV·kv_bytes-ish
The ratio MODEL_FLOPS / (counted FLOPs × devices) exposes remat,
padding and replicated work.

Constants (H100 SXM5 datasheet; every time derived from them is a
bound, not a measurement): 989e12 FLOP/s dense bf16 on tensor cores
and 3.35e12 B/s of HBM3 a GPU. Links: 450e9 B/s a direction over
NVLink among the 8 GPUs of a node, and 50e9 B/s a GPU across nodes
(one 400 Gb/s NDR InfiniBand NIC a GPU). The production meshes' axes
(16 and 32 positions) span nodes, so their collectives take the
inter-node rate.

    python -m repro_torch.roofline.analysis [results/torch_dryrun.json]

prints the table that ``benchmarks/roofline_table.py`` prints for the
reference.
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass

from repro_torch.configs import SHAPE_BY_NAME, get_config
from repro_torch.models.base import Family

# NVIDIA H100 SXM5 (datasheet).
PEAK_FLOPS = 989e12          # dense bf16 / GPU (tensor cores)
HBM_BPS = 3.35e12            # HBM3 bytes/s / GPU
NVLINK_BPS = 450e9           # bytes/s / GPU / direction, within a node
NODE_GPUS = 8                # GPUs a node shares NVLink among
IB_BPS = 50e9                # bytes/s / GPU across nodes (400 Gb/s NDR)


def link_bps(n_devices: int) -> float:
    """The per-GPU link rate of a collective over ``n_devices``: NVLink
    within a node, the inter-node NIC past it."""
    return NVLINK_BPS if n_devices <= NODE_GPUS else IB_BPS


def scan_trips(arch: str, shape_name: str) -> int:
    """Executions of the reference's layer-scan body per step (what its
    ``analyze_cell`` multiplies XLA's once-counted body by). The port's
    counts already span the step; this is kept to compare the two."""
    from repro_torch.launch.cases import MICROBATCHES
    cfg = get_config(arch)
    kind = SHAPE_BY_NAME[shape_name].kind
    if cfg.family == Family.MOE:
        base = cfg.n_layers // cfg.moe_every
    elif cfg.family == Family.HYBRID:
        base = cfg.n_layers // cfg.attn_every
    else:
        base = cfg.n_layers
    mb = MICROBATCHES.get(arch, 1)
    if kind == "train":
        base *= mb
    elif kind == "prefill":
        base *= min(mb, 2)
    return max(base, 1)


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float          # analytic HBM lower bound (see memory_lb_bytes)
    memory_hlo_s: float      # raw counted bytes (upper bound)
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_total: float
    useful_ratio: float
    bytes_per_device: float
    step_lower_bound_s: float
    mfu_bound: float         # MODEL_FLOPS / (chips·peak·step_bound)

    def table_row(self) -> dict:
        return {k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in self.__dict__.items()}


def model_flops(arch: str, shape_name: str) -> float:
    cfg = get_config(arch)
    spec = SHAPE_BY_NAME[shape_name]
    n_active = cfg.active_param_count()
    tokens = spec.global_batch * spec.seq_len
    if spec.kind == "train":
        return 6.0 * n_active * tokens
    if spec.kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one new token per sequence.
    return 2.0 * n_active * spec.global_batch


def memory_lb_bytes(arch: str, shape_name: str, n_devices: int) -> float:
    """Analytic per-device HBM-traffic lower bound (bytes/step).

    The counted ``bytes_accessed`` is logical operand bytes pre-fusion
    (far above real HBM traffic), so the memory roofline term uses this
    physical minimum instead: every resident byte the step must touch
    at least once — weights (+moments r/w ×2 for train, ×3 with
    gradient), KV/state read+write, activation stream. The counted
    bytes are still reported as an upper bound.
    """
    cfg = get_config(arch)
    spec = SHAPE_BY_NAME[shape_name]
    par = cfg.param_count() * 2 / n_devices           # bf16, FSDP (train)
    # Inference weights shard over TP only (replicated across data) —
    # except MoE expert weights, which shard over the expert axis too.
    tp = 16
    if cfg.family == Family.MOE:
        inf_par = cfg.param_count() * 2 / min(n_devices, 256)
    else:
        inf_par = cfg.param_count() * 2 / tp
    act_par = (cfg.active_param_count() * 2
               * (inf_par / (cfg.param_count() * 2)))
    tokens_dev = spec.global_batch * spec.seq_len / n_devices
    d = cfg.d_model
    if spec.kind == "train":
        # params read + grad write + moments r/w (bf16) + activation
        # stream (~12 residual-sized reads/writes per layer with remat).
        weights = par * (1 + 1 + 4)
        acts = tokens_dev * d * 2 * 12 * max(cfg.n_layers, 1)
        return weights + acts
    if spec.kind == "prefill":
        weights = act_par
        acts = tokens_dev * d * 2 * 8 * max(cfg.n_layers, 1)
        kv_write = (2 * cfg.n_layers * cfg.kv_dim * tokens_dev * 2
                    if cfg.n_kv_heads else 0)
        return weights + acts + kv_write
    # decode: stream active params once + read the full KV/state.
    if cfg.n_kv_heads:
        kv = (2 * cfg.n_layers * cfg.kv_dim * spec.seq_len
              * spec.global_batch * 2 / n_devices)
        if cfg.family == Family.HYBRID:
            n_sites = cfg.n_layers // cfg.attn_every
            kv = (2 * n_sites * cfg.kv_dim * spec.seq_len
                  * spec.global_batch * 2 / n_devices)
    else:
        kv = 0.0
    if cfg.family in (Family.SSM, Family.HYBRID):
        kv += (cfg.n_layers * cfg.d_inner * max(cfg.d_state, 1) * 4
               * spec.global_batch / n_devices)
    return act_par + kv


def analyze_cell(rec: dict, n_layers: int) -> RooflineRow | None:
    """The row of one dry-run record (``n_layers`` is unused: the
    record's counts span the step; kept for the reference's call)."""
    if not rec.get("ok"):
        return None
    flops_dev = rec["cost"].get("flops", 0.0)
    bytes_dev = rec["cost"].get("bytes_accessed", 0.0)
    coll_dev = rec["collectives"]["total_bytes"]
    compute_s = flops_dev / PEAK_FLOPS
    mem_lb = memory_lb_bytes(rec["arch"], rec["shape"],
                             rec["n_devices"]) / HBM_BPS
    memory_hlo_s = bytes_dev / HBM_BPS
    coll_s = coll_dev / link_bps(rec["n_devices"])
    dom = max(("compute", compute_s), ("memory", mem_lb),
              ("collective", coll_s), key=lambda kv: kv[1])[0]
    mf = model_flops(rec["arch"], rec["shape"])
    total_flops = flops_dev * rec["n_devices"]
    bound = max(compute_s, mem_lb, coll_s)
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        compute_s=compute_s, memory_s=mem_lb, memory_hlo_s=memory_hlo_s,
        collective_s=coll_s,
        dominant=dom, model_flops=mf, hlo_flops_total=total_flops,
        useful_ratio=mf / total_flops if total_flops else 0.0,
        bytes_per_device=bytes_dev,
        step_lower_bound_s=bound,
        mfu_bound=(mf / (rec["n_devices"] * PEAK_FLOPS * bound)
                   if bound else 0.0))


def analyze_file(path: str, mesh: str = "16x16") -> list[RooflineRow]:
    with open(path) as f:
        results = json.load(f)
    rows = []
    for key, rec in sorted(results.items()):
        if rec.get("mesh") != mesh or not rec.get("ok"):
            continue
        row = analyze_cell(rec, get_config(rec["arch"]).n_layers)
        if row:
            rows.append(row)
    return rows


def whats_the_bottleneck(row: RooflineRow) -> str:
    """One sentence on what would move the dominant term down."""
    if row.dominant == "compute":
        if row.useful_ratio < 0.35:
            return ("compute-bound with low useful ratio: cut replicated "
                    "column work and remat recompute (whole-head and "
                    "first-column blocks, the causal flash kernel's "
                    "diagonal tiles)")
        return ("compute-bound near useful: bf16 or FP8 (wgmma) GEMMs "
                "and more GPUs are the only levers")
    if row.dominant == "memory":
        return ("HBM-bound: fuse the bandwidth-bound ops into the CUDA "
                "kernels (norms, rope, residual adds), shrink KV/state "
                "dtype (FP8 KV), or raise arithmetic intensity (larger "
                "per-GPU batch)")
    return ("collective-bound: keep the big axes inside an NVLink node, "
            "reshard to cut all-gathers, overlap NCCL collectives with "
            "compute on side streams, or quantise gradients")


def table(path: str) -> list[dict]:
    """The rows of both production meshes, each with its lever
    (``next_move``), as ``benchmarks/roofline_table.py`` builds them."""
    rows = []
    for mesh in ("16x16", "2x16x16"):
        for r in analyze_file(path, mesh=mesh):
            d = r.table_row()
            d["next_move"] = whats_the_bottleneck(r)
            rows.append(d)
    return rows


def print_table(rows: list[dict], out=None) -> None:
    """The table ``benchmarks/roofline_table.py`` prints for the
    reference, in seconds a step: bounds at the datasheet constants."""
    out = out or sys.stdout
    hdr = (f"{'arch':<26} {'shape':<12} {'mesh':<8} {'compute_s':>10} "
           f"{'memory_s':>10} {'collect_s':>10} {'dominant':>10} "
           f"{'useful':>7} {'mfu_bnd':>8}")
    print(hdr, file=out)
    print("-" * len(hdr), file=out)
    for r in rows:
        print(f"{r['arch']:<26} {r['shape']:<12} {r['mesh']:<8} "
              f"{r['compute_s']:>10.4f} {r['memory_s']:>10.4f} "
              f"{r['collective_s']:>10.4f} {r['dominant']:>10} "
              f"{r['useful_ratio']:>7.3f} {r['mfu_bound']:>8.4f}",
              file=out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", default="results/torch_dryrun.json")
    args = ap.parse_args()
    rows = table(args.path)
    print_table(rows)
    doms: dict = {}
    for r in rows:
        if r["mesh"] == "16x16":
            doms[r["dominant"]] = doms.get(r["dominant"], 0) + 1
    print({"cells_analyzed_single_pod": sum(doms.values()),
           "dominant_term_histogram": doms})


if __name__ == "__main__":
    main()
