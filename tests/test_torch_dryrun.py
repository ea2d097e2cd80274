"""``launch/dryrun.py``, ``roofline/hlo_stats.py`` and
``roofline/analysis.py`` against the reference's, and the kernels' meta
paths, on the CPU (no device: a dry-run runs on ``meta`` positions).

- Each family (dense, MoE, VLM, SSM, hybrid, enc-dec) × each kind
  (train, prefill, decode), reduced, on meta meshes (1, 1) and (2, 2):
  the record's keys are the reference's; at (1, 1) the busiest
  position's counts are the sums; the FLOPs summed over positions equal
  an analytic count of the unsharded step (``analytic_flops``: the
  parameter GEMMs from ``param_shapes``, attention as the flash kernel
  visits it, the LoRA kernels, the MoE experts over their capacity
  slots, the SSM scans' products, the backward at 2× and, with remat,
  the recompute), exactly (to 1e-9 relative) at (1, 1). At (2, 2) the
  mesh adds work the unsharded step does not do, each term counted
  here: the LoRA shrink runs on every column (A is gathered whole where
  the rule table splits its din), the token-parallel MoE decode runs
  each expert over a dropless capacity of the whole group, and the
  hybrid's Mamba2 columns each compute the whole B and C segments of
  in_proj and the SSD's C·Bᵀ; with those terms the sum is exact too.
- ``--depth fit`` (1 and 2 units, extended) equals a full count.
- Argument bytes per position equal the JAX rule table's shard sizes
  (``NamedSharding.shard_shape``) on both production meshes for every
  cell; ``model_flops`` and ``memory_lb_bytes`` equal the reference's.
- The copied ``_wire_bytes`` gives the reference's numbers on the HLO
  sample of ``tests/test_layers_blocked_attn.py``.
- A (2, 2) mesh train step on repeated ``cpu`` positions records
  collectives whose calls equal ``COLLECTIVE_METER``'s counts; a
  (1, 1) step records none.
- Each kernel's meta path returns its CPU plain version's shapes and
  dtypes and counts its stated formula.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jax.devices()

from _port_cases import FAMILIES, fake_meshes, walk  # noqa: E402
from repro.configs import assigned_cells  # noqa: E402
from repro_torch.configs import SHAPE_BY_NAME, get_config  # noqa: E402
from repro_torch.kernels import meta as kmeta  # noqa: E402
from repro_torch.kernels.ops import COLLECTIVE_METER  # noqa: E402
from repro_torch.launch import cases, dryrun  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.base import Family, param_shapes  # noqa: E402
from repro_torch.models.hybrid import attn_sites  # noqa: E402
from repro_torch.roofline import analysis, hlo_stats  # noqa: E402

KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
S = 16
CELLS = assigned_cells(include_paper_model=True)


def batch(fam: str, kind: str) -> int:
    """Rows of a reduced case: the MoE train step runs 8 microbatches,
    each split over the (2, 2) mesh's 2 batch shards."""
    return 16 if fam == "moe" and kind == "train" else 4


def meta(shape):
    return dryrun.meta_mesh(shape, ("data", "model"))


def small(fam: str):
    """The reduced config of ``fam`` one stack unit deep (a layer; the
    hybrid's period of ``attn_every`` layers and its shared-block site;
    an encoder and a decoder layer): the analytic count is per unit, and
    ``test_depth_fit_equals_full`` holds the count's depth to a line."""
    cfg = get_config(FAMILIES[fam]).reduced()
    if fam == "hybrid":
        return dataclasses.replace(cfg, n_layers=cfg.attn_every)
    if fam == "encdec":
        return dataclasses.replace(cfg, n_layers=1, n_enc_layers=1)
    return dataclasses.replace(cfg, n_layers=cfg.moe_every)


_RECORDS = {}


def record(fam, kind, shape, **kw):
    key = (fam, kind, shape, tuple(sorted(kw.items())))
    if key not in _RECORDS:
        arch = FAMILIES[fam]
        cfg = kw.pop("config", None) or small(fam)
        _RECORDS[key] = dryrun.count_cell(
            arch, KINDS[kind], meta(shape), config=cfg, seq_override=S,
            batch_override=batch(fam, kind), depth=kw.pop("depth", "full"),
            **kw)
    return _RECORDS[key]


# ------------------------------------------------------ analytic count
_MATS = ("q", "k", "v", "o", "gate", "up", "down", "in_proj", "x_proj",
         "dt_proj", "out_proj", "router", "shared_gate", "shared_up",
         "shared_down", "xq", "xk", "xv", "xo")


def _visited(n, causal):
    return kmeta.visited_pairs(n, causal)


def analytic_flops(cfg, kind: str, B: int, M: int = 1) -> float:
    """Operations of the unsharded step of reduced ``cfg`` on B rows of
    S tokens (M > 1: plus the (1, M)-column mesh's replicated terms of
    the module docstring)."""
    shapes = param_shapes(cfg)
    T = B * S if kind != "decode" else B          # token rows a layer
    enc_T = B * cfg.enc_ctx
    sites = (len(attn_sites(cfg)) if cfg.family == Family.HYBRID else 0)
    D, H, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    mats = 0.0                                    # GEMM MACs, forward
    last = 0.0                                    # a body's last product
    for path, shape in shapes.items():
        leaf = path.split("/")[-1]
        if leaf not in _MATS or path.startswith("moe/w_"):
            continue
        n = shape[0] if len(shape) == 3 else 1
        rows = T
        if path.startswith("enc/") or path in ("dec/xk", "dec/xv"):
            # the encoder and the cross K/V run at prefill, not decode
            rows = enc_T if kind != "decode" else 0
        if path.startswith("shared/"):
            n = sites
        mats += n * rows * shape[-2] * shape[-1]
        if leaf in ("down", "out_proj"):
            last += n * rows * shape[-2] * shape[-1]
    fwd = 2 * mats
    # the head: every position in training, the last one when serving
    fwd += 2 * (T if kind == "train" else B) * D * cfg.vocab_size
    attn = bwd_attn = 0.0
    n_attn = {Family.HYBRID: sites, Family.SSM: 0}.get(cfg.family,
                                                      cfg.n_layers)
    if kind != "decode":
        attn = 4 * dh * H * B * _visited(S, True) * n_attn
        if cfg.family == Family.ENCDEC:
            attn += 4 * dh * H * B * _visited(cfg.enc_ctx, False) \
                * cfg.n_enc_layers
        bwd_attn = attn / 4 * 14
    else:                       # plain attention over the S-slot slab
        fwd += 4 * B * H * S * dh * n_attn
    if cfg.family == Family.ENCDEC:               # cross attention
        fwd += 4 * B * H * (S if kind != "decode" else 1) * cfg.enc_ctx \
            * dh * cfg.n_layers
    Sp = -(-S // cfg.ssm_chunk) * cfg.ssm_chunk   # a scan's padded S
    if cfg.family in (Family.SSM, Family.HYBRID) and kind == "decode":
        conv = cfg.d_inner + (2 * cfg.d_state if cfg.ssm_version == 2
                              else 0)             # the conv as a product
        fwd += 2 * B * cfg.d_conv * conv * cfg.n_layers
    if cfg.family == Family.SSM:                  # C·h readout
        fwd += 2 * (B * Sp if kind != "decode" else B) * cfg.d_inner \
            * cfg.d_state * cfg.n_layers
    unused = 0.0          # forward products no gradient flows back to
    if cfg.family == Family.HYBRID:
        Di, N, Q, L = cfg.d_inner, cfg.d_state, cfg.ssm_chunk, cfg.n_layers
        if kind != "decode":                      # SSD over padded S
            fwd += 2 * B * Sp * (Q * Di + 2 * Di * N + Q * N) * L
            if Sp == Q:
                # one chunk: no carried state, so of the two inter-chunk
                # products (chunk states, their readout) the backward
                # takes only the readout's gradient w.r.t. C
                unused = 2 * B * Sp * Di * N * L
            if kind == "prefill":                 # conv state: in_proj
                fwd += 2 * (cfg.d_conv - 1) * B * D \
                    * shapes["layers/in_proj"][-1] * L
        else:                                     # one step: C·h
            fwd += 2 * B * Di * N * L
        # every column computes the whole B and C: their in_proj columns
        # (and conv at decode, the prefill's conv-state rows) and C·Bᵀ
        rep = 2 * T * D * 2 * N
        if kind == "prefill":
            rep += 2 * (cfg.d_conv - 1) * B * D * 2 * N
        if kind == "decode":
            rep += 2 * B * cfg.d_conv * 2 * N
        else:
            rep += 2 * B * Sp * Q * N
        fwd += (M - 1) * rep * L
    if cfg.family == Family.MOE:
        E, K, Fe = cfg.n_experts, cfg.top_k, cfg.d_ff_expert
        n_moe = shapes["moe/router"][0]
        if kind == "decode" and M == 1:           # the gather: T·K rows
            slots = T * K
        elif kind == "decode":                    # dropless capacity
            slots = E * T
        else:
            mb = cases.MICROBATCHES.get(FAMILIES["moe"], 1) \
                if kind == "train" else 1
            Tm = T // mb
            Tg = min(moe.MOE_GROUP, Tm)
            slots = mb * E * (Tm // Tg) * moe._capacity(
                Tg, E, K, cfg.capacity_factor)
        fwd += 2 * 3 * D * Fe * slots * n_moe
    if kind in ("prefill", "decode") and cfg.family in (
            Family.DENSE, Family.MOE, Family.VLM, Family.HYBRID):
        r = cases.LORA_RMAX
        if kind == "prefill":
            tile = min(128, -(-S // 8) * 8)
            rows = B * (-(-S // tile) * tile)
        else:
            rows = B
        n = sites if cfg.family == Family.HYBRID else cfg.n_layers
        dims = [(D, cfg.q_dim), (D, cfg.kv_dim), (D, cfg.kv_dim),
                (cfg.q_dim, D)]
        fwd += n * sum(2 * rows * r * (M * din + dout)
                       for din, dout in dims)
    if kind != "train":
        return fwd + attn
    total = 3 * fwd - 3 * unused + attn + bwd_attn
    if cfg.remat:          # the recompute stops before each body's last
        total += 2 * (mats - last) + attn
    return total


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_record_counts_the_step(fam, kind):
    cfg = small(fam)
    B = batch(fam, kind)
    want = analytic_flops(cfg, kind, B)
    one = record(fam, kind, (1, 1))
    c = one["cost"]
    assert c["flops"] == c["flops_sum"] and \
        c["bytes_accessed"] == c["bytes_accessed_sum"]
    assert math.isclose(c["flops_sum"], want, rel_tol=1e-9), (
        c["flops_sum"], want, c["flops_by_op"])
    four = record(fam, kind, (2, 2))
    want = analytic_flops(cfg, kind, B, M=2)
    assert math.isclose(four["cost"]["flops_sum"], want, rel_tol=1e-9), (
        four["cost"]["flops_sum"], want, four["cost"]["flops_by_op"])
    assert four["cost"]["flops"] < four["cost"]["flops_sum"]
    for rec in (one, four):
        assert set(rec) >= REF_KEYS
        assert set(rec["memory"]) >= REF_MEMORY
        assert set(rec["cost"]) >= {"flops", "bytes_accessed"}
        assert set(rec["collectives"]) >= {"per_op", "count", "total_bytes",
                                           "total_bytes_scaled"}
        assert rec["memory"]["temp_size_in_bytes"] is None
    if kind == "train":
        assert four["memory"]["saved_bytes"] > 0
    assert not one["collectives"]["count"]
    assert four["collectives"]["total_bytes"] > 0


#: The reference's record keys (``src/repro/launch/dryrun.py``).
REF_KEYS = {"arch", "shape", "mesh", "n_devices", "ok", "lower_s",
            "compile_s", "memory", "cost", "collectives"}
REF_MEMORY = {"argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes",
              "alias_size_in_bytes"}


def test_remat_recompute_is_counted():
    cfg = dataclasses.replace(small("dense"), remat=True)
    rec = record("dense", "train", (1, 1), config=cfg)
    assert math.isclose(rec["cost"]["flops_sum"],
                        analytic_flops(cfg, "train", 4), rel_tol=1e-9)
    assert rec["memory"]["saved_boundary_bytes"] > 0


@pytest.mark.parametrize("fam,kind", [("dense", "train"),
                                      ("moe", "prefill"),
                                      ("hybrid", "decode")])
def test_depth_fit_equals_full(fam, kind):
    cfg = dataclasses.replace(get_config(FAMILIES[fam]).reduced())
    if fam != "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=3 * cfg.moe_every
                                  if fam == "moe" else 3)
    else:
        cfg = dataclasses.replace(cfg, n_layers=3 * cfg.attn_every + 1)
    full = record(fam, kind, (2, 2), config=cfg, depth="full")
    fit = record(fam, kind, (2, 2), config=cfg, depth="fit")
    assert fit["depth"]["method"] == "fit"
    for k in ("flops", "flops_sum", "bytes_accessed", "bytes_accessed_sum"):
        assert math.isclose(fit["cost"][k], full["cost"][k],
                            rel_tol=1e-9), k
    assert math.isclose(fit["collectives"]["total_bytes"],
                        full["collectives"]["total_bytes"], rel_tol=1e-9)


# ----------------------------------------------- the rule table's bytes
_JMESH = {}


@pytest.mark.filterwarnings("ignore:fit_spec")
@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_argument_bytes_equal_rule_table(arch, shape, multi):
    from repro.launch.cases import build_case as jbuild_case
    if multi not in _JMESH:
        _JMESH[multi] = fake_meshes(multi)
    jm, _ = _JMESH[multi]
    _, jargs, jsh = jbuild_case(arch, shape, jm)
    want = 0
    for (_, a), (_, s) in zip(walk(jargs), walk(jsh)):
        if hasattr(a, "shape"):
            want += int(np.prod(s.shard_shape(a.shape))) * a.dtype.itemsize
    mesh = dryrun.production_mesh(multi)
    with dryrun.fake_mode():
        _, args, sh = cases.build_case(arch, shape, mesh)
        assert dryrun.argument_bytes(args, sh, mesh) == want


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_model_flops_and_memory_bound_equal_reference(arch, shape):
    from repro.roofline import analysis as janalysis
    assert analysis.model_flops(arch, shape) == \
        janalysis.model_flops(arch, shape)
    for n in (256, 512):
        assert analysis.memory_lb_bytes(arch, shape, n) == \
            janalysis.memory_lb_bytes(arch, shape, n)
    assert analysis.scan_trips(arch, shape) == \
        janalysis.scan_trips(arch, shape)


def test_wire_bytes_match_reference_sample():
    from repro.roofline import hlo_stats as jstats
    # the sample of tests/test_layers_blocked_attn.py: an all-reduce of
    # f32[4,128] over 4, an all-gather of bf16[64,32] over 2, a permute
    # of f32[2,64]
    for op, b, k in (("all-reduce", 4 * 128 * 4, 4),
                     ("all-gather", 64 * 32 * 2, 2),
                     ("collective-permute", 2 * 64 * 4, 16),
                     ("reduce-scatter", 1024, 8), ("all-to-all", 1024, 16)):
        assert hlo_stats._wire_bytes(op, b, k) == jstats._wire_bytes(op, b, k)
    assert hlo_stats._wire_bytes("all-reduce", 2048, 4) == 2 * 2048 * 3 / 4
    assert hlo_stats._DTYPE_BYTES == jstats._DTYPE_BYTES
    rec = {"per_op": {"all-gather": 8.0, "all-reduce": 4.0}}
    assert hlo_stats.scaled_collective_bytes(rec, 10) == \
        jstats.scaled_collective_bytes(rec, 10) == 12.0


# ------------------------------------------------ collectives vs meter
@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_train_step_collectives_match_meter(shape):
    from _port_train_mesh import OPT, place
    from _port_training import batch_np, to_tensors
    from repro_torch.distributed import act_sharding as acts
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import api
    from repro_torch.training import make_train_step
    cfg = get_config(FAMILIES["dense"]).reduced()
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = [torch.device("cpu")] * grid.size
    mesh = Mesh(grid.reshape(shape), ("data", "model"))
    p, o = place(cfg, api.init_params(cfg, 0, torch.float32,
                                      device="cpu"), mesh)
    COLLECTIVE_METER.reset()
    with acts.activation_sharding(("data",), mesh=mesh), \
            hlo_stats.recording() as rec:
        make_train_step(cfg, OPT)(p, o, to_tensors(batch_np(cfg, 0), "cpu"))
    got = rec.mesh.meter
    assert got.get("gathers", 0) == COLLECTIVE_METER.gathers
    assert got.get("reduces", 0) == COLLECTIVE_METER.reduces
    assert got.get("all_to_alls", 0) == COLLECTIVE_METER.all_to_alls
    r = rec.record()
    if shape == (1, 1):
        assert r["count"] == {} and r["total_bytes"] == 0.0
    else:
        assert r["count"]["all-gather"] > 0 and r["total_bytes"] > 0
        # one process on one CPU device: no byte crosses positions
        assert r["total_moved_bytes"] == 0.0


# ---------------------------------------------------- the meta paths
def test_kernel_meta_paths():
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import ops
    from repro_torch.kernels.bgmv import bgmv
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.sgmv import sgmv
    g = torch.Generator().manual_seed(0)

    def pair(shape, dtype=torch.float32):
        t = torch.randn(shape, generator=g).to(dtype)
        return t, torch.empty(shape, dtype=dtype, device="meta")

    def same(cpu, m):
        assert m.device.type == "meta"
        assert (m.shape, m.dtype) == (cpu.shape, cpu.dtype)

    def count(fn):
        with FlopCounterMode(display=False) as fc:
            out = fn()
        return out, fc.get_total_flops()

    (x, xm), (A, Am), (Bw, Bm) = (pair((5, 96), torch.bfloat16),
                                 pair((3, 96, 8), torch.bfloat16),
                                 pair((3, 8, 40), torch.bfloat16))
    idx = torch.tensor([0, 2, 1, 0, 2])
    ym, f = count(lambda: bgmv(xm, Am, Bm, idx.to("meta")))
    same(bgmv(x, A, Bw, idx), ym)
    assert f == 2 * 5 * 8 * (96 + 40)
    (x, xm), = (pair((64, 96)),)
    ts = torch.tensor([0, 2])
    ym, f = count(lambda: sgmv(xm, Am.float(), Bm.float(), ts.to("meta"),
                               32))
    same(sgmv(x, A.float(), Bw.float(), ts, 32), ym)
    assert f == 2 * 64 * 8 * (96 + 40)
    for Sq, causal in ((100, True), (100, False), (64, True)):
        (q, qm), (k, km), (v, vm) = (pair((2, Sq, 4, 32)),
                                     pair((2, Sq, 2, 32)),
                                     pair((2, Sq, 2, 32)))
        (om, lm), f = count(lambda: flash_attention(qm, km, vm, causal,
                                                    return_lse=True))
        o, lse = flash_attention(q, k, v, causal, return_lse=True)
        same(o, om)
        same(lse, lm)
        V = kmeta.visited_pairs(Sq, causal)
        assert f == 4 * 32 * 4 * 2 * V
        grads, f = count(lambda: flash_attention_bwd(qm, km, vm, om, om,
                                                     causal, lse=lm))
        for gm, gc in zip(grads, flash_attention_bwd(q, k, v, o, o, causal)):
            same(gc, gm)
        assert f == 14 * 32 * 4 * 2 * V
        # under autograd the meta tensors take the kernel's autograd path
        leaves = [t.requires_grad_(True) for t in (qm, km, vm)]
        _, f = count(lambda: ops.flash_attention(*leaves, causal)
                     .sum().backward())
        assert f == 18 * 32 * 4 * 2 * V
    assert kmeta.visited_pairs(100, True) == 64 * 64 + 36 * 100
    assert kmeta.visited_pairs(128, True) == 64 * 64 * 3
    assert kmeta.visited_pairs(100, False) == 100 * 100


def test_meta_ops_refuse_real_tensors():
    x = torch.zeros(4, 8)
    with pytest.raises(RuntimeError, match="meta"):
        torch.ops.repro_torch.bgmv_meta(x, torch.zeros(1, 8, 2),
                                        torch.zeros(1, 2, 3),
                                        torch.zeros(4, dtype=torch.int32))


def test_roofline_table_prints(tmp_path, capsys):
    rec = record("dense", "decode", (2, 2))
    rec = dict(rec, arch="internlm2-1.8b", shape="decode_32k", mesh="16x16",
               n_devices=256)
    path = tmp_path / "dry.json"
    path.write_text(__import__("json").dumps(
        {"internlm2-1.8b|decode_32k|single": rec,
         "x|long_500k|single": {"ok": False, "skipped": True}}))
    rows = analysis.analyze_file(str(path))
    assert len(rows) == 1 and rows[0].dominant in ("compute", "memory",
                                                   "collective")
    assert rows[0].collective_s == rec["collectives"]["total_bytes"] / 50e9
    analysis.print_table(analysis.table(str(path)))
    out = capsys.readouterr().out
    assert "internlm2-1.8b" in out and "decode_32k" in out
    assert SHAPE_BY_NAME["decode_32k"].kind == "decode"


@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh_positions(multi):
    """c10's device index has 8 bits: past 128 positions they share
    ``meta`` devices, the first position alone on ``meta:0``."""
    mesh = dryrun.production_mesh(multi)
    shared = dryrun.share(mesh)
    assert sum(shared.values()) == mesh.size == (512 if multi else 256)
    assert max(shared) < dryrun.MAX_INDEX and shared[0] == 1
    for coords in np.ndindex(*mesh.devices.shape):
        i = mesh.devices[coords].index
        # rows r and r + 8 of one column share a device
        assert coords[-1] == i % 16 and coords[-2] % 8 == i // 16 or \
            i == 16 and coords[-1] == 0
