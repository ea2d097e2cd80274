"""Shared set-up of the training tests: seeded numpy batches for every
family, and the reduced train steps run card against CPU
(``tests/test_torch_cuda.py``). Imports no JAX."""
import importlib

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.models.base import Family

B, S = 4, 16
#: Tolerances of train steps compared across backends (CPU against
#: card, port against JAX), all f32. Loss, grad norm and lr of every
#: step: ``TOL`` relative. Params after the first step: ``TOL`` where
#: f32 resolves the gradient element (|g| >= ``UNRESOLVED``); Adam's
#: first step moves an element by lr * g / (|g| + eps), which depends
#: on g's value only through eps / |g|, so there the two agree far
#: inside ``TOL``; below it the sign of g is rounding noise (the port's
#: own f32 step differs from its f64 step by 2e-4 at |g| = 2e-8,
#: reduced falcon-mamba, lr 1e-3) and the element may differ by lr.
#: Later steps divide m by sqrt(v), which cancels where steps' gradients
#: do, so their params are held within lr a step (both inside the span
#: Adam allows) and their moments within ``TOL`` relative; that the
#: updated params compute the same function is what the next step's
#: loss and grad norm check.
TOL = 1e-4
UNRESOLVED = 1e-6
KERNELS = ("bgmv", "sgmv", "paged_attention", "flash_attention")


def batch_np(cfg, i, B=B, S=S):
    """Batch ``i``: tokens/labels (B, S) int32, plus ``frames`` (enc-dec)
    and distinct t/h/w ``mrope_pos`` (VLM), all from numpy."""
    rng = np.random.default_rng(1000 + i)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == Family.ENCDEC:
        b["frames"] = rng.standard_normal(
            (B, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None, None],
                              (3, B, S)).copy()
        pos[1, :, S // 4:] += 2
        pos[2, :, S // 2:] += 5
        b["mrope_pos"] = pos
    return b


def attention_layers(cfg) -> int:
    """flash_attention calls of one forward of ``cfg``: a layer each for
    the decoder-only families, the shared block's sites (hybrid), the
    encoder and decoder layers (enc-dec), none for the SSM family."""
    if cfg.family == Family.SSM:
        return 0
    if cfg.family == Family.HYBRID:
        return cfg.n_layers // cfg.attn_every
    if cfg.family == Family.ENCDEC:
        return cfg.n_enc_layers + cfg.n_layers
    return cfg.n_layers


def to_tensors(b, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in b.items()}


def first_step_close(ref, got, opt_cfg, m1):
    """Params after one AdamW step from equal states: the largest
    difference where the gradient is resolved (``param``), the count of
    unresolved elements past ``TOL`` and whether one differs by more
    than lr. ``m1``: the reference's first moments after the step,
    (1 - b1) g exactly in f32, to within bf16 rounding in bf16."""
    b1 = opt_cfg.b1
    err = 2 ** -8 if opt_cfg.moment_dtype == "bfloat16" else 0.0
    out = dict(param=0.0, unresolved=0, unresolved_over_lr=False)
    for k in ref:
        g = np.abs(np.asarray(m1[k], np.float64)) / (1 - b1)
        bad = np.broadcast_to(g * (1 - err) < UNRESOLVED, np.shape(ref[k]))
        d = np.abs(np.asarray(ref[k], np.float64)
                   - np.asarray(got[k], np.float64))
        if (~bad).any():
            out["param"] = max(out["param"], float(d[~bad].max()))
        out["unresolved"] += int(((d > TOL) & bad).sum())
        out["unresolved_over_lr"] |= bool((d[bad] > opt_cfg.lr).any())
    return out


def final_close(ref, got, opt_cfg, steps):
    """After ``steps`` steps: the largest param difference in units of
    lr a step (``param_in_lr``, at most 1 to pass) and the largest
    relative moment difference (``opt``)."""
    (rp, ro), (gp, go) = ref, got
    d = max(float(np.abs(np.asarray(rp[k], np.float64)
                         - np.asarray(gp[k], np.float64)).max())
            for k in rp)
    opt = max(float((np.abs(np.asarray(ro[k], np.float64)
                            - np.asarray(go[k], np.float64))
                     / (1 + np.abs(np.asarray(ro[k], np.float64)))).max())
              for k in ro)
    return dict(param_in_lr=d / (opt_cfg.lr * steps), opt=opt)


def states_ok(first, final):
    return (first["param"] <= TOL and not first["unresolved_over_lr"]
            and final["param_in_lr"] <= 1.0 and final["opt"] <= TOL)


def all_stats():
    return {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
            for n in KERNELS}


def host(tree):
    """Leaves as f32 numpy copies (the step updates in place)."""
    return {k: v.detach().float().cpu().numpy().copy()
            for k, v in tree.items()}


def card_vs_cpu_train_steps(name, opt_cfg, steps=2, mesh_shape=None):
    """``steps`` train steps of reduced ``name`` in f32 on the card and
    on the CPU from the port's seeded params; with ``mesh_shape`` the
    card's state is placed by the train rule table on a ("data",
    "model") mesh of that shape over repeated positions of the card.
    Returns the largest relative difference of loss, grad norm and lr
    (``metrics_err``), ``first_step_close`` and ``final_close``
    readings, the card's flash forward and backward launches, its plain
    calls and the card's mesh positions."""
    from repro_torch.distributed.sharding import (ShardedTensor, device_put,
                                                  param_shardings)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.training import init_opt_state, make_train_step
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    cfg = get_config(name).reduced()
    cpu = api.init_params(cfg, 0, torch.float32, device="cpu")
    positions = 1
    if mesh_shape is None:
        card = {k: v.to("cuda") for k, v in cpu.items()}
    else:
        grid = np.empty(int(np.prod(mesh_shape)), dtype=object)
        grid[:] = [torch.device("cuda", torch.cuda.current_device())] \
            * grid.size
        mesh = Mesh(grid.reshape(mesh_shape), ("data", "model"))
        card = device_put(cpu, param_shardings(cfg, cpu, mesh, "train"))
        positions = mesh.size
    states = {"cpu": (cpu, init_opt_state(cpu, opt_cfg)),
              "cuda": (card, init_opt_state(card, opt_cfg))}

    def whole(tree):
        return host({k: v.full("cpu") if isinstance(v, ShardedTensor) else v
                     for k, v in tree.items()})

    step = make_train_step(cfg, opt_cfg)
    stats = all_stats()
    ms, after1 = {}, {}
    for dev, (p, o) in states.items():      # the CPU first, then the card
        for st in (*stats.values(), fa.BWD_STATS):
            st.reset()
        ms[dev] = []
        for i in range(steps):
            ms[dev].append(step(p, o, to_tensors(batch_np(cfg, i), dev))[2])
            if i == 0:
                after1[dev] = (whole(p), {k[2:]: v for k, v in
                                          whole(o).items()
                                          if k.startswith("m/")})
    err = max(abs(float(a[k]) - float(b[k])) / max(abs(float(a[k])), 1.0)
              for a, b in zip(ms["cpu"], ms["cuda"])
              for k in ("loss", "grad_norm", "lr"))
    first = first_step_close(after1["cpu"][0], after1["cuda"][0], opt_cfg,
                             after1["cpu"][1])
    final = final_close(*[tuple(whole(t) for t in states[d])
                          for d in ("cpu", "cuda")], opt_cfg, steps)
    plain = fa.BWD_STATS.plain + sum(st.plain for st in stats.values())
    return dict(metrics_err=err, first=first, final=final,
                fwd_launches=stats["flash_attention"].launches,
                bwd_launches=fa.BWD_STATS.launches, plain=plain,
                positions=positions)
