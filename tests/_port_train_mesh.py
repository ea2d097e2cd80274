"""Shared set-up of the mesh train-step tests: meshes of repeated
``cpu`` positions, placing a state by the train rule table, running the
port's step and JAX's jitted step, and comparing two runs with
``tests/_port_training.py``'s tolerances."""
import numpy as np
import torch

from repro_torch.distributed import sharding as tsh
from repro_torch.launch.mesh import Mesh
from repro_torch.models import api
from repro_torch.models import moe as moe_mod
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

from _port_training import (TOL, batch_np, final_close, first_step_close,
                            states_ok, to_tensors)

OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, clip_norm=0.5)
AXES = ("data", "model")
MESHES = {"1x1": ((1, 1), AXES), "2x1": ((2, 1), AXES),
          "1x2": ((1, 2), AXES), "2x2": ((2, 2), AXES),
          "pod2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
STEPS = 2


def cpu_mesh(name):
    shape, axes = MESHES[name]
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = [torch.device("cpu")] * grid.size
    return Mesh(grid.reshape(shape), axes)


def place(cfg, params, mesh):
    """The params placed by the train rule table (copies) and their
    moments placed alike."""
    p = tsh.device_put(params, tsh.param_shardings(cfg, params, mesh,
                                                   "train"))
    return p, init_opt_state(p, OPT)


def whole(tree):
    """Leaves as f32 numpy copies, placed ones gathered."""
    return {k: (v.cpu() if isinstance(v, tsh.ShardedTensor) else v)
            .detach().float().numpy().copy() for k, v in tree.items()}


def run(cfg, params, opt, steps=STEPS, microbatches=1, first=0,
        batch=None):
    """Steps ``first``.. of the port's step on ``batch_np`` batches (of
    shape ``batch`` = (B, S) when given); the metrics of each (with the
    MoE capacity drops, ``dropped``), the state after the first one
    (params, first moments) and at the end."""
    step = make_train_step(cfg, OPT, microbatches)
    ms, after1 = [], None
    kw = dict(zip(("B", "S"), batch)) if batch is not None else {}
    for i in range(first, first + steps):
        moe_mod.STATS.reset()
        m = step(params, opt, to_tensors(batch_np(cfg, i, **kw), "cpu"))[2]
        ms.append({k: float(v) for k, v in m.items()})
        ms[-1]["dropped"] = moe_mod.STATS.dropped
        if after1 is None:
            after1 = (whole(params), {k[2:]: v for k, v in whole(opt).items()
                                      if k.startswith("m/")})
    return ms, after1, (whole(params), whole(opt))


def assert_runs_close(ref, got):
    """Loss, grad norm and lr of each step within ``TOL``, equal MoE
    drops (where ``ref`` counts them), and the states by
    ``states_ok``."""
    (rm, r1, rend), (gm, g1, gend) = ref, got
    for a, b in zip(rm, gm):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(b[k] - a[k]) <= TOL * max(abs(a[k]), 1.0), (k, a, b)
        if "dropped" in a:
            assert a["dropped"] == b["dropped"], (a, b)
    first = first_step_close(r1[0], g1[0], OPT, r1[1])
    final = final_close(rend, gend, OPT, len(rm))
    assert states_ok(first, final), (first, final)


def unsharded(cfg, **kw):
    """The port's seeded f32 params and the unsharded run from them."""
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    return params, run(cfg, {k: v.clone() for k, v in params.items()},
                       init_opt_state(params, OPT), **kw)


def jax_run(name, steps=STEPS):
    """JAX's jitted step on reduced ``name`` from JAX's seeded f32
    params, as ``run`` reports it (drops not counted), and those params
    bridged to the port."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.models import api as japi
    from repro.training import optimizer as jopt
    from repro.training import train_step as jtrain
    from repro_torch import bridge
    from repro_torch.configs import get_config
    cfg, jcfg = get_config(name).reduced(), jget_config(name).reduced()
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    params = bridge.params_to_torch(jparams, "cpu")
    jocfg = jopt.AdamWConfig(lr=OPT.lr, warmup_steps=OPT.warmup_steps,
                             total_steps=OPT.total_steps,
                             clip_norm=OPT.clip_norm)
    jstate = jopt.init_opt_state(jparams, jocfg)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jocfg))
    jm, j1 = [], None
    for i in range(steps):
        b = {k: jnp.asarray(v) for k, v in batch_np(cfg, i).items()}
        jparams, jstate, m = jstep(jparams, jstate, b)
        jm.append({k: float(v) for k, v in m.items()})
        if i == 0:
            j1 = ({k: np.asarray(v) for k, v in jparams.items()},
                  {k[2:]: np.asarray(v) for k, v in jstate.items()
                   if k.startswith("m/")})
    return params, (jm, j1, ({k: np.asarray(v) for k, v in jparams.items()},
                             {k: np.asarray(v, np.float32)
                              for k, v in jstate.items()}))
