"""Training launcher: --arch <id> on the host's cards or a forced mesh
(PyTorch).

Port of ``src/repro/launch/train.py`` with the same flags and defaults:
AdamW (``warmup_steps = min(20, steps // 5)``), f32 params from a
seeded init, ``SyntheticLM`` batches, async checkpoints every
``--checkpoint-every`` steps and a restore of the latest one at start.
``--devices host`` trains any ``--arch`` over every visible card on
the host mesh ``(n, 1)``: params and AdamW moments FSDP-sharded over
"data" by the train rule table, each card a batch shard (one card
trains unsharded). ``SyntheticLM`` makes no ``frames`` (nor does the
JAX package's), so the enc-dec family trains through
``make_train_step`` with batches of its own;
``--device cpu`` asks for the CPU instead, whose positions
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` sets.
``--devices production[-multipod]`` builds the 16x16 (2x16x16) mesh,
which raises when the host has too few devices, as ``jax.make_mesh``
does.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --reduced --steps 50 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (device_put, opt_shardings,
                                              param_shardings)
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.models import api
from repro_torch.models.base import ModelConfig
from repro_torch.training import (AdamWConfig, AsyncCheckpointer, DataConfig,
                                  SyntheticLM, init_opt_state, latest_step,
                                  make_train_step, restore_checkpoint)


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          lr: float = 3e-4, checkpoint_dir: str | None = None,
          checkpoint_every: int = 50, device=None, mesh: Mesh | None = None,
          log=print) -> dict:
    """Run the launcher's loop; returns dict(params, opt, opt_cfg,
    history): the trained state and, for each step run, its step,
    loss, grad norm, lr and host seconds (each step ends in a read of
    its loss, which waits for the device). With ``mesh`` of more than
    one position the state is placed on it (``param_shardings(kind=
    "train")``, ``opt_shardings``) and restored onto it, and each batch
    goes whole to the mesh's first position, the step splitting its
    rows; a one-position mesh trains unsharded on its device."""
    if mesh is not None and mesh.size == 1:
        device, mesh = mesh.devices.flat[0], None
    device = resolve_device(device) if mesh is None else mesh.devices.flat[0]
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=min(20, steps // 5),
                          total_steps=steps)
    params = api.init_params(cfg, 0, torch.float32, device=device)
    shardings = None
    if mesh is not None:
        p_sh = param_shardings(cfg, params, mesh, "train")
        shardings = {"params": p_sh, "opt": opt_shardings(p_sh, mesh)}
        params = device_put(params, p_sh)
        log(f"mesh {dict(mesh.shape)}: {mesh.size} positions")
    opt = init_opt_state(params, opt_cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch))
    step_fn = make_train_step(cfg, opt_cfg)
    ck = AsyncCheckpointer(checkpoint_dir) if checkpoint_dir else None
    start = 0
    if ck and latest_step(checkpoint_dir) is not None:
        start, trees = restore_checkpoint(checkpoint_dir,
                                          shardings=shardings, device=device)
        params, opt = trees["params"], trees["opt"]
        log(f"restored checkpoint at step {start}")

    history = []
    t0 = time.time()
    for step in range(start, steps):
        ts = time.perf_counter()
        b = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch(step).items()}
        params, opt, m = step_fn(params, opt, b)
        rec = dict(step=step, loss=float(m["loss"]),
                   grad_norm=float(m["grad_norm"]), lr=float(m["lr"]),
                   seconds=time.perf_counter() - ts)
        history.append(rec)
        if step % 10 == 0 or step == steps - 1:
            log(f"step {step:5d} loss {rec['loss']:.4f} "
                f"gnorm {rec['grad_norm']:.3f} "
                f"({(time.time()-t0)/(step-start+1):.2f}s/step)")
        if ck and (step + 1) % checkpoint_every == 0:
            ck.save(step + 1, {"params": params, "opt": opt})
    if ck:
        ck.save(steps, {"params": params, "opt": opt})
        ck.wait()
    return dict(params=params, opt=opt, opt_cfg=opt_cfg, history=history)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--devices", choices=("host", "production",
                                          "production-multipod"),
                    default="host")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.devices == "host":
        mesh = make_host_mesh(args.device)
    else:
        mesh = make_production_mesh(
            multi_pod=args.devices == "production-multipod",
            device=args.device)
    train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
          lr=args.lr, checkpoint_dir=args.checkpoint_dir,
          checkpoint_every=args.checkpoint_every, device=args.device,
          mesh=mesh)
    print("done")


if __name__ == "__main__":
    main()
