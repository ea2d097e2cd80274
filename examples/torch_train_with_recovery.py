"""Train a small LM with fault tolerance on the PyTorch port.

The port's counterpart of ``examples/train_with_recovery.py``: AdamW,
deterministic synthetic data, async checkpointing, and
checkpoint/restart recovery from injected node failures, with the same
reduced model, schedule and failure steps. Runs on the card unless
``--device cpu`` asks for the CPU.

    PYTHONPATH=src python examples/torch_train_with_recovery.py [--steps 200]
"""
import argparse
import shutil
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.training import (AdamWConfig, AsyncCheckpointer, DataConfig,
                                  NodeFailure, SyntheticLM, init_train_state,
                                  latest_step, make_train_step,
                                  restore_checkpoint, run_with_recovery)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[60, 140])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("internlm2-1.8b").reduced(
        n_layers=4, d_model=192, vocab_size=4096, d_ff=512)
    n_params_cfg = cfg.param_count()
    print(f"model: {cfg.name} reduced -> {n_params_cfg/1e6:.1f}M params")

    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    params, opt = init_train_state(cfg, opt_cfg, 0, torch.float32,
                                   device=device)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=16))
    step_fn = make_train_step(cfg, opt_cfg)

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    ck = AsyncCheckpointer(ckpt_dir, keep=2)
    state = {"params": params, "opt": opt}
    fail_at = set(args.fail_at)
    losses = []

    def train_one(step):
        if step in fail_at:
            fail_at.discard(step)
            raise NodeFailure(host=step % 7)
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(step).items()}
        state["params"], state["opt"], m = step_fn(
            state["params"], state["opt"], batch)
        losses.append(float(m["loss"]))
        if step % 25 == 0:
            print(f"  step {step:4d} loss {float(m['loss']):.3f} "
                  f"lr {float(m['lr']):.2e}")
        return {"loss": float(m["loss"])}

    def save(step):
        ck.save(step, {"params": state["params"], "opt": state["opt"]})

    def restore():
        ck.wait()
        last = latest_step(ckpt_dir)
        if last is None:
            return 0
        step, trees = restore_checkpoint(ckpt_dir, device=device)
        state["params"], state["opt"] = trees["params"], trees["opt"]
        print(f"  [recovery] restored step {step}")
        return step

    try:
        out = run_with_recovery(train_one, save, restore,
                                n_steps=args.steps, checkpoint_every=50)
        ck.wait()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"\ndone: {out['steps_done']} steps, "
          f"{out['recoveries']} recoveries, "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    if not losses[-1] < losses[0]:
        raise RuntimeError("training must make progress")
    return dict(out, losses=losses)


if __name__ == "__main__":
    main()
