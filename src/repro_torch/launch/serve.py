"""Serving launcher: trace-driven Chameleon node.

Port of ``src/repro/launch/serve.py``. Two backends:
- ``--backend sim``    calibrated DES at production scale (default);
- ``--backend engine`` the PyTorch engine on a reduced model, on the
  CUDA device unless ``--device cpu`` asks for the CPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --rps 12
    PYTHONPATH=src python -m repro_torch.launch.serve --backend engine
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.serving import (NodeConfig, SYSTEM_NAMES, TraceConfig,
                                 build_node, synthesize)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--system", default="chameleon", choices=SYSTEM_NAMES)
    ap.add_argument("--backend", default="sim", choices=("sim", "engine"))
    ap.add_argument("--rps", type=float, default=10.0)
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--n-adapters", type=int, default=100)
    ap.add_argument("--hw", default="a40")
    ap.add_argument("--model", default="llama-7b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="engine backend: torch device (default: CUDA)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    if args.backend == "engine":
        import torch

        from repro_torch.configs import get_config
        from repro_torch.core import Request
        from repro_torch.models import api
        from repro_torch.serving.engine import ChameleonEngine, EngineConfig
        cfg = get_config("chameleon-llama-7b").reduced()
        params = api.init_params(cfg, args.seed, torch.float32,
                                 device=args.device)
        eng = ChameleonEngine(cfg, params, EngineConfig(
            max_slots=6, max_len=128, n_lora_slots=4, n_adapters=12),
            device=args.device)
        rng = np.random.default_rng(args.seed)
        for _ in range(24):
            eng.submit(Request(input_len=int(rng.integers(4, 40)),
                               output_len=int(rng.integers(4, 30)),
                               adapter_id=int(rng.integers(0, 12))))
        eng.run_until_drained()
        ttfts = sorted(r.ttft() for r in eng.completed)
        print(f"completed {len(eng.completed)}; "
              f"p50 TTFT {ttfts[len(ttfts)//2]:.3f}s "
              f"p99 TTFT {ttfts[-1]:.3f}s")
        print("cache:", eng.stats()["cache"])
        return

    cfg = NodeConfig(hw=args.hw, model=args.model,
                     n_adapters=args.n_adapters, seed=args.seed)
    sim, adapters, cost = build_node(args.system, cfg)
    trace = synthesize(
        TraceConfig(rps=args.rps, duration_s=args.duration,
                    n_adapters=args.n_adapters, seed=args.seed),
        list(adapters.values()))
    m = sim.run(trace)
    summary = m.summary()
    if args.json:
        print(json.dumps(summary, indent=1, default=float))
    else:
        for k, v in summary.items():
            print(f"{k:>22}: {v if not isinstance(v, float) else round(v, 4)}")


if __name__ == "__main__":
    main()
