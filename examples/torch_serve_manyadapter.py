"""End-to-end many-adapter serving on the PyTorch port (the paper's kind of
workload).

The port's counterpart of ``examples/serve_manyadapter.py``, with the
same modes, traces and flags. By default it replays a production-style
trace (heavy-tailed lengths, Poisson arrivals, power-law adapter
popularity, 100 adapters) through the Chameleon node and the S-LoRA
baseline on the calibrated simulator and prints the paper's headline
comparison (a DES: the same lines as the JAX example). ``--engine``
drives the port's real engine on a scaled-down trace, and
``--cluster`` drives N real engine replicas behind adapter-affinity
routing (shared AdapterCatalog, per-node cache/scheduler stats).

Runs on the card unless ``--device cpu`` asks for the CPU. On the card
the real engines serve ``chameleon-llama-7b`` at full width (seeded
bf16 weights, one copy shared by the replicas) and also check that
bgmv, sgmv and paged_attention launched, with no plain version and no
einsum LoRA; on the CPU the reduced model the JAX example serves.

    PYTHONPATH=src python examples/torch_serve_manyadapter.py [--rps 12]
    PYTHONPATH=src python examples/torch_serve_manyadapter.py --engine
    PYTHONPATH=src python examples/torch_serve_manyadapter.py --cluster
"""
import argparse

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.serving import (NodeConfig, TraceConfig, build_node,
                                 synthesize)
from repro_torch.serving.example_support import (counted_launches,
                                                 example_model, summary)


def run_sim(rps: float) -> dict:
    print(f"=== many-adapter serving @ {rps} RPS "
          f"(Llama-7B / A40 / 100 adapters) ===")
    rows = {}
    for system in ("slora", "userve-sjf", "chameleon"):
        sim, adapters, cost = build_node(system, NodeConfig())
        trace = synthesize(TraceConfig(rps=rps, duration_s=120.0, seed=1),
                           list(adapters.values()))
        m = sim.run(trace)
        rows[system] = m
        print(f"{system:>12}: p50 TTFT {m.p50_ttft():7.3f}s   "
              f"p99 TTFT {m.p99_ttft():8.3f}s   "
              f"p99 TBT {m.p99_tbt():6.3f}s   "
              f"hit {m.cache_stats['hit_rate']:.2f}   "
              f"loaded {m.cache_stats['gb_loaded']:.1f} GB")
    s, c = rows["slora"], rows["chameleon"]
    print(f"\nChameleon vs S-LoRA: P99 TTFT −{1 - c.p99_ttft()/s.p99_ttft():.1%}, "
          f"P50 TTFT −{1 - c.p50_ttft()/s.p50_ttft():.1%} "
          f"(paper at high load: −80.7 % / −48.1 %)")
    return dict(summary(c), requests=c.n_submitted,
                slora_ttft_p99_s=s.p99_ttft())


def run_engine(device, model_cfg, params) -> dict:
    from repro_torch.core import Request, RequestState
    from repro_torch.serving import build_system
    from repro_torch.serving.engine import EngineConfig

    print("=== real PyTorch engine (unified surface) ===")
    eng = build_system("chameleon", tier="engine", ecfg=EngineConfig(
        max_slots=6, max_len=128, n_lora_slots=4, n_adapters=12),
        model_cfg=model_cfg, params=params, device=device)
    with counted_launches(device) as counts:
        rng = np.random.default_rng(1)
        handles = [eng.submit(Request(input_len=int(rng.integers(4, 40)),
                                      output_len=int(rng.integers(4, 30)),
                                      adapter_id=int(rng.integers(0, 12))))
                   for _ in range(24)]
        # Stream one request live; cancel another mid-queue (the
        # api-smoke contract: at least one streamed token, one clean
        # cancellation).
        first_tok = next(iter(handles[0]))
        victim = handles[-1]
        assert victim.cancel()
        eng.drain()
    assert victim.state is RequestState.CANCELLED
    done = [h.result() for h in handles
            if h.state is RequestState.FINISHED]
    assert len(done) == 23 and first_tok == handles[0].tokens[0]
    ttfts = sorted(r.ttft for r in done)
    print(f"completed {len(done)} (+1 cancelled); "
          f"p50 TTFT {ttfts[len(ttfts)//2]:.3f}s  "
          f"p99 TTFT {ttfts[-1]:.3f}s")
    print("cache:", eng.stats()["cache"])
    print("api-smoke ok: streamed tokens + clean cancellation")
    return dict(summary(eng.metrics()), requests=len(handles),
                cancelled=sum(h.state is RequestState.CANCELLED
                              for h in handles), **counts)


def run_engine_cluster(n_engines: int, device, model_cfg, params) -> dict:
    from repro_torch.core.lora import build_adapter_pool
    from repro_torch.serving import build_system
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.trace import (TraceConfig, downscale_for_engine,
                                           synthesize)

    print(f"=== real-engine cluster ({n_engines} replicas, "
          f"adapter-affinity routing) ===")
    ecfg = EngineConfig(max_slots=4, max_len=128, n_lora_slots=3,
                        n_adapters=12)
    base = synthesize(TraceConfig(rps=12.0, duration_s=4.0,
                                  n_adapters=ecfg.n_adapters, seed=1),
                      build_adapter_pool(ecfg.n_adapters, 64, 4, 64))
    trace = downscale_for_engine(base, ecfg.n_adapters,
                                 max_input=48, max_output=16)
    cluster = build_system("chameleon", tier="cluster", ecfg=ecfg,
                           n_nodes=n_engines, policy="adapter_affinity",
                           model_cfg=model_cfg, params=params,
                           device=device)
    cluster.warmup()
    with counted_launches(device) as counts:
        merged, per_node = cluster.run(trace.requests)
    print(f"completed {merged.completed()}/{merged.n_submitted}  "
          f"p50 TTFT {merged.p50_ttft():.3f}s  "
          f"p99 TTFT {merged.p99_ttft():.3f}s  "
          f"hit {merged.cache_stats['hit_rate']:.2f}  "
          f"adapter loads {merged.cache_stats['misses']}")
    for i, m in enumerate(per_node):
        print(f"  node {i}: {m.completed():3d} reqs  "
              f"p99 TTFT {m.p99_ttft():7.3f}s  "
              f"hit {m.cache_stats['hit_rate']:.2f}  "
              f"bypassed {m.sched_stats['bypassed']}")
    assert merged.completed() == merged.n_submitted == len(trace.requests), \
        "every request of the trace must complete"
    return dict(summary(merged), requests=len(trace.requests),
                cancelled=0, replicas=n_engines,
                finished_by_replica=[m.completed() for m in per_node],
                **counts)


def main(argv=None, *, model_cfg=None, params=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rps", type=float, default=12.0)
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--cluster", action="store_true")
    ap.add_argument("--n-engines", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if not (args.cluster or args.engine):
        return run_sim(args.rps)
    model_cfg, params = example_model(device, model_cfg, params)
    if args.cluster:
        return run_engine_cluster(args.n_engines, device, model_cfg, params)
    return run_engine(device, model_cfg, params)


if __name__ == "__main__":
    main()
