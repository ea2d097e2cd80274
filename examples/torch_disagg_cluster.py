"""Disaggregated prefill/decode serving on the PyTorch port: long-prefill
bursts beside a live decode stream.

The port's counterpart of ``examples/disagg_cluster.py``, with the same
engines, requests, seeds and contract. Builds the ``"disagg"`` tier
via ``build_system`` (replicas split into prefill and decode roles, a
paged-KV handoff plane between them) and drives the scenario
disaggregation exists for: a steady decode stream that keeps producing
tokens while bursts of long prompts prefill *on the other tier*.
Prints the handoff statistics (shipments, bytes, link wait) and the
per-role utilization gauges.

Runs on the card unless ``--device cpu`` asks for the CPU. On the card
the three replicas serve ``chameleon-llama-7b`` at full width from one
copy of seeded bf16 weights and the run also checks that bgmv, sgmv
and paged_attention launched, with no plain version and no einsum
LoRA; on the CPU the reduced model the JAX example serves.

    PYTHONPATH=src python examples/torch_disagg_cluster.py [--device cpu]

Exits non-zero unless every request completes, at least one KV handoff
actually crossed the link, and a mid-handoff cancellation resolves
cleanly.
"""
import argparse

import numpy as np

from repro_torch.core import Request, RequestState
from repro_torch.device import resolve_device
from repro_torch.serving import build_system
from repro_torch.serving.disagg import DisaggCluster
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.example_support import (counted_launches,
                                                 example_model, summary)


def main(argv=None, *, model_cfg=None, params=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model_cfg, params = example_model(device, model_cfg, params)

    system = build_system(
        "chameleon", tier="disagg", n_nodes=3,
        ecfg=EngineConfig(max_slots=4, max_len=320, n_lora_slots=4,
                          n_adapters=8),
        model_cfg=model_cfg, params=params, device=device)
    assert isinstance(system, DisaggCluster)
    print(f"system: {type(system).__name__} "
          f"({len(system.prefill)} prefill + {len(system.decode)} "
          f"decode replicas)")
    system.warmup()
    with counted_launches(device) as counts:
        # --- decode stream: short prompts, long outputs ----------------
        rng = np.random.default_rng(0)
        stream = [system.submit(Request(
            input_len=12, output_len=48, adapter_id=i % 4,
            prompt=[int(x) for x in rng.integers(1, 120, 12)]))
            for i in range(4)]

        # Let the stream hand off to the decode tier and produce a while.
        while any(len(h.tokens) < 8 for h in stream):
            system.step()
        print("stream decoding on the decode tier; migrating now:",
              sum(len(e._migrating) for e in system.engines))

        # --- long-prefill burst: lands on the *prefill* tier -----------
        burst = [system.submit(Request(
            input_len=200, output_len=4, adapter_id=4 + i,
            prompt=[int(x) for x in rng.integers(1, 120, 200)]))
            for i in range(2)]
        print("burst submitted: 2 x 200-token prompts "
              f"-> replicas {[h.node for h in burst]}")

        # --- cancel one stream request mid-flight ----------------------
        victim = stream.pop()
        assert victim.cancel(), "cancel must succeed on a live request"

        system.drain()
    assert victim.state is RequestState.CANCELLED, victim.state
    done = stream + burst
    assert all(h.done and h.state is RequestState.FINISHED
               for h in done), [h.state for h in done]
    assert all(len(h.tokens) == h.req.output_len for h in done)

    # --- what moved where ------------------------------------------------
    s = system.stats()
    merged, _ = system.metrics()
    sg = merged.sched_stats
    print(f"handoffs: {s['handoff']['handoffs']} shipments, "
          f"{s['handoff']['handoff_gb']:.6f} GB over the link, "
          f"mean wait {s['handoff']['handoff_wait_s'] * 1e3:.2f} ms")
    print(f"spilled prefills: {s['spilled_prefills']}  "
          f"routed via prefill tier: {s['routed_prefill']}")
    print(f"role utilization: prefill={sg['prefill_util']:.3f} "
          f"decode={sg['decode_util']:.3f}")
    if "role_plan" in s:
        p = s["role_plan"]
        print(f"autoscaler: wants {p['want_prefill']} prefill / "
              f"{p['want_decode']} decode "
              f"(demand {p['prefill_demand_tokens']} vs "
              f"{p['decode_demand_tokens']} tokens)")
    assert s["handoff"]["handoffs"] >= 1, "no KV handoff crossed the link"
    for e in system.engines:
        if e.paged:
            e.pool.check_invariants(free_page_ids=e.free_pages)
    print("ok: all requests completed, tokens streamed across the "
          "prefill->decode handoff")
    return dict(summary(merged), requests=len(done) + 1,
                cancelled=int(victim.state is RequestState.CANCELLED),
                replicas=len(system.engines),
                handoffs=s["handoff"]["handoffs"],
                handoff_gb=s["handoff"]["handoff_gb"],
                spilled_prefills=s["spilled_prefills"], **counts)


if __name__ == "__main__":
    main()
