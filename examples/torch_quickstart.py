"""Quickstart on the PyTorch port: serve an LLM with many LoRA adapters
via Chameleon.

The port's counterpart of ``examples/quickstart.py``: the real engine
(continuous batching + Chameleon adapter cache + WRS multi-queue
scheduler) through the unified serving surface. ``build_system``
assembles the tier, ``submit`` returns a ``RequestHandle`` that streams
tokens, carries the lifecycle state machine, and supports ``cancel()``
and per-request ``SamplingParams``. The same engine shape, requests,
seeds and contract as the JAX example.

Runs on the card unless ``--device cpu`` asks for the CPU. On the card
it serves ``chameleon-llama-7b`` at full width (seeded bf16 weights)
and also checks that bgmv, sgmv and paged_attention launched, with no
plain version and no einsum LoRA; on the CPU the reduced model the JAX
example serves (about 20 s).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Exits non-zero unless at least one token streamed and one cancellation
completed cleanly.
"""
import argparse

import numpy as np

from repro_torch.core import Request, RequestState, SamplingParams
from repro_torch.device import resolve_device
from repro_torch.serving import build_system
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.example_support import (counted_launches,
                                                 example_model, summary)

ECFG = EngineConfig(max_slots=4, max_len=128, n_lora_slots=4, n_adapters=8)


def stream_and_sample(system) -> tuple[list, list]:
    """Stream the greedy request, then serve the seeded sampled one:
    (streamed tokens, sampled tokens)."""
    streamed = []
    handle = system.submit(
        Request(input_len=12, output_len=8, adapter_id=0,
                prompt=list(range(100, 112))),
        on_token=streamed.append)
    print("streaming req", handle.req_id, "tokens:", end=" ", flush=True)
    for tok in handle:
        print(tok, end=" ", flush=True)
    print(f"  [{handle.state.value}]")
    assert len(streamed) == 8, "expected 8 streamed tokens"

    sampled = system.submit(
        Request(input_len=12, output_len=8, adapter_id=1),
        sampling=SamplingParams(temperature=0.8, top_k=20, seed=7),
    ).result()
    print(f"sampled  req tokens={sampled.tokens} "
          f"(T=0.8 top_k=20 seed=7)")
    return streamed, list(sampled.tokens)


def main(argv=None, *, model_cfg=None, params=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model_cfg, params = example_model(device, model_cfg, params)

    system = build_system("chameleon", tier="engine", ecfg=ECFG,
                          model_cfg=model_cfg, params=params, device=device)
    print(f"system: {type(system).__name__} (unified serving surface)")

    with counted_launches(device) as counts:
        # --- streaming + sampling --------------------------------------
        streamed, sampled = stream_and_sample(system)

        # --- a small batch + one cancellation ----------------------------
        rng = np.random.default_rng(0)
        handles = [system.submit(Request(
            input_len=int(rng.integers(4, 30)),
            output_len=int(rng.integers(4, 24)),
            adapter_id=int(rng.integers(0, 8)))) for _ in range(14)]
        victim = handles[len(handles) // 2]
        assert victim.cancel(), "cancel must succeed on a live request"
        system.drain()
    assert victim.state is RequestState.CANCELLED, victim.state
    done = [h for h in handles if h.state is RequestState.FINISHED]
    print(f"\ncompleted {len(done)}/{len(handles)} "
          f"(1 cancelled cleanly)")

    for h in done[:5]:
        res = h.result()
        print(f"  req {res.req_id:3d} adapter={res.adapter_id} "
              f"n={res.n_tokens:3d} queue={res.queue_wait:.3f}s "
              f"load={res.adapter_load_wait:.3f}s "
              f"ttft={res.ttft:.3f}s e2e={res.e2e:.3f}s")

    st = system.stats()
    c = st["cache"]
    print(f"\nadapter cache: {c['hits']} hits / {c['misses']} misses "
          f"/ {c['evictions']} evictions")
    print(f"scheduler: bypassed={st['bypassed']} "
          f"squashed={st['squashed']} cancelled={st['cancelled']} "
          f"expired={st['expired']}")
    print("resident adapters at drain:", st["resident_adapters"])
    print("api-smoke ok: streamed tokens + clean cancellation")
    return dict(summary(system.metrics()), cancelled=st["cancelled"],
                requests=len(handles) + 2, streamed=streamed,
                sampled=sampled, **counts)


if __name__ == "__main__":
    main()
