"""Multi-tenant gateway quickstart on the PyTorch port: admission control
in front of a tier.

The port's counterpart of ``examples/gateway_multitenant.py``, with the
same node, tenants, requests and contract. Wraps the paper-scale DES
node with ``serving.gateway.Gateway`` via ``build_system(...,
gateway=...)`` and walks the four outcomes a production front door must
surface:

- **stream**  an admitted request's tokens through the same
  ``RequestHandle`` every tier returns;
- **cancel**  a gateway-queued request before it ever reaches the node;
- **reject**  overflow beyond a tenant's queue cap, with a
  ``retry_after`` hint on the handle;
- **audit**   one ``GatewayDecision`` per submit plus the per-tenant
  ``gateway_stats()`` roll-up.

A DES: it prints what the JAX example prints, line for line, and runs
no device code. Like every entry point of the port it resolves its
device first (the card unless ``--device cpu``). Runs in a couple of
seconds. Exits non-zero unless every contract above held.

    PYTHONPATH=src python examples/torch_gateway_multitenant.py [--device cpu]
"""
import argparse

from repro_torch.core import Request, RequestState
from repro_torch.device import resolve_device
from repro_torch.serving import (GatewayConfig, NodeConfig, TenantPolicy,
                                 build_system)
from repro_torch.serving.example_support import summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    system = build_system(
        "chameleon", tier="sim", node=NodeConfig(n_adapters=16),
        gateway=GatewayConfig(
            default_policy=TenantPolicy(weight=1.0, max_inflight=8,
                                        max_queued=64),
            tenants={"bulk": TenantPolicy(weight=0.5, max_inflight=1,
                                          max_queued=3)},
        ))
    print(f"system: {type(system).__name__} wrapping "
          f"{type(system.inner).__name__}")

    # --- stream: tenant-tagged submit, same handle as every tier -----
    streamed = []
    handle = system.submit(
        "acme", Request(input_len=64, output_len=8, adapter_id=0),
        on_token=streamed.append)
    print("streaming req", handle.req_id, "for acme:", end=" ")
    for tok in handle:
        print(tok, end=" ", flush=True)
    print(f" [{handle.state.value}]")
    assert len(streamed) == 8, "expected 8 streamed tokens"
    assert handle.decision.action == "admit", handle.decision

    # --- cancel: a queued request never reaches the node -------------
    victim = system.submit(
        "acme", Request(input_len=64, output_len=32, adapter_id=1))
    assert victim.cancel(), "cancel must succeed while gateway-queued"
    assert victim.state is RequestState.CANCELLED, victim.state
    print(f"cancelled req {victim.req_id} while queued at the gateway")

    # --- reject: the 'bulk' tenant overflows its own queue cap -------
    flood = [system.submit("bulk", Request(input_len=64, output_len=16,
                                           adapter_id=2))
             for _ in range(10)]
    rejected = [h for h in flood if h.state is RequestState.REJECTED]
    print(f"bulk flood: {len(flood) - len(rejected)} admitted, "
          f"{len(rejected)} rejected "
          f"(retry_after={rejected[0].retry_after:.1f}s, "
          f"reason={rejected[0].decision.reason})")
    assert rejected, "queue cap must reject the overflow"
    assert all(h.retry_after > 0 for h in rejected)
    assert all(h.decision.reason == "tenant_queue_full" for h in rejected)

    system.drain()
    survivors = [h for h in flood if h.state is RequestState.FINISHED]
    assert len(survivors) == len(flood) - len(rejected), \
        "every admitted request must reach a terminal state"

    # --- audit: decision per submit + per-tenant roll-up -------------
    gs = system.gateway_stats()
    assert len(system.decisions) == gs["n_submitted"]
    print(f"\ngateway: {gs['n_submitted']} submitted, "
          f"{gs['n_admitted']} admitted, {gs['n_rejected']} rejected")
    for tenant, ts in sorted(gs["tenants"].items()):
        print(f"  {tenant:8s} submitted={ts['submitted']:2d} "
              f"completed={ts['completed']:2d} "
              f"rejected={ts['rejected']:2d} "
              f"tokens={ts['tokens_done']}")
    print("gateway-smoke ok: stream + cancel + reject + audit")
    out = dict(summary(system.inner.metrics()), requests=gs["n_submitted"],
               cancelled=int(victim.state is RequestState.CANCELLED),
               rejected=gs["n_rejected"])
    assert out["finished"] == sum(ts["completed"]
                                  for ts in gs["tenants"].values())
    return out


if __name__ == "__main__":
    main()
