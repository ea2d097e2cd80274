"""The port's cluster tiers against the JAX package, on the CPU.

- ``build_system(tier="cluster")``: two PyTorch engines behind the
  router, drained, give the JAX engine's tokens; the replicas share one
  adapter catalog and the caller's weight tensors (no copy); affinity
  routing sends an adapter's next request to the replica holding it.
- The simulator tiers (``sim``, ``sim-cluster``) are verbatim copies:
  on the same trace their ``metrics().summary()`` equals the JAX
  package's, and so do the gateway's admission decisions over the sim
  tier and the sim launcher's output. The gateway also serves a trace
  over the port's engine tier.
"""
import dataclasses
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on one
# machine, and torch's default of one thread per core oversubscribes it.
torch.set_num_threads(1)
pytest.importorskip("jax")

from _port_serving import ENGINE, check_pools, models, prompt  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.core import Request as JRequest  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import serving  # noqa: E402
from repro_torch.core import Request, RequestState  # noqa: E402
from repro_torch.core.request import TERMINAL_STATES  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import engine  # noqa: E402
from repro_torch.serving.cluster import EngineCluster  # noqa: E402

SPEC = [(25, 8, 0), (6, 5, 1), (40, 6, 2), (10, 4, 0), (33, 7, 3),
        (12, 3, 1), (50, 5, 4)]
NODE = dict(n_adapters=20)


def spec_requests(request_cls):
    rng = np.random.default_rng(3)
    return [request_cls(input_len=L, output_len=O, adapter_id=a,
                        prompt=prompt(rng, L)) for L, O, a in SPEC]


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX single engine's tokens for SPEC (greedy f32 tokens do
    not depend on the schedule)."""
    m = models()
    eng = jengine.ChameleonEngine(m["jcfg"], m["jparams"],
                                  jengine.EngineConfig(**ENGINE),
                                  catalog=m["jcat"])
    hs = [eng.submit(r) for r in spec_requests(JRequest)]
    eng.drain()
    return [h.tokens for h in hs]


@pytest.fixture
def bridged_catalog(monkeypatch):
    """Clusters build their catalog from the JAX package's weights."""
    m = models()
    monkeypatch.setattr(engine, "AdapterCatalog",
                        lambda *a, **k: m["cat"])


def port_cluster(**kw):
    m = models()
    return serving.build_system(
        "chameleon", tier="cluster", model_cfg=m["cfg"], params=m["params"],
        ecfg=engine.EngineConfig(**ENGINE), device="cpu", **kw)


def test_cluster_tokens_match_jax_engine(jax_tokens, bridged_catalog):
    cl = port_cluster(n_nodes=2, policy="least_loaded")
    assert isinstance(cl, EngineCluster)
    assert isinstance(cl, serving.ServingSystem)
    cl.warmup()
    hs = [cl.submit(r) for r in spec_requests(Request)]
    cl.drain()
    assert all(h.state is RequestState.FINISHED for h in hs)
    assert [h.tokens for h in hs] == jax_tokens
    assert {h.node for h in hs} == {0, 1}          # both replicas served
    check_pools(*cl.engines)


def test_replicas_share_catalog_and_weights():
    cl = port_cluster(n_nodes=3)
    params = models()["params"]
    for e in cl.engines:
        assert e.catalog is cl.catalog
        assert e.host_adapters is cl.catalog.weights
        assert e.device.type == "cpu"
        assert all(e.params[k].data_ptr() == v.data_ptr()
                   for k, v in params.items())
    # Device state stays per replica.
    a, b = cl.engines[:2]
    assert a.kv_pages[0].data_ptr() != b.kv_pages[0].data_ptr()
    assert a.lora is not b.lora


def test_affinity_routes_to_the_resident_replica():
    cl = port_cluster(n_nodes=2, policy="adapter_affinity")
    h = cl.submit(Request(input_len=10, output_len=3, adapter_id=3))
    cl.drain()
    home = h.node
    assert cl.engines[home].cache.resident(3)
    assert not cl.engines[1 - home].cache.resident(3)
    # Load the home replica so a load-only policy would go elsewhere.
    busy = [cl.engines[home].submit(Request(input_len=8, output_len=20,
                                            adapter_id=5))]
    h2 = cl.submit(Request(input_len=10, output_len=3, adapter_id=3))
    assert h2.node == home
    cl.drain()
    assert h2.done and busy[0].done
    assert cl.stats()["routed"][home] == 2


def _trace(pkg, adapters, multitenant=False):
    cfg = pkg.TraceConfig(rps=6.0, duration_s=30.0,
                          n_adapters=NODE["n_adapters"], seed=2)
    if multitenant:
        trace = pkg.synthesize_multitenant(
            cfg, list(adapters.values()), tenants=("acme", "globex"),
            heavy_hitter="floodcorp", heavy_rps_factor=6.0)
    else:
        trace = pkg.synthesize(cfg, list(adapters.values()))
    for i, r in enumerate(trace.requests):
        r.req_id = i          # each package numbers requests on its own
    return trace


def _sim_summary(pkg, tier):
    sys_ = pkg.build_system("chameleon", tier=tier,
                            node=pkg.NodeConfig(**NODE), n_nodes=3)
    m = sys_.run(_trace(pkg, sys_.adapters))
    return (m if tier == "sim" else m[0]).summary()


@pytest.mark.parametrize("tier", ["sim", "sim-cluster"])
def test_sim_tiers_equal_jax(tier):
    got, want = _sim_summary(serving, tier), _sim_summary(jserving, tier)
    assert got["completed"] > 0
    assert got == want


def _gateway_decisions(pkg):
    gw = pkg.build_system("chameleon", tier="sim",
                          node=pkg.NodeConfig(**NODE),
                          gateway=pkg.GatewayConfig(slo_default_s=3.0))
    trace = _trace(pkg, gw.inner.adapters, multitenant=True)
    hs = [gw.submit(r.tenant, r) for r in trace.requests]
    gw.drain()
    return ([dataclasses.asdict(gw.decisions[h.req.req_id]) for h in hs],
            [h.state.name for h in hs], gw.gateway_stats())


def test_gateway_over_sim_decides_as_jax():
    got, want = _gateway_decisions(serving), _gateway_decisions(jserving)
    assert {d["action"] for d in got[0]} >= {"admit", "reject"}
    assert got == want


def test_gateway_over_port_engine_serves_a_trace():
    m = models()
    gw = serving.build_system(
        "chameleon", tier="engine", model_cfg=m["cfg"], params=m["params"],
        ecfg=engine.EngineConfig(**ENGINE), gateway=True, device="cpu")
    assert isinstance(gw, serving.Gateway)
    rng = np.random.default_rng(4)
    hs = [gw.submit(t, Request(input_len=int(rng.integers(4, 30)),
                               output_len=4, adapter_id=i % 5))
          for i, t in enumerate(["acme", "globex"] * 3)]
    gw.drain()
    assert all(h.state in TERMINAL_STATES for h in hs)
    assert all(h.state is RequestState.FINISHED and len(h.tokens) == 4
               for h in hs)
    assert set(gw.gateway_stats()["tenants"]) == {"acme", "globex"}


def test_sim_launcher_prints_what_jax_prints(monkeypatch, capsys):
    argv = ["serve", "--duration", "15", "--rps", "4", "--json"]
    monkeypatch.setattr(sys, "argv", argv)
    jserve.main()
    want = json.loads(capsys.readouterr().out)
    serve.main(argv[1:])
    got = json.loads(capsys.readouterr().out)
    assert got["completed"] > 0 and got == want
