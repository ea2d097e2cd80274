"""The KV-migration API and the disaggregated tier of the port against
the JAX package, on the CPU.

- **Handoff parity**: a request exported mid-decode from one port
  engine and imported into another (paged and dense) streams the JAX
  single engine's tokens, and its payload equals the JAX engine's own
  ``begin_migration`` payload on the same weights and prompt (within
  1e-5 of the payload's largest magnitude, f32). An export taken while the source's pipelined horizon is
  in flight ships the current position.
- **Pool safety and lifecycle**: COW-shared prefix pages survive
  migration; cancel, expiry and abort after an import refusal leave
  both pools consistent.
- **The cluster**: cancel and expiry on the link under a manual clock
  (the tests never wait on wall time); ``DisaggCluster`` tokens equal
  the JAX engine's; spill-back and rank-aware decode homes; the
  ``build_system`` factory and its gauges; ``RoleAutoscaler`` and the
  elastic planners equal the JAX package's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on one
# machine, and torch's default of one thread per core oversubscribes it.
torch.set_num_threads(1)
pytest.importorskip("jax")

from _port_serving import (ENGINE, StepClock, check_pools,  # noqa: E402
                           models, prompt, run_to_generated)
from repro.core import Request as JRequest  # noqa: E402
from repro.distributed import elastic as jelastic  # noqa: E402
from repro.serving import disagg as jdisagg  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.core import Request, RequestState  # noqa: E402
from repro_torch.distributed import elastic  # noqa: E402
from repro_torch.serving import (GAUGES, ServingSystem,  # noqa: E402
                                 build_system)
from repro_torch.serving import cluster as tcluster  # noqa: E402
from repro_torch.serving import disagg, engine  # noqa: E402

#: The payload tolerance, relative to the payload's largest magnitude.
#: Each package's f32 payload differs from the port's payload with f64
#: weights and KV by up to 1.3e-5 (port) and 8.6e-6 (JAX) absolute at
#: magnitudes up to 6.3, about 20 f32 ulps of the largest value (the
#: port's error is the smaller in mean and 99th percentile): GEMM
#: summation order accumulates error with the rows' norms, not with
#: each element. So the bound scales with the payload, 1e-5 of its
#: largest magnitude (5.4e-5 for K, 6.3e-5 for V), over twice the sum
#: of both sides' measured errors.
PAYLOAD_TOL = 1e-5
#: The migrated request of tests/test_disagg.py: 25 prompt tokens,
#: 10 out, adapter 1, exported after 3 tokens.
MIG = dict(L=25, out=10, adapter=1, at=3, seed=5)
#: The DisaggCluster spec of tests/test_disagg.py.
CLUSTER_SPEC = [(25, 8, 0), (6, 5, 1), (40, 6, 2), (10, 4, 0), (33, 7, 3),
                (12, 3, 1), (50, 5, 4)]


def mig_prompt():
    return prompt(np.random.default_rng(MIG["seed"]), MIG["L"])


def spec_requests(request_cls):
    rng = np.random.default_rng(3)
    return [request_cls(input_len=L, output_len=O, adapter_id=a,
                        prompt=prompt(rng, L)) for L, O, a in CLUSTER_SPEC]


@pytest.fixture(scope="module")
def jax_oracle():
    """Per KV layout: the JAX single engine's tokens for the migrated
    request (the paged engine also serves the cluster spec: greedy f32
    tokens do not depend on the schedule) and the JAX engine's own
    ``begin_migration`` payload after ``MIG["at"]`` tokens."""
    m = models()
    out = {}
    for paged in (True, False):
        base = jengine.ChameleonEngine(
            m["jcfg"], m["jparams"],
            jengine.EngineConfig(**ENGINE, paged=paged), catalog=m["jcat"])
        h = base.submit(JRequest(input_len=MIG["L"], output_len=MIG["out"],
                                 adapter_id=MIG["adapter"],
                                 prompt=mig_prompt()))
        spec = ([base.submit(r) for r in spec_requests(JRequest)]
                if paged else [])
        base.drain()
        src = jengine.ChameleonEngine(
            m["jcfg"], m["jparams"],
            jengine.EngineConfig(**ENGINE, paged=paged, max_horizon=1,
                                 pipeline_readback=False),
            catalog=m["jcat"])
        req = JRequest(input_len=MIG["L"], output_len=MIG["out"],
                       adapter_id=MIG["adapter"], prompt=mig_prompt())
        run_to_generated(src, src.submit(req), MIG["at"])
        ship = src.begin_migration(req)
        out[paged] = dict(tokens=h.tokens, spec=[x.tokens for x in spec],
                          ship=ship)
    return out


def port_engine(**kw):
    m = models()
    return engine.ChameleonEngine(
        m["cfg"], m["params"], engine.EngineConfig(**{**ENGINE, **kw}),
        catalog=m["cat"], device="cpu")


def export(src, n, **req_kw):
    """Submit the migrated request to ``src``, step it to ``n`` tokens
    and export it."""
    req = Request(input_len=MIG["L"], output_len=MIG["out"],
                  adapter_id=MIG["adapter"], prompt=mig_prompt(), **req_kw)
    h = src.submit(req)
    run_to_generated(src, h, n)
    ship = src.begin_migration(req)
    assert ship is not None
    return req, h, ship


def land(src, dst, req, h, ship):
    """Import into ``dst``, release ``src``, finish on ``dst``."""
    check_pools(src, dst)               # source pages pinned, not freed
    assert dst.import_request_kv(ship)
    src.complete_migration(req)
    check_pools(src, dst)
    assert req.state is RequestState.RUNNING
    h._system = dst
    dst.drain()
    assert h.done and req.state is RequestState.FINISHED
    return h.tokens


@pytest.mark.parametrize("paged", [True, False])
def test_migrated_tokens_and_payload_match_jax(jax_oracle, paged):
    want = jax_oracle[paged]
    src = port_engine(paged=paged, max_horizon=1, pipeline_readback=False)
    dst = port_engine(paged=paged)
    req, h, ship = export(src, MIG["at"])
    assert req.state is RequestState.MIGRATING and not req.terminal
    jship = want["ship"]
    for key in ("cache_len", "pending_token", "paged", "nbytes", "outputs"):
        assert ship[key] == jship[key], key
    # Times are each engine's own clock: only their count is shared.
    assert len(ship["tbts"]) == len(jship["tbts"]) == MIG["at"] - 1
    assert ship["last_tok"] is not None and ship["handle"] is h
    for key in ("k", "v"):
        assert isinstance(ship[key], torch.Tensor)
        assert ship[key].device.type == "cpu"
        assert tuple(ship[key].shape) == jship[key].shape
        atol = PAYLOAD_TOL * float(np.abs(jship[key]).max())
        np.testing.assert_allclose(ship[key].numpy(), jship[key], rtol=0,
                                   atol=atol)
    assert land(src, dst, req, h, ship) == want["tokens"]
    assert src.n_kv_exports == 1 and dst.n_kv_imports == 1
    assert dst.kv_handoff_bytes == ship["nbytes"] > 0
    assert len(h.result().tbts) == MIG["out"] - 1
    assert src.stats()["kv_exports"] == 1
    assert dst.stats()["kv_handoff_gb"] == round(ship["nbytes"] / 1e9, 6)


def test_export_with_a_pipelined_horizon_in_flight(jax_oracle):
    """Default engines (fused horizon 8, pipelined readback): the export
    drains the in-flight horizon before it reads the position."""
    src, dst = port_engine(), port_engine()
    req = Request(input_len=MIG["L"], output_len=MIG["out"],
                  adapter_id=MIG["adapter"], prompt=mig_prompt())
    h = src.submit(req)
    for _ in range(100):
        src.step()
        if src._inflight is not None and len(h.tokens) >= 2:
            break
    assert src._inflight is not None
    ship = src.begin_migration(req)
    assert src._inflight is None
    assert ship["cache_len"] == MIG["L"] + len(ship["outputs"]) - 1
    assert ship["cache_len"] == MIG["L"] + req.generated - 1
    assert len(ship["outputs"]) < MIG["out"]
    assert land(src, dst, req, h, ship) == jax_oracle[True]["tokens"]


def test_cow_shared_pages_survive_migration():
    rng = np.random.default_rng(7)
    pre = prompt(rng, 32)           # two full pages of preamble

    def warm(eng):
        w = eng.submit(Request(input_len=32, output_len=4, adapter_id=2,
                               prompt=list(pre)))
        eng.drain()
        assert w.done

    base = port_engine()
    warm(base)
    hb = base.submit(Request(input_len=32, output_len=8, adapter_id=2,
                             prompt=list(pre)))
    base.drain()
    src = port_engine(max_horizon=1, pipeline_readback=False)
    dst = port_engine()
    warm(src)
    req = Request(input_len=32, output_len=8, adapter_id=2,
                  prompt=list(pre))
    h = src.submit(req)
    run_to_generated(src, h, 2)
    assert src.n_prefix_hits >= 1   # the slot really shares pages
    assert src.slot_shared[src.slot_req.index(req)]
    ship = src.begin_migration(req)
    assert land(src, dst, req, h, ship) == hb.tokens
    # The tree still holds the shared pages on the source.
    assert src.pool.n_shared_pages > 0


def _h1_export(ttl=None):
    src = port_engine(max_horizon=1, pipeline_readback=False)
    req = Request(input_len=20, output_len=12, adapter_id=0)
    h = src.submit(req, ttl=ttl)
    run_to_generated(src, h, 3)
    ship = src.begin_migration(req)
    assert ship is not None
    return src, req, h, ship


@pytest.mark.parametrize("state", [RequestState.CANCELLED,
                                   RequestState.EXPIRED])
def test_abort_mid_handoff(state):
    src, req, h, ship = _h1_export(ttl=30.0)
    assert src.abort_migration(req, state, shipment=ship)
    assert req.state is state
    check_pools(src)
    assert not src._migrating and not src.busy()
    res = h.result()
    assert len(res.tokens) == 3 and len(res.tbts) == 2
    # The slot is reusable afterwards.
    h2 = src.submit(Request(input_len=8, output_len=3, adapter_id=1))
    src.drain()
    assert h2.done and len(h2.tokens) == 3


def test_abort_after_import_refusal_leaves_dst_clean():
    src, req, h, ship = _h1_export()
    dst = port_engine(max_slots=2)
    blockers = [dst.submit(Request(input_len=8, output_len=40,
                                   adapter_id=i)) for i in range(2)]
    while not dst.active.all():
        dst.step()
    used = dst.pool.used_requests
    assert dst.import_request_kv(ship) is False
    assert dst.pool.used_requests == used and dst.n_kv_imports == 0
    check_pools(dst)
    assert src.abort_migration(req, RequestState.CANCELLED, shipment=ship)
    check_pools(src)
    dst.drain()
    assert all(b.done for b in blockers)


@pytest.fixture
def manual_clock(monkeypatch):
    """Every cluster's shared clock becomes a StepClock the test moves
    (``disagg`` imports the name itself, so both modules are patched)."""
    clocks = []

    def make():
        clocks.append(StepClock())
        return clocks[-1]
    monkeypatch.setattr(tcluster, "_SharedClock", make)
    monkeypatch.setattr(disagg, "_SharedClock", make)
    return clocks


@pytest.fixture
def bridged_catalog(monkeypatch):
    """Clusters build their catalog from the JAX package's weights."""
    m = models()
    monkeypatch.setattr(engine, "AdapterCatalog",
                        lambda *a, **k: m["cat"])


def make_disagg(link_gbps=8.0, **dkw):
    m = models()
    return disagg.DisaggCluster(
        m["cfg"], m["params"], engine.EngineConfig(**ENGINE),
        disagg.DisaggConfig(**{**dict(n_prefill=1, n_decode=2,
                                      link_gbps=link_gbps, seed=0),
                               **dkw}), device="cpu")


def _to_link(dis, clock, req):
    for _ in range(1000):
        if req.state is RequestState.MIGRATING:
            return
        dis.step()
        clock.t += 0.01
    raise AssertionError("the request never reached the link")


def test_cluster_cancel_while_on_link(manual_clock):
    dis = make_disagg(link_gbps=1e-6)     # never lands
    clock = manual_clock[0]
    req = Request(input_len=20, output_len=12, adapter_id=0)
    h = dis.submit(req)
    _to_link(dis, clock, req)
    assert h.cancel()
    dis.step()
    assert req.state is RequestState.CANCELLED
    assert dis.handoff.n_dropped == 1
    assert not dis.busy()
    check_pools(*dis.engines)


def test_cluster_expiry_while_on_link(manual_clock):
    dis = make_disagg(link_gbps=1e-6)
    clock = manual_clock[0]
    req = Request(input_len=20, output_len=12, adapter_id=0)
    dis.submit(req, ttl=1.5)
    _to_link(dis, clock, req)
    dis.step()
    assert req.state is RequestState.MIGRATING    # TTL not reached
    clock.t = 2.0
    dis.step()
    assert req.state is RequestState.EXPIRED
    assert not dis.busy()
    check_pools(*dis.engines)


def test_disagg_cluster_tokens_match_jax_engine(jax_oracle,
                                                bridged_catalog):
    dis = make_disagg()
    dis.warmup()
    got = [dis.submit(r) for r in spec_requests(Request)]
    dis.drain()
    assert all(h.done and h.state is RequestState.FINISHED for h in got)
    assert [h.tokens for h in got] == jax_oracle[True]["spec"]
    s = dis.stats()
    assert s["handoff"]["handoffs"] + s["spilled_prefills"] \
        == len(CLUSTER_SPEC)
    assert s["handoff"]["handoffs"] >= 1
    for e in dis.engines:           # replicas share the weights
        assert all(e.params[k].data_ptr() == v.data_ptr()
                   for k, v in models()["params"].items())
    check_pools(*dis.engines)


def test_spillback_when_prefill_saturated():
    dis = make_disagg(spill_factor=1e-9)
    hs = [dis.submit(Request(input_len=10, output_len=4, adapter_id=i % 4))
          for i in range(5)]
    assert dis.n_spilled == 4        # only the idle-tier submit stayed
    dis.drain()
    assert all(h.done for h in hs)
    assert dis.handoff.n_begun == 1
    assert sum(len(e.records) for e in dis.decode) >= 4


def test_rank_aware_decode_homes_spread():
    dis = make_disagg()
    r1 = Request(input_len=8, output_len=2, adapter_id=0)
    r2 = Request(input_len=8, output_len=2, adapter_id=1)
    h1, h2 = dis._decode_home(r1), dis._decode_home(r2)
    assert h1 is not h2
    assert dis._decode_home(r1) is h1


def test_build_system_disagg_serves_with_handoff_gauges():
    m = models()
    sys_ = build_system(tier="disagg", model_cfg=m["cfg"],
                        params=m["params"],
                        ecfg=engine.EngineConfig(**ENGINE), n_nodes=3,
                        device="cpu")
    assert isinstance(sys_, disagg.DisaggCluster)
    assert isinstance(sys_, ServingSystem)
    assert len(sys_.prefill) == 1 and len(sys_.decode) == 2
    assert all(e.device.type == "cpu" for e in sys_.engines)
    hs = [sys_.submit(Request(input_len=20, output_len=4,
                              adapter_id=i % 3)) for i in range(3)]
    assert len(list(hs[0].stream())) == 4
    sys_.drain()
    assert all(h.done for h in hs)
    s = sys_.stats()
    assert s["handoff"]["handoffs"] == 3
    per = s["per_engine"]
    assert sum(p.get("kv_exports", 0) for p in per) == 3
    assert sum(p.get("kv_imports", 0) for p in per) == 3
    assert all(k in per[0] for k in ("chunked_prefills", "kv_exports",
                                     "kv_imports", "kv_handoff_gb",
                                     "migrating"))
    merged, per_node = sys_.metrics()
    live = set(merged.cache_stats) | set(merged.sched_stats)
    for m_ in per_node:
        live |= set(m_.cache_stats) | set(m_.sched_stats)
    assert not live - set(GAUGES), sorted(live - set(GAUGES))


def test_role_autoscaler_and_elastic_planners_equal_jax(monkeypatch):
    for shape in ((4, 2), (2, 2, 2), (8, 1), (1, 4), (3, 2, 4)):
        axes = ("pod", "data", "model")[-len(shape):]
        for n in range(shape[-1], 2 * np.prod(shape) + 1):
            for batch in (1, 7, 64):
                for fn in ("plan_after_failure", "scale_out_plan"):
                    got = getattr(elastic, fn)(shape, axes, n, batch)
                    want = getattr(jelastic, fn)(shape, axes, n, batch)
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want), (fn, shape, n, batch)
    with pytest.raises(ValueError):
        elastic.plan_after_failure((2, 4), ("data", "model"), 3, 8)
    plan = elastic.scale_out_plan((1, 1), ("data", "model"), 2, 2)
    monkeypatch.delenv("XLA_FLAGS", raising=False)
    with pytest.raises(ValueError, match="devices"):
        plan.make(device="cpu")          # one host device
    ours, ref = disagg.RoleAutoscaler(), jdisagg.RoleAutoscaler()
    demand = [(4000.0, 100.0)] * 8 + [(10.0, 5000.0)] * 16 + [(0, 0)]
    for i, (pre, dec) in enumerate(demand):
        ours.observe(pre, dec)
        ref.observe(pre, dec)
        for n_pre, n_dec in ((1, 3), (2, 2), (1, 1), (3, 5)):
            a, b = ours.plan(n_pre, n_dec), ref.plan(n_pre, n_dec)
            for k in ("prefill_plan", "decode_plan"):
                a[k], b[k] = (dataclasses.asdict(a[k]),
                              dataclasses.asdict(b[k]))
            assert a == b, (i, n_pre, n_dec)


def test_apply_moves_idle_replica():
    dis = make_disagg(autoscale_apply=True)
    dis.autoscaler.observe(10.0, 5000.0)
    dis.last_role_plan = dis.autoscaler.plan(1, 2)
    dis._maybe_rebalance()
    assert len(dis.prefill) == 1 and dis.n_rebalances == 0
    for _ in range(8):
        dis.autoscaler.observe(5000.0, 10.0)
    dis.last_role_plan = dis.autoscaler.plan(1, 2)
    dis._maybe_rebalance()
    assert len(dis.prefill) == 2 and len(dis.decode) == 1
    assert dis.router.n == 2 and dis.n_rebalances == 1
    h = dis.submit(Request(input_len=10, output_len=3, adapter_id=0))
    dis.drain()
    assert h.done and len(h.tokens) == 3
