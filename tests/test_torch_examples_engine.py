"""The port's engine examples run to their end on the CPU with their
contracts held (``--device cpu``: the reduced model the JAX examples
serve): quickstart, ``serve_manyadapter --engine`` and ``--cluster``,
and the disagg tier. Each example's ``main`` asserts its own contract
(a streamed token, a clean cancel, 23 of 24 finished, every request at
its output length, at least one KV handoff, the pool invariants); the
tests also read what it returns. On the CPU the kernel wrappers serve
their plain versions, so no launch is counted; the two tiers' tests
check that every warm-up ran before the counted block opened, so on
the card the counts are the served run's own.

Quickstart's streamed greedy request and seeded sampled request, served
by the example's own ``stream_and_sample`` on a port engine, give the
JAX engine's tokens on the same weights and adapters.
"""
import contextlib

import pytest
from _port_examples import load

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on one
# machine, and torch's default of one thread per core oversubscribes it.
torch.set_num_threads(1)


def run_example(script: str, *args: str, events: list | None = None,
                monkeypatch=None) -> dict:
    """The example's ``main`` with ``--device cpu``. Given ``events``,
    its ``counted_launches`` block and every tier warm-up append to it
    ("count", "counted", "warmup"), so a test can read their order."""
    mod = load(script)
    if events is not None:
        from repro_torch.serving.cluster import EngineCluster
        from repro_torch.serving.disagg import DisaggCluster

        @contextlib.contextmanager
        def counting(device):
            events.append("count")
            with real(device) as counts:
                yield counts
            events.append("counted")

        def warming(warmup):
            def wrapped(self):
                events.append("warmup")
                return warmup(self)
            return wrapped

        real = mod.counted_launches
        monkeypatch.setattr(mod, "counted_launches", counting)
        for cls in (EngineCluster, DisaggCluster):
            monkeypatch.setattr(cls, "warmup", warming(cls.warmup))
    return mod.main([*args, "--device", "cpu"])


def warmed_before_counting(events: list) -> bool:
    """Every warm-up ran, and ran before the counted block opened: the
    launch counts are the served run's own."""
    return ("warmup" in events and events.count("count") == 1
            and events.index("count") > max(
                i for i, e in enumerate(events) if e == "warmup")
            and events[-1] == "counted")


def test_quickstart(capsys):
    out = run_example("torch_quickstart.py")
    text = capsys.readouterr().out
    assert "api-smoke ok: streamed tokens + clean cancellation" in text
    assert out["requests"] == 16 and out["cancelled"] == 1
    assert out["finished"] == 15
    assert len(out["streamed"]) == len(out["sampled"]) == 8
    assert "launches" not in out
    assert 0 <= out["ttft_p50_s"] <= out["ttft_p99_s"]


def test_serve_manyadapter_engine(capsys):
    out = run_example("torch_serve_manyadapter.py", "--engine")
    assert "completed 23 (+1 cancelled)" in capsys.readouterr().out
    assert (out["finished"], out["cancelled"], out["requests"]) == (23, 1,
                                                                     24)
    assert out["cache"]["misses"] > 0 and out["cache"]["evictions"] > 0


def test_serve_manyadapter_cluster(capsys, monkeypatch):
    events = []
    out = run_example("torch_serve_manyadapter.py", "--cluster",
                      events=events, monkeypatch=monkeypatch)
    assert warmed_before_counting(events), events
    text = capsys.readouterr().out
    assert "real-engine cluster (2 replicas" in text
    assert out["finished"] == out["requests"] > 0
    assert sum(out["finished_by_replica"]) == out["requests"]
    assert all(n > 0 for n in out["finished_by_replica"])


def test_disagg_cluster(capsys, monkeypatch):
    events = []
    out = run_example("torch_disagg_cluster.py", events=events,
                      monkeypatch=monkeypatch)
    assert warmed_before_counting(events), events
    text = capsys.readouterr().out
    assert "ok: all requests completed" in text
    assert out["replicas"] == 3 and out["cancelled"] == 1
    assert out["finished"] == out["requests"] - 1 == 5
    assert out["handoffs"] >= 1 and out["handoff_gb"] > 0


def test_quickstart_requests_give_the_jax_engines_tokens():
    """The streamed greedy request (prompt 100..111, 8 tokens, adapter
    0) and the seeded sampled one (T 0.8, top_k 20, seed 7, adapter 1)
    through the example's ``stream_and_sample`` on a port engine, and
    the same two requests on the JAX engine, both on the bridged JAX
    weights and catalog under the example's ``EngineConfig``."""
    pytest.importorskip("jax")
    from _port_serving import ENGINE, land_jax_loads, models

    from repro.core import Request as JRequest
    from repro.core import SamplingParams as JSamplingParams
    from repro.serving import engine as jengine
    from repro_torch.core import Request
    from repro_torch.serving.systems import build_engine

    qs = load("torch_quickstart.py")
    m = models()
    ecfg = qs.ECFG
    assert {k: getattr(ecfg, k) for k in ENGINE} == ENGINE

    eng = build_engine("chameleon", m["cfg"], m["params"], ecfg,
                       catalog=m["cat"], device="cpu")
    streamed, sampled = qs.stream_and_sample(eng)

    jeng = jengine.ChameleonEngine(m["jcfg"], m["jparams"],
                                   jengine.EngineConfig(**ENGINE),
                                   catalog=m["jcat"])

    def serve(req, sampling=None):
        h = jeng.submit(req, sampling=sampling)
        for _ in range(1000):
            if h.done:
                break
            land_jax_loads(jeng)
            jeng.step()
        assert h.done
        return list(h.tokens)

    jstreamed = serve(JRequest(input_len=12, output_len=8, adapter_id=0,
                               prompt=list(range(100, 112))))
    jsampled = serve(JRequest(input_len=12, output_len=8, adapter_id=1),
                     JSamplingParams(temperature=0.8, top_k=20, seed=7))
    assert streamed == jstreamed
    assert sampled == jsampled
    assert len(streamed) == len(sampled) == 8
    # The sampled request really sampled: not the greedy argmax chain.
    greedy = build_engine("chameleon", m["cfg"], m["params"], ecfg,
                          catalog=m["cat"], device="cpu")
    g = greedy.submit(Request(input_len=12, output_len=8, adapter_id=1))
    assert list(g.result().tokens) != sampled
