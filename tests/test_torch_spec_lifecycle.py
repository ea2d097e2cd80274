"""Speculative decoding in the port's engine vs the JAX engine (CPU):
seeded sampling, mixed batches, and squash, cancel and deadline expiry
during a speculative burst (the contracts of
``tests/test_spec_decode.py``).

Both engines run each scenario on the same weights, adapters, draft and
virtual clock (``tests/_port_serving.py``); the port's tokens must
equal the JAX engine's, sampled ones too (the rejection rule draws
JAX's own threefry streams), and the port must keep each contract
itself: the same seeded tokens across runs and KV layouts, greedy rows
of a mixed batch equal to the non-speculative loop's, a squash that
keeps the streamed prefix, nothing leaked after a cancel, every hold
released after an expiry.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on one
# machine, and torch's default of one thread per core oversubscribes it.
torch.set_num_threads(1)
pytest.importorskip("jax")

from _port_serving import (core_classes, serve_trace,  # noqa: E402
                           spec_engines, spec_trace, step_once)

SAMPLED = dict(temperature=0.8, top_k=12, top_p=0.9, seed=1234)


def both(**kw):
    """[(JAX engine, clock), (port engine, clock)]."""
    return list(spec_engines(**kw))


def test_sampled_deterministic_and_layout_invariant():
    """Seeded sampling through the rejection rule is keyed on (seed,
    position): the port equals the JAX engine, twice, and dense KV
    equals paged."""
    specs = spec_trace(n=6, seed=5)
    (jeng, jclock), (eng, clock) = both(paged=True)
    want = [h.tokens for h in serve_trace(jeng, jclock, specs, SAMPLED)]
    outs = {"paged_a": [h.tokens for h in
                        serve_trace(eng, clock, specs, SAMPLED)]}
    for tag, paged in (("paged_b", True), ("dense", False)):
        _, (e, c) = spec_engines(paged=paged)
        outs[tag] = [h.tokens for h in serve_trace(e, c, specs, SAMPLED)]
    assert outs["paged_a"] == want, "sampled spec tokens differ from JAX"
    assert outs["paged_b"] == outs["paged_a"], "not deterministic"
    assert outs["dense"] == outs["paged_a"], "KV layout changed tokens"
    assert eng.spec_stats() == jeng.spec_stats()


def serve_plans(eng, clock, plans):
    req_cls, sp_cls = core_classes(eng)
    handles = [eng.submit(req_cls(input_len=i, output_len=o, adapter_id=a),
                          sampling=sp_cls(**s) if s else None)
               for i, o, a, s in plans]
    while eng.busy():
        step_once(eng, clock)
    return [h.tokens for h in handles]


def test_mixed_greedy_and_sampled_batch():
    """Greedy and seeded rows in one speculative batch: all equal the
    JAX engine's, and the greedy rows equal the non-speculative loop's."""
    sp = dict(temperature=0.9, top_k=20, seed=77)
    plans = [(8, 12, 0, None), (6, 15, 1, sp), (10, 10, 2, None),
             (5, 20, 3, sp)]
    (jeng, jclock), (eng, clock) = both(paged=True)
    want = serve_plans(jeng, jclock, plans)
    got = serve_plans(eng, clock, plans)
    assert got == want
    assert eng.spec_stats() == jeng.spec_stats()
    _, (ref, rclock) = spec_engines(spec=False, draft=None, paged=True)
    plain = serve_plans(ref, rclock, plans)
    for j, p in enumerate(plans):
        if p[3] is None:
            assert got[j] == plain[j], f"greedy row {j} diverged"


def steal_and_squash(eng, clock):
    """Stream 4 tokens, take every free page, step until the request is
    preempted, give the pages back and drain. Returns (handle, prefix
    streamed before the squash, n_preempted)."""
    req_cls, _ = core_classes(eng)
    h = eng.submit(req_cls(input_len=8, output_len=40, adapter_id=0))
    while len(h.tokens) < 4:
        step_once(eng, clock)
    prefix = list(h.tokens)
    stolen, eng.free_pages = eng.free_pages, []
    for _ in range(30):
        step_once(eng, clock)
        if eng.n_preempted:
            break
    n_pre = eng.n_preempted
    assert h.tokens[:len(prefix)] == prefix, "stream rewound"
    eng.free_pages = stolen
    while eng.busy():
        step_once(eng, clock)
    return h, prefix, n_pre


def test_mid_stream_squash_parity():
    """Page preemption mid-burst: the grown pages are reclaimable, the
    squash keeps the streamed prefix, and the continuation equals the
    JAX engine's and the non-speculative tokens."""
    (jeng, jclock), (eng, clock) = both()
    jh, jprefix, jpre = steal_and_squash(jeng, jclock)
    h, prefix, pre = steal_and_squash(eng, clock)
    assert pre >= 1, "the steal must force a preemption"
    assert (prefix, pre, h.tokens) == (jprefix, jpre, jh.tokens)
    assert h.state.name == "FINISHED" and h.req.squash_count >= 1
    _, (ref, rclock) = spec_engines(spec=False, draft=None)
    assert [x.tokens for x in serve_trace(ref, rclock, [(8, 40, 0)])] \
        == [h.tokens]
    assert eng.spec_stats() == jeng.spec_stats()


def cancel_mid_burst(eng, clock):
    req_cls, _ = core_classes(eng)
    h = eng.submit(req_cls(input_len=8, output_len=100, adapter_id=0))
    while not h.tokens:
        step_once(eng, clock)
    n_at_cancel = len(h.tokens)
    assert h.cancel()
    while eng.busy():
        step_once(eng, clock)
    return h, n_at_cancel


def test_cancel_during_spec_burst():
    (jeng, jclock), (eng, clock) = both()
    jh, jn = cancel_mid_burst(jeng, jclock)
    h, n = cancel_mid_burst(eng, clock)
    assert h.state.name == "CANCELLED"
    assert len(h.tokens) == n, "post-cancel tokens leaked to the handle"
    assert (h.tokens, n) == (jh.tokens, jn)
    eng.pool.check_invariants(free_page_ids=eng.free_pages)
    assert eng.pool.used_requests == 0
    assert int(np.sum(eng._draft_len)) == 0


def expire_mid_decode(eng, clock):
    """A ttl passing mid-decode under the virtual clock: place and run
    speculative bursts for 6 steps of 10 ms, then jump past the
    deadline. (An output of 5000 tokens, as in the JAX test, is never
    admitted at this pool size: it would expire in the queue.)"""
    req_cls, _ = core_classes(eng)
    h = eng.submit(req_cls(input_len=8, output_len=110, adapter_id=0),
                   ttl=10.0)
    for _ in range(6):
        step_once(eng, clock)
    clock.t = 1e9
    while eng.busy():
        step_once(eng, clock, dt=0.0)
    return h


def test_deadline_expiry_during_spec():
    (jeng, jclock), (eng, clock) = both()
    jh = expire_mid_decode(jeng, jclock)
    h = expire_mid_decode(eng, clock)
    assert h.state.name == "EXPIRED"
    assert h.tokens == jh.tokens
    assert h.req.generated == jh.req.generated > 1   # it decoded first
    eng.pool.check_invariants(free_page_ids=eng.free_pages)
    assert eng.pool.used_requests == 0
    assert int(np.sum(eng._draft_len)) == 0
    assert eng.spec_stats() == jeng.spec_stats()
