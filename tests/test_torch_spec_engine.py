"""Speculative decoding in the port's engine vs the JAX engine (CPU):
greedy parity, acceptance, page accounting, the draft-KV mirror and the
gauges of ``tests/test_spec_decode.py``.

Each contract runs the JAX engine and the port's on the same weights,
adapters, draft, trace and virtual clock (``tests/_port_serving.py``):
tokens and ``spec_stats()`` must be equal, and the port must keep the
contract itself (speculative greedy tokens equal to the port's own
non-speculative loop; the self-draft accepting everything; pages back
after every speculative block; the mirror freed). One JAX run of the
disagreeing draft per KV layout serves the contracts that share its
trace.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on one
# machine, and torch's default of one thread per core oversubscribes it.
torch.set_num_threads(1)
pytest.importorskip("jax")

from _port_serving import (serve_trace, spec_engines,  # noqa: E402
                           spec_trace)

SPEC_GAUGES = ("spec_accept_rate", "spec_drafted_tokens",
               "spec_accepted_tokens", "spec_draft_dispatches",
               "spec_verify_dispatches", "spec_dispatches", "spec_k_eff")


def run_pair(specs, paged, after_port_step=None, **kw):
    """Serve ``specs`` on both engines; returns (JAX tokens, JAX
    spec_stats, port engine, port tokens)."""
    (jeng, jclock), (eng, clock) = spec_engines(paged=paged, **kw)
    jh = serve_trace(jeng, jclock, specs)
    h = serve_trace(eng, clock, specs, after_step=after_port_step)
    return [x.tokens for x in jh], jeng.spec_stats(), eng, \
        [x.tokens for x in h]


def pages_balance(checks):
    """An ``after_step`` hook: pool invariants and the private/shared
    page arithmetic at every step boundary, through speculative
    grow/shrink cycles, appended to ``checks``."""
    def hook(eng):
        eng.pool.check_invariants(free_page_ids=eng.free_pages)
        shared = set(eng.pool.shared_page_ids())
        priv = sum(1 for plist in eng.slot_pages for p in plist
                   if p not in shared)
        checks.append(eng.pool.used_requests == priv * eng.pool.page_size
                      and len(eng.free_pages) + priv + len(shared)
                      == eng.n_pages - 1)
    return hook


@pytest.fixture(scope="module")
def disagreeing():
    """The disagreeing draft over ``spec_trace()`` on both engines, run
    once per KV layout on first use: {paged: readings}."""
    runs = {}

    def get(paged):
        if paged not in runs:
            checks = []
            jt, jstats, eng, toks = run_pair(
                spec_trace(), paged,
                after_port_step=pages_balance(checks) if paged else None)
            runs[paged] = dict(jtoks=jt, jstats=jstats, eng=eng, toks=toks,
                               stats=eng.stats(), page_checks=checks)
        return runs[paged]
    return get


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_greedy_token_parity_disagreeing_draft(disagreeing, paged):
    """Every round rejects early and rolls back; the tokens equal the
    JAX spec engine's and the port's own non-speculative loop's, and the
    gauges equal JAX's."""
    d = disagreeing(paged)
    assert d["toks"] == d["jtoks"]
    st = {g: d["stats"][g] for g in SPEC_GAUGES}
    assert st == d["jstats"]
    assert st["spec_drafted_tokens"] > 0 and st["spec_verify_dispatches"] > 0
    assert d["stats"]["completed"] == len(d["toks"])
    _, (ref, clock) = spec_engines(spec=False, draft=None, paged=paged)
    assert [h.tokens for h in serve_trace(ref, clock, spec_trace())] \
        == d["toks"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_greedy_full_acceptance_self_draft(paged):
    """The target drafts for itself over zero LoRA deltas: every
    proposal is accepted, tokens equal JAX's and the non-speculative
    loop's."""
    specs = spec_trace(n=4, seed=9)
    jt, jstats, eng, toks = run_pair(specs, paged, draft="self",
                                     catalog="zero")
    assert toks == jt
    st = eng.spec_stats()
    assert st == jstats
    assert st["spec_accept_rate"] == 1.0, st
    assert st["spec_accepted_tokens"] == st["spec_drafted_tokens"] > 0
    _, (ref, clock) = spec_engines(spec=False, draft=None, catalog="zero",
                                   paged=paged)
    assert [h.tokens for h in serve_trace(ref, clock, specs)] == toks


def test_page_accounting_holds_every_spec_step(disagreeing):
    d = disagreeing(True)
    assert d["page_checks"] and all(d["page_checks"])
    eng = d["eng"]
    assert eng.pool.used_requests == 0
    assert len(eng.free_pages) + eng.pool.n_shared_pages == eng.n_pages - 1


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_draft_kv_freed_on_finish(disagreeing, paged):
    """The draft-cache mirror is per-slot bookkeeping: every finished
    slot's ``_draft_len`` is back to 0."""
    eng = disagreeing(paged)["eng"]
    assert int(np.sum(eng._draft_len)) == 0, eng._draft_len


def test_gauges_emitted_and_reset(disagreeing):
    d = disagreeing(True)
    eng, st = d["eng"], d["stats"]
    for g in SPEC_GAUGES:
        assert g in st, f"{g} missing from stats()"
        assert st[g] == d["jstats"][g]
    assert 0.0 <= st["spec_accept_rate"] <= 1.0
    m = eng.metrics().sched_stats
    assert all(m[g] == st[g] for g in SPEC_GAUGES)
    eng.reset_stats()
    st2 = eng.spec_stats()
    assert st2["spec_drafted_tokens"] == 0
    assert st2["spec_draft_dispatches"] == 0
    assert st2["spec_k_eff"] == st["spec_k_eff"]   # the EWMA stays warm
