"""Chunked prefill (``EngineConfig.prefill_chunk_tokens > 0``) in the
port's engine against the JAX engine, on the CPU.

Both engines serve the same weights (the JAX package's, bridged), the
spec of ``tests/test_disagg.py``'s chunked-prefill test plus one
seeded-sampled request, under a virtual clock both advance by the same
step. Tokens (sampled ones too) and the whole ``stats()`` summary must
be equal at chunk sizes 4, 8 and 32; the pool invariants must hold
after every step of the port. Mid-chunk cancel and expiry must free the
slot for reuse, and a prompt prefilled chunk by chunk beside two
decoding rows must end with the pages a monolithic prefill writes
(within 1e-5, f32): decode writes every row's K/V, so a chunked row's
pages must stay unmapped until it activates.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on one
# machine, and torch's default of one thread per core oversubscribes it.
torch.set_num_threads(1)
pytest.importorskip("jax")

from _port_serving import (ENGINE, StepClock, check_pools,  # noqa: E402
                           land_jax_loads, models, page_kv, prompt)
from repro.core import Request as JRequest  # noqa: E402
from repro.core import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.core import Request, RequestState  # noqa: E402
from repro_torch.core import SamplingParams  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

#: (input_len, output_len, adapter) as in tests/test_disagg.py, plus a
#: seeded-sampled request (the last).
SPEC = [(25, 8, 0), (6, 5, 1), (40, 6, 2), (10, 4, 0), (33, 7, 3),
        (30, 6, 5)]
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9, seed=7)
CHUNKS = (4, 8, 32)
KV_TOL = 1e-5


def serve(eng, request_cls, sampling_cls, clock, before_step=None,
          check=False):
    rng = np.random.default_rng(11)
    hs = [eng.submit(request_cls(input_len=L, output_len=O, adapter_id=a,
                                 prompt=prompt(rng, L)),
                     sampling=(sampling_cls(**SAMPLED)
                               if i == len(SPEC) - 1 else None))
          for i, (L, O, a) in enumerate(SPEC)]
    for _ in range(5000):
        if not eng.busy():
            break
        if before_step is not None:
            before_step(eng)
        eng.step()
        if check:
            check_pools(eng)
        clock.t += 0.01
    assert not eng.busy(), "engine failed to drain"
    return [h.tokens for h in hs], eng.stats()


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's tokens and stats at each chunk size."""
    m = models()
    out = {}
    for chunk in CHUNKS:
        clock = StepClock()
        eng = jengine.ChameleonEngine(
            m["jcfg"], m["jparams"],
            jengine.EngineConfig(**ENGINE, prefill_chunk_tokens=chunk),
            catalog=m["jcat"], clock=clock)
        out[chunk] = serve(eng, JRequest, JSamplingParams, clock,
                           before_step=land_jax_loads)
    return out


def port_engine(clock=None, **kw):
    m = models()
    return engine.ChameleonEngine(
        m["cfg"], m["params"], engine.EngineConfig(**{**ENGINE, **kw}),
        catalog=m["cat"], clock=clock or StepClock(), device="cpu")


@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_engine_matches_jax_engine(jax_runs, chunk):
    clock = StepClock()
    toks, stats = serve(port_engine(clock, prefill_chunk_tokens=chunk),
                        Request, SamplingParams, clock, check=True)
    jtoks, jstats = jax_runs[chunk]
    assert [len(t) for t in toks] == [o for _, o, _ in SPEC]
    assert toks == jtoks
    assert stats == jstats
    assert stats["chunked_prefills"] == sum(L > chunk for L, _, _ in SPEC)


def test_chunk_8_equals_chunk_0():
    runs = {}
    for chunk in (0, 8):
        clock = StepClock()
        runs[chunk] = serve(port_engine(clock, prefill_chunk_tokens=chunk),
                            Request, SamplingParams, clock)
    assert runs[8][0] == runs[0][0]
    assert runs[8][1]["chunked_prefills"] > 0
    assert "chunked_prefills" not in runs[0][1]


@pytest.mark.parametrize("end", ["cancel", "expire"])
def test_mid_chunk_end_frees_the_slot(end):
    """One batch slot: the request that follows can only run in the slot
    the mid-chunk request held."""
    clock = StepClock()
    eng = port_engine(clock, prefill_chunk_tokens=4, max_slots=1)
    req = Request(input_len=60, output_len=8, adapter_id=0)
    h = eng.submit(req, ttl=1.0 if end == "expire" else None)
    for _ in range(200):
        eng.step()
        clock.t += 0.01
        if eng._chunked:
            break
    assert eng._chunked and eng._chunked[0]["done"] < req.input_len
    if end == "cancel":
        assert h.cancel()
    else:
        clock.t += 1.0
    eng.step()
    want = (RequestState.CANCELLED if end == "cancel"
            else RequestState.EXPIRED)
    assert req.state is want
    assert not eng._chunked and eng.slot_req == [None]
    check_pools(eng)
    assert eng.pool.used_requests == 0
    h2 = eng.submit(Request(input_len=8, output_len=3, adapter_id=1))
    for _ in range(200):
        if not eng.busy():
            break
        eng.step()
        clock.t += 0.01
    assert h2.done and len(h2.tokens) == 3
    check_pools(eng)


def test_chunked_prompt_beside_decoding_rows_keeps_its_pages():
    """Two rows decode (fused horizons) while a 40-token prompt prefills
    in chunks of 4; when it activates, its prompt K/V equal a monolithic
    prefill's, and its tokens equal the monolithic run's."""
    rng = np.random.default_rng(3)
    decoding = [prompt(rng, 12), prompt(rng, 9)]
    long = prompt(rng, 40)
    got = {}
    for chunk in (0, 4):
        clock = StepClock()
        eng = port_engine(clock, prefill_chunk_tokens=chunk,
                          prefix_cache=False)
        hs = [eng.submit(Request(input_len=len(p), output_len=40,
                                 adapter_id=i, prompt=p))
              for i, p in enumerate(decoding)]
        for _ in range(50):
            eng.step()
            clock.t += 0.01
            if all(len(h.tokens) >= 2 for h in hs):
                break
        req = Request(input_len=40, output_len=6, adapter_id=2, prompt=long)
        h = eng.submit(req)
        n_chunk_steps = 0
        while req.generated == 0:
            eng.step()
            clock.t += 0.01
            n_chunk_steps += bool(eng._chunked)
        assert sum(r is not None and r.generated >= 1
                   for r in eng.slot_req) == 3
        if chunk:
            # The decoding rows stepped while the prompt was chunked.
            assert n_chunk_steps >= 40 // chunk - 1
        kv = page_kv(eng, eng.slot_req.index(req), 40)
        while eng.busy():
            eng.step()
            clock.t += 0.01
        check_pools(eng)
        got[chunk] = (kv, h.tokens, [x.tokens for x in hs])
    for a, b in zip(got[4][0], got[0][0]):
        np.testing.assert_allclose(a, b, rtol=0, atol=KV_TOL)
    assert got[4][1] == got[0][1]
    assert got[4][2] == got[0][2]
