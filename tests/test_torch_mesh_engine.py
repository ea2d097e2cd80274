"""The port's mesh-sharded serving data plane on the CPU.

Counterparts of ``tests/test_sharded_engine.py``, case for case. A mesh
engine (``EngineConfig.mesh_shape``) places weights and the LoRA B
halves over "model", KV pages (or slab rows) and batch state over
"data", and computes one "model" column per shard, gathering at the
exact-reductions points; it must emit exactly the tokens of the
``mesh_shape=None`` engine. The reference's own mesh engine fails on
this tree (pinned below), so the oracle is its contract: every mesh
engine's tokens equal the port's ``mesh_shape=None`` engine's and the
JAX ``mesh_shape=None`` engine's, in f32, paged and dense, fused and
seed loop, greedy and seeded rows, with the prefix cache and its
refcounts. Tolerance: none — tokens are compared for equality.

The CPU hosts a mesh's positions as JAX's CPU does: the tests set
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, which the port
reads at call time (every position is the ``cpu`` device). The JAX
engines run on a virtual clock with their adapter loads landed before
each step (``land_jax_loads``), so both packages make the same
scheduling decisions.
"""
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on one
# machine, and torch's default of one thread per core oversubscribes it.
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
# JAX reads XLA_FLAGS once, when its backend starts: start it now, so
# the XLA_FLAGS these tests set for the port never reach JAX.
jax.devices()

from _port_serving import (ENGINE, StepClock, land_jax_loads,  # noqa: E402
                           models)

MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
FORCE4 = "--xla_force_host_platform_device_count=4"
DT = 0.01


@pytest.fixture(autouse=True)
def four_host_devices(monkeypatch):
    """Four CPU mesh positions for the port (JAX's devices are fixed at
    its start-up and stay as they are)."""
    monkeypatch.setenv("XLA_FLAGS", FORCE4)


def trace(n=8, seed=0, sample_every=3):
    """``test_sharded_engine.run_trace``'s mixed greedy/sampled trace:
    (input_len, output_len, adapter, sampling seed or None)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sp = i if sample_every and i % sample_every == 2 else None
        out.append((int(rng.integers(8, 40)), int(rng.integers(4, 12)),
                    int(rng.integers(0, 8)), sp))
    return out


def shared_prefix_prompts(n=8, prefix_len=40, n_prefixes=2, seed=11,
                          vocab=256):
    rng = np.random.default_rng(seed)
    pres = [rng.integers(3, vocab, size=prefix_len).tolist()
            for _ in range(n_prefixes)]
    return [pres[i % n_prefixes]
            + rng.integers(3, vocab, size=int(rng.integers(4, 13))).tolist()
            for i in range(n)]


def drain(eng, clock, jax_engine=False, max_steps=20_000):
    steps = 0
    while eng.busy() and steps < max_steps:
        if jax_engine:
            land_jax_loads(eng)
        eng.step()
        if not jax_engine:
            eng.pool.check_invariants(
                free_page_ids=getattr(eng, "free_pages", None))
        clock.t += DT
        steps += 1
    assert not eng.busy(), "engine failed to drain"


def submit_trace(eng, jax_engine, items, prompts=None):
    if jax_engine:
        from repro.core import Request, SamplingParams
    else:
        from repro_torch.core import Request, SamplingParams
    handles = []
    for i, (L, out, a, seed) in enumerate(items):
        kw = {} if prompts is None else dict(prompt=list(prompts[i]))
        sp = (SamplingParams(temperature=0.8, top_k=8, seed=seed)
              if seed is not None else None)
        handles.append(eng.submit(Request(input_len=L, output_len=out,
                                          adapter_id=a, **kw), sampling=sp))
    return handles


def port_engine(mesh_shape, clock=None, **kw):
    from repro_torch.serving.engine import ChameleonEngine, EngineConfig
    m = models()
    return ChameleonEngine(m["cfg"], m["params"],
                           EngineConfig(**{**ENGINE, **kw,
                                           "mesh_shape": mesh_shape}),
                           catalog=m["cat"], clock=clock, device="cpu")


#: name: (EngineConfig knobs, trace: "mixed" or "prefix")
CASES = {
    "fused_paged": (dict(paged=True, fused_hotloop=True), "mixed"),
    "fused_dense": (dict(paged=False, fused_hotloop=True), "mixed"),
    "unfused": (dict(paged=True, fused_hotloop=False), "mixed"),
    "prefix": (dict(paged=True, fused_hotloop=True, prefix_cache=True),
               "prefix"),
    "no_prefix": (dict(paged=True, prefix_cache=False), "mixed"),
}


def _items(kind):
    if kind == "mixed":
        return trace(), None
    prompts = shared_prefix_prompts(n=8)
    return ([(len(p), 8, i % 2, None) for i, p in enumerate(prompts)],
            prompts)


@functools.lru_cache(maxsize=None)
def jax_tokens(case):
    """The JAX engine at ``mesh_shape=None`` on the case's trace."""
    from repro.serving import engine as jengine
    m = models()
    knobs, kind = CASES[case]
    clock = StepClock()
    eng = jengine.ChameleonEngine(m["jcfg"], m["jparams"],
                                  jengine.EngineConfig(**ENGINE, **knobs),
                                  catalog=m["jcat"], clock=clock)
    items, prompts = _items(kind)
    hs = submit_trace(eng, True, items, prompts)
    drain(eng, clock, jax_engine=True)
    return [h.tokens for h in hs]


@functools.lru_cache(maxsize=None)
def port_run(case, mesh_shape, lora_backend="einsum"):
    """(tokens, engine) of the port at ``mesh_shape`` on the case."""
    knobs, kind = CASES[case]
    clock = StepClock()
    eng = port_engine(mesh_shape, clock, lora_backend=lora_backend, **knobs)
    items, prompts = _items(kind)
    hs = submit_trace(eng, False, items, prompts)
    drain(eng, clock)
    return [h.tokens for h in hs], eng


def assert_parity(case, mesh_shape):
    got, _ = port_run(case, mesh_shape)
    base, _ = port_run(case, None)
    assert got == base, "mesh sharding changed decoded tokens"
    assert got == jax_tokens(case), "tokens differ from the JAX engine"


# --------------------------------------------------------- token parity
class TestShardedParity:
    @pytest.mark.parametrize("mesh_shape", MESHES)
    @pytest.mark.parametrize("paged", (False, True))
    def test_token_parity_fused(self, paged, mesh_shape):
        """mesh == no-mesh (port and JAX), token for token, both KV
        layouts, fused hot loop, mixed greedy/sampled traffic."""
        assert_parity("fused_paged" if paged else "fused_dense", mesh_shape)

    @pytest.mark.parametrize("mesh_shape", MESHES)
    def test_token_parity_unfused(self, mesh_shape):
        """The seed loop (decode + host sample) holds parity too."""
        assert_parity("unfused", mesh_shape)

    @pytest.mark.parametrize("mesh_shape", MESHES)
    def test_prefix_cache_parity_and_refcounts(self, mesh_shape):
        """Prefix cache on a sharded pool: parity, pages actually
        shared, every refcount back to the tree's own after drain."""
        assert_parity("prefix", mesh_shape)
        _, eng = port_run("prefix", mesh_shape)
        assert eng.prefix_hit_tokens > 0, "no pages were reused"
        assert eng.n_cow_forks > 0
        shared = eng.pool.shared_page_ids()
        assert shared, "prefix tree retained no pages"
        assert all(eng.pool.shared_refcount(p) == 1 for p in shared)
        eng.pool.check_invariants(free_page_ids=eng.free_pages)

    @pytest.mark.parametrize("mesh_shape", MESHES[1:])
    def test_whole_prompt_prefill_parity(self, mesh_shape):
        """``prefix_cache=False``: the dense prefill's per-column K/V
        copied into the paged shards."""
        assert_parity("no_prefix", mesh_shape)

    @pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
    @pytest.mark.parametrize("case", ["fused_paged", "fused_dense"])
    def test_kernel_lora_parity(self, case, mesh_shape):
        """``lora_backend="kernel"``: bgmv and sgmv (their plain
        versions on CPU tensors) at each column's dout. (The kernels
        round the rank-r product to the bf16 slots' dtype, as Pallas
        bgmv does, so the einsum engines are not their oracle.)"""
        got, _ = port_run(case, mesh_shape, "kernel")
        assert got == port_run(case, None, "kernel")[0]

    @pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)])
    def test_pages_on_every_data_shard(self, mesh_shape):
        """Long prompts fill pages on both data shards: writes through
        each shard's sink, reads gathered across shards."""
        def run(shape):
            clock = StepClock()
            eng = port_engine(shape, clock, max_slots=8, max_len=256)
            rng = np.random.default_rng(5)
            items = [(int(rng.integers(200, 240)), 12, i % 8,
                      i if i % 4 == 3 else None) for i in range(16)]
            hs = submit_trace(eng, False, items)
            peak = None
            while eng.busy():
                eng.step()
                clock.t += DT
                if shape is not None:
                    used = eng.shard_stats()["per_shard_pages_used"]
                    peak = used if peak is None else list(
                        map(max, peak, used))
            return [h.tokens for h in hs], peak
        got, peak = run(mesh_shape)
        assert all(p > 0 for p in peak), peak
        assert got == run(None)[0]

    @pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
    def test_chunked_prefill_parity(self, mesh_shape):
        """Chunked prefill's B=1 suffix passes on the mesh."""
        def run(shape):
            eng = port_engine(shape, StepClock(), prefill_chunk_tokens=8)
            hs = submit_trace(eng, False, trace())
            drain(eng, eng._clock)
            assert eng.n_chunked_prefills > 0
            return [h.tokens for h in hs]
        assert run(mesh_shape) == run(None)

    def test_spec_decode_warns_and_is_ignored(self):
        from _port_serving import draft_models
        from repro_torch.serving.engine import ChameleonEngine, EngineConfig
        m = models()
        _, draft = draft_models()
        with pytest.warns(RuntimeWarning, match="mesh"):
            eng = ChameleonEngine(m["cfg"], m["params"], EngineConfig(
                **ENGINE, mesh_shape=(1, 2), spec_decode=True),
                catalog=m["cat"], draft=draft, device="cpu")
        assert not eng.spec


# ------------------------------------------------------------ telemetry
class TestShardTelemetry:
    def test_no_mesh_no_shard_stats(self):
        eng = port_engine(None)
        assert eng.shard_stats() == {}
        assert "mesh_shape" not in eng.stats()

    @pytest.mark.parametrize("mesh_shape", MESHES[1:])
    def test_shard_stats_surface(self, mesh_shape):
        from repro_torch.kernels.ops import COLLECTIVE_METER
        COLLECTIVE_METER.reset()
        clock = StepClock()
        eng = port_engine(mesh_shape, clock, paged=True)
        submit_trace(eng, False, trace(n=4))
        drain(eng, clock)
        s = eng.shard_stats()
        d, m = mesh_shape
        assert tuple(s["mesh_shape"]) == mesh_shape
        assert s["n_devices"] == d * m
        assert len(s["per_shard_pages_used"]) == d
        assert s["per_shard_pages_total"] * d == eng.n_pages
        assert s["per_shard_lora_slot_bytes"] > 0
        if d * m > 1:
            assert s["collective_dispatches"] > 0
            assert s["collective_gathers"] > 0
            assert 0.0 <= s["collective_frac"] <= 1.0
        # Gauges flow into the metrics surface for cluster merging.
        assert eng.metrics().sched_stats["n_devices"] == d * m

    @pytest.mark.parametrize("mesh_shape", MESHES[1:])
    def test_pool_accounting_mesh_invariant(self, mesh_shape):
        """Global page/slot accounting must not depend on the mesh —
        only the per-shard view divides by the data-axis size."""
        a = port_engine(None, paged=True)
        b = port_engine(mesh_shape, paged=True)
        assert b.pool.snapshot()["capacity"] == \
            a.pool.snapshot()["capacity"]
        assert b.pool.n_shards == mesh_shape[0] * mesh_shape[1]
        assert b.n_pages % mesh_shape[0] == 0
        # Extra physical pages sit at the far end of the free list.
        assert b.free_pages[-(a.n_pages - 1):] == a.free_pages

    @pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
    def test_lora_arena_in_shard_layout(self, mesh_shape):
        """A whole on every position, B's dout split over "model": one
        device holds A plus B / model_size, and a load copies each
        device only its block of B."""
        eng = port_engine(mesh_shape)
        m = mesh_shape[1]
        want = 0
        for a, b in eng.lora.values():
            assert a.local((0, 0)).shape == a.shape
            assert b.local((0, 0)).shape[-1] * m == b.shape[-1]
            want += (a.local((0, 0)).nbytes + b.local((0, 0)).nbytes)
        assert eng.shard_stats()["per_shard_lora_slot_bytes"] == want
        eng.cache.acquire(3, 0.0)
        slot = eng.slot_of[3]
        for proj, (a, b) in eng.lora.items():
            host_a, host_b = models()["cat"].weights[3][proj]
            assert torch.equal(a.full()[:, slot], host_a)
            assert torch.equal(b.full()[:, slot], host_b)
            w = b.shape[-1] // m
            assert torch.equal(b.local((0, m - 1))[:, slot],
                               host_b[..., (m - 1) * w:])


# ------------------------------------------------------ cluster / systems
class TestClusterAndSystems:
    def test_cluster_rejects_overcommitted_devices(self, monkeypatch):
        from repro_torch.serving.cluster import (EngineCluster,
                                                 EngineClusterConfig)
        from repro_torch.serving.engine import EngineConfig
        monkeypatch.delenv("XLA_FLAGS")
        m = models()
        with pytest.raises(ValueError, match="devices"):
            EngineCluster(m["cfg"], m["params"],
                          ecfg=EngineConfig(**ENGINE, mesh_shape=(2, 1)),
                          ccfg=EngineClusterConfig(n_engines=1),
                          device="cpu")

    def test_cluster_of_sharded_engines(self):
        from repro_torch.serving.cluster import (EngineCluster,
                                                 EngineClusterConfig)
        from repro_torch.serving.engine import EngineConfig
        m = models()
        cluster = EngineCluster(m["cfg"], m["params"],
                                ecfg=EngineConfig(**ENGINE,
                                                  mesh_shape=(1, 2)),
                                ccfg=EngineClusterConfig(n_engines=1),
                                device="cpu")
        eng = cluster.engines[0]
        assert eng.mesh is not None and eng.mesh.size == 2

    def test_build_system_threads_mesh_shape(self):
        from repro_torch.serving.engine import EngineConfig
        from repro_torch.serving.systems import build_system
        m = models()
        eng = build_system("chameleon", "engine", model_cfg=m["cfg"],
                           params=m["params"], ecfg=EngineConfig(**ENGINE),
                           mesh_shape=(1, 2), device="cpu")
        assert dict(eng.mesh.shape) == {"data": 1, "model": 2}

    def test_build_system_rejects_mesh_on_sim_tier(self):
        from repro_torch.serving.systems import build_system
        with pytest.raises(ValueError, match="mesh"):
            build_system("chameleon", "sim", mesh_shape=(1, 2))

    def test_disagg_tier_on_meshes_keeps_tokens(self):
        """``tier="disagg"`` with every replica on a (1, 2) mesh: KV
        shipped between sharded engines, tokens of the unsharded
        tier."""
        from repro_torch.core import Request
        from repro_torch.serving.engine import EngineConfig
        from repro_torch.serving.systems import build_system
        m = models()

        def run(shape):
            sys_ = build_system("chameleon", "disagg", n_nodes=2,
                                model_cfg=m["cfg"], params=m["params"],
                                ecfg=EngineConfig(**ENGINE),
                                mesh_shape=shape, device="cpu")
            hs = [sys_.submit(Request(input_len=L, output_len=out,
                                      adapter_id=a))
                  for L, out, a, _ in trace()]
            sys_.drain()
            return [h.tokens for h in hs], sys_.stats()
        got, st = run((1, 2))
        base, _ = run(None)
        assert got == base
        assert st["handoff"]["handoffs"] > 0
        assert all(e["n_devices"] == 2 for e in st["per_engine"])

    def test_mesh_larger_than_the_host_raises(self, monkeypatch):
        """No fallback to ``mesh_shape=None`` or a smaller mesh."""
        monkeypatch.delenv("XLA_FLAGS")
        with pytest.raises(ValueError, match="XLA_FLAGS"):
            port_engine((2, 2))


# ---------------------------------------------------------- not served
def test_moe_on_a_mesh_raises_naming_the_missing_piece():
    """What stays refused on a mesh: MoE with ``spec_decode`` (no MoE
    verify pass, on a mesh or off it), the message naming the missing
    piece. A config whose ``d_ff`` or ``n_heads`` does not divide the
    "model" axis is served, its MLP or its attention whole on the first
    column, with the ``mesh_shape=None`` engine's tokens."""
    import dataclasses

    from _port_whole_heads import engine_tokens
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import ChameleonEngine, EngineConfig
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    params = lm.init_params(cfg, 0, torch.float32, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="spec_decode=True on model family MOE"):
        ChameleonEngine(cfg, params, EngineConfig(n_adapters=2,
                                                  mesh_shape=(1, 2),
                                                  spec_decode=True),
                        draft=(cfg, params), device="cpu")
    base = get_config("chameleon-llama-7b").reduced()
    for over in (dict(d_ff=250), dict(n_heads=6, n_kv_heads=2)):
        odd = dataclasses.replace(base, **over)
        odd_params = lm.init_params(odd, 0, torch.float32, device="cpu")
        assert engine_tokens(odd, odd_params, (1, 4)) == \
            engine_tokens(odd, odd_params, None)


def test_reference_mesh_engine_fails_at_its_first_prefill():
    """The JAX engine at ``mesh_shape=(1, 1)`` builds, then its first
    prefill raises ``ShardingTypeError`` in ``layers.embed``
    (``src/repro/models/layers.py``): the row gather of the
    vocab-sharded ``embed/tok`` table needs an ``out_sharding`` under
    jax 0.9. So the port's mesh engines are held to the
    ``mesh_shape=None`` engines instead."""
    import traceback

    from repro.core import Request
    from repro.serving import engine as jengine
    m = models()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = jengine.ChameleonEngine(
            m["jcfg"], m["jparams"],
            jengine.EngineConfig(**ENGINE, mesh_shape=(1, 1)),
            catalog=m["jcat"], clock=StepClock())
    eng.submit(Request(input_len=12, output_len=4, adapter_id=0))
    with pytest.raises(Exception) as info:
        for _ in range(50):
            land_jax_loads(eng)
            eng.step()
    assert type(info.value).__name__ == "ShardingTypeError"
    frames = traceback.extract_tb(info.value.__traceback__)
    assert any(f.name == "embed" and f.filename.endswith(
        "repro/models/layers.py") for f in frames)
