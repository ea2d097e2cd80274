"""The MoE family and few-KV-head configs on a device mesh, on the CPU.

The port's mesh data plane (one process drives every position) with
the MoE experts over "data" (each data shard runs its own experts and
the outputs are gathered in the unsharded expert order before the
combine) and with KV heads that do not divide the "model" axis (each
column reads the KV head its query heads read, stored whole in the
pages or split along the slab's positions).

- ``moe_block``/``moe_block_gather`` given per-data-shard expert blocks
  (placed through the rule table at (2, 1) and (4, 1)) equal the
  unsharded port bit for bit and JAX's blocks within 1e-5 (f32).
- ``moe_block_a2a`` at 1, 2 and 4 shards mirrors
  ``tests/test_moe_a2a.py``: within 1e-5 of JAX ``moe_block`` at cf 8.0
  and of ``moe_block_gather`` at cf E/K for S = 1; with drops (cf
  1.25), JAX ``moe_block`` on each batch shard, concatenated, aux the
  shards' mean; at one shard also JAX's own ``moe_block_a2a`` on its
  one-device mesh.
- The MoE engine (reduced qwen3-moe and llama4) at (1, 1), (2, 1),
  (1, 2) and (2, 2), fused and seed, greedy and seeded: tokens and
  capacity drops equal the ``mesh_shape=None`` engine's on one step
  clock (the JAX mesh engine fails at its first prefill, pinned in
  ``tests/test_torch_mesh_engine.py``, so it cannot be the oracle).
- Reduced granite-34b (MQA) at (1, 2), (1, 4) and (2, 2) and reduced
  Llama at (1, 4), paged and dense: tokens equal the unsharded
  engine's, and the placed KV specs equal JAX's ``kv_pages_spec`` /
  ``kv_cache_spec``. On positions that are distinct tensors, every
  replica of a KV block holds the same values.
- The rule table: ``ShardPlan`` for the MoE leaves equals JAX's
  ``param_shardings(kind="decode")``.
Tolerances: none for tokens, drops, specs and the sharded-vs-unsharded
port; 1e-5 against JAX in f32.
"""
import dataclasses
import functools

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
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from _port_serving import (ENGINE, StepClock, models,  # noqa: E402
                           spec_trace, step_once)
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.moe_shard_map import moe_block_a2a as jmoe_a2a  # noqa: E402
from repro_torch.distributed import act_sharding as acts  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.moe_shard_map import moe_block_a2a  # noqa: E402
from repro_torch.serving import engine  # noqa: E402
from repro_torch.serving.shard_plan import ShardPlan  # noqa: E402

FORCE4 = "--xla_force_host_platform_device_count=4"
MOE_CONFIGS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]
P = tsh.PartitionSpec


@pytest.fixture(autouse=True)
def four_host_devices(monkeypatch):
    """Four CPU mesh positions for the port (JAX's devices are fixed at
    its start-up and stay as they are)."""
    monkeypatch.setenv("XLA_FLAGS", FORCE4)


def cpu_mesh(d, m, distinct=False):
    """The port's ("data", "model") mesh of d*m CPU positions; with
    ``distinct`` each position is its own device index, so blocks that
    several positions hold are separate tensors."""
    devs = np.empty(d * m, dtype=object)
    devs[:] = [torch.device("cpu", i) if distinct else torch.device("cpu")
               for i in range(d * m)]
    return Mesh(devs.reshape(d, m), ("data", "model"))


def jax_mesh(d, m):
    devs = np.asarray(jax.devices()[:1] * (d * m)).reshape(d, m)
    return JMesh(devs, ("data", "model"))


@functools.lru_cache(maxsize=None)
def operands(B=4, S=64, D=32, E=8, F=16, seed=0):
    """x (B, S, D), router (D, E), w_gate/w_up (E, D, F), w_down (E, F,
    D), f32, from a numpy seed (``tests/test_moe_a2a.py``'s shapes)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, D)).astype(np.float32),
            (rng.standard_normal((D, E)) * 0.1).astype(np.float32),
            (rng.standard_normal((E, D, F)) * 0.1).astype(np.float32),
            (rng.standard_normal((E, D, F)) * 0.1).astype(np.float32),
            (rng.standard_normal((E, F, D)) * 0.1).astype(np.float32))


def T(a):
    return torch.from_numpy(np.asarray(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def expert_blocks(wg, wu, wd, rw, d):
    """The expert stacks placed at (d, 1) through the serving rule table
    (one MoE layer), as ``MeshParams.experts`` sees them."""
    cfg = dataclasses.replace(models("qwen3-moe-235b-a22b")["cfg"],
                              n_experts=wg.shape[0])
    mesh = cpu_mesh(d, 1)
    params = {"moe/w_gate": T(wg)[None], "moe/w_up": T(wu)[None],
              "moe/w_down": T(wd)[None], "moe/router": T(rw)[None]}
    sh = tsh.param_shardings(cfg, params, mesh, "decode")
    assert sh["moe/w_gate"].spec == P(None, "data")
    placed = {k: sh[k].shard(v) for k, v in params.items()}
    blocks = tsh.expert_shards(placed)
    assert [(b["lo"], b["hi"]) for b in blocks] == [
        (i * wg.shape[0] // d, (i + 1) * wg.shape[0] // d)
        for i in range(d)]
    return mesh, [[b[leaf][0] for b in blocks]
                  for leaf in ("w_gate", "w_up", "w_down")]


# ------------------------------------------------------- sharded blocks
@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("kind", ["buckets", "gather"])
def test_sharded_blocks_equal_unsharded_and_jax(kind, d):
    x, rw, wg, wu, wd = operands()
    if kind == "gather":
        x = x[:, :1]
    mesh, blocks = expert_blocks(wg, wu, wd, rw, d)
    port = moe.moe_block if kind == "buckets" else moe.moe_block_gather
    ref = jmoe.moe_block if kind == "buckets" else jmoe.moe_block_gather
    want, want_aux = port(T(x), T(rw), T(wg), T(wu), T(wd), 2)
    moe.STATS.reset()
    with acts.activation_sharding((), mesh=mesh, exact_reductions=True):
        got, aux = port(T(x), T(rw), *blocks, 2)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    # One call, one host read of the routing: counted once, not a shard.
    assert (moe.STATS.capacity_calls, moe.STATS.gather_calls) == (
        (1, 0) if kind == "buckets" else (0, 1))
    jy, _ = ref(*map(J, (x, rw, wg, wu, wd)), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------- all-to-all
@pytest.mark.parametrize("n", [1, 2, 4])
def test_a2a_matches_einsum_dispatch(n):
    x, rw, wg, wu, wd = operands()
    jy, _ = jmoe.moe_block(*map(J, (x, rw, wg, wu, wd)), top_k=2,
                           capacity_factor=8.0, group_size=64)
    mesh, blocks = expert_blocks(wg, wu, wd, rw, n)
    y, _ = moe_block_a2a(T(x), T(rw), *blocks, 2, 8.0, mesh, group_size=64)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_a2a_dropless_decode_matches_gather(n):
    x, rw, wg, wu, wd = operands()
    x1 = x[:, :1]
    jy, _ = jmoe.moe_block_gather(*map(J, (x1, rw, wg, wu, wd)), top_k=2)
    mesh, blocks = expert_blocks(wg, wu, wd, rw, n)
    y, _ = moe_block_a2a(T(x1), T(rw), *blocks, 2, 8 / 2, mesh,
                         group_size=64)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_a2a_with_drops_is_moe_block_per_batch_shard(n):
    """Group-local capacity: each shard buckets its own rows, so with
    drops the result is JAX ``moe_block`` on each batch shard; the aux
    loss is the shards' mean (``pmean``). Expert blocks as placed by
    the rule table."""
    x, rw, wg, wu, wd = operands(B=8, S=32)
    moe.STATS.reset()
    mesh, blocks = expert_blocks(wg, wu, wd, rw, n)
    y, aux = moe_block_a2a(T(x), T(rw), *blocks, 2, 1.25, mesh,
                           group_size=32)
    parts = [jmoe.moe_block(*map(J, (xs, rw, wg, wu, wd)), top_k=2,
                            capacity_factor=1.25, group_size=32)
             for xs in np.split(x, n)]
    np.testing.assert_allclose(
        y.numpy(), np.concatenate([np.asarray(p[0]) for p in parts]),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux),
                               np.mean([float(p[1]) for p in parts]),
                               rtol=1e-5)
    assert moe.STATS.capacity_calls == 1 and moe.STATS.dropped > 0


def test_a2a_one_shard_matches_jax_a2a():
    x, rw, wg, wu, wd = operands()
    jm = jax.make_mesh((1, 1), ("data", "model"))
    with jm:
        jy, jaux = jax.jit(lambda *a: jmoe_a2a(
            *a, top_k=2, capacity_factor=1.25, mesh=jm,
            group_size=64))(*map(J, (x, rw, wg, wu, wd)))
    mesh, blocks = expert_blocks(wg, wu, wd, rw, 1)
    y, aux = moe_block_a2a(T(x), T(rw), *blocks, 2, 1.25, mesh,
                           group_size=64)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_a2a_needs_experts_and_rows_to_divide():
    x, rw, wg, wu, wd = operands(B=3)
    with pytest.raises(ValueError, match="divisible"):
        moe_block_a2a(T(x), T(rw), *expert_blocks(wg, wu, wd, rw, 2)[1], 2,
                      1.25, cpu_mesh(2, 1))


@pytest.mark.parametrize("d", [2, 4])
def test_token_parallel_decode_step_runs_the_a2a(d):
    """``moe_token_parallel=True`` arms ``moe_a2a_mesh``: the MoE decode
    step on a (d, 1) mesh runs ``moe_block_a2a`` (dropless at cf E/K)
    and gives the unsharded decode step's logits within 1e-5."""
    from repro_torch.models import api
    m = models("qwen3-moe-235b-a22b")
    cfg = m["cfg"]
    rng = np.random.default_rng(3)
    B, L = 4, 10
    kv = api.init_serve_state(cfg, B, 32, torch.float32, device="cpu")
    toks = T(rng.integers(3, cfg.vocab_size, (B, L)).astype(np.int64))
    _, (k, v) = api.prefill(cfg, m["params"], toks)
    kv[0][:, :, :L], kv[1][:, :, :L] = k, v
    nxt = T(rng.integers(3, cfg.vocab_size, (B, 1)).astype(np.int64))
    clen = torch.full((B,), L, dtype=torch.int32)
    want, _ = api.decode_step(cfg, m["params"], nxt,
                              tuple(t.clone() for t in kv), clen)
    mesh = cpu_mesh(d, 1)
    plan = ShardPlan(mesh, cfg)
    sh = plan.params(m["params"])
    mp = tsh.MeshParams(cfg, {p: sh[p].shard(t) for p, t in
                              m["params"].items()}, mesh)
    skv = tuple(plan.zeros_kv_dense(tuple(t.shape), t.dtype).copy_(t)
                for t in kv)
    moe.STATS.reset()
    with acts.activation_sharding((), mesh=mesh, exact_reductions=True,
                                  moe_token_parallel=True):
        assert acts.moe_a2a_mesh() == (mesh, "data")
        got, _ = api.decode_step(cfg, mp, nxt, skv, clen)
    assert acts.moe_a2a_mesh() is None
    assert moe.STATS.gather_calls == 0
    assert moe.STATS.capacity_calls == cfg.n_layers
    assert moe.STATS.dropped == 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------- the engine
TRACE = spec_trace(n=8, seed=4)


def serve(name, mesh_shape, fused, mixed, distinct=False, **knobs):
    """Tokens and capacity drops of the port's engine on ``TRACE``
    (every second request seeded when ``mixed``), on a step clock."""
    from repro_torch.core import Request, SamplingParams
    m = models(name)
    clock = StepClock()
    make = engine.make_serving_mesh
    if distinct:
        engine.make_serving_mesh = lambda n, mp, device=None: cpu_mesh(
            n // mp, mp, distinct=True)
    try:
        eng = engine.ChameleonEngine(
            m["cfg"], m["params"],
            engine.EngineConfig(**{**ENGINE, **knobs,
                                   "fused_hotloop": fused,
                                   "mesh_shape": mesh_shape}),
            catalog=m["cat"], clock=clock, device="cpu")
    finally:
        engine.make_serving_mesh = make
    moe.STATS.reset()
    hs = [eng.submit(Request(input_len=i, output_len=o, adapter_id=a),
                     sampling=(SamplingParams(temperature=0.8, top_k=20,
                                              seed=50 + n)
                               if mixed and n % 2 else None))
          for n, (i, o, a) in enumerate(TRACE)]
    for _ in range(5000):
        if not eng.busy():
            break
        step_once(eng, clock)
    assert not eng.busy(), "engine failed to drain"
    return [h.tokens for h in hs], moe.STATS.dropped, eng


@functools.lru_cache(maxsize=None)
def unsharded(name, fused, mixed, **knobs):
    toks, dropped, _ = serve(name, None, fused, mixed, **knobs)
    return toks, dropped


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("fused,mixed", [(True, False), (False, False),
                                         (True, True), (False, True)])
@pytest.mark.parametrize("name", MOE_CONFIGS)
def test_moe_engine_on_a_mesh_equals_unsharded(name, fused, mixed,
                                               mesh_shape):
    toks, dropped, eng = serve(name, mesh_shape, fused, mixed)
    assert (toks, dropped) == unsharded(name, fused, mixed)
    assert dropped > 0, "the trace should drop over capacity"
    assert eng.kv is not None and eng.kv_pages is None
    d, m = mesh_shape
    s = eng.shard_stats()
    assert s["mesh_shape"] == [d, m] and s["n_devices"] == d * m
    # Every data shard holds its block of experts, and the columns
    # never read an expert stack.
    E = eng.cfg.n_experts
    assert [(b["lo"], b["hi"]) for b in eng.params.experts] == [
        (i * E // d, (i + 1) * E // d) for i in range(d)]
    assert not any(k.startswith("moe/w_") for c in eng.params.cols
                   for k in c)


@pytest.mark.parametrize("name", MOE_CONFIGS)
def test_moe_engine_on_distinct_positions(name):
    """(2, 2) with every position its own tensor: shards and replicas
    are separate tensors, and the tokens still equal the unsharded
    engine's."""
    toks, dropped, eng = serve(name, (2, 2), True, True, distinct=True)
    assert (toks, dropped) == unsharded(name, True, True)
    for st in eng.kv:
        assert len(st.unique()) == 4


# ------------------------------------------------------ few KV heads
UNEVEN = [("granite-34b", (1, 2)), ("granite-34b", (1, 4)),
          ("granite-34b", (2, 2)), ("chameleon-llama-7b", (1, 4))]


def _jax_kv_spec(kind, mesh_shape, shape):
    jm = jax_mesh(*mesh_shape)
    f = jsh.kv_pages_spec if kind == "pages" else jsh.kv_cache_spec
    return tuple(f(jm, shape))


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("name,mesh_shape", UNEVEN)
def test_uneven_kv_heads_equal_unsharded(name, mesh_shape, paged):
    toks, _, eng = serve(name, mesh_shape, True, True, paged=paged)
    assert toks == unsharded(name, True, True, paged=paged)[0]
    st = (eng.kv_pages if paged else eng.kv)[0]
    kind = "pages" if paged else "slab"
    assert tuple(st.sharding.spec) == _jax_kv_spec(kind, mesh_shape,
                                                   st.shape)
    Kh, M = eng.cfg.n_kv_heads, mesh_shape[1]
    assert Kh % M, "the case should not split its KV heads evenly"
    mp = eng.params
    assert mp.col_cfg.n_kv_heads == 1
    assert mp.kv_heads == [(m // (M // Kh), m // (M // Kh) + 1)
                           for m in range(M)]


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("name,mesh_shape", [("granite-34b", (1, 2)),
                                             ("chameleon-llama-7b",
                                              (1, 4))])
def test_kv_replicas_agree_on_distinct_positions(name, mesh_shape, paged):
    """Every position its own tensor: columns that share a KV head
    write every replica of it, so every shard that holds a block holds
    the same values; tokens equal the unsharded engine's."""
    toks, _, eng = serve(name, mesh_shape, True, False, distinct=True,
                         paged=paged)
    assert toks == unsharded(name, True, False, paged=paged)[0]
    for st in (eng.kv_pages if paged else eng.kv):
        blocks: dict = {}
        for slc, t in st.unique():
            key = tuple((s.start, s.stop) for s in slc)
            if key in blocks:
                assert torch.equal(blocks[key], t)
            blocks.setdefault(key, t)
        assert len(st.unique()) == mesh_shape[0] * mesh_shape[1]


def test_kv_heads_of_column_and_the_refusals():
    assert [tsh.kv_heads_of_column(8, 4, m) for m in range(4)] == [
        (0, 2), (2, 4), (4, 6), (6, 8)]
    assert [tsh.kv_heads_of_column(1, 4, m) for m in range(4)] == [
        (0, 1)] * 4
    assert [tsh.kv_heads_of_column(2, 4, m) for m in range(4)] == [
        (0, 1), (0, 1), (1, 2), (1, 2)]
    cfg = models()["cfg"]
    assert tsh.mesh_unsupported(cfg, 4) == []
    odd = dataclasses.replace(cfg, n_heads=12, n_kv_heads=3)
    assert tsh.mesh_unsupported(odd, 2) == [
        "n_kv_heads=3 on a 2-way model axis (a column's query heads "
        "would read parts of two KV groups)"]
    wide = dataclasses.replace(models("llama4-maverick-400b-a17b")["cfg"],
                               shared_expert_ff=66)
    assert any("shared_expert_ff=66" in w
               for w in tsh.mesh_unsupported(wide, 4))


# ------------------------------------------------------- the rule table
@pytest.mark.parametrize("mesh_shape", [(2, 1), (4, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("name", MOE_CONFIGS + ("granite-34b",))
def test_shard_plan_equals_jax_rule_table(name, mesh_shape):
    """``ShardPlan.params`` (every leaf, the MoE ones included) and the
    slab / page specs of the reduced configs equal JAX's
    ``param_shardings(kind="decode")``, ``kv_cache_spec`` and
    ``kv_pages_spec``."""
    from repro.models.base import param_shapes as jparam_shapes
    from repro.serving.shard_plan import ShardPlan as JShardPlan
    m = models(name)
    cfg = m["cfg"]
    shapes = jparam_shapes(m["jcfg"])
    tp = ShardPlan(cpu_mesh(*mesh_shape), cfg)
    jp = JShardPlan(jax_mesh(*mesh_shape), m["jcfg"])
    tparams, jparams = tp.params(shapes), jp.params(shapes)
    assert tparams.keys() == jparams.keys()
    for k in shapes:
        assert tuple(tparams[k].spec) == tuple(jparams[k].spec), k
    if cfg.n_experts:
        assert tparams["moe/w_gate"].spec == P(None, "data")
    slab = (cfg.n_layers, 4, 128, cfg.n_kv_heads, cfg.head_dim)
    pages = (cfg.n_layers, 40, 16, cfg.n_kv_heads, cfg.head_dim)
    assert tuple(tp.kv_dense(slab).spec) == tuple(jp.kv_dense(slab).spec)
    assert tuple(tp.kv_pages(pages).spec) == tuple(
        jp.kv_pages(pages).spec)


# ----------------------------------------------------- MeshParams views
def test_column_refuses_a_leaf_split_over_data():
    """No leaf split over "data" may be read through data shard 0
    alone: a column raises for one it does not handle (the experts are
    read per data shard, never by a column)."""
    cfg = models()["cfg"]
    mesh = cpu_mesh(2, 1)
    params = models()["params"]
    plan = ShardPlan(mesh, cfg)
    sh = plan.params(params)
    placed = {p: sh[p].shard(t) for p, t in params.items()}
    placed["layers/up"] = tsh.NamedSharding(mesh, P(None, "data")).shard(
        params["layers/up"])
    with pytest.raises(NotImplementedError, match="split over \\['data'\\]"):
        tsh.MeshParams(cfg, placed, mesh)


def test_expert_blocks_on_their_own_device_are_views():
    """Expert blocks placed on the device the whole stack lives on are
    views of it (a model's experts do not fit twice on one card);
    column blocks are still contiguous copies."""
    m = models("qwen3-moe-235b-a22b")
    cfg, params = m["cfg"], m["params"]
    mesh = cpu_mesh(2, 2)
    sh = ShardPlan(mesh, cfg).params(params)
    wg = sh["moe/w_gate"].shard(params["moe/w_gate"])
    base = params["moe/w_gate"].untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base
               for _, t in wg.unique())
    q = sh["layers/q"].shard(params["layers/q"])
    assert all(t.is_contiguous() for _, t in q.unique())
    assert len({t.untyped_storage().data_ptr() for _, t in q.unique()}) == 2


def test_a_bare_cuda_position_is_held_as_the_current_card(monkeypatch):
    """A mesh built from bare ``cuda`` devices holds each such position
    as the current card's index, the device its shards' tensors report:
    the engine keys its load streams by mesh device and writes an
    adapter into the shards whose tensors lie on that device, so a bare
    key would match no shard and skip every upload."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    grid = np.empty(4, dtype=object)
    grid[:] = [torch.device("cuda")] * 3 + [torch.device("cuda", 0)]
    mesh = Mesh(grid.reshape(2, 2), ("data", "model"))
    assert [str(d) for d in mesh.devices.flat] == ["cuda:1"] * 3 + [
        "cuda:0"]
    assert all(d.index is not None for d in mesh.devices.flat)
    assert cpu_mesh(2, 1).devices[1, 0] == torch.device("cpu")
