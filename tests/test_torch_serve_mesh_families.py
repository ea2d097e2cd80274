"""The serving step functions of every family on a device mesh, on the
CPU.

``api.prefill`` then ``N_DECODE`` ``api.decode_step``s on serving
``MeshParams`` over repeated ``cpu`` positions, for reduced qwen2-vl
(M-RoPE), falcon-mamba (Mamba1), zamba2 (Mamba2 plus the shared
attention block), whisper (enc-dec), internlm2 (dense) and qwen3-moe
(token-parallel MoE), in f32, at (1, 1), (2, 1), (1, 2), (2, 2) and
(1, 4) (one KV head shared by two columns). The dry-run's scope is
installed: batch rows over "data" in exact mode, MoE token-parallel.
Every mesh run is teacher-forced with the unsharded port's greedy
tokens and held to:

- the unsharded port: bit for bit at (1, 1); elsewhere its argmax
  equal to the unsharded token at every step and its logits within
  ``REL`` (1e-5) relative to the largest logit;
- the JAX package's ``api.prefill``/``decode_step``, unsharded, on the
  same numpy weights: within ``JAX_TOL`` (1e-4).

The returned state is placed as ``kv_cache_spec``, ``ssm_state_spec``
and ``conv_state_spec`` say. Under token parallelism each data shard
routes its own rows with its own capacity groups, so the MoE prefill's
references are the prefills of each shard's rows. Also: the engine's
full-batch scope (``batch_axes=()``) gives the same logits, whisper's
published vocabulary of 51865 serves whole on 2 columns, falcon-mamba's
and zamba2's mixers serve whole on 3 columns, and the engine still
refuses the four families.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jax.devices()

from _port_cases import (FAMILIES, JAX_TOL, MESHES, REL, cpu_mesh,  # noqa
                         inputs, model, place_params, reference, run_mesh)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import act_sharding as acts  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.base import Family  # noqa: E402
from repro_torch.serving import engine  # noqa: E402

CASES = [(f, shape) for f in FAMILIES for shape in MESHES]


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("family,shape", CASES,
                         ids=[f"{f}-{d}x{m}" for f, (d, m) in CASES])
def test_mesh_prefill_and_decode(family, shape):
    name = FAMILIES[family]
    ref = reference(name, shape[0])
    got, _, _ = run_mesh(name, shape, ref["tokens"])
    assert len(got) == len(ref["logits"])
    for step, (g, w, j) in enumerate(zip(got, ref["logits"], ref["jax"])):
        assert g.shape == w.shape and torch.isfinite(g).all()
        if shape == (1, 1):
            assert torch.equal(g, w), (family, step)
        else:
            assert rel_err(g, w) <= REL, (family, shape, step)
        if step < len(ref["tokens"]):
            assert torch.equal(torch.argmax(g, -1).to(torch.int32),
                               ref["tokens"][step][:, 0]), (family, step)
        np.testing.assert_allclose(g.numpy(), j, rtol=JAX_TOL,
                                   atol=JAX_TOL)


@pytest.mark.parametrize("family", ["vlm", "ssm", "hybrid", "encdec"])
def test_state_is_placed_as_the_rule_table_says(family):
    """The prefill's state on (2, 2): each stack's sharding is the rule
    table's spec for its shape, and gathered it equals the unsharded
    prefill's state."""
    name = FAMILIES[family]
    _, cfg, _, tp = model(name)
    _, state, _ = run_mesh(name, (2, 2), [])
    mesh = state_mesh(state)
    toks, kw = inputs(cfg)
    pkw = {"kv_max_len": 12} if cfg.family == Family.HYBRID else {}
    _, want = api.prefill(cfg, tp, torch.from_numpy(toks),
                          **{a: torch.from_numpy(v) for a, v in kw.items()},
                          **pkw)
    pairs = list(zip(leaves(state), leaves(want)))
    assert len(pairs) == {"vlm": 2, "ssm": 2, "hybrid": 4, "encdec": 4}[
        family]
    for i, (st, w) in enumerate(pairs):
        assert isinstance(st, tsh.ShardedTensor)
        shape = tuple(w.shape)
        if len(shape) == 5 and not (cfg.family in (Family.SSM,
                                                   Family.HYBRID) and i == 0):
            spec = tsh.kv_cache_spec(mesh, shape)
        elif i == 0:
            spec = tsh.ssm_state_spec(mesh, shape)
        else:
            spec = tsh.conv_state_spec(mesh, shape)
        assert tuple(st.sharding.spec) == tuple(spec), (family, i)
        assert torch.allclose(st.cpu(), w, rtol=1e-5, atol=1e-5)


def leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def state_mesh(state):
    return leaves(state)[0].mesh


@pytest.mark.parametrize("family", ["vlm", "hybrid", "encdec"])
def test_engine_scope_computes_the_same(family):
    """Under the engine's scope (``batch_axes=()``: compute at full
    batch on the first row of positions) the steps give the batch-row
    run's logits."""
    name = FAMILIES[family]
    ref = reference(name, 1)
    rows, _, _ = run_mesh(name, (2, 2), ref["tokens"])
    whole, _, _ = run_mesh(name, (2, 2), ref["tokens"], batch_rows=False)
    for a, b in zip(rows, whole):
        assert torch.allclose(a, b, rtol=REL, atol=REL)


def test_whisper_published_vocab_serves_whole_on_two_columns():
    """V 51865 does not divide 2 columns: the embedding and the head
    stay whole on every column, and the mesh gives the unsharded
    logits."""
    cfg = get_config("whisper-base").reduced(vocab_size=51865)
    assert tsh.whole_blocks(cfg, 2) == frozenset()
    params = api.init_params(cfg, 0, torch.float32, device="cpu")
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, 51865, (2, 6)).astype(np.int32))
    frames = torch.from_numpy(rng.standard_normal(
        (2, cfg.enc_ctx, cfg.d_model)).astype(np.float32))
    want, _ = api.prefill(cfg, params, toks, frames=frames)
    mesh = cpu_mesh((1, 2))
    with pytest.warns(UserWarning, match="drops non-dividing"):
        mp, _ = place_params(cfg, params, mesh)
    assert mp.whole_vocab
    assert all(c["embed/tok"].shape[0] == 51865 for c in mp.cols)
    got, _ = api.prefill(cfg, mp, toks, frames=frames)
    assert torch.allclose(got, want, rtol=REL, atol=REL)


@pytest.mark.filterwarnings("ignore:fit_spec")
def test_refusals_name_the_dimension():
    """What the port once refused now serves: every family's reduced
    config splits every block over 4 columns, and falcon-mamba's
    d_inner of 256 and zamba2's 8 Mamba2 heads on 3 columns (the mixer
    whole on the first column, the state in the rule table's layout)
    give the unsharded port's logits and tokens."""
    from _port_uneven import assert_serves_unsharded
    for name in FAMILIES.values():
        assert tsh.whole_blocks(get_config(name).reduced(), 4) == frozenset()
    for name in ("falcon-mamba-7b", "zamba2-1.2b"):
        cfg = get_config(name).reduced()
        assert "mixer" in tsh.whole_blocks(cfg, 3)
        params = api.init_params(cfg, 0, torch.float32, device="cpu")
        state, mp = assert_serves_unsharded(cfg, params, (1, 3))
        assert mp.n_cols("mixer") == 1
        ssm = state[0]
        assert tuple(ssm.sharding.spec) == tuple(
            tsh.ssm_state_spec(mp.mesh, ssm.shape))


@pytest.mark.parametrize("family", ["vlm", "ssm", "hybrid", "encdec"])
def test_engine_still_refuses_the_family(family):
    cfg = get_config(FAMILIES[family]).reduced()
    with pytest.raises(NotImplementedError, match=cfg.family.name):
        engine.ChameleonEngine(cfg, {}, engine.EngineConfig(
            n_adapters=2, mesh_shape=(1, 2)), device="cpu")


def test_row_spans_follow_the_batch_rows():
    mesh = cpu_mesh((2, 2))
    with acts.activation_sharding(("data",), mesh=mesh,
                                  exact_reductions=True):
        assert acts.row_spans(8) == [(0, 0, 4), (1, 4, 8)]
        assert acts.row_spans(1) == [(0, 0, 1)]
        with acts.batch_row(1):
            assert acts.replicate(torch.zeros(1))[0].device.type == "cpu"
