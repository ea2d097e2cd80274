"""Blocks that a mesh axis does not divide, served and trained on a
mesh, on the CPU.

The JAX rule table passes every spec through ``fit_spec``, which drops
an axis that does not divide its dimension, so the weight, and its
compute, is replicated along it: the reference takes every config on
every mesh. The port computes such a block whole on each batch row's
first column, from weights assembled from their stored blocks
(``sharding.whole_blocks``). One reduced config a row of that table,
with that dimension alone uneven on its mesh (``tests/_port_uneven.py``
``CASES``), so most blocks split and one runs whole, and cases at
(2, 3) where every block is whole; f32, over repeated ``cpu``
positions:

- serving steps: a prefill and greedy decode steps teacher-forced with
  the unsharded port's tokens, logits within 1e-5 relative (``REL``:
  the mesh's column blocks and gathers reorder no reduction, but the
  split attention's products may round differently from the whole
  ones) and every argmax equal to the unsharded token; the placed
  state's specs equal the JAX package's ``kv_cache_spec``,
  ``ssm_state_spec`` and ``conv_state_spec``;
- the engine (dense and MoE, paged and dense slab): greedy and seeded
  tokens equal to the ``mesh_shape=None`` engine's;
- train steps: the sharded step against the unsharded one over two
  steps, with ``tests/_port_training.py``'s tolerances (loss and grad
  norm 1e-4 relative, params within lr a step, moments 1e-4: the
  partial products are summed over the columns in another order than
  the unsharded step's), MoE drops equal, and a whole block gathered
  by each batch row's first column alone, so its gradient is reduced
  into its stored blocks once;
- placement: the port's ``param_shardings`` (serving and train) equal
  the JAX package's on the same mesh;
- every published config constructs ``MeshParams`` and ``TrainView``
  on 1, 2, 3, 4, 6, 8 or 16 columns with 1, 2, 3 or 16 data shards
  (meta tensors: shapes alone, no step);
- the dry-run at (1, 3) counts a whole block's FLOPs on position 0.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jax.devices()
from jax.sharding import Mesh as JMesh  # noqa: E402

from _port_cases import cpu_mesh  # noqa: E402
from _port_train_mesh import assert_runs_close, place, run  # noqa: E402
from _port_train_mesh import unsharded as unsharded_train  # noqa: E402
from _port_uneven import (CASES, FORCE8, assert_serves_unsharded,  # noqa
                          case_config, case_params, train_batch,
                          unsharded)
from _port_whole_heads import engine_tokens  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models.base import param_shapes as jparam_shapes  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.base import Family, param_shapes  # noqa: E402
from repro_torch.serving.shard_plan import ShardPlan  # noqa: E402

NAMES = list(CASES)
ENGINE = [c for c in NAMES
          if get_config(CASES[c][0]).family in (Family.DENSE, Family.MOE)]


def jax_mesh(shape):
    n = int(np.prod(shape))
    return JMesh(np.asarray(jax.devices()[:1] * n).reshape(shape),
                 ("data", "model"))


def jax_config(case):
    name, over, *_ = CASES[case]
    return dataclasses.replace(jget_config(name).reduced(), **over)


def _state_stacks(cfg, state):
    """The placed KV / SSM stacks of a prefill's state, with the JAX
    spec function each is laid out by."""
    if cfg.family in (Family.DENSE, Family.MOE, Family.VLM):
        return [(t, jsh.kv_cache_spec) for t in state]
    if cfg.family == Family.ENCDEC:
        return [(t, jsh.kv_cache_spec) for t in state[0] + state[1]]
    out = [(state[0], jsh.ssm_state_spec), (state[1], jsh.conv_state_spec)]
    if cfg.family == Family.HYBRID:
        out += [(t, jsh.kv_cache_spec) for t in state[2]]
    return out


@pytest.mark.filterwarnings("ignore:fit_spec")
@pytest.mark.parametrize("case", NAMES)
def test_mesh_steps_equal_unsharded(case):
    state, mp = assert_serves_unsharded(*case_params(case), CASES[case][2],
                                        unsharded(case))
    assert mp.whole == CASES[case][3], mp.whole
    jm = jax_mesh(CASES[case][2])
    for t, spec in _state_stacks(mp.cfg, state):
        assert tuple(t.sharding.spec) == tuple(spec(jm, t.shape)), case


@pytest.mark.filterwarnings("ignore:fit_spec")
@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("case", ENGINE)
def test_engine_tokens_equal_unsharded(case, paged, monkeypatch):
    monkeypatch.setenv("XLA_FLAGS", FORCE8)
    cfg, params = case_params(case)
    assert engine_tokens(cfg, params, CASES[case][2], paged=paged) == \
        engine_tokens(cfg, params, None, paged=paged)


def _gathers(monkeypatch) -> dict:
    """{(path, layer): [mesh position (b, m), ...]} of every gather the
    recording ``FsdpStep`` makes."""
    seen: dict = {}
    gather = tsh.FsdpStep.gather

    def spy(self, path, st, index, device, pos=None):
        key = (path, index[0] if isinstance(index[0], int) else None)
        seen.setdefault(key, []).append(pos)
        return gather(self, path, st, index, device, pos)

    monkeypatch.setattr(tsh.FsdpStep, "gather", spy)
    return seen


#: The leaves of each whole block as the train step gathers them.
_WHOLE_TRAIN = {"attn": ("q", "k", "v", "o", "xq", "xo"),
                "mlp": ("gate", "up", "down"),
                "shared": ("shared_gate", "shared_up", "shared_down"),
                "mixer": ("in_proj", "x_proj", "out_proj", "A_log"),
                "expert_ff": ("w_gate", "w_up", "w_down")}


@pytest.mark.filterwarnings("ignore:fit_spec")
@pytest.mark.parametrize("case", NAMES)
def test_train_step_equals_unsharded(case, monkeypatch):
    cfg = case_config(case)
    batch = train_batch(case)
    params, ref = unsharded_train(cfg, batch=batch)
    p, o = place(cfg, params, cpu_mesh(CASES[case][2]))
    tv = tsh.TrainView(cfg, p)
    assert tv.whole == CASES[case][4], tv.whole
    seen = _gathers(monkeypatch)
    got = run(cfg, p, o, batch=batch)
    assert_runs_close(ref, got)
    # a whole block: gathered by each batch row's first column alone,
    # as often by every row
    for block in tv.whole - {"experts"}:
        for (path, _), pos in seen.items():
            if path.split("/")[-1] in _WHOLE_TRAIN[block]:
                assert {m for _, m in pos} == {0}, (path, pos)
                n = [pos.count((b, 0)) for b in range(tv.n_batch)]
                assert min(n) == max(n) > 0, (path, pos)
    if "experts" in tv.whole:       # every expert on every batch row
        assert any(k[0] == "moe/w_gate" for k in seen)
        for b in range(tv.n_batch):
            box, = tv.boxes("moe/w_gate", 0, 0, b)
            assert box[1] == slice(0, cfg.n_experts)


@pytest.mark.filterwarnings("ignore:fit_spec")
@pytest.mark.parametrize("case", ["all_moe", "all_hybrid"])
def test_whole_blocks_under_remat(case):
    """Every block whole at (2, 3) with remat on: the replayed gathers
    of the whole blocks feed the same gradients."""
    cfg = case_config(case, remat=True)
    params, ref = unsharded_train(dataclasses.replace(cfg, remat=False))
    got = run(cfg, *place(cfg, params, cpu_mesh(CASES[case][2])))
    assert_runs_close(ref, got)


@pytest.mark.filterwarnings("ignore:fit_spec")
@pytest.mark.parametrize("case", NAMES)
def test_placement_equals_reference(case):
    """Serving and train rule tables against the JAX package's on the
    case's mesh, and the placed serving weights against them."""
    cfg, jcfg = case_config(case), jax_config(case)
    shape = CASES[case][2]
    mesh, jm = cpu_mesh(shape), jax_mesh(shape)
    shapes, jshapes = param_shapes(cfg), jparam_shapes(jcfg)
    assert shapes == jshapes
    for kind in ("decode", "train"):
        got = tsh.param_shardings(cfg, shapes, mesh, kind)
        want = jsh.param_shardings(jcfg, jshapes, jm, kind)
        for k in shapes:
            assert tuple(got[k].spec) == tuple(want[k].spec), (kind, k)
    plan = ShardPlan(mesh, cfg).params(shapes)
    want = jsh.param_shardings(jcfg, jshapes, jm, "decode")
    for k in shapes:
        assert tuple(plan[k].spec) == tuple(want[k].spec), k


def meta_mesh(shape) -> Mesh:
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = [torch.device("meta")] * grid.size
    return Mesh(grid.reshape(shape), ("data", "model"))


@pytest.mark.filterwarnings("ignore:fit_spec")
@pytest.mark.parametrize("name", ARCH_IDS)
def test_every_published_config_on_every_mesh(name):
    """Serving ``MeshParams`` and ``TrainView`` of the published config
    on every mesh of 1, 2, 3, 4, 6, 8 or 16 columns and 1, 2, 3 or 16
    data shards, weights on ``meta`` positions: each column's view of a
    whole block is the whole weight, every other view its block, and
    each train box lies inside its leaf."""
    cfg = get_config(name)
    params = {k: torch.empty(s, dtype=torch.bfloat16, device="meta")
              for k, s in param_shapes(cfg).items()}
    for data in (1, 2, 3, 16):
        for M in (1, 2, 3, 4, 6, 8, 16):
            mesh = meta_mesh((data, M))
            sh = ShardPlan(mesh, cfg).params(params)
            mp = tsh.MeshParams(cfg, {k: sh[k].shard(v)
                                      for k, v in params.items()}, mesh)
            assert mp.whole == tsh.whole_blocks(cfg, M)
            for k, v in params.items():
                leaf = k.split("/")[-1]
                if k in mp.cols[0] and tsh.leaf_whole(mp.whole, leaf):
                    assert mp.cols[0][k].shape == v.shape, (name, k)
            tsh_ = tsh.param_shardings(cfg, params, mesh, "train")
            tv = tsh.TrainView(cfg, {k: tsh_[k].shard(v)
                                     for k, v in params.items()})
            assert tv.whole == tsh.whole_blocks(cfg, M, data, train=True)
            for k, v in params.items():
                for b in (0, tv.n_batch - 1):
                    for m in range(M):
                        for box in tv.boxes(k, m, None, b):
                            for s, n in zip(tsh._box(box, v.shape),
                                            v.shape):
                                assert 0 <= s.start < s.stop <= n, (k, box)


@pytest.mark.parametrize("kind,shape", [("train", "train_4k"),
                                        ("prefill", "prefill_32k"),
                                        ("decode", "decode_32k")])
def test_dryrun_counts_whole_blocks_on_position_zero(kind, shape):
    """Reduced internlm2 at (1, 3), where 3 divides none of its heads,
    KV heads, d_model, d_ff or vocabulary: position 0 counts the
    unsharded step's FLOPs, the other columns none. With 6 heads of 3
    KV heads and a vocabulary of 513 the train step splits all but the
    MLP: position 0 counts the whole MLP's 18 T D F (three GEMMs, their
    backward twice) more than each other column."""
    cfg = dataclasses.replace(get_config("internlm2-1.8b").reduced(),
                              n_layers=1)

    def count(c, mesh):
        return dryrun.count_case("internlm2-1.8b", shape, dryrun.meta_mesh(
            mesh, ("data", "model")), c, 16, 4, None).flops

    one, three = count(cfg, (1, 1)), count(cfg, (1, 3))
    assert sum(three.values()) > 0
    assert math.isclose(three.get(0, 0.0), sum(one.values()), rel_tol=1e-9)
    assert all(three.get(i, 0.0) == 0 for i in (1, 2)), three
    if kind != "train":
        return
    mixed = dataclasses.replace(cfg, n_heads=6, n_kv_heads=3, vocab_size=513)
    assert tsh.whole_blocks(mixed, 3, train=True) == {"mlp"}
    f = count(mixed, (1, 3))
    assert f[1] == f[2] > 0
    assert f[0] - f[1] == 18 * 4 * 16 * mixed.d_model * mixed.d_ff
