"""Heads that the "model" axis does not divide, served and trained on a
mesh, on the CPU.

The JAX rule table keeps a weight split wherever its dimension divides
the axis (q of 6 heads of 32 over 4 columns: 1.5 heads a block) and
replicates the head activations; the port then computes the attention
block whole on each batch row's first column, from weights assembled
from those blocks (``sharding.whole_blocks``: ``attn``). Reduced
configs with 6 heads (2 KV heads) at (1, 4) and (2, 4) for the dense,
MoE, VLM and hybrid (its shared block) families and whisper with 4
heads at (1, 8), in f32, over repeated ``cpu`` positions:

- serving steps: a prefill and greedy decode steps teacher-forced with
  the unsharded port's tokens, logits within 1e-5 relative (``REL``)
  and every argmax equal to the unsharded token; the placed state in
  the rule table's layout (``kv_cache_spec``);
- the engine (dense and MoE, paged and dense slab): greedy and seeded
  tokens equal to the ``mesh_shape=None`` engine's;
- train steps: the sharded step against the unsharded one over two
  steps, with ``tests/_port_training.py``'s tolerances (loss and grad
  norm 1e-4 relative, params within lr a step, moments 1e-4), the
  attention weights' gradients reduced into their stored blocks once;
- no published config is refused for its heads on 2, 3, 4, 6, 8 or 16
  columns, with 1 or 16 data shards, serving or training; what the
  port once refused (an uneven d_ff, KV heads a column would read
  parts of) now runs whole on the first column.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jax.devices()

from _port_train_mesh import assert_runs_close, place, run  # noqa: E402
from _port_train_mesh import unsharded as unsharded_train  # noqa: E402
from _port_uneven import assert_serves_unsharded  # noqa: E402
from _port_whole_heads import (FORCE8, ODD, REL, engine_tokens,  # noqa
                               mesh_steps, odd_config, odd_params,
                               rel_err, unsharded)
from repro_torch.models import api  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.base import Family  # noqa: E402

SERVE = [(f, shape) for f, (_, _, shapes) in ODD.items() for shape in shapes]
IDS = [f"{f}-{d}x{m}" for f, (d, m) in SERVE]


def mesh_of(shape) -> Mesh:
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = [torch.device("cpu")] * grid.size
    return Mesh(grid.reshape(shape), ("data", "model"))


@pytest.mark.filterwarnings("ignore:fit_spec")
@pytest.mark.parametrize("family,shape", SERVE, ids=IDS)
def test_mesh_steps_equal_unsharded(family, shape):
    want, tokens = unsharded(family)
    got, state, mp = mesh_steps(family, shape)
    assert "attn" in mp.whole and mp.n_cols("attn") == 1
    assert len(got) == len(want)
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert rel_err(g, w) <= REL, (family, shape, step)
        if step < len(tokens):
            assert torch.equal(torch.argmax(g, -1).to(torch.int32),
                               tokens[step][:, 0]), (family, step)
    kv = {Family.HYBRID: lambda: state[2], Family.ENCDEC: lambda: state[0]
          }.get(mp.cfg.family, lambda: state)()
    for t in kv:
        assert tuple(t.sharding.spec) == tuple(
            tsh.kv_cache_spec(mp.mesh, t.shape))


@pytest.mark.filterwarnings("ignore:fit_spec")
def test_column_views_hold_whole_heads():
    """Storage keeps the JAX layout (q split into 1.5-head blocks); the
    first column computes with q/k/v/o whole, one tensor a device."""
    cfg, params = odd_params("dense")
    from _port_cases import place_params
    mp, _ = place_params(cfg, params, mesh_of((1, 4)))
    assert tuple(mp.placed["layers/q"].sharding.spec) == (None, None,
                                                          "model")
    assert mp.placed["layers/q"].local((0, 1)).shape[-1] == 48
    for leaf in ("q", "k", "v", "o"):
        w = mp.cols[0]["layers/" + leaf]
        assert torch.equal(w, params["layers/" + leaf])
        assert mp.cols[3]["layers/" + leaf] is w
    assert mp.col_cfg.n_heads == 6 and mp.kv_heads == [(0, 2)] * 4
    assert mp.cols[1]["layers/gate"].shape[-1] == cfg.d_ff // 4


@pytest.mark.filterwarnings("ignore:fit_spec")
@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("shape", [(1, 4), (2, 4)])
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_engine_tokens_equal_unsharded(family, shape, paged, monkeypatch):
    monkeypatch.setenv("XLA_FLAGS", FORCE8)
    cfg, params = odd_params(family)
    assert engine_tokens(cfg, params, shape, paged=paged) == \
        engine_tokens(cfg, params, None, paged=paged)


TRAIN = [(f, shape) for f, (_, _, shapes) in ODD.items()
         for shape in shapes]


@pytest.mark.filterwarnings("ignore:fit_spec")
@pytest.mark.parametrize("family,shape", TRAIN, ids=IDS)
def test_train_step_equals_unsharded(family, shape):
    cfg = odd_config(family)
    params, ref = unsharded_train(cfg)
    p, o = place(cfg, params, mesh_of(shape))
    assert "attn" in tsh.TrainView(cfg, p).whole
    got = run(cfg, p, o)
    assert_runs_close(ref, got)


@pytest.mark.filterwarnings("ignore:fit_spec")
@pytest.mark.parametrize("remat", [False, True])
def test_whole_heads_under_remat(remat):
    """The 6-head dense step at (2, 4) with remat on and off: the
    replayed gathers of the whole q/k/v/o feed the same gradients."""
    cfg = odd_config("dense", remat=remat)
    params, ref = unsharded_train(dataclasses.replace(cfg, remat=False))
    got = run(cfg, *place(cfg, params, mesh_of((2, 4))))
    assert_runs_close(ref, got)


@pytest.mark.filterwarnings("ignore:fit_spec")
@pytest.mark.parametrize("data", [1, 16])
@pytest.mark.parametrize("M", [2, 3, 4, 6, 8, 16])
def test_no_published_config_refused_for_heads(M, data):
    """Every published config serves and trains on 2, 3, 4, 6, 8 or 16
    columns with 1 or 16 data shards: its attention runs whole exactly
    where M does not divide its heads (or its KV heads neither divide M
    nor are divided by it); the other blocks M does not divide run
    whole too (``tests/test_torch_uneven_splits.py`` builds each
    config's views on such meshes)."""
    for name in ARCH_IDS:
        cfg = get_config(name)
        Kh = cfg.n_kv_heads
        attn = bool(cfg.n_heads) and bool(cfg.n_heads % M
                                          or Kh % M and M % Kh)
        for train in (False, True):
            whole = tsh.whole_blocks(cfg, M, data, train=train)
            assert ("attn" in whole) == attn, (name, M, data, train)


@pytest.mark.filterwarnings("ignore:fit_spec")
def test_the_remaining_rules_still_refuse():
    """What the port once refused now runs: a d_ff 4 columns do not
    divide (the MLP whole on the first column) and 12 heads of 6 KV
    heads on 4 columns (a column's query heads would read parts of two
    KV groups: the attention whole) serve the unsharded port's logits
    and tokens, and train its steps."""
    cfg = get_config("internlm2-1.8b").reduced()
    for over, block in ((dict(d_ff=250), "mlp"),
                        (dict(n_heads=12, n_kv_heads=6), "attn")):
        odd = dataclasses.replace(cfg, **over)
        assert tsh.whole_blocks(odd, 4) == {block}
        params = api.init_params(odd, 0, torch.float32, device="cpu")
        _, mp = assert_serves_unsharded(odd, params, (1, 4))
        assert mp.n_cols(block) == 1
        _, ref = unsharded_train(odd)
        assert_runs_close(ref, run(odd, *place(odd, params,
                                               mesh_of((2, 4)))))
    assert tsh.whole_blocks(cfg, 4) == frozenset()
    assert "attn" in tsh.whole_blocks(odd_config("dense"), 4)
