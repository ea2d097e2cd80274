"""Heads that the "model" axis does not divide, served and trained on a
mesh, on the CPU.

The JAX rule table keeps a weight split wherever its dimension divides
the axis (q of 6 heads of 32 over 4 columns: 1.5 heads a block) and
replicates the head activations; the port then computes the attention
block whole on each batch row's first column, from weights assembled
from those blocks (``sharding.whole_heads``). Reduced configs with 6
heads (2 KV heads) at (1, 4) and (2, 4) for the dense, MoE, VLM and
hybrid (its shared block) families and whisper with 4 heads at (1, 8),
in f32, over repeated ``cpu`` positions:

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
- no published config is refused for its heads on 2, 4, 8 or 16
  columns, with 1 or 16 data shards, serving or training; the rules
  that stay (an uneven d_ff, KV heads a column would read parts of)
  still refuse.
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
from _port_whole_heads import (FORCE8, ODD, REL, engine_tokens,  # noqa
                               mesh_steps, odd_config, odd_params,
                               rel_err, unsharded)
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
    assert mp.whole_heads and mp.attn_cols == 1
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
    assert tsh.TrainView(cfg, p).whole_heads
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
@pytest.mark.parametrize("M", [2, 4, 8, 16])
def test_no_published_config_refused_for_heads(M, data):
    mesh = mesh_of((data, M))
    for name in ARCH_IDS:
        cfg = get_config(name)
        assert tsh.mesh_unsupported(cfg, M) == [], (name, M)
        assert tsh.train_unsupported(cfg, mesh) == [], (name, M, data)


def test_the_remaining_rules_still_refuse():
    cfg = get_config("internlm2-1.8b").reduced()
    odd_ff = dict(d_ff=250)
    assert tsh.mesh_unsupported(dataclasses.replace(cfg, **odd_ff), 4) == [
        "d_ff=250 on a 4-way model axis (column compute needs even "
        "blocks; uneven column splits are not ported)"]
    kv = dataclasses.replace(cfg, n_heads=6, n_kv_heads=6)
    assert tsh.mesh_unsupported(kv, 4) == [
        "n_kv_heads=6 on a 4-way model axis (a column's query heads "
        "would read parts of two KV groups)"]
    assert tsh.mesh_unsupported(odd_config("dense"), 4) == []
    assert not tsh.whole_heads(cfg, 4) and tsh.whole_heads(
        odd_config("dense"), 4)
