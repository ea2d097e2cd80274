"""The sequence-parallel boundary (``activation_sharding(
seq_shard_boundary=True)``) of the mesh train step, on the CPU.

- Each family's reduced f32 train step (dense, MoE, VLM, SSM, hybrid,
  enc-dec) at (2, 2) and (1, 2) over repeated ``cpu`` positions, two
  steps from JAX's seeded params: with the flag the loss, grad norm and
  every parameter are bit-identical to the step without it (the
  residual's pieces feed the same sums in the same column order), and
  both are within ``_port_cases.JAX_TOL`` of JAX's unsharded jitted
  step (loss and grad norm; the states by ``_port_training``'s
  tolerances).
- A sequence the "model" axis does not divide stays whole.
- Remat's saved boundary bytes (a remat body's inputs, counted by
  ``sharding.saved_probe``) fall by M at the busiest position, on a
  dry-run mesh of distinct ``meta`` positions.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
jax.devices()

from _port_cases import FAMILIES, JAX_TOL, cpu_mesh  # noqa: E402
from _port_train_mesh import (assert_runs_close, jax_run, place,  # noqa
                              run)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import act_sharding as acts  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


@functools.lru_cache(maxsize=None)
def reference(name):
    return jax_run(name)


def mesh_run(name, shape, seq: bool, params):
    cfg = get_config(name).reduced()
    mesh = cpu_mesh(shape)
    p, o = place(cfg, {k: v.clone() for k, v in params.items()}, mesh)
    with acts.activation_sharding(("data",), mesh=mesh,
                                  seq_shard_boundary=seq):
        return run(cfg, p, o)


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)], ids=["2x2", "1x2"])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_seq_shard_is_bit_identical(fam, shape):
    name = FAMILIES[fam]
    params, jref = reference(name)
    off = mesh_run(name, shape, False, params)
    on = mesh_run(name, shape, True, params)
    (m0, _, (p0, o0)), (m1, _, (p1, o1)) = off, on
    for a, b in zip(m0, m1):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
    for k in o0:
        np.testing.assert_array_equal(o0[k], o1[k], err_msg=k)
    for j, b in zip(jref[0], m1):
        for k in ("loss", "grad_norm"):
            assert abs(b[k] - j[k]) <= JAX_TOL * max(abs(j[k]), 1.0), (k,
                                                                      j, b)
    if fam != "moe":       # MoE drops are not counted in JAX's run
        assert_runs_close(jref, on)


def test_indivisible_sequence_stays_whole():
    mesh = cpu_mesh((1, 2))
    devs = list(mesh.devices[0])
    with acts.activation_sharding(("data",), mesh=mesh,
                                  seq_shard_boundary=True):
        for S, pieces in ((16, 2), (15, 1)):
            parts = [torch.randn(2, S, 8) for _ in devs]
            h = acts.residual_in(parts, devs)
            assert len(h) == pieces
            whole = torch.cat(h, dim=1)
            torch.testing.assert_close(whole, parts[0] + parts[1],
                                       rtol=0, atol=0)
            xs = acts.columns_in(h, devs)
            assert all(torch.equal(x, whole) for x in xs)
    with acts.activation_sharding(("data",), mesh=mesh):
        assert len(acts.residual_in([torch.randn(2, 16, 8)] * 2,
                                    devs)) == 1


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_remat_boundary_bytes_fall_by_m(shape):
    cfg = dataclasses.replace(get_config(FAMILIES["dense"]).reduced(),
                              remat=True)
    mesh = dryrun.meta_mesh(shape, ("data", "model"))
    saved = {}
    for seq in (False, True):
        rec = dryrun.count_cell(FAMILIES["dense"], "train_4k", mesh,
                                config=cfg, seq_override=16,
                                batch_override=4, depth="full",
                                seq_shard=seq)
        saved[seq] = rec["memory"]["saved_boundary_bytes"]
    assert saved[False] > 0
    assert saved[False] == shape[1] * saved[True]
