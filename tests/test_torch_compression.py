"""The port's int8 gradient compression against the JAX package's.

``quantize_int8``, ``dequantize_int8`` and ``compress_with_feedback``
(three steps, the error feedback carried) give JAX's numbers bit for
bit on the same inputs: both take the max, divide, round half to even
and clip in the input's dtype (f32, or bf16 as JAX does it).
``compressed_psum`` runs in two ``torch.distributed`` processes on the
gloo backend (an all-reduce over the default group) against JAX's
``compressed_psum`` under ``jax.vmap`` with a named axis of two hosts,
on the same per-host gradients: the averaged gradients and each
host's new error feedback equal JAX's.
"""
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.training import compression as jc  # noqa: E402
from repro_torch.bridge import to_numpy, to_torch  # noqa: E402
from repro_torch.training import compression as tc  # noqa: E402


def grads_np(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"layers/w": (rng.standard_normal((16, 8)) * scale)
            .astype(np.float32),
            "embed/tok": (rng.standard_normal((5, 4)) * scale * 1e-3)
            .astype(np.float32),
            "tiny": np.full((6,), 1e-8, np.float32)}


@pytest.mark.parametrize("scale", [1e-4, 1.0, 1e3])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_matches_jax(scale, dt):
    g = jnp.asarray(grads_np(0, scale)["layers/w"],
                    jnp.bfloat16 if dt == "bf16" else jnp.float32)
    jq, js = jc.quantize_int8(g)
    tq, ts = tc.quantize_int8(to_torch(g, "cpu"))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert to_numpy(ts) == np.asarray(js, np.float32)
    np.testing.assert_array_equal(
        tc.dequantize_int8(tq, ts).numpy(),
        np.asarray(jc.dequantize_int8(jq, js)))
    if dt == "f32":     # the JAX test's bound: half a quantum (f32 math)
        err = (tc.dequantize_int8(tq, ts) - to_torch(g, "cpu")).abs()
        assert float(err.max()) <= float(ts) * 0.5 + 1e-9


def test_compress_with_feedback_matches_jax_over_steps():
    jerr = terr = None
    for step in range(3):
        g = grads_np(10 + step)
        jq, jdeq, jerr = jc.compress_with_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, jerr)
        tq, tdeq, terr = tc.compress_with_feedback(
            {k: torch.from_numpy(v) for k, v in g.items()}, terr)
        for k in g:
            np.testing.assert_array_equal(tq[k][0].numpy(),
                                          np.asarray(jq[k][0]))
            assert float(tq[k][1]) == float(jq[k][1])
            np.testing.assert_array_equal(tdeq[k].numpy(),
                                          np.asarray(jdeq[k]))
            np.testing.assert_array_equal(terr[k].numpy(),
                                          np.asarray(jerr[k]))
    # Tiny grads quantise to zero; the residual carries them.
    assert float(terr["tiny"].abs().sum()) > 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _psum_worker(rank, world, port, grads, errors, out_q):
    import torch.distributed as dist

    from repro_torch.training import compression
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        out, err = compression.compressed_psum(
            {k: torch.from_numpy(v) for k, v in grads.items()},
            errors={k: torch.from_numpy(v) for k, v in errors.items()})
        out_q.put((rank, {k: v.numpy() for k, v in out.items()},
                   {k: v.numpy() for k, v in err.items()}))
    finally:
        dist.destroy_process_group()


def test_compressed_psum_in_two_gloo_processes_matches_jax():
    import multiprocessing as mp
    world = 2
    grads = [grads_np(20 + r, scale=1.0 + r) for r in range(world)]
    errors = [{k: (np.random.default_rng(30 + r).standard_normal(v.shape)
                   * 1e-3).astype(np.float32) for k, v in g.items()}
              for r, g in enumerate(grads)]
    stack = {k: jnp.asarray(np.stack([g[k] for g in grads]))
             for k in grads[0]}
    estack = {k: jnp.asarray(np.stack([e[k] for e in errors]))
              for k in grads[0]}
    jout, jerr = jax.vmap(lambda g, e: jc.compressed_psum(g, "hosts", e),
                          axis_name="hosts")(stack, estack)

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_psum_worker,
                         args=(r, world, port, grads[r], errors[r], q))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        results = dict((r, (o, e)) for r, o, e in
                       (q.get(timeout=120) for _ in range(world)))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    for r in range(world):
        out, err = results[r]
        for k in grads[0]:
            np.testing.assert_array_equal(out[k], np.asarray(jout[k][r]))
            np.testing.assert_array_equal(err[k], np.asarray(jerr[k][r]))
