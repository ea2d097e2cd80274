"""Port LoRA dispatch on the CPU vs the JAX package's.

``lora_delta`` with each backend is held to JAX's ``lora_delta`` with
the same backend (the kernel route runs the Pallas bgmv/sgmv in
interpret mode on the JAX side and the kernels' plain versions on the
port side) at the ``(Bt, S)`` grid of ``tests/test_lora_dispatch.py``,
tolerance 2e-4. Also: backend resolution, the in-place slot write and
the dispatch meter.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs several pytest workers on one
# machine, and torch's default of one thread per core oversubscribes it.
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models.lora_apply import lora_delta as jlora_delta  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lora_apply  # noqa: E402

GRID = [(4, 1), (1, 1), (3, 12), (2, 16), (1, 7)]


def delta_inputs(Bt, S, seed, dt):
    rng = np.random.default_rng(seed)
    n, din, r, dout = 5, 128, 32, 192
    x = rng.standard_normal((Bt, S, din)).astype(np.float32)
    A = jnp.asarray(rng.standard_normal((n, din, r)) * 0.05, dt)
    B = jnp.asarray(rng.standard_normal((n, r, dout)) * 0.05, dt)
    idx = rng.integers(0, n, Bt).astype(np.int32)
    return (jnp.asarray(x), A, B, jnp.asarray(idx)), \
        (torch.from_numpy(x), bridge.to_torch(A, "cpu"),
         bridge.to_torch(B, "cpu"), torch.from_numpy(idx))


@pytest.mark.parametrize("backend", ["einsum", "kernel"])
@pytest.mark.parametrize("slot_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("Bt,S", GRID)
def test_lora_delta_matches_jax(Bt, S, slot_dtype, backend):
    """f32 activations against f32 or bf16 slots (the engine's mix)."""
    dt = jnp.float32 if slot_dtype == "f32" else jnp.bfloat16
    (xj, Aj, Bj, ij), (xt, At, Bt_, it) = delta_inputs(Bt, S, Bt * 31 + S,
                                                       dt)
    want = jlora_delta(xj, (Aj, Bj), ij, backend=backend)
    got = lora_apply.lora_delta(xt, (At, Bt_), it, backend=backend)
    assert tuple(got.shape) == (Bt, S, 192)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(bridge.to_numpy(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_rank_padding_zero_rows_are_inert():
    rng = np.random.default_rng(5)
    din, dout, r, r_max = 128, 128, 8, 32
    A8 = torch.from_numpy(rng.standard_normal((2, din, r)) * 0.1).float()
    B8 = torch.from_numpy(rng.standard_normal((2, r, dout)) * 0.1).float()
    A = torch.zeros(2, din, r_max)
    B = torch.zeros(2, r_max, dout)
    A[:, :, :r], B[:, :r] = A8, B8
    x = torch.from_numpy(rng.standard_normal((2, 4, din))).float()
    idx = torch.tensor([0, 1])
    want = lora_apply.lora_delta(x, (A8, B8), idx, backend="einsum")
    got = lora_apply.lora_delta(x, (A, B), idx, backend="kernel")
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_resolve_backend_follows_the_device():
    assert ops.resolve_lora_backend("auto", "cpu") == "einsum"
    assert ops.resolve_lora_backend(None, "cuda") == "kernel"
    assert ops.resolve_lora_backend("kernel", "cpu") == "kernel"
    with pytest.raises(ValueError):
        ops.resolve_lora_backend("pallas", "cpu")


def test_einsum_counter_counts_only_the_einsum_route():
    (_, _, _, _), (xt, At, Bt_, it) = delta_inputs(2, 1, 0, jnp.float32)
    lora_apply.EINSUM.reset()
    lora_apply.lora_delta(xt, (At, Bt_), it, backend="kernel")
    assert lora_apply.EINSUM.calls == 0
    lora_apply.lora_delta(xt, (At, Bt_), it, backend="einsum")
    assert lora_apply.EINSUM.calls == 1


def test_write_adapter_to_slot_is_in_place():
    slots = lora_apply.init_lora_slots(3, 2, 16, 16, 8, 4,
                                       dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    w = lora_apply.random_lora_weights(gen, 2, 4, 2, 16, 16, 8,
                                       dtype=torch.float32)
    before = {k: (a.data_ptr(), b.data_ptr()) for k, (a, b) in slots.items()}
    out = lora_apply.write_adapter_to_slot(slots, w, 1)
    assert out is slots
    for k, (a, b) in slots.items():
        assert (a.data_ptr(), b.data_ptr()) == before[k]
        assert torch.equal(a[:, 1], w[k][0]) and torch.equal(b[:, 1], w[k][1])
        assert not a[:, 0].any() and not b[:, 2].any()
        assert not w[k][0][:, :, 2:].any()      # rank 2 padded to r_max 4


def test_dispatch_meter():
    m = ops.DispatchMeter()
    m.tick()
    m.tick(3)
    with m.sync():
        pass
    assert m.dispatches == 4 and m.sync_seconds >= 0
    m.reset()
    assert (m.dispatches, m.sync_seconds) == (0, 0.0)


def test_bridge_keeps_dtypes_and_values():
    """bf16 goes through float32 (exact), int and f32 arrays copy as
    they are; the structures keep their nesting."""
    rng = np.random.default_rng(6)
    a16 = jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16)
    a32 = jnp.asarray(rng.standard_normal((2, 5)), jnp.float32)
    ids = jnp.arange(6, dtype=jnp.int32)
    t16, t32, tid = (bridge.to_torch(a, "cpu") for a in (a16, a32, ids))
    assert (t16.dtype, t32.dtype, tid.dtype) == (
        torch.bfloat16, torch.float32, torch.int32)
    np.testing.assert_array_equal(bridge.to_numpy(t16),
                                  np.asarray(a16, np.float32))
    np.testing.assert_array_equal(bridge.to_numpy(t32), np.asarray(a32))
    k, v = bridge.kv_to_torch((a32, a32 + 1), "cpu")
    assert torch.equal(v, k + 1)
    cat = bridge.catalog_weights_to_torch({7: {"q": (a16, a32)}}, "cpu")
    assert cat[7]["q"][0].dtype == torch.bfloat16
    params = bridge.params_to_torch({"layers/q": a16}, "cpu")
    assert torch.equal(params["layers/q"], t16)
