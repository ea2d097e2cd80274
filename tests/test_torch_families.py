"""The port's SSM, hybrid and enc-dec families on the CPU vs the JAX
package.

``repro_torch.models.api`` ``forward``, ``train_loss``, ``prefill``,
``decode_step`` (4 greedy steps) and ``init_serve_state`` against
``repro.models.api`` for falcon-mamba-7b, zamba2-1.2b and whisper-base
at ``.reduced()`` in f32 (set-up and checks: ``tests/_port_families.py``);
logits, states and losses within 1e-4. SSM and hybrid also run at
S = 70 (three chunks of 32, the last padded); there the hybrid's JAX
SSD overflows to NaN with its own weights (``tests/test_torch_ssm.py``
pins it), so both sides take A_log scaled down. Each side decodes from
its own prefill state; the port writes K/V slabs in place, JAX returns
new arrays. Also: the hybrid's shared-block LoRA through the einsum
path and the kernels' plain versions, and the short-prompt behaviour
both packages share (a prompt shorter than d_conv - 1 leaves a short
conv state the next decode step cannot use). The decoder-only configs
are ``tests/test_torch_family_api.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _port_families import (B, check_forward_and_train_loss,  # noqa: E402
                            check_init_serve_state,
                            check_prefill_then_decode, close, close_tree,
                            inputs, jdecode_step, model)
from repro.models import api as japi  # noqa: E402
from repro.models.lora_apply import (  # noqa: E402
    init_lora_slots as jinit_slots, random_lora_weights as jrandom_lora,
    write_adapter_to_slot as jwrite_slot)
from repro_torch import bridge  # noqa: E402
from repro_torch.models import api, hybrid  # noqa: E402
from repro_torch.models.base import Family  # noqa: E402

FAMILIES = ("falcon-mamba-7b", "zamba2-1.2b", "whisper-base")
#: (config, S, A_log scaled down): S = 16 for each, S = 70 for the scans.
CASES = [(a, 16, False) for a in FAMILIES] + [
    ("falcon-mamba-7b", 70, False), ("zamba2-1.2b", 70, True)]
R_MAX = 8


@pytest.mark.parametrize("arch,S,small", CASES)
def test_forward_and_train_loss(arch, S, small):
    check_forward_and_train_loss(arch, S, small)


@pytest.mark.parametrize("arch,S,small", CASES)
def test_prefill_then_decode(arch, S, small):
    check_prefill_then_decode(arch, S, small)


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_serve_state(arch):
    check_init_serve_state(arch)


def hybrid_lora(jcfg):
    """Three adapters in the hybrid's shared-block slots, stacks of
    (n_sites, slots, din, r), f32."""
    n_sites = len(hybrid.attn_sites(jcfg))
    slots = jinit_slots(jax.random.PRNGKey(1), 3, n_sites, jcfg.d_model,
                        jcfg.q_dim, jcfg.kv_dim, R_MAX, dtype=jnp.float32)
    for i, rank in enumerate((2, 4, 8)):
        slots = jwrite_slot(slots, jrandom_lora(
            jax.random.PRNGKey(10 + i), rank, R_MAX, n_sites, jcfg.d_model,
            jcfg.q_dim, jcfg.kv_dim, dtype=jnp.float32), i)
    return slots


@pytest.mark.parametrize("backend", ["einsum", "kernel"])
def test_hybrid_lora(backend):
    """The shared block's q/k/v/o LoRA: prefill, then 2 decode steps,
    against JAX's einsum path; the port's kernel backend runs the sgmv
    and bgmv wrappers (their plain versions on CPU tensors)."""
    import importlib
    jcfg, cfg, jp, tp = model("zamba2-1.2b")
    jslots = hybrid_lora(jcfg)
    tslots = bridge.lora_to_torch(jslots, "cpu")
    idx = np.array([2, 0], np.int32)
    toks, _, _ = inputs(cfg, 16, seed=3)
    stats = {n: importlib.import_module(f"repro_torch.kernels.{n}").STATS
             for n in ("sgmv", "bgmv")}
    for st in stats.values():
        st.reset()
    jl, jstate = japi.prefill(jcfg, jp, jnp.asarray(toks), kv_max_len=20,
                              lora=jslots, adapter_idx=jnp.asarray(idx))
    tl, tstate = api.prefill(cfg, tp, torch.from_numpy(toks), kv_max_len=20,
                             lora=tslots, adapter_idx=torch.from_numpy(idx),
                             lora_backend=backend)
    close(tl, jl)
    close_tree(tstate, jstate)
    plain, _ = api.prefill(cfg, tp, torch.from_numpy(toks))
    assert (plain - tl).abs().max() > 1e-3     # the adapters act
    for step in range(2):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        clen = np.full((B,), 16 + step, np.int32)
        jl, jstate = jdecode_step(
            jcfg, jp, jnp.asarray(nxt), jstate, jnp.asarray(clen),
            lora=jslots, adapter_idx=jnp.asarray(idx))
        tl, tstate = api.decode_step(
            cfg, tp, torch.from_numpy(nxt), tstate, torch.from_numpy(clen),
            lora=tslots, adapter_idx=torch.from_numpy(idx),
            lora_backend=backend)
        close(tl, jl)
        close_tree(tstate, jstate)
    n_sites = len(hybrid.attn_sites(cfg))
    if backend == "kernel":
        # q/k/v/o at every site: one sgmv per projection per prefill,
        # one bgmv per projection per decode step.
        assert stats["sgmv"].plain == 4 * n_sites
        assert stats["bgmv"].plain == 2 * 4 * n_sites
    else:
        assert stats["sgmv"].plain == stats["bgmv"].plain == 0


def test_hybrid_decode_writes_kv_in_place():
    """The port's hybrid decode_step writes the given K/V tensors (the
    JAX function returns new arrays): a caller that needs the old state
    clones it."""
    _, cfg, _, tp = model("zamba2-1.2b")
    toks, _, _ = inputs(cfg, 8)
    _, state = api.prefill(cfg, tp, torch.from_numpy(toks), kv_max_len=12)
    k_before = state[2][0].clone()
    _, new = api.decode_step(cfg, tp, torch.zeros((B, 1), dtype=torch.int32),
                             state, torch.full((B,), 8, dtype=torch.int32))
    assert new[2][0] is state[2][0]
    assert not torch.equal(state[2][0], k_before)
    assert torch.equal(state[2][0][:, :, :8], k_before[:, :, :8])


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_short_prompt_conv_state(arch):
    """A prompt shorter than d_conv - 1 leaves a conv state of its own
    length in both packages, and the next decode step fails in both."""
    jcfg, cfg, jp, tp = model(arch)
    toks, _, _ = inputs(cfg, 2)
    pkw = dict(kv_max_len=8) if cfg.family == Family.HYBRID else {}
    jl, jstate = japi.prefill(jcfg, jp, jnp.asarray(toks), **pkw)
    tl, tstate = api.prefill(cfg, tp, torch.from_numpy(toks), **pkw)
    close(tl, jl)
    close_tree(tstate, jstate)
    assert tstate[1].shape[2] == 2 < cfg.d_conv - 1
    nxt = np.zeros((B, 1), np.int32)
    clen = np.full((B,), 2, np.int32)
    with pytest.raises(Exception):
        japi.decode_step(jcfg, jp, jnp.asarray(nxt), jstate,
                         jnp.asarray(clen))
    with pytest.raises(RuntimeError):
        api.decode_step(cfg, tp, torch.from_numpy(nxt), tstate,
                        torch.from_numpy(clen))
