"""The port's model API for the decoder-only configs on the CPU vs the
JAX package.

``repro_torch.models.api`` ``forward``, ``train_loss`` (with the MoE
aux term), ``prefill``, ``decode_step`` (4 greedy steps over the padded
slab) and ``init_serve_state`` against ``repro.models.api`` for the
eight dense, MoE and VLM configs at ``.reduced()`` in f32 (set-up and
checks: ``tests/_port_families.py``), within 1e-4; and
``layers.cross_entropy`` with a mask. The other families are
``tests/test_torch_families.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _port_families import (check_forward_and_train_loss,  # noqa: E402
                            check_init_serve_state,
                            check_prefill_then_decode, close, inputs, model)
from repro.configs import ARCH_IDS  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.base import Family  # noqa: E402

DECODER_ONLY = tuple(a for a in ARCH_IDS if get_config(a).family in (
    Family.DENSE, Family.MOE, Family.VLM))


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_forward_and_train_loss(arch):
    check_forward_and_train_loss(arch, 16, False)


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_prefill_then_decode(arch):
    check_prefill_then_decode(arch, 16, False)


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_init_serve_state(arch):
    check_init_serve_state(arch)


def test_moe_train_loss_carries_the_aux_term():
    """lm.train_loss adds 0.01 x the MoE load-balance loss, as JAX: the
    difference from cross-entropy alone is the same on both sides."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers
    jcfg, cfg, jp, tp = model("qwen3-moe-235b-a22b")
    toks, _, _ = inputs(cfg, 16)
    t = torch.from_numpy(toks)
    ce = layers.cross_entropy(api.forward(cfg, tp, t), t)
    jce = jlayers.cross_entropy(japi.forward(jcfg, jp, jnp.asarray(toks)),
                                jnp.asarray(toks))
    aux_t = api.train_loss(cfg, tp, t, t) - ce
    aux_j = japi.train_loss(jcfg, jp, jnp.asarray(toks),
                            jnp.asarray(toks)) - jce
    assert float(aux_j) > 1e-4
    close(aux_t, aux_j, rtol=1e-3, atol=1e-5)


def test_cross_entropy_mask():
    from repro.models import layers as jlayers
    from repro_torch.models import layers
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    for mask in (np.array([[1, 1, 0, 1, 0], [0, 0, 0, 1, 1]], np.float32),
                 np.zeros((2, 5), np.float32)):
        close(layers.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels),
                                   torch.from_numpy(mask)),
              jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    jnp.asarray(mask)))
