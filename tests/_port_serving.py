"""Shared set-up of the port's serving tests (chunked prefill, the
migration API and the tiers of ``build_system``).

``models()`` builds the reduced Llama once per process: the JAX
package's weights and adapter catalog, and the same bridged to tensors
on the CPU, so the JAX engine and the port serve identical models.
"""
import functools

import numpy as np

#: The engine shape of ``tests/test_disagg.py``'s engines.
ENGINE = dict(max_slots=4, max_len=128, n_lora_slots=4, n_adapters=8,
              seed=0)


@functools.lru_cache(maxsize=None)
def models():
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import api as japi
    from repro.serving import engine as jengine
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.serving import engine

    jcfg = jget_config("chameleon-llama-7b").reduced()
    jparams = japi.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    jcat = jengine.AdapterCatalog(jcfg, ENGINE["n_adapters"], 32, seed=0)
    cfg = get_config("chameleon-llama-7b").reduced()
    cat = engine.AdapterCatalog(
        cfg, ENGINE["n_adapters"], 32,
        weights=bridge.catalog_weights_to_torch(jcat.weights, "cpu"))
    return dict(jcfg=jcfg, jparams=jparams, jcat=jcat, cfg=cfg,
                params=bridge.params_to_torch(jparams, "cpu"), cat=cat)


class StepClock:
    """Virtual time a test advances by hand; never the wall clock."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def reset(self) -> None:
        self.t = 0.0


def land_jax_loads(eng):
    """Block until the JAX engine's in-flight slot writes are done, so
    its ``_poll_loads`` finds them ready at the next step, as the port's
    synchronous CPU copies are."""
    import jax
    for _, leaves, _ in eng._pending_loads.values():
        jax.block_until_ready(leaves)


def prompt(rng, n):
    return [int(x) for x in rng.integers(1, 200, n)]


def check_pools(*engines):
    for e in engines:
        if e.paged:
            e.pool.check_invariants(free_page_ids=e.free_pages)


def run_to_generated(eng, handle, n):
    """Step until the request has streamed ``n`` tokens."""
    for _ in range(10_000):
        if len(handle.tokens) >= n or handle.done:
            return
        eng.step()
    raise AssertionError("request never reached the target progress")


def page_kv(eng, slot, n):
    """The first ``n`` positions of K and V in ``slot``'s pages, as
    (L, n, Kh, Dh) arrays."""
    import torch
    ps = eng.pool.page_size
    pos = torch.arange(n)
    pages = torch.as_tensor(eng.slot_pages[slot])[pos // ps]
    return [t[:, pages, pos % ps].numpy() for t in eng.kv_pages]
