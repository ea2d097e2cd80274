"""Per-request sampling parameters for the serving surface.

Pure-Python control-plane object (no jax import): requests carry a
``SamplingParams`` through every tier; only the real engine turns it
into device work via the batched sampler in ``repro.models.lm``
(``sample_tokens``). The default is greedy decoding, which reproduces
the pre-SamplingParams engine token-for-token (argmax over logits).

Seeding: sampling randomness is keyed per *(seed, token position)* —
never per batch slot or step — so a request decodes the same tokens
regardless of batch composition, KV layout (dense/paged), LoRA backend
(einsum/kernel), or a squash/requeue that re-executes its prefix.
``seed=None`` with ``temperature > 0`` derives the seed from the
request id, which keeps runs reproducible without forcing callers to
thread seeds.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class SamplingParams:
    """How to turn logits into the next token, per request.

    temperature  <= 0 means greedy (argmax); > 0 scales logits.
    top_k        0 disables; else sample only among the k best logits.
    top_p        1.0 disables; else nucleus sampling (smallest prefix of
                 the sorted distribution with cumulative prob >= top_p;
                 the best token is always kept).
    seed         per-request RNG seed; None derives it from the req_id.
    max_new_tokens  caps decode length below the workload's output_len
                 (None = no cap).
    stop_token_ids  generation finishes early when one is sampled (the
                 stop token itself is kept, vLLM-style).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int | None = None
    max_new_tokens: int | None = None
    stop_token_ids: tuple[int, ...] = field(default_factory=tuple)

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_new_tokens is not None and self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # Normalise for hashing/equality (callers pass lists too).
        object.__setattr__(self, "stop_token_ids",
                           tuple(self.stop_token_ids))

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def seed_for(self, req_id: int) -> int:
        """The effective RNG seed for a request (masked to uint32)."""
        s = self.seed if self.seed is not None else req_id
        return int(s) & 0xFFFFFFFF


GREEDY = SamplingParams()


# ------------------------------------------- speculative decoding rule
#
# Draft–verify speculation must stay deterministic under the same
# contract as ``sample_tokens``: every random draw is keyed on
# *(seed, token position)* only, so a squash/requeue that re-executes a
# request's prefix regenerates bit-identical tokens even though the
# draft/verify *round boundaries* land differently on the second run.
# Each position therefore derives one base key
# ``fold_in(PRNGKey(seed), position)`` (the non-spec sampler's key) and
# splits it into independent streams by folding in a stream tag:
#
#   SPEC_DRAFT_FOLD     Gumbel noise for the draft model's proposal
#   SPEC_ACCEPT_FOLD    the uniform for the rejection-sampling accept
#   SPEC_RESIDUAL_FOLD  Gumbel noise for the residual resample on reject
#
# The *bonus* token (all drafts accepted) is drawn from the base key
# with no fold — i.e. by ``sample_tokens`` itself — so a fully-accepted
# round ends with exactly the token the non-speculative loop would have
# sampled at that position. Greedy rows (temperature <= 0) never touch
# these streams: acceptance is an argmax comparison against the target
# logits, which makes greedy speculation bit-identical by construction.
SPEC_DRAFT_FOLD = 1
SPEC_ACCEPT_FOLD = 2
SPEC_RESIDUAL_FOLD = 3


def spec_residual_reference(p, q):
    """Reference residual distribution for rejection sampling.

    Pure-Python/numpy-friendly oracle the spec-decode tests check the
    device rule against: after a draft token from ``q`` is rejected
    against target probs ``p`` (accept prob ``min(1, p[d]/q[d])``), the
    replacement is drawn from ``normalize(max(p - q, 0))`` — the unique
    choice that makes the emitted token exactly ``p``-distributed.
    Degenerate case ``p == q`` (residual mass 0) falls back to ``p``;
    the accept probability is 1 there, so the branch is never taken on
    device.
    """
    r = [max(pi - qi, 0.0) for pi, qi in zip(p, q)]
    s = sum(r)
    if s <= 0.0:
        return list(p)
    return [ri / s for ri in r]
