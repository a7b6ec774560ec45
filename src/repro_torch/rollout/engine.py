"""Rollout batches (``repro.rollout.engine``, in part).

``RolloutBatch`` is the host-side record of one generation batch that the
trainer assembles into a ``TrainBatch``. ``rollout_batch`` builds one from
the continuous-batching engine's finished ``Request``s, as the reference's
``ServingControlPlane.rollout_batch`` does. The batched ``RolloutEngine``
itself is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.data import tokenizer as tok


@dataclasses.dataclass
class RolloutBatch:
    """One generation batch (host-side, numpy)."""

    tokens: np.ndarray         # [B, P + N] prompts + generations (PAD after)
    prompt_lengths: np.ndarray  # [B]
    gen_logp: np.ndarray       # [B, N] behavior logp of generated tokens
    gen_mask: np.ndarray       # [B, N] 1.0 up to & including EOS
    version: int = 0           # behavior policy version (stamped by caller)
    rewards: Optional[np.ndarray] = None  # [B] attached after verification
    # [B, N] per-token weight versions when generation crossed a publish;
    # None => every token was sampled at `version`
    gen_versions: Optional[np.ndarray] = None

    @property
    def batch_size(self) -> int:
        return self.tokens.shape[0]

    def min_version(self) -> int:
        """Oldest behavior version in the batch (staleness gate input)."""
        if self.gen_versions is None:
            return self.version
        stamped = self.gen_versions[self.gen_mask > 0]
        return int(stamped.min()) if stamped.size else self.version


def rollout_batch(reqs: List, prompt_pad: int, max_new: int,
                  version: int = 0) -> RolloutBatch:
    """Finished requests (``rollout.continuous.Request``) -> a stamped
    ``RolloutBatch``: prompts left-aligned and padded to ``prompt_pad``,
    generations after them, per-token version stamps from the engine.
    ``version`` stamps a request that generated nothing and the batch when
    no request generated anything; otherwise the batch carries its oldest
    token's version."""
    B = len(reqs)
    tokens = np.full((B, prompt_pad + max_new), tok.PAD, np.int32)
    lengths = np.zeros((B,), np.int32)
    gen_logp = np.zeros((B, max_new), np.float32)
    gen_mask = np.zeros((B, max_new), np.float32)
    gen_versions = np.zeros((B, max_new), np.int32)
    for i, r in enumerate(reqs):
        L = len(r.prompt)
        n = len(r.generated)
        if L > prompt_pad or n > max_new:
            raise ValueError(f"request {r.rid}: {L} prompt + {n} generated "
                             f"tokens exceed {prompt_pad} + {max_new}")
        lengths[i] = L
        tokens[i, :L] = r.prompt
        tokens[i, L: L + n] = r.generated
        gen_logp[i, :n] = r.gen_logp
        gen_mask[i, :n] = 1.0
        gen_versions[i, :n] = r.token_versions
        gen_versions[i, n:] = r.token_versions[-1] if n else version
    batch_version = int(gen_versions[gen_mask > 0].min()) \
        if B and gen_mask.any() else version
    return RolloutBatch(tokens=tokens, prompt_lengths=lengths,
                        gen_logp=gen_logp, gen_mask=gen_mask,
                        version=batch_version, gen_versions=gen_versions)
