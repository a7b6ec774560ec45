"""Token sampling: temperature + top-p, returning behavior log-probs
(``repro.rollout.sampler``).

The behavior log-prob is recorded under the *tempered* distribution (the
actual sampling policy). A ``torch.Generator`` replaces the JAX key: every
sampled step draws one ``[B, V]`` block of uniforms from it, so a fused
horizon and the same number of single steps consume identical draws. The
draws are not JAX's threefry bits; sampled runs are reproducible within
the port, and parity with JAX is greedy only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.data import tokenizer as tok


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 *, temperature: float = 1.0, top_p: float = 1.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [B, V] -> (token [B] int64, behav_logp [B] float32).

    Categorical draw by the Gumbel-max trick (argmax of logits plus
    Gumbel noise), which needs no host synchronisation."""
    logits = logits.float() / max(temperature, 1e-6)
    logp_full = torch.log_softmax(logits, dim=-1)
    if top_p < 1.0:
        logits = top_p_filter(logits, top_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    token = torch.argmax(logits + gumbel, dim=-1)
    return token, logp_full.gather(-1, token[:, None])[:, 0]


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """logits [B, V] float32 with every token outside the row's nucleus
    (the smallest prefix, by descending logit, whose cumulative mass
    reaches ``top_p``) set to -inf. Where rounding leaves the whole row's
    mass below ``top_p`` the cutoff is the smallest logit and nothing is
    masked, as in the reference, whose out-of-range take fills NaN there
    (an index past V would be a device-side assert on the card)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp_max(
        logits.shape[-1] - 1)
    cutoff = sorted_logits.gather(-1, cutoff_idx)
    return torch.where(logits < cutoff, -torch.inf, logits)


def greedy_token(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    logp_full = torch.log_softmax(logits.float(), dim=-1)
    token = torch.argmax(logits, dim=-1)
    return token, logp_full.gather(-1, token[:, None])[:, 0]


def fused_sample_step(logits: torch.Tensor,
                      generator: Optional[torch.Generator],
                      done: torch.Tensor, *, temperature: float = 1.0,
                      top_p: float = 1.0, greedy: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """One on-device step of a fused decode loop.

    Samples a token per row, masks rows that already finished (PAD token,
    zero logp, zero mask) and folds the EOS check into the done flags.

    logits [B,V]; done [B] bool -> (token [B], logp [B], mask [B] f32,
    done' [B]). ``mask`` is 1.0 exactly where a token was emitted (up to
    and including EOS); ``greedy`` ignores ``generator``.
    """
    if greedy:
        token, logp = greedy_token(logits)
    else:
        token, logp = sample_token(logits, generator, temperature=temperature,
                                   top_p=top_p)
    token = torch.where(done, tok.PAD, token)
    logp = torch.where(done, 0.0, logp)
    mask = (~done).float()
    done = done | (token == tok.EOS)
    return token, logp, mask, done
