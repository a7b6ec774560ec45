"""Batched autoregressive rollout engine (``repro.rollout.engine``).

``RolloutEngine.generate`` prefills the (right-padded, ragged) prompts
into a dense cache, then runs ``max_new`` steps of on-device sampling and
``decode_step``, and returns the sequences, per-token behaviour log-probs
and the response mask, stamped with the policy version the async runtime
gives it. It serves every stack the paged engine serves and the MoE and
MLA stacks, which only it serves (as in the reference); a frontend
(vision, audio) stack raises, since the engine is given no frontend
embeddings. The loop makes one device-to-host transfer, at its end. Weights
are passed per call: the async runtime swaps them under the engine, as an
inference engine receiving weight updates.

``RolloutBatch`` is the host-side record of one generation batch that the
trainer assembles into a ``TrainBatch``. ``rollout_batch`` builds one from
the continuous-batching engine's finished ``Request``s, as the reference's
``ServingControlPlane.rollout_batch`` does.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RLConfig
from repro_torch.data import tokenizer as tok
from repro_torch.models import model as M
from repro_torch.models.layers import logits_from_hidden
from repro_torch.obs.tracing import span
from repro_torch.rollout.sampler import fused_sample_step


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
    A request that generated nothing is stamped with its
    ``submit_version``, as the reference does; ``version`` stamps the batch
    when no request generated anything, otherwise the batch carries its
    oldest token's version."""
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
        gen_versions[i, n:] = r.token_versions[-1] if n else r.submit_version
    batch_version = int(gen_versions[gen_mask > 0].min()) \
        if B and gen_mask.any() else version
    return RolloutBatch(tokens=tokens, prompt_lengths=lengths,
                        gen_logp=gen_logp, gen_mask=gen_mask,
                        version=batch_version, gen_versions=gen_versions)


@torch.no_grad()
def _generate(params, cfg: ModelConfig, prompts: torch.Tensor,
              prompt_lengths: torch.Tensor,
              generator: Optional[torch.Generator], max_new: int,
              temperature: float, top_p: float,
              greedy: bool = False) -> torch.Tensor:
    """The device side of ``generate`` (the reference's ``_generate_jit``):
    prompts [B,P] int64 and prompt_lengths [B] int32 on the device ->
    float64 [3, B, max_new] of (token, behaviour logp, mask). Nothing here
    reads a device value on the host."""
    B, P = prompts.shape
    with span("prefill", batch=B, tokens=P):
        hidden, cache = M.prefill(params, cfg, prompts,
                                  lengths=prompt_lengths,
                                  max_len=P + max_new)
        rows = torch.arange(B, device=prompts.device)
        last_h = hidden[rows, prompt_lengths.long() - 1]
        logits = logits_from_hidden(params["embedding"], last_h, cfg)
    layers = M.unstack_model(params, cfg)
    done = torch.zeros((B,), dtype=torch.bool, device=prompts.device)
    steps = []
    for t in range(max_new):
        with span("decode_step", step=t):
            token, logp, mask, done = fused_sample_step(
                logits, generator, done, temperature=temperature,
                top_p=top_p, greedy=greedy)
            logits, cache = M.decode_step(params, cfg, cache, token,
                                          layers=layers)
            steps.append(torch.stack([token.double(), logp.double(),
                                      mask.double()]))
    return torch.stack(steps, dim=-1)


class RolloutEngine:
    """Holds generation settings; weights are passed per call (the async
    runtime swaps them under us, exactly like an inference engine receiving
    weight updates). They run on the device they lie on."""

    def __init__(self, cfg: ModelConfig, rl: Optional[RLConfig] = None,
                 max_new_tokens: int = 16):
        self.cfg = cfg
        self.rl = rl or RLConfig()
        self.max_new_tokens = max_new_tokens

    def generate(self, params, prompts: np.ndarray,
                 prompt_lengths: np.ndarray,
                 generator: Optional[torch.Generator] = None, *,
                 version: int = 0, greedy: bool = False) -> RolloutBatch:
        """prompts [B,P] right-padded, prompt_lengths [B] -> a stamped
        ``RolloutBatch``. ``generator`` (on the weights' device) drives the
        sampling, as the reference's key; ``greedy`` ignores it."""
        device = params["embedding"]["embed"].device
        with span("rollout_generate", batch=int(prompts.shape[0]),
                  max_new=self.max_new_tokens, version=version):
            packed = _generate(
                params, self.cfg,
                torch.as_tensor(np.asarray(prompts), dtype=torch.long)
                .to(device),
                torch.as_tensor(np.asarray(prompt_lengths),
                                dtype=torch.int32).to(device),
                generator, self.max_new_tokens, self.rl.temperature,
                self.rl.top_p, greedy)
            out = packed.cpu().numpy()  # the one device-to-host transfer
        toks = out[0].astype(np.int32)
        B, P = prompts.shape
        N = toks.shape[1]
        full = np.concatenate([np.asarray(prompts, np.int32),
                               np.full((B, N), tok.PAD, np.int32)], axis=1)
        # place generated tokens right after each ragged prompt
        cols = np.asarray(prompt_lengths, np.int64)[:, None] + np.arange(N)
        np.put_along_axis(full, cols, toks, axis=1)
        return RolloutBatch(
            tokens=full,
            prompt_lengths=np.asarray(prompt_lengths),
            gen_logp=out[1].astype(np.float32),
            gen_mask=out[2].astype(np.float32),
            version=version,
        )

    def completions(self, batch: RolloutBatch) -> list:
        """Generated token ids per sequence (the tokens after each
        prompt; decoding stops at EOS)."""
        N = batch.gen_logp.shape[1]
        return [batch.tokens[b, L: L + N]
                for b, L in enumerate(np.asarray(batch.prompt_lengths))]
