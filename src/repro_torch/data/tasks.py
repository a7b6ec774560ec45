"""Synthetic verifiable math tasks (the offline GSM8K stand-in); a copy of
``repro.data.tasks``, numpy only.

Each task yields (prompt, verifier). Rewards are binary exact-match like the
paper's math verifiers; prompts are uniform-length (right padding inside the
prompt region) so batched generation is rectangular.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.data import tokenizer as tok


@dataclasses.dataclass
class TaskBatch:
    prompts: np.ndarray        # [B, P] int32, right-padded with PAD
    prompt_lengths: np.ndarray  # [B]
    answers: List[str]


class ArithmeticTask:
    """Multi-step addition/subtraction chains, e.g. '12+34-5=' -> '41'."""

    def __init__(self, max_operand: int = 99, n_terms: int = 2,
                 prompt_len: int = 16, max_answer_len: int = 6,
                 seed: int = 0):
        self.max_operand = max_operand
        self.n_terms = n_terms
        self.prompt_len = prompt_len
        self.max_answer_len = max_answer_len
        self.rng = np.random.default_rng(seed)

    def sample(self, n: int) -> TaskBatch:
        prompts = np.full((n, self.prompt_len), tok.PAD, np.int32)
        lengths = np.zeros((n,), np.int32)
        answers: List[str] = []
        for i in range(n):
            terms = self.rng.integers(0, self.max_operand + 1,
                                      size=self.n_terms)
            ops = self.rng.choice(["+", "-"], size=self.n_terms - 1)
            expr = str(terms[0])
            val = int(terms[0])
            for t, op in zip(terms[1:], ops):
                expr += op + str(t)
                val = val + int(t) if op == "+" else val - int(t)
            text = expr + "="
            ids = tok.encode(text, add_bos=True)
            assert len(ids) <= self.prompt_len, (text, self.prompt_len)
            prompts[i, : len(ids)] = ids
            lengths[i] = len(ids)
            answers.append(str(val))
        return TaskBatch(prompts, lengths, answers)

    def reward(self, completion_ids, answer: str) -> float:
        return 1.0 if tok.decode(completion_ids) == answer else 0.0

    def rewards(self, completions: np.ndarray, answers: List[str]
                ) -> np.ndarray:
        return np.array([self.reward(c, a)
                         for c, a in zip(completions, answers)], np.float32)

    # ------------------------------------------------------------ SFT warmup
    def sft_batch(self, n: int, total_len: int):
        """Supervised sequences 'a+b=c<EOS>' for base-policy warmup.

        Returns (tokens [n, total_len], loss_mask [n, total_len-1]) where the
        mask covers answer tokens only (mirrors instruct-tuning a base model
        before RL, as the paper's setups assume).
        """
        batch = self.sample(n)
        tokens = np.full((n, total_len), tok.PAD, np.int32)
        mask = np.zeros((n, total_len - 1), np.float32)
        for i in range(n):
            p = batch.prompts[i, : batch.prompt_lengths[i]]
            ans = tok.encode(batch.answers[i]) + [tok.EOS]
            seq = list(p) + ans
            seq = seq[:total_len]
            tokens[i, : len(seq)] = seq
            lo = int(batch.prompt_lengths[i]) - 1  # predict first answer tok
            hi = min(len(seq) - 1, total_len - 1)
            mask[i, lo:hi] = 1.0
        return tokens, mask
