"""The one generator of training traffic: a pool of GRPO batches drawn
from a traffic file's parameters and a seed.

A batch is ``prompts`` prompts, each answered ``group`` times, padded to
``row_len`` tokens a row. The sizes are fixed by the file and not by the
seed, and are the same in every batch of the pool, so every seed does the
same work in every step: the prompt lengths are the ``prompts``
quantiles of their distribution, the response lengths the ``prompts x
group`` quantiles of theirs, group j taking prompt j and every
``prompts``-th response from j. A response is cut so that its row fits
``row_len``. The seed draws the order of the groups and of the rows in a
group, the token ids, each row's staleness (uniform over ``staleness``),
the Bernoulli rewards and the behaviour log-probs' drift.
"""
from __future__ import annotations

from statistics import NormalDist
from typing import Dict, List

import numpy as np


def _quantiles(spec: dict, n: int) -> np.ndarray:
    """The n quantiles (i + 1/2) / n of a length distribution."""
    q = (np.arange(n) + 0.5) / n
    if spec["dist"] == "uniform":
        return np.rint(spec["low"] + q * (spec["high"] - spec["low"]))
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in q])
        return np.rint(spec["median"] * np.exp(spec["sigma"] * z))
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def sizes(tr: dict) -> List[tuple]:
    """Per group of a batch: (prompt length, [response lengths]); the
    same for every batch and every seed."""
    n, g, T = tr["prompts"], tr["group"], tr["row_len"]
    prompt = _quantiles(tr["prompt_len"], n).astype(int)
    resp = _quantiles(tr["response_len"], n * g).astype(int)
    return [(int(prompt[j]), [int(min(max(r, 1), T - prompt[j]))
                              for r in resp[j::n]]) for j in range(n)]


def generate(tr: dict, vocab: int, seed: int) -> List[Dict[str, np.ndarray]]:
    """The pool: per slot ``tokens`` [B, T] int64 (0 past each row's end),
    ``prompt`` and ``lengths`` [B], ``mask`` [B, T-1] float32 (1 where
    column t predicts a response token t + 1), ``stale`` [B] int,
    ``rewards`` [B] float32 and ``drift`` [B, T-1] float32 (standard
    normal draws that scale the behaviour log-probs' departure)."""
    rng = np.random.default_rng(int(seed))
    T = tr["row_len"]
    slot = sizes(tr)
    pool = []
    for _ in range(tr["pool"]):
        rows = []
        for j in rng.permutation(len(slot)):
            p, rs = slot[j]
            prompt = rng.integers(1, vocab, size=p)
            for i in rng.permutation(len(rs)):
                rows.append((prompt, rng.integers(1, vocab, size=rs[i])))
        B = len(rows)
        tokens = np.zeros((B, T), np.int64)
        mask = np.zeros((B, T - 1), np.float32)
        plen = np.zeros(B, np.int64)
        for r, (prompt, resp) in enumerate(rows):
            p, n = len(prompt), len(resp)
            tokens[r, :p], tokens[r, p:p + n] = prompt, resp
            mask[r, p - 1:p + n - 1] = 1.0
            plen[r] = p
        lo, hi = tr["staleness"]["low"], tr["staleness"]["high"]
        pool.append({
            "tokens": tokens, "prompt": plen,
            "lengths": plen + mask.sum(1).astype(np.int64), "mask": mask,
            "stale": rng.integers(lo, hi + 1, size=B),
            "rewards": rng.binomial(1, tr["reward_p"], size=B).astype(
                np.float32),
            "drift": rng.standard_normal((B, T - 1)).astype(np.float32)})
    return pool


def real_tokens(batch: Dict[str, np.ndarray]) -> int:
    """Non-padding tokens (prompt and response) of a batch."""
    return int(batch["lengths"].sum())


def rows_count(tr: dict) -> int:
    return tr["prompts"] * tr["group"]

