"""Character-level tokenizer for the synthetic math tasks.

GSM8K / DAPO-Math-17k are unavailable offline; the toy task family uses a
small closed vocabulary so end-to-end RL runs on CPU. IDs 0-3 are special.
"""
from __future__ import annotations

from typing import List

PAD, BOS, EOS, SEP = 0, 1, 2, 3
_CHARS = "0123456789+-*=() ."
CHAR_TO_ID = {c: i + 4 for i, c in enumerate(_CHARS)}
ID_TO_CHAR = {i: c for c, i in CHAR_TO_ID.items()}
VOCAB_SIZE = 4 + len(_CHARS)  # 22 (toy model vocab 64 leaves headroom)


def encode(text: str, add_bos: bool = False) -> List[int]:
    ids = [BOS] if add_bos else []
    ids.extend(CHAR_TO_ID[c] for c in text)
    return ids


def decode(ids, stop_at_eos: bool = True) -> str:
    out = []
    for i in ids:
        i = int(i)
        if i == EOS and stop_at_eos:
            break
        if i in (PAD, BOS, SEP):
            continue
        out.append(ID_TO_CHAR.get(i, "?"))
    return "".join(out)
