"""Paged KV cache, dense parts (``repro.rollout.paged_cache``).

Layout:
  pool_k/pool_v : [n_layers, n_blocks, block_size, KV, hd]
  block_tables  : [max_seqs, max_blocks_per_seq] int32 (-1 = unmapped)
  seq_lens      : [max_seqs] int32

Unlike the JAX package's immutable arrays, the port updates the pool,
tables and lengths in place (no second pool is ever allocated); the
functions still return the state so call sites read like the reference.
Block bookkeeping is on the host (``BlockAllocator``, and the engine's
numpy mirrors of the tables and lengths).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class PagedCacheState:
    pool_k: torch.Tensor
    pool_v: torch.Tensor
    block_tables: torch.Tensor  # [max_seqs, max_blocks] int32
    seq_lens: torch.Tensor      # [max_seqs] int32

    @property
    def block_size(self) -> int:
        return self.pool_k.shape[2]

    @property
    def max_blocks(self) -> int:
        return self.block_tables.shape[1]


class BlockAllocator:
    """Host-side free-list over pool blocks (shared across layers).

    Blocks are reference-counted so the radix prefix cache and multiple
    sequences can share one physical block. ``alloc`` hands out blocks at
    refcount 1; ``release`` decrements and only returns a block to the free
    list when its count reaches zero.
    """

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self.free: List[int] = list(range(n_blocks - 1, -1, -1))
        self.refcount: Dict[int, int] = {}
        self.forks = 0  # copy-on-write forks performed (metrics)

    def alloc(self, n: int) -> List[int]:
        if len(self.free) < n:
            raise RuntimeError(f"paged cache OOM: need {n} blocks, "
                               f"have {len(self.free)}")
        blocks = [self.free.pop() for _ in range(n)]
        for b in blocks:
            self.refcount[b] = 1
        return blocks

    def incref(self, block: int) -> None:
        assert block in self.refcount, f"incref of unallocated block {block}"
        self.refcount[block] += 1

    def decref(self, block: int) -> bool:
        """Drop one reference; returns True when the block was freed."""
        rc = self.refcount.get(block)
        assert rc is not None and rc > 0, \
            f"decref of unallocated block {block}"
        if rc == 1:
            del self.refcount[block]
            self.free.append(block)
            return True
        self.refcount[block] = rc - 1
        return False

    def refs(self, block: int) -> int:
        return self.refcount.get(block, 0)

    def release(self, blocks: List[int]) -> None:
        for b in blocks:
            if b >= 0:
                self.decref(b)

    @property
    def n_free(self) -> int:
        return len(self.free)


def init_paged_cache(cfg: ModelConfig, *, n_blocks: int, block_size: int,
                     max_seqs: int, max_blocks_per_seq: int,
                     dtype: torch.dtype, device) -> PagedCacheState:
    if cfg.mla is not None or cfg.arch_type != "dense":
        raise NotImplementedError("paged cache: dense GQA/MHA stacks only")
    shape = (cfg.num_layers, n_blocks, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return PagedCacheState(
        pool_k=torch.zeros(shape, dtype=dtype, device=device),
        pool_v=torch.zeros(shape, dtype=dtype, device=device),
        block_tables=torch.full((max_seqs, max_blocks_per_seq), -1,
                                dtype=torch.int32, device=device),
        seq_lens=torch.zeros((max_seqs,), dtype=torch.int32, device=device),
    )


def _set_row(state: PagedCacheState, slot: int, table: np.ndarray,
             length: int) -> None:
    state.block_tables[slot] = torch.from_numpy(table).to(
        state.block_tables.device)
    state.seq_lens[slot] = length


def map_sequence(state: PagedCacheState, allocator: BlockAllocator,
                 slot: int, n_tokens: int) -> PagedCacheState:
    """Allocate blocks for a new sequence of n_tokens (prefill) + growth."""
    n_needed = -(-n_tokens // state.block_size)
    if n_needed > state.max_blocks:
        raise RuntimeError("sequence exceeded max_blocks_per_seq")
    table = np.full((state.max_blocks,), -1, np.int32)
    table[:n_needed] = allocator.alloc(n_needed)
    _set_row(state, slot, table, 0)
    return state


def map_sequence_prefixed(state: PagedCacheState, allocator: BlockAllocator,
                          slot: int, prefix_blocks: List[int],
                          n_prefix_tokens: int, n_tokens: int
                          ) -> PagedCacheState:
    """Map a sequence whose first ``n_prefix_tokens`` live in shared blocks.

    ``prefix_blocks`` must already carry a reference for this sequence (the
    prefix cache increfs on match); only the remainder of the table is
    freshly allocated, and ``seq_lens`` starts at ``n_prefix_tokens``.
    """
    n_needed = -(-n_tokens // state.block_size)
    assert n_needed <= state.max_blocks, "sequence exceeds max_blocks_per_seq"
    assert len(prefix_blocks) <= n_needed, (prefix_blocks, n_tokens)
    fresh = allocator.alloc(n_needed - len(prefix_blocks))
    table = np.full((state.max_blocks,), -1, np.int32)
    table[: len(prefix_blocks)] = prefix_blocks
    table[len(prefix_blocks): n_needed] = fresh
    _set_row(state, slot, table, n_prefix_tokens)
    return state


def ensure_capacity(state: PagedCacheState, allocator: BlockAllocator,
                    slot: int) -> PagedCacheState:
    """Grow the sequence's table by one block if the next token needs it
    (reads the slot's length back from the device)."""
    block_idx = int(state.seq_lens[slot]) // state.block_size
    if block_idx >= state.max_blocks:
        raise RuntimeError("sequence exceeded max_blocks_per_seq")
    if int(state.block_tables[slot, block_idx]) < 0:
        (blk,) = allocator.alloc(1)
        state.block_tables[slot, block_idx] = blk
    return state


def write_range(length: int, n_tokens: int, block_size: int,
                max_blocks: int) -> Tuple[int, int]:
    """(first, last) block indices the next ``n_tokens`` writes of a
    sequence at ``length`` will touch — the single definition both the
    headroom estimate and the actual allocation use."""
    first = length // block_size
    last = (length + n_tokens - 1) // block_size
    if last >= max_blocks:
        raise RuntimeError("sequence exceeded max_blocks_per_seq")
    return first, last


def alloc_horizon_blocks(allocator: BlockAllocator, tables: np.ndarray,
                         lens: np.ndarray, slot_tokens: Dict[int, int],
                         block_size: int) -> bool:
    """Pre-map every block the next ``n`` writes of each slot will touch.

    ``tables``/``lens`` are the caller's host mirrors, edited in place (no
    device readback); the caller pushes the mirror to the device once if
    this returns True (at least one block was mapped).
    """
    changed = False
    for slot, n_tokens in slot_tokens.items():
        if n_tokens <= 0:
            continue
        first, last = write_range(int(lens[slot]), n_tokens, block_size,
                                  tables.shape[1])
        for i in range(first, last + 1):
            if tables[slot, i] < 0:
                (blk,) = allocator.alloc(1)
                tables[slot, i] = blk
                changed = True
    return changed


def fork_block(state: PagedCacheState, allocator: BlockAllocator,
               block: int) -> Tuple[PagedCacheState, int]:
    """Copy-on-write: clone ``block`` into a fresh private block across all
    layers and drop one reference on the shared original."""
    (new,) = allocator.alloc(1)
    state.pool_k[:, new] = state.pool_k[:, block]
    state.pool_v[:, new] = state.pool_v[:, block]
    allocator.decref(block)
    allocator.forks += 1
    return state, new


def ensure_writable(state: PagedCacheState, allocator: BlockAllocator,
                    slot: int) -> PagedCacheState:
    """CoW guard: fork the block the next token writes into if shared."""
    block_idx = int(state.seq_lens[slot]) // state.block_size
    if block_idx >= state.max_blocks:
        return state  # ensure_capacity raises the real error
    blk = int(state.block_tables[slot, block_idx])
    if blk >= 0 and allocator.refs(blk) > 1:
        state, new = fork_block(state, allocator, blk)
        state.block_tables[slot, block_idx] = new
    return state


def release_sequence(state: PagedCacheState, allocator: BlockAllocator,
                     slot: int) -> PagedCacheState:
    table = state.block_tables[slot].cpu().numpy()
    allocator.release([int(b) for b in table if b >= 0])
    _set_row(state, slot, np.full((state.max_blocks,), -1, np.int32), 0)
    return state
