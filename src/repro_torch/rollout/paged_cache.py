"""Paged KV cache and the SSM state slot pool
(``repro.rollout.paged_cache``).

Layout:
  pool_k/pool_v : [n_attn_layers, n_blocks, block_size, KV, hd]
  block_tables  : [max_seqs, max_blocks_per_seq] int32 (-1 = unmapped)
  seq_lens      : [max_seqs] int32
  ssm conv      : [n_ssm_layers, max_seqs, d_conv-1, conv_dim]
  ssm state     : [n_ssm_layers, max_seqs, nh, hd, d_state] float32

Unlike the JAX package's immutable arrays, the port updates the pools,
tables and lengths in place (no second pool is ever allocated); the
functions still return the state so call sites read like the reference.
Block and slot bookkeeping is on the host (``BlockAllocator``,
``SSMSlotPool``, and the engine's numpy mirrors of the tables and
lengths).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import layout


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
    """One pool layer per attention layer: an attention-free (pure SSM)
    stack gets a zero-layer pool, so the block and length bookkeeping stays
    the same for every family at no memory cost."""
    if cfg.mla is not None or cfg.arch_type not in ("dense", "ssm",
                                                    "hybrid"):
        raise NotImplementedError("paged cache: GQA/MHA attention, SSM and "
                                  "hybrid stacks only")
    shape = (layout(cfg)[0], n_blocks, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return PagedCacheState(
        pool_k=torch.zeros(shape, dtype=dtype, device=device),
        pool_v=torch.zeros(shape, dtype=dtype, device=device),
        block_tables=torch.full((max_seqs, max_blocks_per_seq), -1,
                                dtype=torch.int32, device=device),
        seq_lens=torch.zeros((max_seqs,), dtype=torch.int32, device=device),
    )


# -------------------------------------------------------------- device ops
def write_token(state: PagedCacheState, layer: int, k: torch.Tensor,
                v: torch.Tensor, slot_ids: torch.Tensor) -> PagedCacheState:
    """Write one token's K/V for active slots, in place.

    k, v: [B_active, KV, hd]; slot_ids: [B_active] rows of block_tables.
    The target block/offset come from seq_lens (position = current len).
    Unmapped (-1) positions are routed to the scratch block, the last pool
    block, which the engine reserves as a write sink, never to live block
    0: a bookkeeping bug then wastes a write instead of corrupting KV.
    """
    slot_ids = torch.as_tensor(slot_ids, device=state.seq_lens.device).long()
    bs = state.block_size
    lens = state.seq_lens[slot_ids].long()
    blocks = state.block_tables[slot_ids, lens // bs].long()
    unmapped = blocks < 0
    blocks = torch.where(unmapped, state.pool_k.shape[1] - 1, blocks)
    offset = torch.where(unmapped, 0, lens % bs)
    state.pool_k[layer, blocks, offset] = k.to(state.pool_k.dtype)
    state.pool_v[layer, blocks, offset] = v.to(state.pool_v.dtype)
    return state


def gather_kv(state: PagedCacheState, layer: int, slot_ids: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-slot K/V views [B, max_blocks*bs, KV, hd] and validity [B,
    max_blocks*bs]: a gather over the block pool (the plain form of the
    paged kernels' block-table walk). Tokens in unmapped blocks are never
    valid: the length bound covers them."""
    slot_ids = torch.as_tensor(slot_ids, device=state.seq_lens.device).long()
    bs = state.block_size
    tables = state.block_tables[slot_ids].long()     # [B, max_blocks]
    safe = tables.clamp_min(0)
    k = state.pool_k[layer][safe]                    # [B, mb, bs, KV, hd]
    v = state.pool_v[layer][safe]
    B, mb = tables.shape
    k = k.reshape(B, mb * bs, *k.shape[3:])
    v = v.reshape(B, mb * bs, *v.shape[3:])
    lens = state.seq_lens[slot_ids]
    valid = (torch.arange(mb * bs, device=lens.device)[None, :]
             < lens[:, None])
    return k, v, valid


def bump_lens(state: PagedCacheState, slot_ids: torch.Tensor
              ) -> PagedCacheState:
    """Advance the lengths of ``slot_ids`` by one token, in place."""
    slot_ids = torch.as_tensor(slot_ids, device=state.seq_lens.device).long()
    state.seq_lens.index_add_(0, slot_ids, torch.ones_like(
        slot_ids, dtype=state.seq_lens.dtype))
    return state


# ------------------------------------------------------------ SSM state pool
@dataclasses.dataclass
class SSMStateCache:
    """Constant-size per-slot recurrent state for SSM/hybrid decode.

    Unlike KV, Mamba2 state does not grow with the sequence, so no block
    table is needed: engine slot ``i`` owns row ``i`` of each pool.

      conv  : [n_ssm_layers, max_seqs, d_conv-1, conv_dim]  (model dtype)
      state : [n_ssm_layers, max_seqs, nh, hd, d_state]     (float32)

    The engine updates both in place.
    """
    conv: torch.Tensor
    state: torch.Tensor

    @property
    def max_seqs(self) -> int:
        return self.conv.shape[1]

    @property
    def n_layers(self) -> int:
        return self.conv.shape[0]


def init_ssm_state_cache(cfg: ModelConfig, *, max_seqs: int,
                         dtype: torch.dtype, device) -> SSMStateCache:
    if cfg.ssm is None:
        raise ValueError("SSM state cache needs cfg.ssm")
    s, d = cfg.ssm, cfg.d_model
    n_ssm = layout(cfg)[1]
    conv_dim = s.d_inner(d) + 2 * s.d_state
    return SSMStateCache(
        conv=torch.zeros((n_ssm, max_seqs, s.d_conv - 1, conv_dim),
                         dtype=dtype, device=device),
        state=torch.zeros((n_ssm, max_seqs, s.num_heads(d), s.head_dim,
                           s.d_state), dtype=torch.float32, device=device))


def ssm_reset_slots(cache: SSMStateCache, slots) -> SSMStateCache:
    """Zero the conv window and state of ``slots`` (fresh sequences), in
    place."""
    idx = torch.as_tensor(slots, dtype=torch.long, device=cache.conv.device)
    cache.conv[:, idx] = 0
    cache.state[:, idx] = 0.0
    return cache


def ssm_fork_slot(cache: SSMStateCache, src: int, dst: int) -> SSMStateCache:
    """Clone slot ``src``'s recurrent state into ``dst``, in place: the SSM
    analogue of ``fork_block`` (state is private per slot, so a fork is a
    plain copy)."""
    cache.conv[:, dst] = cache.conv[:, src]
    cache.state[:, dst] = cache.state[:, src]
    return cache


class SSMSlotPool:
    """Host-side lifecycle mirror for SSM-state slots.

    Constant-size state needs no free list (slot ids are the engine's
    own), but the lifecycle mirrors ``BlockAllocator``'s: map on admit,
    release on finish or preemption (a released slot is zeroed again
    before reuse), fork when a mapped slot's state is cloned. Double map
    and double release fail as assertions at once, as the KV path's
    refcount errors do.
    """

    def __init__(self, max_seqs: int):
        self.max_seqs = max_seqs
        self.mapped: set = set()
        self.forks = 0  # state clones performed (metrics)

    def map(self, slot: int) -> None:
        assert 0 <= slot < self.max_seqs, f"SSM slot {slot} out of range"
        assert slot not in self.mapped, f"double map of SSM slot {slot}"
        self.mapped.add(slot)

    def release(self, slot: int) -> None:
        assert slot in self.mapped, f"release of unmapped SSM slot {slot}"
        self.mapped.discard(slot)

    def fork(self, src: int, dst: int) -> None:
        assert src in self.mapped, f"fork from unmapped SSM slot {src}"
        self.map(dst)
        self.forks += 1

    def is_mapped(self, slot: int) -> bool:
        return slot in self.mapped

    @property
    def n_free(self) -> int:
        return self.max_seqs - len(self.mapped)


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
