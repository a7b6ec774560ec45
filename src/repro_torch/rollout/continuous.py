"""Continuous batching server over the paged KV cache
(``repro.rollout.continuous``).

Requests are admitted into fixed slots as others finish; finished
sequences release their pages back to the allocator. Prompts stream
through the chunked prefill lane (segment-packed chunks of at most
``prefill_chunk`` tokens, resumable across launches), and decoding runs
either one token per ``step`` or ``decode_horizon`` tokens per
``step_horizon`` with a single device-to-host drain per horizon.

Dense attention stacks, pure SSM stacks (mamba2: a constant-size per-slot
state pool instead of KV blocks, beside a zero-layer KV pool) and hybrid
stacks (zamba2: SSM state slots plus the paged pool for the shared
attention layers) are served. SSM layers decode through the SSD decode
kernel op and prefill through the chunked SSD scan, one batch row per
prefilling slot.

The entry points (``run``, ``step``, ``step_horizon``, ``prefill_step``)
run under ``torch.no_grad()``: serving weights that require gradients (the
trainer's) records no autograd graph.

Attention always takes the paged path: every decoded token and every
prefill chunk attends through the block table with the paged kernels
(``paged_decode_attention_op`` / ``paged_prefill_attention_op``), on the
card and, through their plain versions, on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RLConfig
from repro_torch.data import tokenizer as tok
from repro_torch.kernels.decode_attn.ops import paged_decode_attention_op
from repro_torch.kernels.prefill_attn.ops import paged_prefill_attention_op
from repro_torch.models import blocks
from repro_torch.models import model as M
from repro_torch.models.attention import project_qkv
from repro_torch.models.layers import (
    apply_rope,
    embed_tokens,
    logits_from_hidden,
    rmsnorm,
    swiglu,
)
from repro_torch.models.model import require_device, torch_dtype
from repro_torch.obs.tracing import annotate, span
from repro_torch.rollout import paged_cache as pc
from repro_torch.rollout.sampler import (
    fused_sample_step,
    greedy_token,
    sample_token,
)


@dataclasses.dataclass
class Request:
    """A generation request and what the engine and the serving control
    plane (``repro_torch.serving``) record for it."""
    rid: int
    prompt: np.ndarray           # [P] token ids (unpadded)
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # --- staleness-aware control plane bookkeeping -----------------------
    # behavior logprob of each generated token (under the params that
    # produced its logits) and the weight version of those params: the
    # per-token [B, T] stamps a3po.staleness consumes.
    gen_logp: List[float] = dataclasses.field(default_factory=list)
    token_versions: List[int] = dataclasses.field(default_factory=list)
    priority: int = 0            # scheduler class (lower = more urgent)
    submit_version: int = 0      # weight version when the request arrived
    prefix_hit_tokens: int = 0   # prompt tokens served from the radix cache
    preempt_count: int = 0
    # chunked-prefill cursor: prompt tokens whose K/V is resident in the
    # paged pool (radix hits count). The slot only enters the decode lane
    # once prefill_done.
    prefill_pos: int = 0
    # lifecycle stamps (control-plane clock; -1 = unset)
    t_submit: float = -1.0
    t_admit: float = -1.0
    t_first_token: float = -1.0
    t_done: float = -1.0
    # --- multi-tenant / SLO bookkeeping ----------------------------------
    tenant: str = ""
    slo_class: str = ""          # SLO class name (stamped by SLO scheduler)
    deadline_s: float = float("inf")  # absolute TTFT deadline (clock time)
    drop_reason: str = ""        # staleness_budget | max_preempts | slo_shed

    @property
    def prefill_done(self) -> bool:
        return self.prefill_pos >= len(self.prompt)

    def min_version(self) -> int:
        return min(self.token_versions) if self.token_versions \
            else self.submit_version

    def reset_generation(self) -> None:
        """Discard sampled state for a fresh restart (preempt/resubmit).

        The first-token stamp is cleared too: a restarted request lost
        its partial generation, so the first token the caller actually
        receives is the one after the restart (TTFT re-observes).
        """
        self.generated = []
        self.gen_logp = []
        self.token_versions = []
        self.done = False
        self.prefill_pos = 0
        self.t_first_token = -1.0


# attend(li, q [R,H,hd], k [R,KV,hd], v [R,KV,hd]) -> o [R,H,hd]
AppendAttend = Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor],
                        torch.Tensor]


def _layers(params, cfg: ModelConfig) -> List[M.Layer]:
    return M.unstack_model(params, cfg)


def _attn_token_layer(lp, x: torch.Tensor, cfg: ModelConfig,
                      pos: torch.Tensor, li: int,
                      append_attend: AppendAttend) -> torch.Tensor:
    """One attention block over rows x [R, d] at positions pos [R, 1];
    ``append_attend`` owns the KV cache of attention layer ``li``."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    ap = lp["attn"]
    q, k, v = project_qkv(ap, h, cfg)
    H = cfg.num_heads
    # one rope over q‖k: positions (and their sin/cos) are shared
    qk = apply_rope(torch.cat([q, k], dim=1)[:, None], pos,
                    cfg.rope_theta)[:, 0]
    o = append_attend(li, qk[:, :H].contiguous(), qk[:, H:], v)
    y = torch.einsum("bhk,hkd->bd", o, ap["wo"])
    if cfg.parallel_block:
        return x + y + swiglu(lp["ffn"], h)
    x = x + y
    return x + swiglu(lp["ffn"], rmsnorm(lp["ln2"], x, cfg.norm_eps))


def _token_layer_stack(params, layers: List[M.Layer], cfg: ModelConfig,
                       positions: torch.Tensor, tokens: torch.Tensor,
                       append_attend: AppendAttend,
                       ssm: Optional[pc.SSMStateCache] = None,
                       update: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """One-token-per-row stack shared by the decode and prefill towers of
    every family (the reference's ``_token_layer_stack`` and
    ``_multiarch_token_stack``): rows are slots (decode) or chunk rows
    (prefill), each at its own ``positions``. ``append_attend`` owns the KV
    cache: it writes the row's K/V into the pool and attends through the
    block table. SSM layers advance the slot rows of the ``ssm`` pools in
    place; ``update`` [S] bool gates that, so a masked slot carries its
    conv window and state through bit for bit (the SSM analogue of parking
    a KV append on the scratch block). Returns the final-normed hidden
    [R, d]."""
    x = embed_tokens(params["embedding"], tokens, cfg)
    pos = positions[:, None]
    if ssm is not None:
        convs = torch.unbind(ssm.conv, 0)
        states = torch.unbind(ssm.state, 0)
    for kind, lp, li in layers:
        if kind == "ssm":
            x, _ = blocks.ssm_block_decode(
                lp, x, cfg, {"conv": convs[li], "state": states[li]}, update)
        else:
            x = _attn_token_layer(lp, x, cfg, pos, li, append_attend)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def _decode_tower(params, layers, cfg: ModelConfig, state: pc.PagedCacheState,
                  lens: torch.Tensor, tokens: torch.Tensor,
                  write_block: torch.Tensor, offset: torch.Tensor,
                  ssm: Optional[pc.SSMStateCache] = None,
                  update: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One token per slot over the paged pool -> float32 logits [S, V].

    Appends each attention layer's K/V at ``(write_block, offset)`` (int64
    [S]) per slot, in place, and attends through the block table with the
    paged decode kernel over ``lens + 1`` keys (the just-written token
    included); SSM layers advance the ``ssm`` pools where ``update``.
    """
    pool_k, pool_v = state.pool_k, state.pool_v
    lens1 = (lens + 1).to(torch.int32)

    def append_attend(li, q, k, v):
        pool_k[li, write_block, offset] = k.to(pool_k.dtype)
        pool_v[li, write_block, offset] = v.to(pool_v.dtype)
        return paged_decode_attention_op(q, pool_k[li], pool_v[li],
                                         state.block_tables, lens1)

    hidden = _token_layer_stack(params, layers, cfg, lens, tokens,
                                append_attend, ssm, update)
    return logits_from_hidden(params["embedding"], hidden, cfg)


def _write_targets(state: pc.PagedCacheState, lens: torch.Tensor,
                   emit: torch.Tensor, trash_block: int):
    """(block, offset) int64 [S] of each slot's next K/V write: its table
    entry at ``lens`` when ``emit``, else the scratch block. The block index
    is clamped to the table so a slot holding exactly ``mb * bs`` tokens
    (which writes nothing) cannot index past it."""
    bs, mb = state.block_size, state.max_blocks
    lens = lens.long()
    blk_idx = (lens // bs).clamp(max=mb - 1)
    wb = state.block_tables.gather(1, blk_idx[:, None])[:, 0].long()
    wb = torch.where(emit, wb.clamp_min(0), trash_block)
    off = torch.where(emit, lens % bs, 0)
    return wb, off


def _paged_decode_step(params, layers, cfg: ModelConfig,
                       state: pc.PagedCacheState, tokens: torch.Tensor,
                       active: torch.Tensor, *, trash_block: int,
                       ssm: Optional[pc.SSMStateCache] = None
                       ) -> torch.Tensor:
    """One token for every slot against the paged pool -> logits [S, V]
    (with ``ssm``, the reference's ``_multiarch_decode_step``).

    Inactive slots (idle, or mid-prefill with live pages at their cursor)
    have their K/V append redirected to the scratch block and their SSM
    state left as it is, so a batch-wide launch never touches state it
    doesn't own.
    """
    wb, off = _write_targets(state, state.seq_lens, active, trash_block)
    return _decode_tower(params, layers, cfg, state, state.seq_lens, tokens,
                         wb, off, ssm, active)


def _paged_decode_horizon(params, layers, cfg: ModelConfig,
                          state: pc.PagedCacheState,
                          next_logits: torch.Tensor, budget: torch.Tensor,
                          generator: Optional[torch.Generator], *,
                          trash_block: int, horizon: int, temperature: float,
                          top_p: float, greedy: bool,
                          ssm: Optional[pc.SSMStateCache] = None):
    """A whole decode horizon with no host round-trip inside (with ``ssm``,
    the reference's ``_multiarch_decode_horizon``).

    Each iteration samples on the device from the carried logits
    (``fused_sample_step``: PAD/zero-mask for finished rows, EOS folded
    into the done flags), appends K/V through the block table, advances
    the SSM state of the emitting slots and bumps their lengths. ``budget``
    [S] caps per-slot emissions; finished or over-budget slots keep
    decoding masked (their writes land on the scratch block, their SSM
    state is carried through unchanged).

    Returns (packed [3, horizon, S] float32 — tokens / logps / masks, for
    ONE drain to the host — lengths [S] int32, next-token logits [S, V]).
    """
    lens = state.seq_lens.clone()
    logits = next_logits
    done = budget <= 0  # inactive slots ship with budget 0
    toks, logps, masks = [], [], []
    for t in range(horizon):
        token, logp, mask, done = fused_sample_step(
            logits, generator, done | (t >= budget), temperature=temperature,
            top_p=top_p, greedy=greedy)
        done = done | (t + 1 >= budget)
        emit = mask > 0.0
        wb, off = _write_targets(state, lens, emit, trash_block)
        logits = _decode_tower(params, layers, cfg, state, lens, token, wb,
                               off, ssm, emit)
        lens = lens + emit.to(lens.dtype)
        toks.append(token)
        logps.append(logp)
        masks.append(mask)
    # token ids are exact in float32 (vocab << 2**24)
    packed = torch.stack([torch.stack(toks).float(), torch.stack(logps),
                          torch.stack(masks)])
    return packed, lens, logits


def _paged_prefill_chunk(params, layers, cfg: ModelConfig,
                         state: pc.PagedCacheState, tokens: np.ndarray,
                         seg_ids: np.ndarray, q_pos: np.ndarray,
                         write_block: np.ndarray, offset: np.ndarray,
                         last_rows: List[int]) -> torch.Tensor:
    """One prefill chunk: C prompt tokens, possibly spanning several slots
    (segment-packed), written straight into pool pages.

    Host arrays [C]: tokens, seg_ids (slot per row), q_pos (position per
    row), write_block/offset (each row's K/V target). ``last_rows`` are
    the rows whose next-token logits are wanted (each completing slot's
    final prompt token); only those rows go through the output head.
    Returns float32 logits [len(last_rows), V].
    """
    dev = state.pool_k.device
    seg_d = torch.from_numpy(seg_ids).to(dev)
    pos_d = torch.from_numpy(q_pos).to(dev)
    wb = torch.from_numpy(write_block.astype(np.int64)).to(dev)
    off = torch.from_numpy(offset.astype(np.int64)).to(dev)
    pool_k, pool_v = state.pool_k, state.pool_v

    def append_attend(li, q, k, v):
        pool_k[li, wb, off] = k.to(pool_k.dtype)
        pool_v[li, wb, off] = v.to(pool_v.dtype)
        return paged_prefill_attention_op(q, pool_k[li], pool_v[li],
                                          state.block_tables, seg_d, pos_d)

    hidden = _token_layer_stack(
        params, layers, cfg, pos_d,
        torch.from_numpy(tokens.astype(np.int64)).to(dev), append_attend)
    rows = torch.as_tensor(last_rows, dtype=torch.long, device=dev)
    return logits_from_hidden(params["embedding"], hidden[rows], cfg)


def _multiarch_prefill_chunk(params, layers, cfg: ModelConfig,
                             state: pc.PagedCacheState,
                             ssm: pc.SSMStateCache, slots: List[int],
                             tokens: np.ndarray, starts: np.ndarray,
                             counts: np.ndarray, write_block: np.ndarray,
                             offset: np.ndarray, last_rows: List[int]
                             ) -> torch.Tensor:
    """One SSM/hybrid prefill chunk, one batch row per prefilling slot.

    The SSD scan is recurrent per sequence, so the prompts cannot be packed
    into one row stream: row r of ``tokens`` [R, W] (right-padded) holds
    ``counts[r]`` prompt tokens of ``slots[r]`` from position ``starts[r]``
    (int64 host arrays). SSM layers run the chunked scan resuming from the
    slots' pool rows and write them back in place; pad steps carry dt = 0,
    so they leave the state as it is, and the conv window is taken at
    ``counts``, so a ragged chunk resumes exactly. Hybrid attention layers
    flatten the rows to [R*W] rows over the paged pool, as the dense chunk
    does, each row's K/V written at ``(write_block, offset)`` ([R*W], pad
    rows on the scratch block). ``last_rows`` are the batch rows of the
    slots that complete their prompt here; returns their float32
    next-token logits [len(last_rows), V].
    """
    dev = state.pool_k.device
    R, W = tokens.shape
    counts_d = torch.from_numpy(counts).to(dev)
    cols = torch.arange(W, device=dev)
    pad_mask = cols[None, :] < counts_d[:, None]                    # [R, W]
    positions = torch.from_numpy(starts).to(dev)[:, None] + cols    # [R, W]
    slot_d = torch.as_tensor(slots, dtype=torch.long, device=dev)
    seg = torch.where(pad_mask, slot_d[:, None], -1).reshape(-1).to(
        torch.int32)
    pos_flat = positions.reshape(-1)
    pos_i32 = pos_flat.to(torch.int32)
    wb = torch.from_numpy(write_block).to(dev)
    off = torch.from_numpy(offset).to(dev)
    pool_k, pool_v = state.pool_k, state.pool_v

    def append_attend(li, q, k, v):
        pool_k[li, wb, off] = k.to(pool_k.dtype)
        pool_v[li, wb, off] = v.to(pool_v.dtype)
        return paged_prefill_attention_op(q, pool_k[li], pool_v[li],
                                          state.block_tables, seg, pos_i32)

    x = embed_tokens(params["embedding"], torch.from_numpy(tokens).to(dev),
                     cfg)
    for kind, lp, li in layers:
        if kind == "ssm":
            c_in = {"conv": ssm.conv[li, slot_d],
                    "state": ssm.state[li, slot_d]}
            x, c_out = blocks.ssm_block_full(lp, x, cfg, pad_mask=pad_mask,
                                             initial_cache=c_in,
                                             valid_lens=counts_d)
            ssm.conv[li, slot_d] = c_out["conv"].to(ssm.conv.dtype)
            ssm.state[li, slot_d] = c_out["state"]
        else:
            x = _attn_token_layer(lp, x.reshape(R * W, -1), cfg,
                                  pos_flat[:, None], li,
                                  append_attend).reshape(R, W, -1)
    rows = torch.as_tensor(last_rows, dtype=torch.long, device=dev)
    h_last = x[rows, counts_d[rows] - 1]
    h_last = rmsnorm(params["final_norm"], h_last, cfg.norm_eps)
    return logits_from_hidden(params["embedding"], h_last, cfg)


class ContinuousBatchingEngine:
    """Paged continuous-batching server for dense, SSM and hybrid stacks.

    ``device`` defaults to CUDA (and raises where there is none); pass
    ``device="cpu"`` for the plain PyTorch path. ``prefix_cache`` is a
    duck-typed ``serving.prefix_cache.RadixPrefixCache`` (``lookup``/
    ``match``/``insert``/``evict``/``evictable_count``; untyped to avoid a
    rollout -> serving import cycle): prompts that hit it start their
    prefill at the matched cursor on shared, copy-on-write pages.
    """

    def __init__(self, cfg: ModelConfig, *, max_seqs: int = 8,
                 block_size: int = 16, n_blocks: int = 256,
                 max_blocks_per_seq: int = 16,
                 rl: Optional[RLConfig] = None, greedy: bool = False,
                 prefix_cache=None, decode_horizon: int = 1,
                 prefill_chunk: int = 32, device="cuda"):
        M.check_arch(cfg)
        self.cfg = cfg
        self.device = require_device(device)
        self.rl = rl or RLConfig()
        self.greedy = greedy
        self.max_seqs = max_seqs
        self.prefill_chunk = int(prefill_chunk)
        # tokens decoded per step_horizon call (1 = per-token step)
        self.decode_horizon = int(decode_horizon)
        self.prefix_cache = prefix_cache
        # SSM/hybrid: constant-size per-slot recurrent state rides next to
        # the paged KV pool (which has zero layers for pure-SSM stacks)
        self.n_ssm = M.layout(cfg)[1]
        if self.n_ssm:
            if prefix_cache is not None:
                raise ValueError(
                    "the radix prefix cache shares KV blocks across "
                    "sequences; recurrent SSM state cannot be shared so")
            self.ssm_cache = pc.init_ssm_state_cache(
                cfg, max_seqs=max_seqs, dtype=torch_dtype(cfg),
                device=self.device)
            self.ssm_pool = pc.SSMSlotPool(max_seqs)
        else:
            self.ssm_cache = None
            self.ssm_pool = None
        # the control plane checks this before attaching a radix cache
        self.supports_prefix_cache = self.n_ssm == 0
        # reserve the last block as the scratch target for idle slots
        self.allocator = pc.BlockAllocator(n_blocks - 1)
        self.trash_block = n_blocks - 1
        self.state = pc.init_paged_cache(
            cfg, n_blocks=n_blocks, block_size=block_size,
            max_seqs=max_seqs, max_blocks_per_seq=max_blocks_per_seq,
            dtype=torch_dtype(cfg), device=self.device)
        # idle slots write into the scratch block
        bt = np.full((max_seqs, max_blocks_per_seq), -1, np.int32)
        bt[:, 0] = self.trash_block
        self.state.block_tables.copy_(torch.from_numpy(bt))
        # host mirrors of block_tables/seq_lens: all decode-path
        # bookkeeping reads these, so the hot loop never blocks on a
        # device readback
        self._tables = bt
        self._lens = np.zeros((max_seqs,), np.int32)
        self.slots: Dict[int, Optional[Request]] = {
            i: None for i in range(max_seqs)}
        self._pending: List[Request] = []
        self._next_logits = torch.zeros((max_seqs, cfg.vocab_size),
                                        dtype=torch.float32,
                                        device=self.device)
        # weight version of the params that produced each slot's
        # _next_logits row — the stamp for the *next* sampled token
        self._logits_version: List[int] = [0] * max_seqs
        self._rid = 0
        # decode-path telemetry: blocking device->host drains, decode
        # launches (steps or horizons) and tokens emitted
        self.host_syncs = 0
        self.decode_launches = 0
        self.tokens_emitted = 0
        self.last_emitted = 0
        # prefill-lane telemetry: chunk launches, prompt tokens computed
        # through the chunk path, and distinct chunk launch shapes. Nothing
        # is compiled here (the reference counts its jit compiles, one per
        # padded bucket); the counter keeps the serving metrics' schema and
        # counts the distinct (rows) / (rows, width) shapes launched.
        self.prefill_launches = 0
        self.prefill_chunk_tokens = 0
        self.prefill_compiles = 0
        self._prefill_shapes: set = set()

    # ------------------------------------------------------------- requests
    def submit(self, prompt_ids, max_new: int = 16, *, priority: int = 0,
               submit_version: int = 0) -> int:
        self._rid += 1
        self._pending.append(Request(self._rid, np.asarray(prompt_ids),
                                     max_new, priority=priority,
                                     submit_version=submit_version))
        return self._rid

    def _cache_plan(self, prompt) -> tuple:
        """(n_blocks, n_tokens) the radix cache will serve."""
        if self.prefix_cache is None:
            return 0, 0
        return self.prefix_cache.lookup(prompt, max_tokens=len(prompt) - 1)

    def blocks_needed(self, prompt, max_new: int) -> int:
        """Fresh blocks a request needs, given current prefix-cache state
        (with headroom for the copy-on-write forks a cached partial block
        can trigger)."""
        P = len(prompt)
        bs = self.state.block_size
        total = -(-(P + max_new) // bs)
        if self.prefix_cache is None:
            return total
        n_blocks, n_matched = self._cache_plan(prompt)
        spare = (1 if n_matched % bs else 0) + (1 if P % bs else 0)
        return total - n_blocks + spare

    def _reclaim_headroom(self, n: int = 1) -> None:
        """Evict cache-only blocks so a decode-time alloc cannot OOM while
        reclaimable blocks exist."""
        if self.prefix_cache is not None and self.allocator.n_free < n:
            self.prefix_cache.evict(n - self.allocator.n_free)

    def _decode_budget(self) -> Dict[int, int]:
        """Tokens the next decode launch writes for each decode-ready slot:
        its horizon budget (one with ``decode_horizon`` 1, ``step``'s)."""
        H = max(self.decode_horizon, 1)
        return {s: min(H, self.slots[s].max_new - len(self.slots[s].generated))
                for s in self.decode_ready_slots()}

    def _write_need(self, slot_tokens: Dict[int, int]) -> int:
        """Fresh blocks the next ``slot_tokens[slot]`` writes of each slot
        take: the unmapped ones in its write range, plus a copy-on-write
        fork where its first write block is radix-shared."""
        bs = self.state.block_size
        mb = self.state.max_blocks
        need = 0
        for slot, n in slot_tokens.items():
            if n <= 0:
                continue
            first, last = pc.write_range(int(self._lens[slot]), n, bs, mb)
            need += int(np.sum(self._tables[slot, first: last + 1] < 0))
            blk = int(self._tables[slot, first])
            if blk >= 0 and self.allocator.refs(blk) > 1:
                need += 1
        return need

    def decode_block_shortfall(self) -> int:
        """Blocks the next decode launch would need beyond what the pool
        can supply (free + cache-evictable), by ``_prepare_decode``'s own
        need count, so the control plane can shed work before the
        allocator runs dry mid-fork. 0 when safe."""
        supply = self.allocator.n_free
        if self.prefix_cache is not None:
            supply += self.prefix_cache.evictable_count()
        return max(self._write_need(self._decode_budget()) - supply, 0)

    def prefill_block_shortfall(self) -> int:
        """Blocks the next prefill chunk launch would need beyond what the
        pool can supply (free + cache-evictable): a chunk that resumes a
        radix-shared partial page forks it first. 0 when safe."""
        supply = self.allocator.n_free
        if self.prefix_cache is not None:
            supply += self.prefix_cache.evictable_count()
        work = self._gather_prefill_work()
        return max(self._write_need({s: n for s, _, n in work}) - supply, 0)

    def free_slots(self) -> List[int]:
        return [s for s, r in self.slots.items() if r is None]

    def decode_ready_slots(self) -> List[int]:
        """Slots whose prompt K/V is fully resident (decode-lane set)."""
        return [s for s, r in self.slots.items()
                if r is not None and r.prefill_done]

    def prefilling_slots(self) -> List[int]:
        return [s for s, r in self.slots.items()
                if r is not None and not r.prefill_done]

    def _admit(self, params, version: int = 0) -> None:
        for slot in self.free_slots():
            if not self._pending:
                break
            nxt = self._pending[0]
            if self.blocks_needed(nxt.prompt, nxt.max_new) \
                    > self.allocator.n_free:
                break
            self._pending.pop(0)
            self.admit_request(params, slot, nxt, version=version)

    def admit_request(self, params, slot: int, req: Request,
                      version: int = 0, *, prefill: bool = True) -> None:
        """Place ``req`` into ``slot``. ``prefill=True`` leaves the slot
        fully prefilled on return (by draining the chunk lane);
        ``prefill=False`` leaves the chunks to ``prefill_step``."""
        self.start_prefill(slot, req, version=version)
        if prefill:
            while not req.prefill_done:
                self.prefill_step(params, version=version, max_chunks=1)

    def start_prefill(self, slot: int, req: Request,
                      version: int = 0) -> None:
        """Map pages for ``req`` (radix prefix included) without running
        any prefill compute; chunk launches stream the rest."""
        assert self.slots[slot] is None, f"slot {slot} occupied"
        self.slots[slot] = req
        P = len(req.prompt)
        matched: List[int] = []
        n_matched = 0
        if self._cache_plan(req.prompt)[1]:
            matched, n_matched = self.prefix_cache.match(req.prompt,
                                                         max_tokens=P - 1)
        if n_matched:
            pc.map_sequence_prefixed(self.state, self.allocator, slot,
                                     matched, n_matched, P + req.max_new)
        else:
            pc.map_sequence(self.state, self.allocator, slot,
                            P + req.max_new)
        req.prefix_hit_tokens = n_matched
        req.prefill_pos = n_matched
        if self.ssm_pool is not None:
            # fresh sequence: map the slot and zero its recurrent state
            self.ssm_pool.map(slot)
            pc.ssm_reset_slots(self.ssm_cache, [slot])
        self._logits_version[slot] = version
        self._sync_mirrors()

    @torch.no_grad()
    def prefill_step(self, params, version: int = 0,
                     max_chunks: Optional[int] = None) -> int:
        """Run up to ``max_chunks`` chunk launches over mid-prefill slots
        (all of them when None); returns the number launched."""
        launched = 0
        while max_chunks is None or launched < max_chunks:
            work = self._gather_prefill_work()
            if not work:
                break
            self._prefill_chunk_launch(params, work, version)
            launched += 1
        return launched

    def _gather_prefill_work(self) -> List[tuple]:
        """Pack pending prompt tokens into one chunk: [(slot, start, n)],
        shortest-remaining-first; a long prompt takes whatever chunk
        capacity is left, so it still progresses every launch.

        SSM/hybrid stacks cannot pack segments into one row stream (the
        SSD scan is recurrent per sequence), so each prefilling slot owns a
        batch row instead and advances by up to a full chunk per launch.
        """
        if self.n_ssm:
            return [(s, self.slots[s].prefill_pos,
                     min(len(self.slots[s].prompt)
                         - self.slots[s].prefill_pos, self.prefill_chunk))
                    for s in sorted(self.prefilling_slots())]
        order = sorted(
            self.prefilling_slots(),
            key=lambda s: (len(self.slots[s].prompt)
                           - self.slots[s].prefill_pos, s))
        work: List[tuple] = []
        used = 0
        for slot in order:
            r = self.slots[slot]
            take = min(len(r.prompt) - r.prefill_pos,
                       self.prefill_chunk - used)
            if take <= 0:
                break
            work.append((slot, r.prefill_pos, take))
            used += take
        return work

    def _prefill_chunk_launch(self, params, work: List[tuple],
                              version: int) -> None:
        """One segment-packed chunk launch over ``[(slot, start, n)]``."""
        if self.n_ssm:
            self._multiarch_prefill_launch(params, work, version)
            return
        n_rows = sum(n for _, _, n in work)
        tokens = np.empty((n_rows,), np.int64)
        seg = np.empty((n_rows,), np.int32)
        pos = np.empty((n_rows,), np.int32)
        completing: List[int] = []
        last_rows: List[int] = []
        row = 0
        for slot, start, n in work:
            r = self.slots[slot]
            tokens[row: row + n] = r.prompt[start: start + n]
            seg[row: row + n] = slot
            pos[row: row + n] = np.arange(start, start + n)
            if start + n == len(r.prompt):
                completing.append(slot)
                last_rows.append(row + n - 1)
            row += n
        with span("prefill_chunk", rows=n_rows, segments=len(work),
                  version=version, completed=len(completing)):
            # fork the (possibly radix-shared) first write block of each
            # slot, pre-map the rest, push the table mirror once
            self._prepare_decode({slot: n for slot, _, n in work})
            bs, mb = self.state.block_size, self.state.max_blocks
            wb = np.maximum(self._tables[seg, np.minimum(pos // bs, mb - 1)],
                            0)
            layers = _layers(params, self.cfg)
            logits = _paged_prefill_chunk(
                params, layers, self.cfg, self.state, tokens, seg, pos, wb,
                pos % bs, last_rows)
            if completing:
                self._next_logits[torch.as_tensor(
                    completing, device=self.device)] = logits
            counts = np.zeros((self.max_seqs,), np.int32)
            for slot, _, n in work:
                counts[slot] = n
            self.state.seq_lens += torch.from_numpy(counts).to(self.device)
        self.prefill_launches += 1
        self.prefill_chunk_tokens += n_rows
        self._note_shape(("chunk", n_rows))
        for slot, start, n in work:
            r = self.slots[slot]
            r.prefill_pos = start + n
            self._lens[slot] += n
            if r.prefill_done:
                self._logits_version[slot] = version
                if self.prefix_cache is not None:
                    n_blocks = -(-len(r.prompt) // bs)
                    self.prefix_cache.insert(
                        r.prompt,
                        [int(b) for b in self._tables[slot][:n_blocks]])

    def _note_shape(self, shape: tuple) -> None:
        if shape not in self._prefill_shapes:
            self._prefill_shapes.add(shape)
            self.prefill_compiles += 1

    def _multiarch_prefill_launch(self, params, work: List[tuple],
                                  version: int) -> None:
        """One batched SSM/hybrid prefill launch over ``[(slot, start,
        n)]``: each slot owns a row of a [len(work), max n] batch."""
        R, W = len(work), max(n for _, _, n in work)
        tokens = np.full((R, W), tok.PAD, np.int64)
        starts = np.zeros((R,), np.int64)
        counts = np.zeros((R,), np.int64)
        last_rows: List[int] = []
        completing: List[int] = []
        for r, (slot, start, n) in enumerate(work):
            tokens[r, :n] = self.slots[slot].prompt[start: start + n]
            starts[r], counts[r] = start, n
            if start + n == len(self.slots[slot].prompt):
                last_rows.append(r)
                completing.append(slot)
        slots = [slot for slot, _, _ in work]
        with span("prefill_chunk", rows=int(counts.sum()), width=W,
                  segments=R, version=version, completed=len(completing)):
            self._prepare_decode({slot: n for slot, _, n in work})
            # each flattened row's K/V target (hybrid attention layers);
            # pad rows land on the scratch block
            bs, mb = self.state.block_size, self.state.max_blocks
            pos = starts[:, None] + np.arange(W)
            valid = np.arange(W)[None, :] < counts[:, None]
            blk = self._tables[np.asarray(slots)[:, None],
                               np.minimum(pos // bs, mb - 1)]
            wb = np.where(valid, np.maximum(blk, 0),
                          self.trash_block).astype(np.int64)
            off = np.where(valid, pos % bs, 0)
            logits = _multiarch_prefill_chunk(
                params, _layers(params, self.cfg), self.cfg, self.state,
                self.ssm_cache, slots, tokens, starts, counts,
                wb.reshape(-1), off.reshape(-1), last_rows)
            if completing:
                self._next_logits[torch.as_tensor(
                    completing, device=self.device)] = logits
            inc = np.zeros((self.max_seqs,), np.int32)
            inc[slots] = counts
            self.state.seq_lens += torch.from_numpy(inc).to(self.device)
        self.prefill_launches += 1
        self.prefill_chunk_tokens += int(counts.sum())
        self._note_shape(("machunk", R, W))
        for slot, start, n in work:
            r = self.slots[slot]
            r.prefill_pos = start + n
            self._lens[slot] += n
            if r.prefill_done:
                self._logits_version[slot] = version

    def _sync_mirrors(self) -> None:
        """Refresh host mirrors from the device (admission only — the
        decode loop itself never reads device state back)."""
        self._tables = self.state.block_tables.cpu().numpy().copy()
        self._lens = self.state.seq_lens.cpu().numpy().copy()

    # ----------------------------------------------------------------- step
    def _prepare_decode(self, slot_tokens: Dict[int, int]) -> None:
        """Boundary bookkeeping, entirely on the host mirrors.

        Reclaims allocator headroom for everything the next
        ``slot_tokens[slot]`` writes of each slot may need, forks the first
        write block of any slot resuming on radix-cache-shared pages, and
        pre-maps every missing block — then pushes the block-table mirror
        to the device at most once. No device readback anywhere.
        """
        bs = self.state.block_size
        mb = self.state.max_blocks
        self._reclaim_headroom(self._write_need(slot_tokens))
        dirty = False
        for slot, n in slot_tokens.items():
            if n <= 0:
                continue
            first = int(self._lens[slot]) // bs
            blk = int(self._tables[slot, first])
            if blk >= 0 and self.allocator.refs(blk) > 1:
                _, new = pc.fork_block(self.state, self.allocator, blk)
                self._tables[slot, first] = new
                dirty = True
        dirty |= pc.alloc_horizon_blocks(self.allocator, self._tables,
                                         self._lens, slot_tokens, bs)
        if __debug__:
            # every active slot's upcoming write positions must be mapped:
            # an unmapped write would be routed to block 0's page
            for slot, n in slot_tokens.items():
                if n <= 0:
                    continue
                first, last = pc.write_range(int(self._lens[slot]), n, bs,
                                             mb)
                tab = self._tables[slot, first: last + 1]
                assert (tab >= 0).all(), (
                    f"slot {slot}: unmapped write blocks {tab.tolist()} "
                    f"in range [{first}, {last}]")
        if dirty:
            self.state.block_tables.copy_(torch.from_numpy(self._tables))

    def _generator(self, generator: Optional[torch.Generator]):
        if generator is None and not self.greedy:
            raise ValueError("sampled decoding needs a torch.Generator")
        return generator

    @torch.no_grad()
    def step(self, params, generator: Optional[torch.Generator] = None,
             version: int = 0) -> List[Request]:
        """One decode step for every active slot; returns finished reqs.

        ``params``/``version`` may change between calls: in-flight
        sequences keep their paged KV and resume under the new weights,
        and every sampled token is stamped with the version of the params
        that produced its logits. Pays two drains per token;
        ``step_horizon`` pays one per horizon.
        """
        with span("decode_step", version=version) as sp:
            finished = self._step_impl(params, generator, version)
            sp.set(tokens=self.last_emitted, finished=len(finished))
        return finished

    def _step_impl(self, params, generator, version: int) -> List[Request]:
        # mid-prefill slots are not decode-ready: they stay masked out
        active = self.decode_ready_slots()
        if not active:
            return []
        if self.greedy:
            tokens, logps = greedy_token(self._next_logits)
        else:
            tokens, logps = sample_token(self._next_logits,
                                         self._generator(generator),
                                         temperature=self.rl.temperature,
                                         top_p=self.rl.top_p)
        tokens_h = tokens.cpu().numpy()
        logps_h = logps.cpu().numpy()
        self.host_syncs += 2  # token + logp drains, one per token decoded
        self.decode_launches += 1
        self._prepare_decode({slot: 1 for slot in active})
        active_arr = np.zeros((self.max_seqs,), bool)
        active_arr[active] = True
        active_d = torch.from_numpy(active_arr).to(self.device)
        # mid-prefill rows of _next_logits become garbage here; they are
        # only read after their completion chunk overwrites them
        self._next_logits = _paged_decode_step(
            params, _layers(params, self.cfg), self.cfg, self.state, tokens,
            active_d, trash_block=self.trash_block, ssm=self.ssm_cache)
        self.state.seq_lens += active_d.to(torch.int32)
        self._lens += active_arr
        self.last_emitted = len(active)
        self.tokens_emitted += len(active)
        finished: List[Request] = []
        for slot in active:
            req = self.slots[slot]
            t = int(tokens_h[slot])
            req.generated.append(t)
            req.gen_logp.append(float(logps_h[slot]))
            req.token_versions.append(int(self._logits_version[slot]))
            if t == tok.EOS or len(req.generated) >= req.max_new:
                req.done = True
                finished.append(req)
                self.release_slot(slot)
        # logits computed this step came from `params`
        for slot in active:
            if self.slots.get(slot) is not None:
                self._logits_version[slot] = version
        return finished

    @torch.no_grad()
    def step_horizon(self, params,
                     generator: Optional[torch.Generator] = None,
                     version: int = 0) -> List[Request]:
        """Decode up to ``decode_horizon`` tokens per active slot with one
        device-to-host drain; returns finished reqs. Token 0 of the horizon
        is stamped with the version that produced the carried-in logits,
        later tokens with ``version``."""
        with span("decode_horizon", horizon=self.decode_horizon,
                  version=version) as sp:
            finished = self._step_horizon_impl(params, generator, version)
            sp.set(tokens=self.last_emitted, finished=len(finished))
        return finished

    def _step_horizon_impl(self, params, generator,
                           version: int) -> List[Request]:
        H = self.decode_horizon
        # decode lane only: mid-prefill slots keep budget 0 (the emit mask
        # parks zero-budget writes on scratch)
        active = {s: self.slots[s] for s in self.decode_ready_slots()}
        if not active:
            return []
        plan = self._decode_budget()
        budget = np.zeros((self.max_seqs,), np.int32)
        budget[list(plan)] = list(plan.values())
        self._prepare_decode(plan)
        with annotate("decode_horizon"):
            packed, lens, logits = _paged_decode_horizon(
                params, _layers(params, self.cfg), self.cfg, self.state,
                self._next_logits,
                torch.from_numpy(budget).to(self.device),
                None if self.greedy else self._generator(generator),
                trash_block=self.trash_block, horizon=H,
                temperature=self.rl.temperature, top_p=self.rl.top_p,
                greedy=self.greedy, ssm=self.ssm_cache)
        self.state.seq_lens.copy_(lens)
        self._next_logits = logits
        drained = packed.cpu().numpy()  # the one blocking drain per horizon
        self.host_syncs += 1
        self.decode_launches += 1
        tokens = drained[0].astype(np.int64)
        logps, masks = drained[1], drained[2]
        # emissions are a prefix per slot (done is sticky), so the mask sum
        # is the emitted count
        n_emit = masks.sum(axis=0).astype(np.int64)
        finished: List[Request] = []
        released: List[int] = []
        for s, r in active.items():
            n = int(n_emit[s])
            if n:
                r.generated.extend(tokens[:n, s].tolist())
                r.gen_logp.extend(logps[:n, s].tolist())
                r.token_versions.append(int(self._logits_version[s]))
                r.token_versions.extend([version] * (n - 1))
            self._lens[s] += n
            if (n and r.generated[-1] == tok.EOS) \
                    or len(r.generated) >= r.max_new:
                r.done = True
                finished.append(r)
                released.append(s)
            else:
                self._logits_version[s] = version
        if released:
            # free all finished slots' pages with one device update
            for s in released:
                self._release_host(s)
            idx = torch.as_tensor(released, device=self.device)
            self.state.block_tables[idx] = torch.from_numpy(
                self._tables[released]).to(self.device)
            self.state.seq_lens[idx] = 0
        self.last_emitted = int(n_emit.sum())
        self.tokens_emitted += self.last_emitted
        return finished

    def _release_host(self, slot: int) -> None:
        """Host half of a slot release: return pages to the allocator and
        reset the mirrors + slot bookkeeping (callers push to device)."""
        self.allocator.release(
            [int(b) for b in self._tables[slot] if b >= 0])
        if self.ssm_pool is not None:
            # stale recurrent state stays in the pool; the next map of
            # this slot zeroes it (ssm_reset_slots in start_prefill)
            self.ssm_pool.release(slot)
        self._tables[slot] = -1
        self._tables[slot, 0] = self.trash_block
        self._lens[slot] = 0
        self.slots[slot] = None
        self._logits_version[slot] = 0

    def release_slot(self, slot: int) -> Optional[Request]:
        """Free a slot's pages (finish or preemption) and park it on the
        scratch block, from the host mirror (no device readback)."""
        req = self.slots[slot]
        self._release_host(slot)
        self.state.block_tables[slot] = torch.from_numpy(
            self._tables[slot]).to(self.device)
        self.state.seq_lens[slot] = 0
        return req

    # ------------------------------------------------------------------ run
    @torch.no_grad()
    def run(self, params, generator: Optional[torch.Generator] = None,
            max_steps: int = 10_000) -> List[Request]:
        """Drive admission + decode to completion. With ``decode_horizon``
        > 1 each iteration is a fused horizon (``max_steps`` counts
        launches, not tokens). Sampled decoding draws from ``generator``
        in a fixed order, so a seeded generator reproduces the run."""
        done: List[Request] = []
        steps = 0
        while (self._pending or any(r is not None
                                    for r in self.slots.values())):
            self._admit(params)
            if not any(r is not None for r in self.slots.values()):
                break
            if self.decode_horizon > 1:
                done.extend(self.step_horizon(params, generator))
            else:
                done.extend(self.step(params, generator))
            steps += 1
            if steps > max_steps:
                raise RuntimeError("serving loop exceeded max_steps")
        return done
