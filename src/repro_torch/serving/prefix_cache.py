"""Radix-tree prefix cache over the paged KV pool (SGLang-style; a copy of
``repro.serving.prefix_cache``, which is host code only).

GRPO rollouts send the *same* prompt ``group_size`` times, and agentic
tasks re-send long shared system/tool prefixes; re-prefilling them is the
dominant wasted work in grouped RL serving. This cache maps token prefixes
to reference-counted blocks in ``rollout.paged_cache.BlockAllocator`` so a
prefix is prefilled once and then shared:

* nodes sit at block granularity — an edge holds the exact token tuple of
  one block (``block_size`` tokens for interior/full nodes, fewer for
  partial leaves);
* ``match`` walks the tree and *increfs* every returned block on behalf of
  the requesting sequence (the sequence's ``release`` decref pairs with
  it);
* shared blocks are never written in place — the engine's copy-on-write
  guard (``paged_cache.ensure_writable``) forks a private copy the moment
  a sequence's write position lands inside a block with refcount > 1;
* the cache itself holds one reference per registered block, so blocks
  survive their creating sequence and are reclaimed by LRU ``evict`` when
  the allocator runs dry.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.rollout.paged_cache import BlockAllocator

TokenKey = Tuple[int, ...]


class _Node:
    __slots__ = ("key", "block", "children", "partials", "parent",
                 "last_used")

    def __init__(self, key: TokenKey, block: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[TokenKey, "_Node"] = {}   # full-block edges
        self.partials: Dict[TokenKey, "_Node"] = {}   # partial leaf edges
        self.last_used = 0

    @property
    def is_leaf(self) -> bool:
        return not self.children and not self.partials


class RadixPrefixCache:
    def __init__(self, allocator: BlockAllocator, block_size: int):
        self.allocator = allocator
        self.block_size = block_size
        self.root = _Node((), -1, None)
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.evicted_blocks = 0

    # ------------------------------------------------------------ internals
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _walk(self, tokens, max_tokens: Optional[int]
              ) -> Tuple[_Node, List[_Node], int]:
        """Longest match. Returns (last node, matched chain, n_tokens)."""
        toks = [int(t) for t in tokens]
        if max_tokens is not None:
            toks = toks[:max(max_tokens, 0)]
        bs = self.block_size
        node = self.root
        chain: List[_Node] = []
        i = 0
        while i + bs <= len(toks):
            child = node.children.get(tuple(toks[i: i + bs]))
            if child is None:
                break
            chain.append(child)
            node = child
            i += bs
        # token-granular tail: the edge out of `node` with the longest
        # common prefix against the remaining tokens. Using only the first
        # j tokens of a cached block is sound — seq_lens masks the block's
        # extra KV, and the first divergent write copy-on-write-forks it.
        rem = tuple(toks[i:])
        best: Optional[_Node] = None
        best_j = 0
        for key, cand in list(node.children.items()) \
                + list(node.partials.items()):
            j = 0
            for a, b in zip(key, rem):
                if a != b:
                    break
                j += 1
            if j > best_j:
                best, best_j = cand, j
        if best is not None:
            chain.append(best)
            i += best_j
        return node, chain, i

    # ----------------------------------------------------------------- api
    def lookup(self, tokens, max_tokens: Optional[int] = None
               ) -> Tuple[int, int]:
        """(n_blocks, n_tokens) the prefix match would reuse. No incref."""
        _, chain, n = self._walk(tokens, max_tokens)
        return len(chain), n

    def match(self, tokens, max_tokens: Optional[int] = None
              ) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``; increfs matched blocks.

        Returns (blocks, n_matched_tokens). The caller owns one reference
        per returned block (released via the sequence's normal
        ``release_sequence`` path).
        """
        _, chain, n = self._walk(tokens, max_tokens)
        now = self._tick()
        for node in chain:
            self.allocator.incref(node.block)
            node.last_used = now
        if chain:
            self.hits += 1
        else:
            self.misses += 1
        return [node.block for node in chain], n

    def insert(self, tokens, blocks: List[int]) -> int:
        """Register a prefilled prompt's blocks; returns #new nodes.

        ``blocks[i]`` must hold the KV of tokens ``[i*bs, (i+1)*bs)`` (the
        final entry may be a partial block). Existing nodes are left in
        place — their block already carries the canonical KV — and each
        newly registered block gets one cache-owned reference.
        """
        bs = self.block_size
        toks = [int(t) for t in tokens]
        assert len(blocks) >= -(-len(toks) // bs), (len(toks), blocks)
        node = self.root
        now = self._tick()
        created = 0
        i = bi = 0
        while i + bs <= len(toks):
            chunk = tuple(toks[i: i + bs])
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk, blocks[bi], node)
                self.allocator.incref(blocks[bi])
                node.children[chunk] = child
                created += 1
            child.last_used = now
            node = child
            i += bs
            bi += 1
        rem = tuple(toks[i:])
        if rem:
            leaf = node.partials.get(rem)
            if leaf is None:
                leaf = _Node(rem, blocks[bi], node)
                self.allocator.incref(blocks[bi])
                node.partials[rem] = leaf
                created += 1
            leaf.last_used = now
        return created

    # ------------------------------------------------------------- eviction
    def _evictable(self) -> List[_Node]:
        """Leaves only the cache still references (refcount == 1)."""
        out: List[_Node] = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            for child in list(node.children.values()):
                stack.append(child)
                if child.is_leaf and self.allocator.refs(child.block) == 1:
                    out.append(child)
            for leaf in node.partials.values():
                if self.allocator.refs(leaf.block) == 1:
                    out.append(leaf)
        return out

    def evictable_count(self) -> int:
        """Blocks repeated ``evict`` rounds could *ever* free.

        A node is reclaimable iff only the cache references its block
        (refcount == 1) AND its entire subtree is reclaimable — an
        in-use descendant pins every ancestor, since eviction only takes
        leaves. Admission uses this to decide whether evicting can
        possibly cover a shortfall before destroying any cached prefix.
        """
        def walk(node: _Node) -> Tuple[int, bool]:
            total, all_free = 0, True
            for child in list(node.children.values()) \
                    + list(node.partials.values()):
                t, f = walk(child)
                total += t
                all_free &= f
            if node is self.root:
                return total, all_free
            if all_free and self.allocator.refs(node.block) == 1:
                return total + 1, True
            return total, False

        return walk(self.root)[0]

    def _drop(self, node: _Node) -> None:
        parent = node.parent
        if node.key in parent.partials and parent.partials[node.key] is node:
            del parent.partials[node.key]
        elif node.key in parent.children \
                and parent.children[node.key] is node:
            del parent.children[node.key]
        self.allocator.decref(node.block)
        self.evicted_blocks += 1

    def evict(self, n_blocks: int) -> int:
        """LRU-evict up to ``n_blocks`` cache-only blocks; returns #freed.

        Dropping a leaf can expose its parent; rounds repeat until the
        target is met or nothing is evictable.
        """
        freed = 0
        while freed < n_blocks:
            candidates = self._evictable()
            if not candidates:
                break
            candidates.sort(key=lambda nd: nd.last_used)
            for node in candidates:
                self._drop(node)
                freed += 1
                if freed >= n_blocks:
                    break
        return freed

    def clear(self) -> int:
        """Drop every cache-held reference (blocks in use survive)."""
        dropped = 0
        stack = list(self.root.children.values()) \
            + list(self.root.partials.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            stack.extend(node.partials.values())
            self.allocator.decref(node.block)
            dropped += 1
        self.root = _Node((), -1, None)
        return dropped

    @property
    def n_cached_blocks(self) -> int:
        count = 0
        stack = list(self.root.children.values()) \
            + list(self.root.partials.values())
        while stack:
            node = stack.pop()
            count += 1
            stack.extend(node.children.values())
            stack.extend(node.partials.values())
        return count
