"""Paged KV cache: fixed-size blocks, free-list allocator, block tables —
port of ``polyaxon_tpu/serve/kv_cache.py``.

The pool is one tensor per K/V with a leading ``[layers, num_blocks]``
prefix on the engine's device; a *block* is the allocation quantum
(``block_size`` token slots for every layer at once). The allocator, the
refcounts and the radix prefix index are host Python, copied from the JAX
package unchanged; only the device storage differs. The model writes the
pools in place (where JAX donates and returns them), and a copy-on-write
copies one block of every layer in place.

Freed blocks are NOT zeroed — the attention length mask makes stale bytes
unreachable.

Prefix sharing: blocks are REFCOUNTED, and a radix trie over full-block
token keys (:class:`PrefixIndex`) remembers which blocks hold the KV of
which token prefixes. An admitted request maps every cached full prefix
block into its table (refcount++) instead of re-prefilling it; a write
into a block someone else can still read copy-on-writes it first
(:meth:`PagedKVCache.ensure_writable`). Release is a decref, so a preempted
or completed sharer can never free a block a live sequence (or the index)
still references. Index-only blocks (refcount 1, held by the trie alone)
are the eviction reserve: when an allocation would fail, leaf-first LRU
eviction reclaims them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

import numpy as np
import torch


class OutOfBlocksError(RuntimeError):
    """The pool cannot satisfy an allocation; callers queue, not crash."""


class BlockAllocator:
    """LIFO free-list over ``num_blocks`` block ids, with per-block
    refcounts: ``alloc`` hands out blocks at refcount 1, ``incref`` adds
    a sharer, ``decref``/``free`` drop one — the block returns to the
    free list only at refcount 0. ``audit_violations`` counts every
    refcount underflow / double-free attempt (the serve fault soak
    asserts it stays 0 under preemption + sharing)."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: list[int] = list(range(num_blocks - 1, -1, -1))
        self._refs: list[int] = [0] * num_blocks
        #: refcount underflows / double frees observed (and raised on) —
        #: a live counter the engine snapshot exposes for the soak gate
        self.audit_violations = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def shared_count(self) -> int:
        """Blocks currently referenced by more than one holder."""
        return sum(1 for r in self._refs if r >= 2)

    @property
    def utilization(self) -> float:
        return self.used_count / self.num_blocks

    def ref(self, block_id: int) -> int:
        return self._refs[block_id]

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def can_ever_alloc(self, n: int) -> bool:
        """Could ``n`` blocks EVER be satisfied, even with the whole pool
        free? A request whose worst-case reservation fails this can never
        admit — admission control must reject it loudly at submit instead
        of queueing it forever (the head-of-line deadlock the preemption
        path must otherwise break)."""
        return n <= self.num_blocks

    def alloc(self, n: int = 1) -> list[int]:
        if len(self._free) < n:
            raise OutOfBlocksError(
                f"need {n} blocks, {len(self._free)}/{self.num_blocks} free")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def incref(self, block_id: int) -> None:
        if not 0 <= block_id < self.num_blocks:
            raise ValueError(f"block id {block_id} out of range")
        if self._refs[block_id] <= 0:
            self.audit_violations += 1
            raise RuntimeError(
                f"incref on unallocated block {block_id}")
        self._refs[block_id] += 1

    def decref(self, block_id: int) -> bool:
        """Drop one reference; returns True when the block hit refcount 0
        and went back to the free list."""
        if not 0 <= block_id < self.num_blocks:
            raise ValueError(f"block id {block_id} out of range")
        if self._refs[block_id] <= 0:
            self.audit_violations += 1
            raise RuntimeError(
                f"double free: block {block_id} already at refcount 0")
        self._refs[block_id] -= 1
        if self._refs[block_id] == 0:
            self._free.append(block_id)
            if len(self._free) > self.num_blocks:
                self.audit_violations += 1
                raise RuntimeError(
                    "double free: free list exceeds pool size")
            return True
        return False

    def free(self, block_ids: list[int]) -> None:
        """Drop one reference per block (the pre-sharing ``free`` is now a
        decref loop — a caller releasing its table can never reclaim a
        block another holder still reads)."""
        for b in block_ids:
            if not 0 <= b < self.num_blocks:
                raise ValueError(f"block id {b} out of range")
        for b in block_ids:
            self.decref(b)


@dataclass
class SequenceBlocks:
    """One sequence's slice of the pool: its ordered block table and live
    token count. ``capacity`` is table length x block size."""

    block_ids: list[int] = field(default_factory=list)
    length: int = 0
    #: leading blocks mapped from the prefix index at admission (each one
    #: holds an extra reference somewhere else until COW'd)
    shared_blocks: int = 0

    def capacity(self, block_size: int) -> int:
        return len(self.block_ids) * block_size


class _RadixNode:
    """One full block of a cached prefix: ``key`` is the block's
    ``block_size`` token ids, ``block_id`` the pool block holding their
    KV. Children extend the prefix by one more full block."""

    __slots__ = ("key", "block_id", "parent", "children", "last_used")

    def __init__(self, key: tuple, block_id: int, parent):
        self.key = key
        self.block_id = block_id
        self.parent = parent
        self.children: dict[tuple, _RadixNode] = {}
        self.last_used = 0


class PrefixIndex:
    """Radix trie over token-id keys at BLOCK granularity.

    Each node owns one reference on its block (taken by the cache at
    insert). ``match`` returns the longest chain of full blocks whose
    concatenated keys prefix the given tokens — KV at a position depends
    only on the tokens before it, so any sequence whose prompt starts
    with that chain can read those blocks verbatim. Eviction is
    leaf-first LRU over nodes whose block nobody but the index holds: an
    interior node is never evicted before its children (removing it would
    orphan a still-matchable chain), it simply *becomes* a leaf once its
    children go."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._root: dict[tuple, _RadixNode] = {}
        self._nodes: dict[int, _RadixNode] = {}   # block_id -> node
        self._clock = 0                            # LRU tick (monotonic int)

    def __len__(self) -> int:
        return len(self._nodes)

    def block_ids(self) -> Iterator[int]:
        return iter(self._nodes.keys())

    def _touch(self, node: _RadixNode) -> None:
        self._clock += 1
        node.last_used = self._clock

    def match(self, tokens: list[int]) -> list[int]:
        """Block ids of the longest cached chain of FULL blocks contained
        in ``tokens``. A match may cover the whole (block-aligned) prompt;
        the admitter still re-prefills the final token for its logits,
        COW-ing the shared tail block it writes into."""
        bs = self.block_size
        out: list[int] = []
        children = self._root
        max_depth = len(tokens) // bs
        for d in range(max_depth):
            key = tuple(tokens[d * bs:(d + 1) * bs])
            node = children.get(key)
            if node is None:
                break
            self._touch(node)
            out.append(node.block_id)
            children = node.children
        return out

    def insert(self, tokens: list[int], block_ids: list[int]) -> list[int]:
        """Publish a prefilled prompt's full blocks. ``block_ids`` are the
        sequence's blocks for depths 0..n; an existing chain wins (the
        first divergence grafts the sequence's own blocks under it — keys
        are token ids, so equal paths hold identical KV by construction).
        Returns the block ids NEWLY taken over by the index; the caller
        (the cache) increfs exactly those."""
        bs = self.block_size
        taken: list[int] = []
        children = self._root
        parent: Optional[_RadixNode] = None
        depth = min(len(block_ids), len(tokens) // bs)
        for d in range(depth):
            key = tuple(tokens[d * bs:(d + 1) * bs])
            node = children.get(key)
            if node is None:
                b = block_ids[d]
                if b in self._nodes:
                    # one index reference per block: a block already
                    # indexed elsewhere (resume re-insert) is not retaken
                    children = self._nodes[b].children
                    parent = self._nodes[b]
                    continue
                node = _RadixNode(key, b, parent)
                children[key] = node
                self._nodes[b] = node
                taken.append(b)
            self._touch(node)
            children = node.children
            parent = node
        return taken

    def evictable(self, allocator: BlockAllocator) -> int:
        """How many index blocks COULD be reclaimed right now (leaf-first
        cascade over refcount-1 blocks) — the admission-pressure signal
        that keeps KV preemption from firing while eviction would do."""
        n = 0
        # a leaf at refcount 1 frees, exposing its parent: the whole
        # refcount-1 suffix of each chain is reclaimable
        def _count(node: _RadixNode) -> bool:
            """True when the entire subtree under (and incl.) node is
            evictable."""
            nonlocal n
            # no short-circuit: every subtree must be counted
            all_children = all([_count(c)
                                for c in list(node.children.values())])
            if all_children and allocator.ref(node.block_id) == 1:
                n += 1
                return True
            return False
        for node in list(self._root.values()):
            _count(node)
        return n

    def evict(self, n: int, allocator: BlockAllocator) -> int:
        """Reclaim up to ``n`` blocks: repeatedly drop the least-recently
        used LEAF whose block only the index holds (decref -> free list).
        Interior nodes become leaves as their children go. Returns the
        number of blocks actually freed."""
        freed = 0
        while freed < n:
            victims = [node for node in self._nodes.values()
                       if not node.children
                       and allocator.ref(node.block_id) == 1]
            if not victims:
                break
            victim = min(victims, key=lambda nd: nd.last_used)
            self._remove(victim, allocator)
            freed += 1
        return freed

    def _remove(self, node: _RadixNode, allocator: BlockAllocator) -> None:
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        else:
            self._root.pop(node.key, None)
        self._nodes.pop(node.block_id, None)
        allocator.decref(node.block_id)

    def drop_all(self, allocator: BlockAllocator) -> int:
        """Release every index reference (shutdown/tests). Blocks still
        mapped by live sequences survive at their remaining refcount."""
        n = 0
        for node in list(self._nodes.values()):
            self._remove(node, allocator)
            n += 1
        return n


class PagedKVCache:
    """Device storage + host allocator for the paged KV pool.

    K/V tensors are ``[L, N+1, bs, KVH, D]`` on ``device``; model code
    writes them in place. ``ensure`` grows a sequence's table to cover a
    target length, ``release`` recycles its blocks on completion/eviction.

    With ``enable_prefix_cache`` (default) the cache also maintains a
    :class:`PrefixIndex`: ``share_prefix`` maps cached full prefix blocks
    into a fresh sequence's table, ``publish_prefix`` indexes a prefilled
    prompt's full blocks, ``ensure_writable`` COWs a block before a write
    that other holders could observe, and ``ensure`` evicts index-only
    blocks before giving up.
    """

    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 kv_heads: int, head_dim: int, dtype: Any = torch.float32,
                 enable_prefix_cache: bool = True, *, device: Any):
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        # one extra TRASH block (index num_blocks): batch padding rows and
        # masked chunk positions direct their cache writes there, so a
        # static-shape scatter never corrupts a live sequence's block. The
        # allocator never hands it out and block tables never reference it.
        self.trash_block = num_blocks
        shape = (num_layers, num_blocks + 1, block_size, kv_heads, head_dim)
        self.device = torch.device(device)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.allocator = BlockAllocator(num_blocks)
        self.prefix_index: Optional[PrefixIndex] = (
            PrefixIndex(block_size) if enable_prefix_cache else None)
        #: cumulative copy-on-write block copies (obs family
        #: ``polyaxon_serve_cow_copies_total``)
        self.cow_copies = 0
        #: cumulative index evictions (a pool-sizing signal)
        self.prefix_evictions = 0

    # -- per-sequence table management --------------------------------------

    def blocks_for(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size) if num_tokens > 0 else 0

    def ensure(self, seq: SequenceBlocks, target_len: int) -> None:
        """Grow ``seq``'s block table to cover ``target_len`` tokens,
        evicting index-only prefix blocks when the free list alone can't.
        Raises :class:`OutOfBlocksError` (allocating nothing) when the pool
        still can't cover it — admission control queues the request."""
        need = self.blocks_for(target_len) - len(seq.block_ids)
        if need > 0:
            if (not self.allocator.can_alloc(need)
                    and self.prefix_index is not None):
                short = need - self.allocator.free_count
                self.prefix_evictions += self.prefix_index.evict(
                    short, self.allocator)
            seq.block_ids.extend(self.allocator.alloc(need))

    def blocks_short(self, seq: SequenceBlocks, target_len: int) -> int:
        """How many blocks ``seq`` still needs to cover ``target_len`` —
        the admission-pressure signal the engine's preemption path reads
        without mutating the allocator."""
        return max(self.blocks_for(target_len) - len(seq.block_ids), 0)

    def free_plus_evictable(self) -> int:
        """Blocks obtainable without preempting anyone: the free list plus
        the index's reclaimable (refcount-1, leaf-cascade) blocks."""
        n = self.allocator.free_count
        if self.prefix_index is not None:
            n += self.prefix_index.evictable(self.allocator)
        return n

    def reclaimable_on_release(self, seq: SequenceBlocks) -> int:
        """How many blocks a :meth:`release` of ``seq`` would make
        obtainable: blocks only it holds free outright, and blocks it
        shares with the index alone drop to index-only (evictable). The
        preemption victim-sizing heuristic — a sharer frees less than its
        table length, so evicting it may not relieve anything."""
        n = 0
        for b in seq.block_ids:
            r = self.allocator.ref(b)
            if r == 1:
                n += 1
            elif (r == 2 and self.prefix_index is not None
                  and b in self.prefix_index._nodes):
                n += 1
        return n

    def release(self, seq: SequenceBlocks) -> None:
        """Drop the sequence's references. Blocks shared with the index or
        another sequence survive at their remaining refcount — a preempted
        sharer can never free a block someone else still reads."""
        if seq.block_ids:
            self.allocator.free(seq.block_ids)
        seq.block_ids = []
        seq.length = 0
        seq.shared_blocks = 0

    # -- prefix sharing -------------------------------------------

    def share_prefix(self, seq: SequenceBlocks, tokens: list[int]) -> int:
        """Map the longest cached full-block prefix of ``tokens`` into a
        FRESH sequence's table (refcount++ per block, zero copies).
        Returns the number of prompt tokens covered."""
        if self.prefix_index is None or seq.block_ids:
            return 0
        ids = self.prefix_index.match(tokens)
        for b in ids:
            self.allocator.incref(b)
        seq.block_ids = list(ids)
        seq.shared_blocks = len(ids)
        return len(ids) * self.block_size

    def publish_prefix(self, seq: SequenceBlocks, tokens: list[int]) -> int:
        """Index ``seq``'s blocks that hold FULL blocks of ``tokens``
        (call after the prompt fully prefilled; the sequence only ever
        writes past ``len(tokens)`` from here on, so those blocks are
        frozen). Returns the number of blocks newly indexed."""
        if self.prefix_index is None:
            return 0
        full = len(tokens) // self.block_size
        taken = self.prefix_index.insert(tokens, seq.block_ids[:full])
        for b in taken:
            self.allocator.incref(b)
        return len(taken)

    def ensure_writable(self, seq: SequenceBlocks, pos: int) -> None:
        """Copy-on-write: the block covering token position ``pos`` must
        be exclusively ours before this sequence writes into it. A block
        at refcount 1 already is; otherwise copy it into a fresh block
        (in place on the device, all layers at once), swap the table
        entry, and drop our reference on the original."""
        bi = pos // self.block_size
        if bi >= len(seq.block_ids):
            raise ValueError(
                f"position {pos} beyond the sequence's {len(seq.block_ids)}"
                f"-block table")
        src = seq.block_ids[bi]
        if self.allocator.ref(src) <= 1:
            return
        if (not self.allocator.can_alloc(1)
                and self.prefix_index is not None):
            self.prefix_evictions += self.prefix_index.evict(
                1, self.allocator)
        [dst] = self.allocator.alloc(1)
        self.k[:, dst].copy_(self.k[:, src])
        self.v[:, dst].copy_(self.v[:, src])
        seq.block_ids[bi] = dst
        if bi < seq.shared_blocks:
            seq.shared_blocks = bi  # trailing shared run shrank
        self.allocator.decref(src)
        self.cow_copies += 1

    # -- batch views ---------------------------------------------------------

    def block_table_array(self, seqs: list[Optional[SequenceBlocks]],
                          max_blocks: int):
        """[B, max_blocks] int32 table (idle/short rows padded with 0 —
        the length mask keeps padded entries unreachable). Rows may ALIAS
        blocks under prefix sharing; reads are safe anywhere, writes only
        ever target positions past each row's shared prefix."""
        b = len(seqs)
        out = np.zeros((b, max_blocks), np.int32)
        for i, s in enumerate(seqs):
            if s is None:
                continue
            ids = s.block_ids[:max_blocks]
            out[i, :len(ids)] = ids
        return out

    @property
    def utilization(self) -> float:
        return self.allocator.utilization
