"""Radix-cache prefix sharing over the paged KV pool.

A copy of the JAX package's ``serve/radix.py``.  Serving traffic is
prefix-heavy — system prompts, few-shot preambles, retrieval headers —
and the pool's paging is PHYSICAL (block tables as data, scatter
writes, table-reading decode kernels), so two requests whose prompts
share a leading run of tokens can share the physical KV blocks backing
that run by indirection alone: the later request maps the earlier
request's block ids into its leading table entries and resumes chunked
prefill mid-prompt (the chunk's ``q_offset``), computing and writing
only its private suffix.

``RadixCache`` is the index that makes the match: a trie keyed on
prompt tokens in BLOCK-SIZE quanta.  One node = one fully written
block; a node's path key (the concatenation of edge labels from the
root) is exactly the token run its block caches.  Partially filled
prompt-tail blocks hang off their node as ``tails`` — exclusive
leaves matched by longest common prefix and copied (never aliased)
into the new request's first private block, because the writer of a
partial block keeps appending decode tokens to it.

Ownership (see ``serve.kvcache``): every block a node or tail
references is RETAINED under the allocator's ``"radix"`` holder, so
slot recycling at retirement decrefs — not frees — prefix blocks still
indexed here.  Eviction is the reverse edge: when admission needs
blocks, the LRU evictable entry (a tail, or a leaf node whose block no
live lease maps — refcount 1, the radix's own) releases until the free
list covers the request.  During one admission round the matched path
is pinned under a per-request holder, so a later admission's eviction
can never free blocks a just-matched request is about to map.

The cache is host-only: it moves ids and tokens, never tensors.  The
engine owns the data motion (seeding a row cache from the matched
blocks, re-quantising the boundary block on the int8 pool).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.obs.trace import get_tracer
from repro_torch.serve.kvcache import BlockAllocator

__all__ = ["MatchResult", "RadixCache", "RadixStats"]

#: the allocator holder under which the trie retains its blocks
RADIX_HOLDER = "radix"


@dataclasses.dataclass
class MatchResult:
    """One admission-time prefix match.

    ``blocks`` are fully-written prefix blocks to ALIAS into the lease's
    leading table entries (``write_start = len(blocks) * block_size``
    tokens never rewritten); ``tail_block``/``tail_len`` describe a
    partial boundary block whose first ``tail_len`` tokens are COPIED —
    via the engine's row-cache seed — into the request's first private
    block.  ``resume`` is the prompt position chunked prefill restarts
    from (always <= prompt_len - 1: the final token is recomputed so
    prefill produces real first-token logits).

    Example::

        m = radix.prepare(req)
        lease = pool.admit(req.rid, plen, shared=m.blocks)
    """

    blocks: list[int] = dataclasses.field(default_factory=list)
    tail_block: Optional[int] = None
    tail_len: int = 0

    @property
    def hit(self) -> bool:
        return bool(self.blocks) or self.tail_len > 0

    def write_start(self, block_size: int) -> int:
        """First prompt position prefill WRITES (block-aligned: shared
        full blocks are never rewritten)."""
        return len(self.blocks) * block_size

    def resume(self, prompt_len: int, block_size: int) -> int:
        """Prompt position prefill resumes computing from."""
        r = len(self.blocks) * block_size + self.tail_len
        return min(r, prompt_len - 1)


@dataclasses.dataclass
class RadixStats:
    """Hit-rate accounting mirrored into ``ServeReport.radix``.

    Example::

        stats = engine._radix.stats
        rate = stats.hits / max(stats.lookups, 1)
    """

    lookups: int = 0
    hits: int = 0
    hit_tokens: int = 0
    inserted_blocks: int = 0
    evicted_blocks: int = 0


class _Node:
    """One trie node = one fully-written block.  ``key`` is the edge
    label from the parent (exactly ``block_size`` tokens); the node's
    full path key is the concatenation of edge labels root->here."""

    __slots__ = ("key", "block", "children", "tails", "parent", "last_used")

    def __init__(self, key: tuple, block: int, parent):
        self.key = key
        self.block = block
        self.children: dict[tuple, _Node] = {}
        self.tails: dict[tuple, "_Tail"] = {}
        self.parent = parent
        self.last_used = 0


class _Tail:
    """A partially-filled prompt-tail block retained at retirement:
    ``tokens`` (< block_size of them) are the valid prefix positions;
    anything past them in the physical block is the donor's decode
    garbage, which sharers never read (they copy only ``tokens``)."""

    __slots__ = ("tokens", "block", "last_used")

    def __init__(self, tokens: tuple, block: int):
        self.tokens = tokens
        self.block = block
        self.last_used = 0


class RadixCache:
    """Trie of radix-retained prefix blocks over a ``BlockAllocator``.

    Example::

        radix = RadixCache(pool.allocator, block_size=16)
        m = radix.prepare(req)                   # match + pin + evict
        lease = pool.admit(req.rid, plen, shared=m.blocks)
        radix.admitted(req.rid)
        ...
        radix.insert(req.prompt, lease.blocks)   # at prefill completion
    """

    def __init__(self, allocator: BlockAllocator, block_size: int,
                 tracer: Optional[Any] = None):
        self.allocator = allocator
        self.block_size = block_size
        self.obs = tracer if tracer is not None else get_tracer()
        self._root = _Node(key=(), block=-1, parent=None)
        self._clock = 0
        self._pending: dict[int, MatchResult] = {}   # rid -> match
        self._pins: dict[int, list[int]] = {}        # rid -> pinned pids
        self.stats = RadixStats()

    # -- lookup -----------------------------------------------------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, prompt: list[int]) -> MatchResult:
        """Longest cached prefix of ``prompt``: full blocks down the
        trie, then the best partial tail.  Bumps LRU stamps on the
        matched path.  Read-only — no refcounts move (see ``prepare``
        for the pinned admission-time variant)."""
        now = self._tick()
        bs = self.block_size
        node = self._root
        blocks: list[int] = []
        i = 0
        # full-block walk: a block is matchable only when the prompt
        # covers it entirely (partial coverage reads positions the
        # request will never attend — and the final token must always
        # be recomputed for logits, which resume() enforces)
        while i + bs <= len(prompt):
            child = node.children.get(tuple(prompt[i:i + bs]))
            if child is None:
                break
            child.last_used = now
            blocks.append(child.block)
            node = child
            i += bs
        # tail: longest common prefix against this node's partial
        # extensions, capped so at least one prompt token stays to
        # recompute
        best_tail, best_len = None, 0
        cap = len(prompt) - 1 - i
        if cap > 0:
            rest = prompt[i:]
            for tok, tail in node.tails.items():
                n = 0
                for a, b in zip(tok, rest):
                    if a != b:
                        break
                    n += 1
                n = min(n, cap)
                if n > best_len:
                    best_tail, best_len = tail, n
        if best_tail is not None:
            best_tail.last_used = now
        return MatchResult(blocks=blocks,
                           tail_block=(best_tail.block if best_tail else None),
                           tail_len=best_len)

    # -- admission protocol ----------------------------------------------

    def prepare(self, req) -> MatchResult:
        """Admission-time match: look up ``req.prompt``, PIN every
        matched block under a per-request holder (so this round's later
        evictions cannot free them before the lease lands), then evict
        LRU entries if the free list cannot cover the request's private
        remainder.  Pair with ``admitted``/``cancel``."""
        self.stats.lookups += 1
        m = self.match(req.prompt)
        pins = list(m.blocks)
        if m.tail_block is not None:
            pins.append(m.tail_block)
        if pins:
            self.allocator.retain(("radix-pin", req.rid), pins)
            self._pins[req.rid] = pins
        self._pending[req.rid] = m
        need = self.allocator.blocks_for(req.projected_len) - len(m.blocks)
        short = need - self.allocator.free_blocks
        if short > 0:
            short -= self.evict(short)
        if short > 0 and m.tail_block is not None:
            # eviction came up short with the tail still pinned.  The
            # tail is a COPY source, not an alias — and its pin may be
            # holding the pool's last evictable block, which would
            # starve this admission outright (matched full blocks can
            # never do that: dropping one raises the private remainder
            # by exactly the block its eviction would free).  No tail
            # reuse is worth a shed request: drop it and re-evict.
            pins = self._pins[req.rid]
            pins.remove(m.tail_block)
            self.allocator.release_blocks(("radix-pin", req.rid),
                                          [m.tail_block])
            if not pins:
                del self._pins[req.rid]
            m.tail_block, m.tail_len = None, 0
            self.evict(short)
        self.obs.count("radix_lookups")
        if m.hit:
            self.stats.hits += 1
            self.obs.count("radix_hits")
        return m

    def cancel(self, rid: int) -> None:
        """Admission fell through after ``prepare``: drop the pin and
        the pending match."""
        self._release_pin(rid)
        self._pending.pop(rid, None)

    def admitted(self, rid: int) -> None:
        """The lease landed: the lease itself now references the full
        prefix blocks, so the pin narrows to the tail block (released by
        ``seeded`` once the engine has copied it out)."""
        m = self._pending.get(rid)
        pins = self._pins.get(rid)
        if m is None or pins is None:
            return
        keep = [m.tail_block] if m.tail_block is not None else []
        drop = [b for b in pins if b not in keep] or None
        if drop:
            self.allocator.release_blocks(("radix-pin", rid), drop)
        if keep:
            self._pins[rid] = keep
        else:
            del self._pins[rid]

    def claim(self, rid: int) -> Optional[MatchResult]:
        """The engine's view of the pending match (kept until
        ``seeded``)."""
        return self._pending.get(rid)

    def seeded(self, rid: int) -> None:
        """The engine copied the matched tail (if any) into the
        request's private boundary block: release the remaining pin."""
        self._release_pin(rid)
        self._pending.pop(rid, None)

    def _release_pin(self, rid: int) -> None:
        pins = self._pins.pop(rid, None)
        if pins:
            self.allocator.release_blocks(("radix-pin", rid), pins)

    # -- insertion --------------------------------------------------------

    def insert(self, prompt: list[int], blocks: list[int]) -> int:
        """Index a prefilled request's FULLY-WRITTEN prompt blocks
        (``len(prompt) // block_size`` of them; the partial tail joins
        at retirement via ``insert_tail``).  Existing nodes are reused —
        only newly-created nodes retain their block under the radix
        holder.  Returns how many blocks were newly retained."""
        now = self._tick()
        bs = self.block_size
        node = self._root
        added = 0
        for j in range(len(prompt) // bs):
            key = tuple(prompt[j * bs:(j + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = _Node(key=key, block=blocks[j], parent=node)
                self.allocator.retain(RADIX_HOLDER, [blocks[j]])
                node.children[key] = child
                added += 1
            child.last_used = now
            node = child
        self.stats.inserted_blocks += added
        return added

    def insert_tail(self, prompt: list[int], blocks: list[int]) -> bool:
        """Index the partial prompt-tail block at RETIREMENT (the owner
        stops appending decode tokens to it only then).  No-ops when the
        prompt is block-aligned, the node path is gone (evicted), or an
        equal-or-longer tail already hangs there."""
        bs = self.block_size
        fb, rem = divmod(len(prompt), bs)
        if rem == 0:
            return False
        node = self._root
        for j in range(fb):
            node = node.children.get(tuple(prompt[j * bs:(j + 1) * bs]))
            if node is None:
                return False
        key = tuple(prompt[fb * bs:])
        if key in node.tails:
            node.tails[key].last_used = self._tick()
            return False
        tail = _Tail(tokens=key, block=blocks[fb])
        tail.last_used = self._tick()
        self.allocator.retain(RADIX_HOLDER, [blocks[fb]])
        node.tails[key] = tail
        self.stats.inserted_blocks += 1
        return True

    # -- eviction ---------------------------------------------------------

    def _evictable(self):
        """(last_used, kind, node, key) for every entry whose block the
        radix alone references (refcount 1): tails, and leaf nodes with
        no children AND no tails.  Pinned or lease-mapped blocks have
        refcount > 1 and never appear."""
        out = []

        def walk(node):
            for key, tail in node.tails.items():
                if self.allocator.refcount(tail.block) == 1:
                    out.append((tail.last_used, "tail", node, key))
            for key, child in node.children.items():
                if not child.children and not child.tails:
                    if self.allocator.refcount(child.block) == 1:
                        out.append((child.last_used, "node", node, key))
                else:
                    walk(child)

        walk(self._root)
        return out

    def evict(self, n_blocks: int) -> int:
        """Release the LRU evictable entries until ``n_blocks`` blocks
        returned to the free list (or nothing evictable remains).
        Removing a leaf can expose its parent, so candidates re-rank
        each step.  Returns blocks actually freed."""
        freed = 0
        while freed < n_blocks:
            cands = self._evictable()
            if not cands:
                break
            _, kind, parent, key = min(cands, key=lambda c: c[0])
            if kind == "tail":
                block = parent.tails.pop(key).block
            else:
                block = parent.children.pop(key).block
            self.allocator.release_blocks(RADIX_HOLDER, [block])
            freed += 1
        if freed:
            self.stats.evicted_blocks += freed
            self.obs.instant("radix_evict", blocks=freed)
            self.obs.count("radix_evicted_blocks", freed)
        return freed

    # -- introspection ----------------------------------------------------

    def blocks_indexed(self) -> int:
        """Blocks currently referenced by trie nodes + tails."""
        return len(self.allocator.holders().get(RADIX_HOLDER, []))

    def check(self) -> None:
        """Trie invariants (property-tested): every node key is exactly
        one block of tokens, each child's key extends its parent's path
        (node key = concatenation of edge labels), tails are strictly
        partial and exclusive to their node, and every referenced block
        is live in the allocator."""
        bs = self.block_size
        held = set(self.allocator.holders().get(RADIX_HOLDER, []))

        def walk(node, depth):
            for key, child in node.children.items():
                assert child.key == key and len(key) == bs, \
                    "node key is not one full block of edge labels"
                assert child.parent is node, "trie parent link broken"
                assert self.allocator.refcount(child.block) >= 1, \
                    "trie references a freed block"
                walk(child, depth + 1)
            seen_tail_blocks = set()
            for key, tail in node.tails.items():
                assert 0 < len(key) < bs, "tail must be strictly partial"
                assert tail.tokens == key
                assert tail.block not in seen_tail_blocks, \
                    "tail block shared inside one node"
                seen_tail_blocks.add(tail.block)
                assert self.allocator.refcount(tail.block) >= 1, \
                    "tail references a freed block"

        walk(self._root, 0)
        # radix holder holds exactly the blocks the structure references
        refs = []

        def collect(node):
            for child in node.children.values():
                refs.append(child.block)
                collect(child)
            refs.extend(t.block for t in node.tails.values())

        collect(self._root)
        assert len(refs) == len(set(refs)), \
            "one block referenced by two trie entries"
        assert set(refs) == held, "radix holder out of sync with the trie"

    def as_report(self) -> dict:
        """Stats dict mirrored into ``ServeReport.radix``."""
        s = self.stats
        return {
            "lookups": s.lookups,
            "hits": s.hits,
            "hit_tokens": s.hit_tokens,
            "hit_rate": s.hits / s.lookups if s.lookups else 0.0,
            "inserted_blocks": s.inserted_blocks,
            "evicted_blocks": s.evicted_blocks,
            "blocks_indexed": self.blocks_indexed(),
        }
