"""Block/paged KV-cache accounting for the serving pool.

A copy of the JAX package's ``serve/kvcache.py`` (the pool's storage
dtype lives in the engine and its adapter here, not in the pool).  It
accounts CAPACITY, blind to the cache arrays' layout:

  * ``BlockAllocator`` — a shared pool of fixed-size KV blocks with
    PER-BLOCK REFCOUNTS.  Every admitted request acquires enough blocks
    to cover its projected length and releases them on retirement;
    blocks are the admission currency.  A block's refcount is the
    number of holders listing it — live requests, plus the radix prefix
    cache (``serve.radix``), which retains prompt-prefix blocks under
    the ``"radix"`` holder so later requests with the same prefix map
    them instead of recomputing.  Invariant (``check``): every block is
    free XOR has refcount >= 1, and the refcount equals its holder
    count.
  * ``KVCachePool`` — slot bookkeeping on top: free-slot tracking,
    admission (slot AND blocks, atomically; optionally aliasing a
    shared block prefix), retirement, copy-on-write block promotion
    (``ensure_private``), and growth when the length bucket steps up.

Paging is PHYSICAL: block ids become cache locations through the
column-major grid mapping (``kernels.paged_gather.flat_position``)

    pid  ->  (slot row = pid % slots, offset = (pid // slots) * block_size)

so pool growth appends new ids without remapping live blocks;
``KVCachePool.block_table`` exports each lease as a logical -> physical
row for the scatter writes and the paged decode kernel.

Sharing safety: a block with refcount > 1 is read-only by contract.  The
engine enforces it by construction — prefix-shared blocks occupy only
the LEADING table entries of a request, the prefill write starts at the
first private block, and decode appends land past the prompt, in
private blocks.  ``ensure_private`` is the accounting half of
copy-on-write: it swaps a shared block out of one lease for a fresh
private one without ever touching the shared block.
"""

from __future__ import annotations

import dataclasses
from typing import Hashable, Iterable, Optional, Sequence


__all__ = ["BlockAllocator", "KVCachePool", "Lease"]


def ceil_div(a: int, b: int) -> int:
    """Ceiling integer division."""
    return -(-a // b)


class BlockAllocator:
    """Fixed pool of KV blocks with refcounted per-holder tracking.

    Example::

        >>> a = BlockAllocator(num_blocks=8, block_size=16)
        >>> a.alloc(rid=0, tokens=40)
        [0, 1, 2]
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: list[int] = list(range(num_blocks - 1, -1, -1))
        self._ref: dict[int, int] = {}                 # block -> refcount
        self._held: dict[Hashable, list[int]] = {}     # holder -> blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to cover ``tokens`` KV positions."""
        return ceil_div(max(tokens, 1), self.block_size)

    def can_alloc(self, tokens: int, shared: int = 0) -> bool:
        """True when the free list covers ``tokens`` positions, of which
        the first ``shared`` blocks come aliased (no free block cost)."""
        return self.blocks_for(tokens) - shared <= len(self._free)

    def refcount(self, block: int) -> int:
        """Current refcount of ``block`` (0 = free)."""
        return self._ref.get(block, 0)

    def alloc(self, rid: Hashable, tokens: int,
              shared: Sequence[int] = ()) -> list[int]:
        """Acquire blocks covering ``tokens`` for request ``rid``.

        ``shared`` aliases already-live blocks (a radix prefix match) as
        the lease's LEADING entries: their refcounts bump instead of
        consuming the free list, and only the remainder is popped fresh.
        """
        if rid in self._held:
            raise ValueError(f"request {rid} already holds blocks")
        n = self.blocks_for(tokens)
        if len(shared) > n:
            raise ValueError(f"shared prefix ({len(shared)} blocks) longer "
                             f"than the lease ({n})")
        for b in shared:
            if self._ref.get(b, 0) < 1:
                raise ValueError(f"shared block {b} is not live")
        fresh = n - len(shared)
        if fresh > len(self._free):
            raise MemoryError(f"need {fresh} blocks, {len(self._free)} free")
        got = list(shared) + [self._free.pop() for _ in range(fresh)]
        for b in got:
            self._ref[b] = self._ref.get(b, 0) + 1
        self._held[rid] = got
        return list(got)

    def release(self, rid: Hashable) -> list[int]:
        """Drop ``rid``'s references; blocks reaching refcount 0 return
        to the free list (a double release is a bug and raises)."""
        blocks = self._held.pop(rid)
        for b in blocks:
            self._decref(b)
        return blocks

    def retain(self, holder: Hashable, blocks: Iterable[int]) -> None:
        """Add references on live blocks under ``holder`` (the radix
        cache's retention path; a holder never lists a block twice)."""
        cur = self._held.setdefault(holder, [])
        seen = set(cur)
        for b in blocks:
            if b in seen:
                raise ValueError(f"holder {holder} already retains {b}")
            if self._ref.get(b, 0) < 1:
                raise ValueError(f"cannot retain free block {b}")
            cur.append(b)
            seen.add(b)
            self._ref[b] += 1

    def release_blocks(self, holder: Hashable,
                       blocks: Iterable[int]) -> None:
        """Drop ``holder``'s references on specific blocks (eviction /
        pin release); blocks reaching refcount 0 free."""
        cur = self._held.get(holder)
        if cur is None:
            raise KeyError(f"holder {holder} holds nothing")
        for b in blocks:
            cur.remove(b)                  # raises if not held: a bug
            self._decref(b)
        if not cur:
            del self._held[holder]

    def swap(self, holder: Hashable, old: int) -> int:
        """Copy-on-write accounting: replace ``holder``'s reference on
        ``old`` with a freshly popped private block.  ``old`` is NEVER
        mutated — only the holder's reference moves.  Returns the new
        private block id; raises ``MemoryError`` when the free list is
        empty."""
        cur = self._held[holder]
        i = cur.index(old)
        if self._ref.get(old, 0) < 1:
            raise ValueError(f"block {old} is not live")
        if not self._free:
            raise MemoryError("no free block for copy-on-write")
        new = self._free.pop()
        cur[i] = new
        self._ref[new] = 1
        self._decref(old)
        return new

    def _decref(self, b: int) -> None:
        self._ref[b] -= 1
        if self._ref[b] == 0:
            del self._ref[b]
            self._free.append(b)

    def holders(self) -> dict[Hashable, list[int]]:
        """Snapshot of holder -> held block ids (copies, not views)."""
        return {r: list(bs) for r, bs in self._held.items()}

    def add_blocks(self, n: int) -> None:
        """Grow the pool (backing a pool-length bucket step)."""
        if n < 0:
            raise ValueError("cannot remove blocks from a live pool")
        first = self.num_blocks
        self.num_blocks += n
        self._free.extend(range(first, first + n))

    def check(self) -> None:
        """Conservation: refcounts equal holder counts, and free XOR
        referenced partitions the pool."""
        counts: dict[int, int] = {}
        for bs in self._held.values():
            assert len(bs) == len(set(bs)), "holder lists a block twice"
            for b in bs:
                counts[b] = counts.get(b, 0) + 1
        assert counts == self._ref, "refcounts out of sync with holders"
        assert not set(counts) & set(self._free), "held block also free"
        assert len(self._free) == len(set(self._free)), "free list aliased"
        assert len(counts) + len(self._free) == self.num_blocks, \
            "blocks lost"
        assert all(c >= 1 for c in counts.values())


@dataclasses.dataclass
class Lease:
    """What one live request holds: a slot row + its KV blocks.  The
    first ``shared`` table entries alias radix-retained prefix blocks
    (refcount > 1, read-only); the rest are private.

    Example::

        lease = pool.admit(req.rid, req.projected_len)
        table_row = lease.blocks            # logical -> physical ids
    """

    rid: int
    slot: int
    blocks: list[int]
    projected_len: int
    shared: int = 0                        # leading aliased block count


class KVCachePool:
    """Slot + block bookkeeping for the engine's decode pool.

    Example::

        pool = KVCachePool(slots=4, kv_len=64, block_size=16)
        if pool.fits(projected):
            lease = pool.admit(rid, projected)
        pool.retire(rid)
    """

    def __init__(self, slots: int, kv_len: int, *, block_size: int = 16,
                 total_blocks: Optional[int] = None,
                 max_len: Optional[int] = None):
        if slots <= 0:
            raise ValueError("need at least one slot")
        self.slots = slots
        self.kv_len = kv_len
        self.max_len = max_len if max_len is not None else kv_len
        if self.max_len < kv_len:
            raise ValueError("max_len below the initial row length")
        self.block_size = block_size
        if total_blocks is None:
            total_blocks = slots * ceil_div(kv_len, block_size)
        self.allocator = BlockAllocator(total_blocks, block_size)
        self._free_slots: list[int] = list(range(slots - 1, -1, -1))
        self._leases: dict[int, Lease] = {}       # rid -> Lease
        self._by_slot: dict[int, int] = {}        # slot -> rid

    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    @property
    def live(self) -> int:
        return len(self._leases)

    def fits(self, projected_len: int, shared: int = 0) -> bool:
        """Admission predicate: a free slot, enough blocks (the first
        ``shared`` come aliased from the radix cache at no free-list
        cost), and a row long enough RIGHT NOW (a later, longer request
        waits for the pool to grow on its turn at the head)."""
        return (bool(self._free_slots)
                and projected_len <= self.kv_len
                and self.allocator.can_alloc(projected_len, shared))

    def admit(self, rid: int, projected_len: int,
              shared: Sequence[int] = ()) -> Lease:
        """Seat a request: a slot + blocks for ``projected_len``,
        atomically (raises without mutating when either is short).
        ``shared`` aliases radix-retained prefix blocks as the lease's
        leading table entries — their refcounts bump, the free list only
        pays for the private remainder."""
        if not self._free_slots:
            raise MemoryError("no free slot")
        if projected_len > self.kv_len:
            raise MemoryError(f"row too short: projected {projected_len} "
                              f"> kv_len {self.kv_len}")
        blocks = self.allocator.alloc(rid, projected_len, shared=shared)
        slot = self._free_slots.pop()
        lease = Lease(rid=rid, slot=slot, blocks=blocks,
                      projected_len=projected_len, shared=len(shared))
        self._leases[rid] = lease
        self._by_slot[slot] = rid
        return lease

    def retire(self, rid: int) -> Lease:
        """Release ``rid``'s slot + block references back to the pool
        (shared blocks survive under their remaining holders)."""
        lease = self._leases.pop(rid)
        self.allocator.release(rid)
        del self._by_slot[lease.slot]
        self._free_slots.append(lease.slot)
        return lease

    def refcount(self, block: int) -> int:
        """Refcount of a physical block (0 = free)."""
        return self.allocator.refcount(block)

    def ensure_private(self, rid: int, j: int) -> tuple[int, int]:
        """Copy-on-write promotion for logical block ``j`` of ``rid``'s
        lease: if the backing block is shared (refcount > 1), swap it
        for a fresh private block and return ``(old, new)``; already
        private returns ``(old, old)``.  PURE ACCOUNTING — the shared
        block's contents are never touched; the caller owns moving any
        live data into ``new``.

        Copy-on-write is legal only at or past the shared run's LAST
        block: a request never writes interior prefix positions (prefill
        resumes at ``write_start``, decode appends past the prompt), so
        an interior swap has no data to move and would strand aliased
        entries behind a shrunken ``lease.shared`` — it raises instead.

        Example::

            old, new = pool.ensure_private(req.rid, prompt_len // bs)
        """
        lease = self._leases[rid]
        old = lease.blocks[j]
        if self.allocator.refcount(old) <= 1:
            return old, old
        if j < lease.shared - 1:
            raise ValueError(
                f"copy-on-write at interior shared block {j} (shared run "
                f"is {lease.shared} blocks): prefix interiors are "
                f"read-only; COW applies at the run boundary only")
        new = self.allocator.swap(rid, old)
        lease.blocks[j] = new
        lease.shared = min(lease.shared, j)
        return old, new

    def lease(self, rid: int) -> Lease:
        """The live ``Lease`` held by request ``rid`` (KeyError if not
        live)."""
        return self._leases[rid]

    @property
    def max_blocks_per_row(self) -> int:
        """Block-table width covering the pool's maximum row length."""
        return ceil_div(self.max_len, self.block_size)

    def block_table(self, rid: int, width: Optional[int] = None) -> list[int]:
        """Request ``rid``'s logical -> physical block row, padded with
        -1 (unmapped) to ``width`` (default ``max_blocks_per_row``) so
        every live row shares one table shape."""
        width = width if width is not None else self.max_blocks_per_row
        blocks = self._leases[rid].blocks
        if len(blocks) > width:
            raise ValueError(f"lease holds {len(blocks)} blocks, table "
                             f"width {width}")
        return list(blocks) + [-1] * (width - len(blocks))

    def slot_owner(self, slot: int) -> Optional[int]:
        """The rid leasing ``slot``, or ``None`` when it is free."""
        return self._by_slot.get(slot)

    def grow(self, new_len: int, extra_blocks: Optional[int] = None) -> None:
        """Step the row length up to the next bucket; the allocator gains
        the blocks backing the new tail capacity."""
        if new_len < self.kv_len:
            raise ValueError("pool never shrinks mid-flight")
        if new_len > self.max_len:
            raise ValueError(f"growth past the pool cap "
                             f"({new_len} > {self.max_len})")
        if new_len == self.kv_len:
            return
        if extra_blocks is None:
            extra_blocks = self.slots * (
                ceil_div(new_len, self.block_size)
                - ceil_div(self.kv_len, self.block_size))
        self.allocator.add_blocks(extra_blocks)
        self.kv_len = new_len

    def check(self) -> None:
        """Pool-level invariants on top of the allocator's: slots
        partition cleanly, every lease fits its row, and live tables are
        pairwise disjoint EXCEPT on their shared leading prefixes."""
        self.allocator.check()
        slots_held = [l.slot for l in self._leases.values()]
        assert len(slots_held) == len(set(slots_held)), "slot double-booked"
        assert not set(slots_held) & set(self._free_slots), \
            "live slot also free"
        assert len(slots_held) + len(self._free_slots) == self.slots, \
            "slots lost"
        for rid, lease in self._leases.items():
            assert self._by_slot[lease.slot] == rid
            assert lease.projected_len <= self.kv_len, \
                "lease outgrew the pool row"
            for b in lease.blocks[lease.shared:]:
                # private region: this lease must be the sole live lease
                # mapping the block (the radix cache may also retain it,
                # so the refcount alone is not the test)
                for r2, l2 in self._leases.items():
                    assert r2 == rid or b not in l2.blocks[l2.shared:], \
                        "private block aliased by two leases"
