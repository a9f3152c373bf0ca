"""Block/paged KV-cache accounting for the serving pool.

A copy of the JAX package's ``serve/kvcache.py`` without the radix
prefix cache's sharing paths (retain, copy-on-write, aliased leases).

  * ``BlockAllocator`` — a shared pool of fixed-size KV blocks.  Every
    admitted request acquires enough blocks to cover its projected
    length and releases them on retirement; blocks are the admission
    currency.  Invariant (``check``): every block is free XOR held by
    exactly one holder.
  * ``KVCachePool`` — slot bookkeeping on top: free-slot tracking,
    admission (slot AND blocks, atomically), retirement, and growth when
    the length bucket steps up.

Paging is PHYSICAL: block ids become cache locations through the
column-major grid mapping (``kernels.paged_gather.flat_position``)

    pid  ->  (slot row = pid % slots, offset = (pid // slots) * block_size)

so pool growth appends new ids without remapping live blocks;
``KVCachePool.block_table`` exports each lease as a logical -> physical
row for the scatter writes and the paged decode kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Hashable, Optional

__all__ = ["BlockAllocator", "KVCachePool", "Lease"]


def ceil_div(a: int, b: int) -> int:
    """Ceiling integer division."""
    return -(-a // b)


class BlockAllocator:
    """Fixed pool of KV blocks with per-holder tracking.

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
        self._held: dict[Hashable, list[int]] = {}     # holder -> blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to cover ``tokens`` KV positions."""
        return ceil_div(max(tokens, 1), self.block_size)

    def can_alloc(self, tokens: int) -> bool:
        """True when the free list covers ``tokens`` positions."""
        return self.blocks_for(tokens) <= len(self._free)

    def alloc(self, rid: Hashable, tokens: int) -> list[int]:
        """Acquire blocks covering ``tokens`` for request ``rid``."""
        if rid in self._held:
            raise ValueError(f"request {rid} already holds blocks")
        n = self.blocks_for(tokens)
        if n > len(self._free):
            raise MemoryError(f"need {n} blocks, {len(self._free)} free")
        got = [self._free.pop() for _ in range(n)]
        self._held[rid] = got
        return list(got)

    def release(self, rid: Hashable) -> list[int]:
        """Return ``rid``'s blocks to the free list (a double release is
        a bug and raises)."""
        blocks = self._held.pop(rid)
        self._free.extend(blocks)
        return blocks

    def add_blocks(self, n: int) -> None:
        """Grow the pool (backing a pool-length bucket step)."""
        if n < 0:
            raise ValueError("cannot remove blocks from a live pool")
        first = self.num_blocks
        self.num_blocks += n
        self._free.extend(range(first, first + n))

    def check(self) -> None:
        """Conservation: held and free partition the pool, no block is
        held twice."""
        held = [b for bs in self._held.values() for b in bs]
        assert len(held) == len(set(held)), "block held twice"
        assert not set(held) & set(self._free), "held block also free"
        assert len(self._free) == len(set(self._free)), "free list aliased"
        assert len(held) + len(self._free) == self.num_blocks, "blocks lost"


@dataclasses.dataclass
class Lease:
    """What one live request holds: a slot row + its KV blocks.

    Example::

        lease = pool.admit(req.rid, req.projected_len)
        table_row = lease.blocks            # logical -> physical ids
    """

    rid: int
    slot: int
    blocks: list[int]
    projected_len: int


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

    def fits(self, projected_len: int) -> bool:
        """Admission predicate: a free slot, enough blocks, and a row
        long enough RIGHT NOW (a later, longer request waits for the pool
        to grow on its turn at the head)."""
        return (bool(self._free_slots)
                and projected_len <= self.kv_len
                and self.allocator.can_alloc(projected_len))

    def admit(self, rid: int, projected_len: int) -> Lease:
        """Seat a request: a slot + blocks for ``projected_len``,
        atomically (raises without mutating when either is short)."""
        if not self._free_slots:
            raise MemoryError("no free slot")
        if projected_len > self.kv_len:
            raise MemoryError(f"row too short: projected {projected_len} "
                              f"> kv_len {self.kv_len}")
        blocks = self.allocator.alloc(rid, projected_len)
        slot = self._free_slots.pop()
        lease = Lease(rid=rid, slot=slot, blocks=blocks,
                      projected_len=projected_len)
        self._leases[rid] = lease
        self._by_slot[slot] = rid
        return lease

    def retire(self, rid: int) -> Lease:
        """Release ``rid``'s slot + blocks back to the pool."""
        lease = self._leases.pop(rid)
        self.allocator.release(rid)
        del self._by_slot[lease.slot]
        self._free_slots.append(lease.slot)
        return lease

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
        partition cleanly and every lease fits its row."""
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
