"""The port's radix prefix cache and refcounted block pool against the
JAX package's, on the CPU (both are host-only: ids and tokens).

  * the invariant harness of ``tests/test_radix.py`` over the port's
    ``KVCachePool`` and ``RadixCache``: refcount conservation, live
    tables disjoint except on shared leading prefixes, copy-on-write
    never mutating a shared block, the trie in sync with the
    ``"radix"`` holder, and a drain back to an all-free pool, checked
    after every op of seeded random tapes;
  * parity: one seeded script of prepare / cancel / admitted / claim /
    seeded / insert / insert_tail / evict / retire / grow / cow run
    through ``repro.serve.radix`` over ``repro.serve.kvcache`` and
    through the port's copies in lockstep, the ``MatchResult``s, the
    evicted counts, ``holders()`` and ``as_report()`` equal after every
    step;
  * ``ensure_private`` refuses an interior copy-on-write in both
    packages and swaps the run's last block the same way in both.
"""

import random

import pytest

from repro.serve import KVCachePool as JaxKVCachePool
from repro.serve import RadixCache as JaxRadixCache
from repro.serve import Request as JaxRequest

from repro_torch.serve import (KVCachePool, MatchResult, RadixCache,
                               RadixStats, Request)

BS = 8                      # small blocks -> dense prefix collisions


# --------------------------------------------------------------------------- #
# the invariant harness (tests/test_radix.py's, on the port's classes)
# --------------------------------------------------------------------------- #


class _Harness:
    """One pool + radix driven through the engine's admission and
    retirement protocol; ``check_all`` runs after every op.  Prompts draw
    from three fixed preambles over a tiny alphabet, so full-block
    matches, partial-tail matches and cold misses all occur within a
    handful of ops."""

    def __init__(self, slots: int, seed: int, kv_len: int = 64,
                 max_len: int = 128):
        self.rng = random.Random(seed)
        self.pool = KVCachePool(slots, kv_len, block_size=BS,
                                max_len=max_len)
        self.radix = RadixCache(self.pool.allocator, BS)
        # one aligned preamble (pure full-block hits), two ragged ones
        # (full blocks + a partial tail)
        self.preambles = [[self.rng.randrange(2, 8) for _ in range(n)]
                          for n in (2 * BS, 2 * BS + 3, BS + 5)]
        self.live: dict[int, tuple[list, object]] = {}  # rid -> (prompt, lease)

    def _prompt(self, a: int, b: int) -> list[int]:
        pre = self.preambles[a % len(self.preambles)]
        head = pre if a % 4 else pre[:b % (len(pre) + 1)]
        suffix = [self.rng.randrange(2, 8) for _ in range(1 + b % 6)]
        return list(head) + suffix

    def admit(self, a: int, b: int):
        prompt = self._prompt(a, b)
        req = Request(prompt=prompt, max_new_tokens=1 + a % 6)
        m = self.radix.prepare(req)
        if not self.pool.fits(req.projected_len, shared=len(m.blocks)):
            self.radix.cancel(req.rid)
            return
        lease = self.pool.admit(req.rid, req.projected_len, shared=m.blocks)
        self.radix.admitted(req.rid)
        assert self.radix.claim(req.rid) is m
        # matched full blocks alias the lease's LEADING entries verbatim
        assert lease.blocks[:len(m.blocks)] == m.blocks
        assert lease.shared == len(m.blocks)
        # shared blocks never reach the decode-append block
        plen = len(prompt)
        assert len(m.blocks) <= plen // BS
        assert len(lease.blocks) > plen // BS or plen % BS
        # resume always leaves the last prompt token to recompute
        assert m.resume(plen, BS) <= plen - 1
        assert m.write_start(BS) == len(m.blocks) * BS
        self.radix.seeded(req.rid)                # row cache seeded
        self.radix.insert(prompt, lease.blocks)   # prefill completed
        self.live[req.rid] = (prompt, lease)

    def retire(self, a: int, b: int):
        if not self.live:
            return
        rid = sorted(self.live)[a % len(self.live)]
        prompt, lease = self.live.pop(rid)
        self.radix.insert_tail(prompt, lease.blocks)
        self.pool.retire(rid)

    def cow(self, a: int, b: int):
        """Copy-on-write some logical block of some live lease."""
        if not self.live or not self.pool.allocator.free_blocks:
            return
        rid = sorted(self.live)[a % len(self.live)]
        lease = self.live[rid][1]
        j = b % len(lease.blocks)
        old = lease.blocks[j]
        before = self.pool.refcount(old)
        free_before = self._free_set()
        if before > 1 and j < lease.shared - 1:
            # interior prefix blocks are read-only: the pool refuses the
            # swap and changes nothing
            with pytest.raises(ValueError):
                self.pool.ensure_private(rid, j)
            assert lease.blocks[j] == old
            assert self.pool.refcount(old) == before
            return
        got_old, new = self.pool.ensure_private(rid, j)
        assert got_old == old
        if before > 1:
            # the shared block keeps its other holders; the private
            # replacement came off the free list (nobody's live data)
            assert new != old
            assert self.pool.refcount(old) == before - 1
            assert self.pool.refcount(new) == 1
            assert new in free_before
            assert lease.shared <= j
        else:
            assert new == old

    def evict(self, a: int, b: int):
        self.radix.evict(1 + a % 3)

    def grow(self, a: int, b: int):
        nxt = min(self.pool.kv_len + BS * (1 + a % 2), self.pool.max_len)
        self.pool.grow(nxt)

    def _free_set(self):
        alloc = self.pool.allocator
        return set(range(alloc.num_blocks)) - {
            b for bs in alloc.holders().values() for b in bs}

    def check_all(self):
        self.pool.check()     # conservation + disjoint-except-shared
        self.radix.check()    # trie structure + holder sync
        for prompt, lease in self.live.values():
            # every shared leading block is also radix-held (>= 2), which
            # is why eviction can never free it
            for blk in lease.blocks[:lease.shared]:
                assert self.pool.refcount(blk) >= 2

    def drain(self):
        """Retire everything, evict everything: the pool ends as it
        started, every block free."""
        for rid in sorted(self.live):
            prompt, lease = self.live[rid]
            self.radix.insert_tail(prompt, lease.blocks)
            self.pool.retire(rid)
        self.live.clear()
        self.radix.evict(10 ** 9)
        alloc = self.pool.allocator
        assert alloc.free_blocks == alloc.num_blocks, "blocks leaked"
        assert alloc.holders() == {}, "stale holders survive drain"
        self.pool.check()
        self.radix.check()


_OPS = ("admit", "admit", "admit", "retire", "cow", "evict", "grow")


def test_invariants_seeded_sweep():
    """The harness over seeded random op tapes, every invariant after
    every op, then a full drain."""
    rng = random.Random(7)
    for trial in range(40):
        ops = [(rng.choice(_OPS), rng.randrange(1000), rng.randrange(1000))
               for _ in range(rng.randrange(1, 30))]
        h = _Harness(rng.randrange(1, 6), trial)
        for kind, a, b in ops:
            getattr(h, kind)(a, b)
            h.check_all()
        h.drain()


def test_stats_report_shape():
    """``as_report`` mirrors the counters ``ServeReport.radix`` exposes."""
    pool = KVCachePool(2, 4 * BS, block_size=BS)
    radix = RadixCache(pool.allocator, BS)
    rep = radix.as_report()
    assert set(rep) == {"lookups", "hits", "hit_tokens", "hit_rate",
                        "inserted_blocks", "evicted_blocks",
                        "blocks_indexed"}
    assert rep["hit_rate"] == 0.0 and rep["blocks_indexed"] == 0
    assert isinstance(radix.stats, RadixStats)
    assert not MatchResult().hit and MatchResult(tail_len=1).hit


# --------------------------------------------------------------------------- #
# parity with the JAX package's radix over its pool
# --------------------------------------------------------------------------- #


class _Side:
    """One package's pool + radix with the requests it holds: prepared
    (match pending), admitted (lease, insert pending) and live."""

    def __init__(self, pool_cls, radix_cls, req_cls, slots, kv_len,
                 max_len, total_blocks):
        self.req_cls = req_cls
        self.pool = pool_cls(slots, kv_len, block_size=BS, max_len=max_len,
                             total_blocks=total_blocks)
        self.radix = radix_cls(self.pool.allocator, BS)
        self.admitted: dict[int, list] = {}     # rid -> prompt (no insert)
        self.live: dict[int, list] = {}         # rid -> prompt

    def state(self):
        return (self.pool.allocator.holders(), self.radix.as_report(),
                self.pool.allocator.free_blocks, self.pool.kv_len)


def _match(m):
    return None if m is None else (list(m.blocks), m.tail_block, m.tail_len,
                                   m.hit)


def _step(side, op, a, b, prompt, rid):
    """Apply one op to one side; returns what the op observed."""
    if op == "admit":
        req = side.req_cls(prompt=prompt, max_new_tokens=1 + a % 5, rid=rid)
        m = side.radix.prepare(req)
        seen = _match(m)
        if not side.pool.fits(req.projected_len, shared=len(m.blocks)):
            side.radix.cancel(rid)
            return ("cancelled", seen)
        lease = side.pool.admit(rid, req.projected_len, shared=m.blocks)
        side.radix.admitted(rid)
        claim = _match(side.radix.claim(rid))
        side.radix.seeded(rid)
        side.admitted[rid] = prompt
        return ("admitted", seen, claim, list(lease.blocks), lease.shared,
                m.resume(len(prompt), BS), m.write_start(BS))
    if op == "insert":
        if not side.admitted:
            return None
        rid = sorted(side.admitted)[a % len(side.admitted)]
        p = side.admitted.pop(rid)
        side.live[rid] = p
        return ("insert", side.radix.insert(p, side.pool.lease(rid).blocks))
    if op == "retire":
        if not side.live:
            return None
        rid = sorted(side.live)[a % len(side.live)]
        p = side.live.pop(rid)
        tail = side.radix.insert_tail(p, side.pool.lease(rid).blocks)
        return ("retire", tail, side.pool.retire(rid).blocks)
    if op == "evict":
        return ("evict", side.radix.evict(1 + a % 4))
    if op == "grow":
        nxt = min(side.pool.kv_len + BS * (1 + a % 2), side.pool.max_len)
        side.pool.grow(nxt)
        return ("grow", side.pool.kv_len)
    if op == "match":
        return ("match", _match(side.radix.match(prompt)))
    if op == "cow":
        if not side.live:
            return None
        rid = sorted(side.live)[a % len(side.live)]
        lease = side.pool.lease(rid)
        j = b % len(lease.blocks)
        try:
            return ("cow", side.pool.ensure_private(rid, j), lease.shared)
        except (ValueError, MemoryError) as e:
            return ("cow refused", type(e).__name__)
    raise AssertionError(op)


_PARITY_OPS = ("admit", "admit", "admit", "insert", "insert", "retire",
               "retire", "evict", "grow", "match", "cow")


@pytest.mark.parametrize("total_blocks", [None, 10], ids=["grid", "tight"])
@pytest.mark.parametrize("seed", range(4))
def test_radix_matches_the_reference_step_by_step(seed, total_blocks):
    rng = random.Random(100 + seed)
    preambles = [[rng.randrange(2, 8) for _ in range(n)]
                 for n in (2 * BS, 2 * BS + 3, BS + 5, 3 * BS + 1)]
    kw = dict(slots=3, kv_len=8 * BS, max_len=16 * BS,
              total_blocks=total_blocks)
    jax_side = _Side(JaxKVCachePool, JaxRadixCache, JaxRequest, **kw)
    port = _Side(KVCachePool, RadixCache, Request, **kw)
    rid = 10_000 * (seed + 1)
    seen_ops = set()
    for _ in range(160):
        op = rng.choice(_PARITY_OPS)
        a, b = rng.randrange(1000), rng.randrange(1000)
        pre = preambles[a % len(preambles)]
        prompt = list(pre[:len(pre) - b % 3]) + \
            [rng.randrange(2, 8) for _ in range(b % 7)]
        if not prompt:
            prompt = [2]
        rid += 1
        want = _step(jax_side, op, a, b, prompt, rid)
        got = _step(port, op, a, b, prompt, rid)
        assert got == want, (op, got, want)
        assert port.state() == jax_side.state(), op
        port.pool.check()
        port.radix.check()
        if got is not None:
            seen_ops.add(got[0])
    assert {"admitted", "insert", "retire", "evict", "match"} <= seen_ops
    rep = port.radix.as_report()
    assert rep["hits"] > 0 and rep["inserted_blocks"] > 0
    if total_blocks is not None:
        assert rep["evicted_blocks"] > 0


def _shared_lease(pool_cls, radix_cls, req_cls):
    """A donor writes a 3-block prompt prefix and retires; a sharer maps
    all three blocks (``lease.shared`` 3)."""
    pool = pool_cls(2, 8 * BS, block_size=BS)
    radix = radix_cls(pool.allocator, BS)
    prompt = list(range(2, 2 + 3 * BS)) + [1]
    for rid in (1, 2):
        req = req_cls(prompt=prompt, max_new_tokens=2, rid=rid)
        m = radix.prepare(req)
        lease = pool.admit(rid, req.projected_len, shared=m.blocks)
        radix.admitted(rid)
        radix.seeded(rid)
        radix.insert(prompt, lease.blocks)
        if rid == 1:
            pool.retire(rid)
    assert pool.lease(2).shared == 3
    return pool, radix


def test_ensure_private_refuses_interior_copy_on_write_in_both():
    results = []
    for classes in ((JaxKVCachePool, JaxRadixCache, JaxRequest),
                    (KVCachePool, RadixCache, Request)):
        pool, radix = _shared_lease(*classes)
        lease = pool.lease(2)
        before = list(lease.blocks)
        for j in (0, 1):                       # interior of the shared run
            with pytest.raises(ValueError, match="interior"):
                pool.ensure_private(2, j)
        assert lease.blocks == before and lease.shared == 3
        old, new = pool.ensure_private(2, 2)   # the run's last block
        assert old == before[2] and new != old
        assert pool.refcount(old) == 1 and pool.refcount(new) == 1
        assert lease.shared == 2
        # a private block stays put
        assert pool.ensure_private(2, 3) == (before[3], before[3])
        pool.check()
        radix.check()
        results.append((lease.blocks, pool.allocator.holders()))
    assert results[0] == results[1]
