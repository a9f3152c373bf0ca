"""Request queue, admission control, and slot recycling.

A copy of the JAX package's ``serve/scheduler.py`` (no position offset:
the port serves no family with cache positions before token 0).
Requests move through four states —

    submitted (future arrival) -> ready (queued) -> live (holds a
    KVCachePool lease) -> done

— under a strict FIFO rule: only the HEAD of the ready queue is ever
considered, and it is admitted the moment the pool can seat it (a free
slot + enough KV blocks).  A request that could never be seated is
rejected at submission, so none starves.  Two admission modes:

  ``continuous``  recycle slots mid-decode — a finished request frees
                  its lease and the queue head takes it on the next tick;
  ``gang``        a new batch is admitted only when the pool is EMPTY —
                  the static fixed-batch baseline.

With a radix cache (``serve.radix``) attached, admission matches each
head request's prompt prefix first, and the matched blocks alias into
the lease's leading table entries.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Optional

from repro_torch.serve.kvcache import KVCachePool

__all__ = ["Request", "Scheduler", "ADMISSION_MODES"]

ADMISSION_MODES = ("continuous", "gang")

_rid_counter = itertools.count()


@dataclasses.dataclass
class Request:
    """One serving request plus its runtime bookkeeping.

    Example::

        req = Request(prompt=[1, 2, 3], max_new_tokens=8, arrival=0.0)
        engine.submit(req)
    """

    prompt: list[int]
    max_new_tokens: int
    arrival: float = 0.0
    rid: int = dataclasses.field(default_factory=lambda: next(_rid_counter))

    # runtime state (owned by scheduler/engine)
    slot: Optional[int] = None
    generated: list[int] = dataclasses.field(default_factory=list)
    rejected: bool = False

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def projected_len(self) -> int:
        """KV positions the request can ever occupy: the prompt plus one
        per generated token (the last token is never written back)."""
        return self.prompt_len + self.max_new_tokens

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class Scheduler:
    """FIFO admission + slot recycling over a ``KVCachePool``.

    Example::

        sched = Scheduler(pool, mode="continuous")
        sched.submit(req); sched.poll(now)
        for r in sched.admissible():
            ...  # prefill + seat r
    """

    def __init__(self, pool: KVCachePool, *, mode: str = "continuous",
                 radix=None):
        if mode not in ADMISSION_MODES:
            raise ValueError(f"mode must be one of {ADMISSION_MODES}, "
                             f"got {mode!r}")
        self.pool = pool
        self.mode = mode
        #: optional ``serve.radix.RadixCache``: admission matches each
        #: head request's prompt prefix, pins + evicts for room, and the
        #: matched blocks alias into the lease's leading table entries
        self.radix = radix
        self._future: deque[Request] = deque()    # submitted, not arrived
        self._ready: deque[Request] = deque()     # arrived, waiting
        self._live: dict[int, Request] = {}
        self.completed: list[Request] = []
        self.rejected: list[Request] = []

    def submit(self, req: Request) -> bool:
        """Accept a request for future admission; reject now the ones
        that could never be seated (projected length past the pool's
        maximum row)."""
        if req.projected_len > self.pool.max_len:
            req.rejected = True
            self.rejected.append(req)
            return False
        self._future.append(req)
        return True

    def poll(self, now: float) -> None:
        """Move arrived requests into the ready queue, in arrival order."""
        while self._future and self._future[0].arrival <= now:
            self._ready.append(self._future.popleft())

    def admissible(self) -> list[Request]:
        """Pop every request admission can seat RIGHT NOW, strictly from
        the queue head.  Callers prefill + seat each returned request.

        With a radix cache attached, each head request's prompt is
        matched FIRST (``RadixCache.prepare``: match, pin, evict for
        room): the matched full-prefix blocks alias into the lease
        (``KVCachePool.admit(shared=...)``), so admission charges the
        free list only for the private remainder, and the pin keeps a
        later head's eviction off the blocks this one maps."""
        if self.mode == "gang" and self._live:
            return []
        out = []
        while self._ready:
            req = self._ready[0]
            shared: list[int] = []
            if self.radix is not None:
                shared = self.radix.prepare(req).blocks
            if not self.pool.fits(req.projected_len, shared=len(shared)):
                if self.radix is not None:
                    self.radix.cancel(req.rid)
                break
            self._ready.popleft()
            lease = self.pool.admit(req.rid, req.projected_len,
                                    shared=shared)
            if self.radix is not None:
                self.radix.admitted(req.rid)
            req.slot = lease.slot
            self._live[req.rid] = req
            out.append(req)
        return out

    def finish(self, req: Request) -> None:
        """Retire a completed request: free its slot + blocks."""
        del self._live[req.rid]
        self.pool.retire(req.rid)
        req.slot = None
        self.completed.append(req)

    @property
    def live(self) -> list[Request]:
        return list(self._live.values())

    def live_by_slot(self) -> dict[int, Request]:
        """slot -> live request (the decode tick's row map)."""
        return {r.slot: r for r in self._live.values()}

    @property
    def backlog(self) -> int:
        return len(self._future) + len(self._ready)

    @property
    def next_arrival(self) -> Optional[float]:
        return self._future[0].arrival if self._future else None

    @property
    def idle(self) -> bool:
        return not (self._future or self._ready or self._live)

    def peek_need_len(self) -> Optional[int]:
        """Cache positions the queue head needs (pool-growth decisions)."""
        if not self._ready:
            return None
        return self._ready[0].projected_len

    def shed_head(self) -> Optional[Request]:
        """Drop the queue head into ``rejected`` — the engine's last
        resort when an empty pool still cannot seat it (block budget)."""
        if not self._ready:
            return None
        req = self._ready.popleft()
        req.rejected = True
        self.rejected.append(req)
        return req
