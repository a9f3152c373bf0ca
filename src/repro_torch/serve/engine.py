"""Continuous-batching serving engine — the dense path of the JAX
package's ``serve/engine.py`` on PyTorch.

  * admitted requests prefill either whole (prompt padded to its bucket,
    true-last-token logits via ``Model.prefill(last_pos=...)``) or, by
    default, chunk by chunk between decode ticks (``prefill_chunk``);
    the finished row's K/V scatter into the request's leased blocks;
  * the whole pool decodes one token per tick through one step whose
    rows are ragged — every row carries its own position — and whose
    attention reads the paged pool through the block tables in the fused
    kernel, at the router's per-bucket ``block_s``;
  * finished requests retire mid-decode and their slot + blocks recycle
    to the queue head; greedy argmax picks every token.

The engine's clock is injectable; when the pool is idle it fast-forwards
to the next synthetic arrival, so open-loop traffic never sleeps.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.hw import detect, resolve_device
from repro_torch.kernels.paged_gather import flat_position
from repro_torch.models import build_model
from repro_torch.serve.adapters import get_adapter
from repro_torch.serve.buckets import BucketRouter, BucketSpec
from repro_torch.serve.kvcache import KVCachePool
from repro_torch.serve.metrics import ServeMetrics, ServeSummary
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["ServeEngine", "ServeReport"]


@dataclasses.dataclass
class _ChunkTask:
    """One in-flight chunked prefill: the request holds its slot and
    blocks from admission, but decode skips it until ``write_row`` lands
    the finished row."""

    req: Request
    cache: dict                    # private B=1 row cache (length pb)
    toks: np.ndarray               # (prompt_len,) prompt tokens
    pb: int                        # row-cache length (prompt bucket)
    tiles: tuple                   # the bucket's flash tiles
    chunk: int                     # chunk width C
    blocks: list                   # leased block ids
    done: int = 0                  # prompt tokens consumed so far


@dataclasses.dataclass
class ServeReport:
    """Everything one engine run produced.

    Example::

        report = engine.run()
        print(report.summary.tokens_per_s, report.outputs)
    """

    summary: ServeSummary
    outputs: dict[int, list[int]]          # rid -> prompt + generated
    completed: list[Request]
    rejected: list[Request]
    router_stats: dict
    pool_growths: int
    #: the bucket plans that executed: kv_len -> paged block_s, and
    #: prompt bucket -> flash (block_q, block_k)
    paged_decode_blocks: dict = dataclasses.field(default_factory=dict)
    prefill_tiles: dict = dataclasses.field(default_factory=dict)


class ServeEngine:
    """Continuous-batching loop over a bucketed, paged decode pool.

    ``arch`` is a registered config name or a ``ModelConfig``; ``reduced``
    applies only to names.  ``device`` defaults to "cuda" and raises when
    no CUDA device is present; ``device="cpu"`` runs the kernels' plain
    versions.  ``params`` (the model's param dict) defaults to random
    weights from ``seed``.  ``prefill_chunk``: "auto" (the default)
    chunks prefill at the bucket's flash ``block_q``, an int fixes the
    width, ``None`` prefills whole prompts.

    Example::

        eng = ServeEngine("smollm-135m", slots=4, max_len=256)
        eng.submit([1, 2, 3], max_new_tokens=8)
        report = eng.run()
    """

    def __init__(self, arch: str | ModelConfig, *,
                 slots: int = 4,
                 max_len: int = 256,
                 reduced: bool = True,
                 params: Optional[dict] = None,
                 seed: int = 0,
                 block_size: int = 16,
                 paged: bool = True,
                 fused_decode: bool = True,
                 prefill_chunk: int | str | None = "auto",
                 eos_id: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 device="cuda",
                 verbose: bool = False):
        self.device = resolve_device(device)
        if not paged:
            raise NotImplementedError(
                "paged=False (contiguous KV rows) is queued for a later "
                "slice of the port")
        if not fused_decode:
            raise NotImplementedError(
                "fused_decode=False (gather-then-sweep decode) is queued for "
                "a later slice of the port")
        if prefill_chunk is not None and not isinstance(prefill_chunk, int) \
                and prefill_chunk != "auto":
            raise ValueError(f"prefill_chunk must be None, an int, or "
                             f"'auto', got {prefill_chunk!r}")
        cfg = get_config(arch) if isinstance(arch, str) else arch
        if isinstance(arch, str) and reduced:
            cfg = cfg.reduced()
        self.adapter = get_adapter(cfg.family)
        self.cfg = cfg
        self.slots = slots
        self.spec = BucketSpec(max_len=max_len, min_len=min(32, max_len))
        for n in self.spec.lattice():
            if n % block_size:
                raise ValueError(f"the paged pool needs lattice lengths "
                                 f"divisible by block_size={block_size}, "
                                 f"got {n}")
        self.eos_id = eos_id
        self.verbose = verbose
        self._clock = clock

        self.model = build_model(cfg, device=self.device)
        self.params = params if params is not None else self.model.init(seed)
        self.hw = detect(self.device)
        self.router = BucketRouter(cfg, self.spec, slots=slots, hw=self.hw,
                                   page_block=block_size)
        self._block_size = block_size
        self._chunk_cfg = prefill_chunk
        self._chunked = prefill_chunk is not None
        self.reset()

    def reset(self) -> None:
        """Clear traffic state (pool, queue, metrics, outputs)."""
        kv0 = self.spec.quantize(1)
        self.pool = KVCachePool(self.slots, kv0, block_size=self._block_size,
                                max_len=self.spec.max_len)
        self.scheduler = Scheduler(self.pool)
        self.metrics = ServeMetrics()
        self.outputs: dict[int, list[int]] = {}
        self._cache = self.adapter.init_pool(self.model, self.slots, kv0)
        self._tables = np.full((self.slots, self.pool.max_blocks_per_row),
                               -1, np.int32)
        self._tables_dev: Optional[torch.Tensor] = None
        self._tokens = np.zeros((self.slots, 1), np.int64)
        self._plan_len = -1
        self._bucket_plan = None
        self._chunk_tasks: list[_ChunkTask] = []
        self._prefilling: dict[int, _ChunkTask] = {}
        self.pool_growths = 0
        self.executed_decode_blocks: dict[int, int] = {}
        self.executed_prefill_tiles: dict[int, tuple] = {}
        self._t0: Optional[float] = None
        self._skew = 0.0

    # -- time -------------------------------------------------------------

    def _now(self) -> float:
        if self._t0 is None:
            self._t0 = self._clock()
        return self._clock() - self._t0 + self._skew

    def _fast_forward(self, to_t: float) -> None:
        now = self._now()
        if to_t > now:
            self._skew += to_t - now

    def _sync(self) -> None:
        """Wait for the device, so host timings cover the work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- pool plumbing ----------------------------------------------------

    def _current_plan(self):
        """The live bucket's plan, memoised on the pool length."""
        if self._plan_len != self.pool.kv_len:
            self._bucket_plan = self.router.resolve(
                self.router.bucket(self.pool.kv_len))
            self._plan_len = self.pool.kv_len
        return self._bucket_plan

    def _grow_pool(self, new_len: int) -> None:
        if new_len % self._block_size:
            raise ValueError(f"paged pool length {new_len} not a multiple "
                             f"of block_size={self._block_size}")
        self._cache = self.adapter.grow(self._cache, new_len)
        self.pool.grow(new_len)
        self.pool_growths += 1
        if self.verbose:
            print(f"[serve] pool -> ({self.slots}, {new_len})")

    def _page_map(self, blocks: list[int], n: int) -> torch.Tensor:
        """Flat physical positions of one request's logical tokens
        ``[0, n)`` (the prefill write path)."""
        bs = self._block_size
        tok = np.arange(n)
        pid = np.asarray(blocks, np.int64)[tok // bs]
        return torch.from_numpy(
            flat_position(pid, tok, self.slots, self.pool.kv_len, bs)
        ).to(self.device)

    def _publish(self, req: Request) -> None:
        """Publish the request's block-table row to the decode step."""
        self._tables[req.slot] = self.pool.block_table(req.rid)
        self._tables_dev = None

    # -- intake -----------------------------------------------------------

    def submit(self, req: Request | list[int], *,
               max_new_tokens: int = 16, arrival: float = 0.0) -> Request:
        """Queue a request (a ``Request`` or a raw prompt token list)."""
        if not isinstance(req, Request):
            req = Request(prompt=list(req), max_new_tokens=max_new_tokens,
                          arrival=arrival)
        req.prompt = [int(t) for t in req.prompt]
        if req.prompt_len < 1:
            raise ValueError("empty prompt")
        if self.scheduler.submit(req):
            self.metrics.on_submit(req.rid, req.arrival, req.prompt_len)
        return req

    # -- admission + prefill ----------------------------------------------

    def _admit(self, req: Request, now: float) -> None:
        if self._chunked:
            self._admit_chunked(req, now)
            return
        plen = req.prompt_len
        pb = self.adapter.prefill_len(plen, self.router.quantize_prompt)
        toks = np.zeros((1, pb), np.int64)
        toks[0, :plen] = req.prompt
        tiles = self.router.prefill_tiles(pb)
        self.executed_prefill_tiles[pb] = tiles
        t0 = time.perf_counter()
        logits, rcache = self.model.prefill(
            self.params, torch.from_numpy(toks).to(self.device), pb,
            last_pos=[plen - 1], prefill_tiles=tiles)
        first = int(logits[0, -1].argmax())          # waits for the device
        self.metrics.add_prefill_time(time.perf_counter() - t0)
        self._publish(req)
        self._cache = self.adapter.write_row(
            self._cache, req.slot, rcache, plen, self.pool.kv_len,
            page_map=self._page_map(self.pool.lease(req.rid).blocks, plen))
        req.generated.append(first)
        self._tokens[req.slot, 0] = first
        self.metrics.on_admit(req.rid, now)
        self.metrics.on_first_token(req.rid, self._now())

    def _chunk_size(self, tiles: tuple) -> int:
        if isinstance(self._chunk_cfg, int):
            return max(1, self._chunk_cfg)
        # "auto": the bucket's flash block_q — the quantum the planner
        # decided a prefill sweep advances in
        return int(tiles[0])

    def _admit_chunked(self, req: Request, now: float) -> None:
        """Seat the request (slot + blocks leased) but run its prefill
        chunk by chunk between decode ticks.  Its block-table row is NOT
        published until the row lands (``_finish_chunked``): a recycled
        slot's stale ``pos`` keeps advancing each tick, and an unpublished
        (-1) row writes nothing."""
        pb = self.adapter.prefill_len(req.prompt_len,
                                      self.router.quantize_prompt)
        tiles = self.router.prefill_tiles(pb)
        self.executed_prefill_tiles[pb] = tiles
        task = _ChunkTask(req=req, cache=self.model.init_cache(1, pb),
                          toks=np.asarray(req.prompt, np.int64), pb=pb,
                          tiles=tiles, chunk=min(self._chunk_size(tiles), pb),
                          blocks=self.pool.lease(req.rid).blocks)
        self._chunk_tasks.append(task)
        self._prefilling[req.rid] = task
        self.metrics.on_admit(req.rid, now)

    def _prefill_tick(self) -> bool:
        """Advance the oldest in-flight chunked prefill by ONE chunk — at
        most one chunk of prefill runs between consecutive decode ticks."""
        if not self._chunk_tasks:
            return False
        task = self._chunk_tasks[0]
        c, start = task.chunk, task.done
        n = min(c, len(task.toks) - start)
        buf = np.zeros((1, c), np.int64)
        buf[0, :n] = task.toks[start:start + n]
        t0 = time.perf_counter()
        logits, task.cache = self.model.prefill_chunk(
            self.params, task.cache, torch.from_numpy(buf).to(self.device),
            n, prefill_tiles=task.tiles)
        task.done += n
        if task.done >= len(task.toks):
            first = int(logits[0, n - 1].argmax())   # waits for the device
            self.metrics.add_prefill_time(time.perf_counter() - t0)
            self._finish_chunked(task, first)
        else:
            self._sync()
            self.metrics.add_prefill_time(time.perf_counter() - t0)
        return True

    def _finish_chunked(self, task: _ChunkTask, first: int) -> None:
        req = task.req
        self._publish(req)
        self._cache = self.adapter.write_row(
            self._cache, req.slot, task.cache, req.prompt_len,
            self.pool.kv_len,
            page_map=self._page_map(task.blocks, req.prompt_len))
        req.generated.append(first)
        self._tokens[req.slot, 0] = first
        self.metrics.on_first_token(req.rid, self._now())
        self._chunk_tasks.pop(0)
        del self._prefilling[req.rid]

    # -- decode -----------------------------------------------------------

    def _decode_tick(self) -> None:
        plan = self._current_plan()
        if self._tables_dev is None:
            # tables change only at admit/retire: upload on change
            self._tables_dev = torch.from_numpy(self._tables).to(self.device)
        self.executed_decode_blocks[self.pool.kv_len] = \
            plan.paged_decode_block
        t0 = time.perf_counter()
        logits, self._cache = self.model.decode_step(
            self.params, self._cache,
            torch.from_numpy(self._tokens).to(self.device),
            page_tables=self._tables_dev, page_block=self._block_size,
            paged_decode_block=plan.paged_decode_block)
        nxt = logits[:, 0].argmax(-1).cpu().numpy()   # waits for the device
        self.metrics.add_decode_time(time.perf_counter() - t0)
        n_dec = 0
        for slot, req in self.scheduler.live_by_slot().items():
            # rows still chunk-prefilling ride the step (their leased row
            # is written by write_row at completion) but their outputs are
            # not real tokens yet
            if not req.done and req.rid not in self._prefilling:
                req.generated.append(int(nxt[slot]))
                self._tokens[slot, 0] = int(nxt[slot])
                n_dec += 1
        self.metrics.on_step(self._now(), n_dec, self.slots)

    # -- main loop --------------------------------------------------------

    def _retire_finished(self, on_complete) -> None:
        now = self._now()
        for req in self.scheduler.live:
            eos = self.eos_id is not None and req.generated \
                and req.generated[-1] == self.eos_id
            if req.done or eos:
                slot = req.slot
                self.scheduler.finish(req)
                self._tables[slot] = -1          # unmap: blocks recycle
                self._tables_dev = None
                self.outputs[req.rid] = list(req.prompt) + list(req.generated)
                self.metrics.on_done(req.rid, now, len(req.generated))
                if on_complete is not None:
                    on_complete(req, now)

    def _admit_ready(self) -> None:
        now = self._now()
        self.scheduler.poll(now)
        need = self.scheduler.peek_need_len()
        if need is not None:
            target = self.spec.quantize(need)
            if target > self.pool.kv_len:
                self._grow_pool(target)
        for req in self.scheduler.admissible():
            self._current_plan()
            self._admit(req, now)

    def run(self, *, on_complete=None,
            max_steps: Optional[int] = None) -> ServeReport:
        """Drain the queue; returns the run's ``ServeReport``."""
        steps = 0
        while not self.scheduler.idle:
            self._admit_ready()
            stepped = self._prefill_tick()
            decodable = any(r.rid not in self._prefilling
                            for r in self.scheduler.live)
            if decodable:
                self._decode_tick()
                self._retire_finished(on_complete)
            elif not stepped:
                nxt = self.scheduler.next_arrival
                if nxt is not None:
                    self._fast_forward(nxt)    # idle: jump to next arrival
                elif self.scheduler.backlog:
                    self.scheduler.shed_head()
                else:
                    break
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.report()

    def report(self) -> ServeReport:
        """Snapshot the run's ``ServeReport`` (also returned by ``run``)."""
        s = self.metrics.summary()
        if self.verbose:
            print(f"[serve] {self.cfg.name}: {s.n_completed}/{s.n_requests} "
                  f"done, {s.output_tokens} tok @ {s.tokens_per_s:.1f} tok/s, "
                  f"ttft p50 {s.ttft_p50_s * 1e3:.1f}ms, util "
                  f"{s.utilization:.2f}")
        return ServeReport(
            summary=s,
            outputs=dict(self.outputs),
            completed=list(self.scheduler.completed),
            rejected=list(self.scheduler.rejected),
            router_stats=dataclasses.asdict(self.router.stats),
            pool_growths=self.pool_growths,
            paged_decode_blocks=dict(self.executed_decode_blocks),
            prefill_tiles=dict(self.executed_prefill_tiles),
        )
