"""Continuous-batching serving engine — the dense, moe, ssm, hybrid and
encdec paths of the JAX package's ``serve/engine.py`` on PyTorch.

  * admitted requests prefill either whole (prompt padded to its bucket,
    true-last-token logits via ``Model.prefill(last_pos=...)``) or, by
    default, chunk by chunk between decode ticks (``prefill_chunk``);
    the finished row's K/V scatter into the request's leased blocks;
  * the whole pool decodes one token per tick through one step whose
    rows are ragged — every row carries its own position.  By default the
    pool is paged and the attention reads it through the block tables in
    the fused kernel, at the router's per-bucket ``block_s`` and split
    width (the report records both per pool length);
    ``fused_decode=False`` gathers each row's logical view first and
    sweeps it with the contiguous kernel, ``paged=False`` keeps one
    contiguous cache row per slot, and ``kv_dtype="int8"`` stores the
    paged pool as int8 codes with per-(block, KV group) scales, which
    the read dequantises in-kernel;
  * finished requests retire mid-decode and their slot + blocks recycle
    to the queue head; greedy argmax picks every token;
  * an attention-free family (ssm, Mamba-2) keeps a length-free state
    per slot: its prompts prefill at their exact length, its chunked
    prefill keeps the configured width ("auto" is 32: there are no
    flash tiles), and the pool's growth is block accounting only; the
    hybrid family (zamba2) pools its shared attention block's K/V per
    group as dense pools a layer's, beside each slot's ssm state; the
    encoder-decoder family (whisper) prefills whole prompts only (the
    model's ``supports_chunked_prefill``: "auto" and an int width both
    fall back to it, as in the reference), each with the adapter's stub
    encoder frames, and pools each slot's static cross-attention K/V
    beside its self-attention K/V;
  * ``prefix_cache=True`` (``serve.radix``) shares prompt prefixes on
    the paged, chunked dense path: a request whose prompt begins with
    blocks another request wrote maps those physical blocks into the
    leading entries of its block table, seeds its row cache from them,
    and resumes chunked prefill mid-prompt (flash at ``q_offset`` =
    the resume position), writing only its private suffix.

The engine's clock is injectable; when the pool is idle it fast-forwards
to the next synthetic arrival, so open-loop traffic never sleeps.

``tracer=`` (``obs.Tracer``) records the run: a ``prefill``,
``prefill_chunk`` or ``decode_tick`` span around each step, closed after
the device finished it, carrying the plan that executed; the router's
resolutions; counters and instants (admits, ticks, tokens, pool growth,
recycled slots).  ``retune=`` adds the live retune loop
(``serve.retune``): the controller observes each decode tick and may
swap a bucket's decode plan between ticks under its A/B guard.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.dtypes import kv_dtype_spec
from repro_torch.core.hw import GpuParams, detect, resolve_device
from repro_torch.core.mapper import MappingPolicy
from repro_torch.kernels.paged_gather import flat_position
from repro_torch.models import build_model
from repro_torch.obs.trace import Tracer, get_tracer
from repro_torch.serve.adapters import get_adapter
from repro_torch.serve.buckets import BucketRouter, BucketSpec
from repro_torch.serve.kvcache import KVCachePool
from repro_torch.serve.metrics import ServeMetrics, ServeSummary
from repro_torch.serve.radix import RadixCache
from repro_torch.serve.retune import RetuneConfig, RetuneController
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.tuner import TuningCache

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
    #: first prompt position write_row scatters (block-aligned; the
    #: positions before it live in radix-SHARED blocks, never rewritten)
    start: int = 0


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
    #: the bucket plans that executed: kv_len -> the fused paged sweep's
    #: block_s and split width (fused reads), kv_len -> the contiguous
    #: sweep's block_s and split width (contiguous pool or
    #: gather-then-sweep), and prompt bucket -> flash (block_q, block_k)
    paged_decode_blocks: dict = dataclasses.field(default_factory=dict)
    decode_blocks: dict = dataclasses.field(default_factory=dict)
    prefill_tiles: dict = dataclasses.field(default_factory=dict)
    paged_decode_splits: dict = dataclasses.field(default_factory=dict)
    decode_splits: dict = dataclasses.field(default_factory=dict)
    #: the retune controller's stats and concluded decisions (None when
    #: the engine runs with ``retune="off"``)
    retune: Optional[dict] = None
    #: radix prefix-cache accounting (hit rate, evictions; None when
    #: ``prefix_cache=False`` or the family cannot share prefixes)
    radix: Optional[dict] = None


class ServeEngine:
    """Continuous-batching loop over a bucketed, paged decode pool.

    ``arch`` is a registered config name or a ``ModelConfig``; ``reduced``
    applies only to names.  ``device`` defaults to "cuda" and raises when
    no CUDA device is present; ``device="cpu"`` runs the kernels' plain
    versions.  ``params`` (the model's param dict) defaults to random
    weights from ``seed``.  ``prefill_chunk``: "auto" (the default)
    chunks prefill at the bucket's flash ``block_q`` (32 tokens for an
    attention-free family), an int fixes the width, ``None`` prefills
    whole prompts; a family the model cannot chunk (encdec) prefills
    whole prompts whatever is asked.  ``paged`` (default True)
    keeps the KV pool in leased blocks, ``fused_decode`` (default True)
    reads them inside the paged sweep instead of gathering first, and
    ``kv_dtype`` ("fp32", the model's dtype, or "int8", which needs the
    paged pool) is what the pool stores.  ``policy`` (default "tuned",
    as the JAX engine's) is how the router plans each bucket's kernels:
    TUNED refines the Eq. 1 seed through the tuner and keeps it in
    ``tuning_cache`` (default: the tuner's process-wide cache, a file in
    the checkout's ``build/repro_torch/``); ``measure`` ("off", "cached"
    or "live") lets a cache miss be judged by recorded or live CUDA-event
    times from ``store`` (default: the profiler's process-wide store).
    ``hw`` defaults to ``detect(device)``.  ``tracer`` (default: the
    ambient tracer at construction, the null tracer unless one is
    installed) receives the run's spans, counters and the model's
    geometry as its ``meta``; ``retune`` ("off", "inline", "background"
    or a ``RetuneConfig``) runs the live retune loop, with a private
    tracer when the engine has none (its drift scan reads spans).
    ``spec`` (a ``BucketSpec``, trimmed to ``max_len``) replaces the
    default pow2 lattice; ``admission`` ("continuous" or "gang") is the
    scheduler's rule; ``total_blocks`` budgets the paged pool below its
    physical grid (admission control); ``prefix_cache`` turns on radix
    prefix sharing, which engages only on a paged, chunked,
    ``shareable_prefix`` family (dense) and is a no-op elsewhere (encdec
    included).

    Example::

        eng = ServeEngine("smollm-135m", slots=4, max_len=256)
        eng.submit([1, 2, 3], max_new_tokens=8)
        report = eng.run()
    """

    def __init__(self, arch: str | ModelConfig, *,
                 slots: int = 4,
                 max_len: int = 256,
                 reduced: bool = True,
                 spec: Optional[BucketSpec] = None,
                 admission: str = "continuous",
                 params: Optional[dict] = None,
                 seed: int = 0,
                 block_size: int = 16,
                 total_blocks: Optional[int] = None,
                 paged: bool = True,
                 kv_dtype: str = "fp32",
                 fused_decode: bool = True,
                 prefill_chunk: int | str | None = "auto",
                 eos_id: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 policy: MappingPolicy | str = MappingPolicy.TUNED,
                 measure: str = "off",
                 store: Optional[Any] = None,
                 tuning_cache: Optional[TuningCache] = None,
                 hw: Optional[GpuParams] = None,
                 device="cuda",
                 tracer: Optional[Any] = None,
                 retune: str | RetuneConfig | None = "off",
                 prefix_cache: bool = False,
                 verbose: bool = False):
        self.device = resolve_device(device)
        self.kv_spec = kv_dtype_spec(kv_dtype)
        if self.kv_spec.quantized and not paged:
            raise ValueError(
                f"kv_dtype={self.kv_spec.name!r} requires paged=True: "
                "quantization scales are per physical block")
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
        self.spec = spec or BucketSpec(max_len=max_len,
                                       min_len=min(32, max_len))
        if self.spec.max_len > max_len:
            self.spec = dataclasses.replace(
                self.spec, max_len=max_len,
                min_len=min(self.spec.min_len, max_len))
        if paged:
            # the physical grid maps block ids onto (slot, offset) pairs:
            # every lattice length must be whole blocks, and the budget
            # may undersubscribe the grid but never exceed it (ids past
            # the grid have no location)
            lattice = self.spec.lattice()
            if not lattice:
                raise ValueError(
                    "the paged pool needs a finite length lattice; "
                    "mode='exact' cannot guarantee block-multiple rows")
            for n in lattice:
                if n % block_size:
                    raise ValueError(f"the paged pool needs lattice "
                                     f"lengths divisible by "
                                     f"block_size={block_size}, got {n}")
            cap0 = slots * (self.spec.quantize(1) // block_size)
            if total_blocks is not None and total_blocks > cap0:
                raise ValueError(
                    f"paged pool: total_blocks={total_blocks} exceeds the "
                    f"physical block grid ({cap0})")
        self.eos_id = eos_id
        self.verbose = verbose
        self._clock = clock
        self.obs = tracer if tracer is not None else get_tracer()
        self._retune_cfg: Optional[RetuneConfig] = None
        if retune not in (None, "off"):
            self._retune_cfg = retune if isinstance(retune, RetuneConfig) \
                else RetuneConfig(mode=retune)
            if not self.obs.enabled:
                self.obs = Tracer()

        self.model = build_model(cfg, device=self.device)
        self.params = params if params is not None else self.model.init(seed)
        self.hw = hw if hw is not None else detect(self.device)
        self.router = BucketRouter(cfg, self.spec, slots=slots, hw=self.hw,
                                   policy=policy, cache=tuning_cache,
                                   measure=measure, store=store,
                                   page_block=block_size if paged else None,
                                   kv_dtype=self.kv_spec.name,
                                   device=self.device, tracer=self.obs)
        self.retune: Optional[RetuneController] = None
        if self._retune_cfg is not None:
            self.retune = RetuneController(self.router,
                                           config=self._retune_cfg,
                                           tracer=self.obs, store=store,
                                           cache=tuning_cache)
        self.paged = paged
        self.fused_decode = fused_decode
        self._block_size = block_size
        self._total_blocks = total_blocks
        self._admission = admission
        self._chunk_cfg = prefill_chunk
        self._chunked = (prefill_chunk is not None
                         and self.model.supports_chunked_prefill)
        self.prefix_cache = bool(prefix_cache)
        if self.obs.enabled:
            # run-level context the trace's header carries: what
            # obs.feedback and obs.drift need to rebuild each bucket's
            # workload description from the trace alone
            self.obs.meta.update(
                arch=cfg.name, family=cfg.family, head_dim=cfg.head_dim,
                heads=cfg.num_heads, kv_heads=max(cfg.num_kv_heads, 1),
                layers=cfg.num_layers, dtype=cfg.dtype,
                dtype_bytes=self.router._dtype_bytes(), slots=slots,
                max_len=self.spec.max_len, hw=self.hw.name, paged=paged,
                fused_decode=fused_decode, kv_dtype=self.kv_spec.name,
                prefix_cache=self._shares_prefixes(),
                **(self.router._geometry() or {}))
        self.reset()

    def _shares_prefixes(self) -> bool:
        """Whether radix sharing engages: the feature is on, the pool is
        paged (tables to alias through), prefill is chunked (a
        mid-prompt resume) and the family's blocks are complete
        per-position context (``adapter.shareable_prefix``)."""
        return (self.prefix_cache and self.paged and self._chunked
                and self.adapter.shareable_prefix)

    def _make_radix(self) -> Optional[RadixCache]:
        """A fresh radix prefix cache over the CURRENT pool's allocator,
        or ``None`` when sharing cannot engage (``_shares_prefixes``)."""
        if not self._shares_prefixes():
            return None
        return RadixCache(self.pool.allocator, self._block_size,
                          tracer=self.obs)

    def reset(self) -> None:
        """Clear traffic state (pool, queue, metrics, outputs)."""
        kv0 = self.spec.quantize(1)
        self.pool = KVCachePool(self.slots, kv0, block_size=self._block_size,
                                total_blocks=self._total_blocks,
                                max_len=self.spec.max_len)
        self._radix = self._make_radix()
        self.scheduler = Scheduler(self.pool, mode=self._admission,
                                   radix=self._radix)
        self.metrics = ServeMetrics()
        self.outputs: dict[int, list[int]] = {}
        self._cache = self.adapter.init_pool(
            self.model, self.slots, kv0, kv_dtype=self.kv_spec.name,
            block_size=self._block_size)
        self._tables = np.full((self.slots, self.pool.max_blocks_per_row),
                               -1, np.int32)
        self._tables_dev: Optional[torch.Tensor] = None
        self._tokens = np.zeros((self.slots, 1), np.int64)
        self._plan_len = -1
        self._bucket_plan = None
        self._chunk_tasks: list[_ChunkTask] = []
        self._prefilling: dict[int, _ChunkTask] = {}
        self.pool_growths = 0
        self.executed_paged_blocks: dict[int, int] = {}
        self.executed_decode_blocks: dict[int, int] = {}
        self.executed_paged_splits: dict[int, int] = {}
        self.executed_decode_splits: dict[int, int] = {}
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
        if self.paged and new_len % self._block_size:
            raise ValueError(f"paged pool length {new_len} not a multiple "
                             f"of block_size={self._block_size}")
        if self.adapter.grows_with_len:
            self._cache = self.adapter.grow(self._cache, new_len)
        self.pool.grow(new_len)
        self.pool_growths += 1
        self.obs.instant("pool_grow", kv_len=new_len)
        self.obs.count("pool_growths")
        if self.verbose:
            print(f"[serve] pool -> ({self.slots}, {new_len})")

    def _page_map(self, blocks: list[int], n: int,
                  start: int = 0) -> torch.Tensor:
        """Flat physical positions of one request's logical tokens
        ``[start, n)`` (the prefill write path).  ``start`` skips the
        radix-shared prefix: positions another lease already wrote and
        this one must never scatter into."""
        bs = self._block_size
        tok = np.arange(start, n)
        pid = np.asarray(blocks, np.int64)[tok // bs]
        return torch.from_numpy(
            flat_position(pid, tok, self.slots, self.pool.kv_len, bs)
        ).to(self.device)

    def _scale_map(self, blocks: list[int]) -> torch.Tensor:
        """Flat scale-grid rows of one request's leased blocks: the scale
        grid is the cache's physical block grid flattened to (slots *
        blocks per row), so pid -> (pid % slots) * nb + pid // slots, the
        identity the kernels resolve in their sweeps."""
        nb = self.pool.kv_len // self._block_size
        pid = np.asarray(blocks, np.int64)
        return torch.from_numpy((pid % self.slots) * nb
                                + pid // self.slots).to(self.device)

    def _write_row(self, req: Request, row_cache: dict,
                   blocks: list[int], start: int = 0) -> None:
        """Land a prefilled row in the pool: through the request's page
        map (and, on the int8 pool, its scale map) when paged, publishing
        its block-table row to the decode step; into the slot's row
        otherwise (and always for a length-free cache, which has no
        blocks to map).  ``start`` (the radix's ``write_start``) keeps
        the write off the shared prefix blocks."""
        pm = sm = None
        if self.paged and self.adapter.grows_with_len:
            self._tables[req.slot] = self.pool.block_table(req.rid)
            self._tables_dev = None
            pm = self._page_map(blocks, req.prompt_len, start=start)
            if self.kv_spec.quantized:
                sm = self._scale_map(blocks)
        self._cache = self.adapter.write_row(
            self._cache, req.slot, row_cache, req.prompt_len,
            self.pool.kv_len, page_map=pm, scale_map=sm,
            page_block=self._block_size, start=start)

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
        tiles = self._prefill_tiles(pb)
        with self.obs.span("prefill", rid=req.rid, prompt_len=plen,
                           bucket=pb, tiles=tiles):
            t0 = time.perf_counter()
            logits, rcache = self.model.prefill(
                self.params, torch.from_numpy(toks).to(self.device), pb,
                last_pos=[plen - 1], prefill_tiles=tiles,
                **self.adapter.prefill_extras(self.model, 1))
            first = int(logits[0, -1].argmax())      # waits for the device
            self.metrics.add_prefill_time(time.perf_counter() - t0)
        self.obs.count("admits")
        self._write_row(req, rcache, self.pool.lease(req.rid).blocks)
        req.generated.append(first)
        self._tokens[req.slot, 0] = first
        self.metrics.on_admit(req.rid, now)
        self.metrics.on_first_token(req.rid, self._now())

    def _prefill_tiles(self, pb: int) -> Optional[tuple]:
        """The prompt bucket's flash tiles (None for attention-free
        families), recorded as executed."""
        tiles = self.router.prefill_tiles(pb)
        if tiles is not None:
            self.executed_prefill_tiles[pb] = tiles
        return tiles

    def _chunk_size(self, tiles: Optional[tuple]) -> int:
        if isinstance(self._chunk_cfg, int):
            return max(1, self._chunk_cfg)
        # "auto": the bucket's flash block_q, the quantum the router's
        # plan (the tuner's, under TUNED) advances a prefill sweep in (32
        # for attention-free families, which have no tiles)
        return int(tiles[0]) if tiles else 32

    def _admit_chunked(self, req: Request, now: float) -> None:
        """Seat the request (slot + blocks leased) but run its prefill
        chunk by chunk between decode ticks.  Its block-table row is NOT
        published until the row lands (``_finish_chunked``): a recycled
        slot's stale ``pos`` keeps advancing each tick, and an unpublished
        (-1) row writes nothing — through a published table whose leading
        entries alias radix-shared blocks, that stale write would land in
        another request's prefix.

        With a radix match pending (``RadixCache.prepare`` ran at
        admission), the matched prefix seeds the row cache and chunked
        prefill RESUMES mid-prompt, computing only the private suffix.

        A length-free row cache (ssm) keeps the configured chunk width;
        a length-bound one (dense, moe, and hybrid, whose K/V grow with
        the row) clamps it to the row."""
        pb = self.adapter.prefill_len(req.prompt_len,
                                      self.router.quantize_prompt)
        tiles = self._prefill_tiles(pb)
        chunk = self._chunk_size(tiles)
        if self.adapter.grows_with_len:
            chunk = min(chunk, pb)
        task = _ChunkTask(req=req, cache=self.model.init_cache(1, pb),
                          toks=np.asarray(req.prompt, np.int64), pb=pb,
                          tiles=tiles, chunk=chunk,
                          blocks=self.pool.lease(req.rid).blocks)
        if self._radix is not None:
            m = self._radix.claim(req.rid)
            if m is not None and m.hit:
                self._radix_seed(task, m)
            self._radix.seeded(req.rid)
        self._chunk_tasks.append(task)
        self._prefilling[req.rid] = task
        self.metrics.on_admit(req.rid, now)
        self.obs.count("admits")

    def _radix_seed(self, task: _ChunkTask, m) -> None:
        """Seed a chunk task's row cache from its radix match: read the
        matched positions' K/V out of the pool's physical blocks (on the
        int8 pool: codes times their f32 scales in f32, rounded once to
        the row cache's dtype), land them at the row's leading positions
        and move the resume offset past them.  The matched FULL blocks
        stay shared (``task.start`` keeps ``write_row`` off them); the
        tail's tokens become private data once in the row cache (the
        int8 pool re-quantises its block at ``write_row``).  The pool is
        indexed at its current length: growth since the donor wrote
        moves the flat positions, never the block ids."""
        bs = self._block_size
        resume = m.resume(task.req.prompt_len, bs)
        if resume <= 0:
            return
        tok = np.arange(resume)
        pid = np.empty(resume, np.int64)
        nfull = len(m.blocks) * bs
        if nfull:
            pid[:nfull] = np.asarray(m.blocks, np.int64)[tok[:nfull] // bs]
        if resume > nfull:
            pid[nfull:] = m.tail_block
        kv_len = self.pool.kv_len
        flat = torch.from_numpy(
            flat_position(pid, tok, self.slots, kv_len, bs)).to(self.device)
        for key in self.adapter.length_keys:
            arr = self._cache[key]                   # (L, B, T, G, hd)
            n, b = arr.shape[:2]
            vals = arr.reshape((n, b * kv_len) + arr.shape[3:])[:, flat]
            skey = key + "_scale"
            if skey in self._cache:
                nb = kv_len // bs
                sidx = torch.from_numpy(
                    (pid % self.slots) * nb + pid // self.slots).to(
                        self.device)
                sarr = self._cache[skey]             # (L, B, nb, G)
                scl = sarr.reshape(n, b * nb, -1)[:, sidx]   # (L, r, G)
                vals = vals.float() * scl[..., None]
            row = task.cache[key]
            row[:, 0, :resume] = vals.to(row.dtype)
        task.cache["pos"] = resume
        task.start = m.write_start(bs)
        task.done = resume
        self._radix.stats.hit_tokens += resume
        self.obs.instant("radix_hit", rid=task.req.rid, tokens=resume,
                         shared_blocks=len(m.blocks), tail=m.tail_len)
        self.obs.count("radix_hit_tokens", resume)

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
        last = start + n >= len(task.toks)
        with self.obs.span("prefill_chunk", rid=task.req.rid, bucket=task.pb,
                           chunk=c, start=start, tiles=task.tiles):
            t0 = time.perf_counter()
            logits, task.cache = self.model.prefill_chunk(
                self.params, task.cache,
                torch.from_numpy(buf).to(self.device), n,
                prefill_tiles=task.tiles)
            if last:
                first = int(logits[0, n - 1].argmax())  # waits for the device
            else:
                self._sync()
            self.metrics.add_prefill_time(time.perf_counter() - t0)
        task.done += n
        if last:
            self._finish_chunked(task, first)
        return True

    def _finish_chunked(self, task: _ChunkTask, first: int) -> None:
        req = task.req
        if self.paged:
            # decode appends land in the prompt's boundary block onward;
            # shared blocks are read-only by contract, so that block
            # must be private
            assert self.pool.refcount(
                task.blocks[req.prompt_len // self._block_size]) == 1, \
                "decode-append block is shared"
        self._write_row(req, task.cache, task.blocks, start=task.start)
        if self._radix is not None:
            # index the request's fully written prompt blocks (shared
            # prefix nodes are reused; only new nodes retain); the
            # partial tail joins at retirement, once decode stops
            # appending into it
            self._radix.insert(req.prompt, task.blocks)
        req.generated.append(first)
        self._tokens[req.slot, 0] = first
        self.metrics.on_first_token(req.rid, self._now())
        self.obs.instant("prefill_complete", rid=req.rid,
                         prompt_len=req.prompt_len, chunk=task.chunk,
                         chunks=-(-len(task.toks) // task.chunk))
        self._chunk_tasks.pop(0)
        del self._prefilling[req.rid]

    # -- decode -----------------------------------------------------------

    def _decode_tick(self) -> None:
        plan = self._current_plan()
        kw = {}
        if self.paged and self.adapter.grows_with_len:
            if self._tables_dev is None:
                # tables change only at admit/retire: upload on change
                self._tables_dev = torch.from_numpy(self._tables).to(
                    self.device)
            # the router's fused block_s; None drops the read back to
            # gather-then-sweep
            kw = dict(page_tables=self._tables_dev,
                      page_block=self._block_size,
                      paged_decode_block=(plan.paged_decode_block
                                          if self.fused_decode else None),
                      paged_decode_split=plan.paged_decode_split)
        kv_len = self.pool.kv_len
        # the plan that executes: the fused sweep's pair when the paged
        # read runs fused, the contiguous sweep's otherwise, none for an
        # attention-free family
        kernel = value = None
        fused = kw.get("paged_decode_block") is not None
        if fused:
            kernel = "paged_decode"
            value = (plan.paged_decode_block, plan.paged_decode_split)
            self.executed_paged_blocks[kv_len] = plan.paged_decode_block
            self.executed_paged_splits[kv_len] = plan.paged_decode_split
        elif plan.decode_block is not None:
            kernel = "decode_attention"
            value = (plan.decode_block, plan.decode_split)
            self.executed_decode_blocks[kv_len] = plan.decode_block
            self.executed_decode_splits[kv_len] = plan.decode_split
        # the span closes after the device finished the step (the .cpu()
        # waits for it), not around the enqueue alone
        with self.obs.span("decode_tick", bucket=kv_len,
                           decode_block=plan.decode_block,
                           decode_split=plan.decode_split,
                           paged_decode_block=kw.get("paged_decode_block"),
                           paged_decode_split=(plan.paged_decode_split
                                               if fused else None),
                           live=len(self.scheduler.live), slots=self.slots):
            t0 = time.perf_counter()
            logits, self._cache = self.model.decode_step(
                self.params, self._cache,
                torch.from_numpy(self._tokens).to(self.device),
                decode_block=plan.decode_block,
                decode_split=plan.decode_split, **kw)
            nxt = logits[:, 0].argmax(-1).cpu().numpy()  # waits for the device
            dt = time.perf_counter() - t0
            self.metrics.add_decode_time(dt)
        if self.retune is not None:
            self.retune.observe_tick(kv_len, kernel, value, dt)
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
        self.obs.count("decode_ticks")
        self.obs.count("tokens_decoded", n_dec)
        self.obs.gauge("live_slots", n_dec)

    # -- main loop --------------------------------------------------------

    def _retire_finished(self, on_complete) -> None:
        now = self._now()
        for req in self.scheduler.live:
            eos = self.eos_id is not None and req.generated \
                and req.generated[-1] == self.eos_id
            if req.done or eos:
                slot = req.slot
                if self._radix is not None \
                        and req.rid not in self._prefilling:
                    # the partial prompt-tail block becomes indexable
                    # only now: its owner stops appending decode tokens
                    self._radix.insert_tail(
                        req.prompt, self.pool.lease(req.rid).blocks)
                self.scheduler.finish(req)
                if self.paged:
                    self._tables[slot] = -1      # unmap: blocks recycle
                    self._tables_dev = None
                self.obs.instant("slot_recycle", rid=req.rid, slot=slot,
                                 generated=len(req.generated))
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
            if self.retune is not None and self.retune.poll():
                # the router's table changed (a trial started or was
                # reverted): drop the plan memo so the next tick reads it
                self._plan_len = -1
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
            paged_decode_blocks=dict(self.executed_paged_blocks),
            decode_blocks=dict(self.executed_decode_blocks),
            prefill_tiles=dict(self.executed_prefill_tiles),
            paged_decode_splits=dict(self.executed_paged_splits),
            decode_splits=dict(self.executed_decode_splits),
            retune=(None if self.retune is None else {
                "stats": dataclasses.asdict(self.retune.stats),
                "decisions": [dataclasses.asdict(d)
                              for d in self.retune.decisions],
            }),
            radix=(self._radix.as_report()
                   if self._radix is not None else None),
        )
