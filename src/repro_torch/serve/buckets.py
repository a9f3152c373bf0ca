"""Shape bucketing and per-bucket kernel plans.

``BucketSpec`` and ``Bucket`` are copies of the JAX package's lattice:
live serving geometry rounds UP onto a bounded set of lengths.
``BucketRouter`` resolves each bucket's kernel mappings — the
contiguous decode ``block_s`` and split width, the fused paged-decode
``block_s`` and split width, and the prefill flash tiles — from the port's Eq. 1 mapper (AUTO) over the
runtime ``GpuParams`` and memoises them per bucket (the tuner cache and
measured refinement are not ported yet, so a cold bucket is one planner
call, a warm one a dict hit).  An attention-free config (ssm) plans
none of the three: its plans are ``None`` — mamba2's ``head_dim`` would
be ``d_model`` = 2048, which no attention kernel takes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hw import GpuParams
from repro_torch.core.mapper import (plan_attention_blocks, plan_cache_block,
                                     plan_decode_split, plan_paged_block)
from repro_torch.kernels.decode_attention import check_split

__all__ = ["BucketSpec", "Bucket", "BucketPlan", "RouterStats",
           "BucketRouter"]

BUCKET_MODES = ("pow2", "linear", "exact", "fixed")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """The length lattice serving shapes are quantized onto.

    ``pow2``   powers of two in [min_len, max_len] — O(log) buckets;
    ``linear`` multiples of ``quantum`` — finer, O(max/quantum) buckets;
    ``exact``  identity (every shape its own bucket);
    ``fixed``  everything maps to ``max_len`` (one max-shape bucket).

    Example::

        >>> BucketSpec(min_len=32, max_len=256).quantize(100)
        128
    """

    min_len: int = 32
    max_len: int = 4096
    mode: str = "pow2"
    quantum: int = 64

    def __post_init__(self):
        if self.mode not in BUCKET_MODES:
            raise ValueError(f"mode must be one of {BUCKET_MODES}, "
                             f"got {self.mode!r}")
        if not 0 < self.min_len <= self.max_len:
            raise ValueError(f"need 0 < min_len <= max_len, got "
                             f"{self.min_len}/{self.max_len}")
        if self.mode == "pow2":
            object.__setattr__(self, "min_len",
                               min(self.max_len, _next_pow2(self.min_len)))

    def quantize(self, n: int) -> int:
        """Smallest lattice length covering ``n`` tokens."""
        if n > self.max_len:
            raise ValueError(f"length {n} exceeds the lattice cap "
                             f"{self.max_len}")
        n = max(n, 1)
        if self.mode == "fixed":
            return self.max_len
        if self.mode == "exact":
            return n
        if self.mode == "pow2":
            return min(self.max_len, _next_pow2(max(n, self.min_len)))
        q = self.quantum
        first = -(-self.min_len // q) * q
        return min(self.max_len, max(first, -(-n // q) * q))

    def lattice(self) -> tuple[int, ...]:
        """Every length this spec can produce (exact mode: unbounded —
        returns ())."""
        if self.mode == "fixed":
            return (self.max_len,)
        if self.mode == "exact":
            return ()
        if self.mode == "pow2":
            n = self.min_len
        else:
            n = -(-self.min_len // self.quantum) * self.quantum
        out = []
        while n < self.max_len:
            out.append(n)
            n = n * 2 if self.mode == "pow2" else n + self.quantum
        out.append(self.max_len)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One lattice point: a decode-pool geometry.

    Example::

        >>> Bucket(slots=4, kv_len=128).covers(2, 100)
        True
    """

    slots: int
    kv_len: int

    def covers(self, batch: int, need_len: int) -> bool:
        """True when this geometry can hold (batch, need_len)."""
        return batch <= self.slots and need_len <= self.kv_len


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """A bucket's resolved decode mappings, threaded into the executed
    decode step: ``decode_block`` and ``decode_split`` are the
    contiguous sweep's ``block_s`` and split width (the contiguous pool
    and the gather-then-sweep read), ``paged_decode_block`` and
    ``paged_decode_split`` the fused paged sweep's (``None`` for an
    unpaged engine).  The split is ``plan_decode_split`` (AUTO) over the
    bucket's slots x KV groups.  The prefill tiles are resolved per
    prompt bucket by ``BucketRouter.prefill_tiles``."""

    bucket: Bucket
    decode_block: Optional[int]          # None: attention-free
    paged_decode_block: Optional[int]    # None: unpaged or attention-free
    decode_split: Optional[int] = None
    paged_decode_split: Optional[int] = None


@dataclasses.dataclass
class RouterStats:
    """Per-router resolution accounting.

    Example::

        >>> RouterStats().cold
        0
    """

    cold: int = 0            # resolutions that ran the planner
    warm: int = 0            # served from the router's memo


class BucketRouter:
    """Maps live (batch, need_len) geometry to per-bucket kernel plans.

    Example::

        router = BucketRouter(cfg, BucketSpec(max_len=256), slots=4,
                              hw=detect("cuda"), page_block=16)
        plan = router.resolve(router.bucket(need_len))
        tiles = router.prefill_tiles(router.quantize_prompt(plen))

    ``page_block=None`` is an unpaged engine (no paged plan).  The int8
    pool resolves the same blocks and splits as the fp32 one: the plan
    sizes the sweep's shared memory for f32 caches, the most it stages.
    """

    def __init__(self, cfg: ModelConfig, spec: BucketSpec, *, slots: int,
                 hw: GpuParams, page_block: Optional[int] = 16):
        self.cfg = cfg
        self.spec = spec
        self.slots = slots
        self.hw = hw
        self.page_block = None if page_block is None else int(page_block)
        self.stats = RouterStats()
        self._plans: dict[int, BucketPlan] = {}
        self._prefill_tiles: dict[int, tuple[int, int]] = {}

    def bucket(self, need_len: int) -> Bucket:
        """The lattice point covering a pool-length requirement."""
        return Bucket(self.slots, self.spec.quantize(need_len))

    def quantize_prompt(self, prompt_len: int) -> int:
        """The prompt bucket a prefill pads to (same lattice)."""
        return self.spec.quantize(prompt_len)

    def resolve(self, bucket: Bucket) -> BucketPlan:
        """Per-bucket kernel mappings, memoised on the bucket length."""
        hit = self._plans.get(bucket.kv_len)
        if hit is not None:
            self.stats.warm += 1
            return hit
        self.stats.cold += 1
        if self.cfg.is_attention_free:
            plan = BucketPlan(bucket, None, None)
        else:
            t, d, r = bucket.kv_len, self.cfg.head_dim, \
                self.cfg.heads_per_group
            rows = bucket.slots * self.cfg.num_kv_heads
            block = plan_cache_block(t, d, self.hw, heads_per_group=r)
            paged = paged_split = None
            if self.page_block is not None:
                paged = plan_paged_block(t, d, self.page_block, self.hw,
                                         heads_per_group=r)
                paged_split = plan_decode_split(
                    t, rows, paged, d, self.hw, heads_per_group=r,
                    page_block=self.page_block)
            split = plan_decode_split(t, rows, block, d, self.hw,
                                      heads_per_group=r)
            # the kernels' split checks, once per plan, not per launch
            check_split(t, block, split)
            if paged is not None:
                check_split(t, paged, paged_split)
            plan = BucketPlan(
                bucket=bucket, decode_block=block,
                paged_decode_block=paged, decode_split=split,
                paged_decode_split=paged_split)
        self._plans[bucket.kv_len] = plan
        return plan

    def prefill_tiles(self, prompt_bucket: int) -> Optional[tuple[int, int]]:
        """The EXECUTED prefill mapping for one prompt bucket, resolved
        at the bucket's own (seq, seq) geometry and memoised per length;
        ``None`` for attention-free families (no flash sweep to map)."""
        hit = self._prefill_tiles.get(prompt_bucket)
        if hit is not None:
            self.stats.warm += 1
            return hit
        if self.cfg.is_attention_free:
            return None
        self.stats.cold += 1
        plan = plan_attention_blocks(prompt_bucket, prompt_bucket,
                                     self.cfg.head_dim, self.hw)
        tiles = (plan.block_q, plan.block_k)
        self._prefill_tiles[prompt_bucket] = tiles
        return tiles
