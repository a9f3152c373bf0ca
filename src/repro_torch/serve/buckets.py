"""Shape bucketing and per-bucket kernel plans.

``BucketSpec`` and ``Bucket`` are copies of the JAX package's lattice:
live serving geometry rounds UP onto a bounded set of lengths.
``BucketRouter`` resolves each bucket's kernel mappings — the fused
paged-decode ``block_s`` and the prefill flash tiles — from the port's
Eq. 1 mapper over the runtime ``GpuParams`` and memoises them per bucket
(the tuner cache and measured refinement are not ported yet, so a cold
bucket is one planner call, a warm one a dict hit).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hw import GpuParams
from repro_torch.core.mapper import plan_attention_blocks, plan_paged_block

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
    """A bucket's resolved decode mapping.  ``paged_decode_block`` is
    threaded into the executed decode step, so the bucket decision sets
    the paged kernel's staging chunk (the prefill tiles are resolved per
    prompt bucket by ``BucketRouter.prefill_tiles``)."""

    bucket: Bucket
    paged_decode_block: int


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
    """

    def __init__(self, cfg: ModelConfig, spec: BucketSpec, *, slots: int,
                 hw: GpuParams, page_block: int = 16):
        self.cfg = cfg
        self.spec = spec
        self.slots = slots
        self.hw = hw
        self.page_block = int(page_block)
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
        plan = BucketPlan(
            bucket=bucket,
            paged_decode_block=plan_paged_block(
                bucket.kv_len, self.cfg.head_dim, self.page_block, self.hw,
                heads_per_group=self.cfg.heads_per_group))
        self._plans[bucket.kv_len] = plan
        return plan

    def prefill_tiles(self, prompt_bucket: int) -> tuple[int, int]:
        """The EXECUTED prefill mapping for one prompt bucket, resolved
        at the bucket's own (seq, seq) geometry and memoised per length."""
        hit = self._prefill_tiles.get(prompt_bucket)
        if hit is not None:
            self.stats.warm += 1
            return hit
        self.stats.cold += 1
        plan = plan_attention_blocks(prompt_bucket, prompt_bucket,
                                     self.cfg.head_dim, self.hw)
        tiles = (plan.block_q, plan.block_k)
        self._prefill_tiles[prompt_bucket] = tiles
        return tiles
