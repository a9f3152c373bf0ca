"""Shape bucketing and per-bucket kernel plans.

``BucketSpec`` and ``Bucket`` are copies of the JAX package's lattice:
live serving geometry rounds UP onto a bounded set of lengths.
``BucketRouter`` resolves each bucket's kernel mappings (the contiguous
decode ``block_s`` and split width, the fused paged decode's, and the
prefill flash tiles) through the tuner (``tuner.resolve_plan``) over the
runtime ``GpuParams``, one ``KERNEL_TABLE`` row a kernel, and memoises
them per bucket signature: under the default TUNED a cold bucket is a
cache lookup or a refinement, a warm one a dict hit with no probe.  An
attention-free config (ssm) plans none of them: its plans are ``None``
(mamba2's ``head_dim`` would be ``d_model`` = 2048, which no attention
kernel takes).  Every resolution reports to the router's tracer
(``obs.trace``): a warm one as a ``bucket_resolve`` (or
``prefill_resolve``) instant, a cold one as a span under which the
tuner's ``resolve_plan`` spans nest; ``swap_plan`` (the retune
controller's actuator) as a ``plan_swap`` instant.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dtypes import kv_dtype_spec
from repro_torch.core.hw import GpuParams, detect
from repro_torch.core.mapper import MappingPolicy
from repro_torch.obs.trace import get_tracer, using_tracer
from repro_torch.tuner import (KERNEL_REGISTRY, ResolveInfo, TuningCache,
                               WorkloadSignature, resolve_plan,
                               workload_signature)

__all__ = ["BucketSpec", "Bucket", "BucketPlan", "RouterStats",
           "BucketRouter", "KernelRow", "KERNEL_TABLE", "kernel_desc"]

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
    """A bucket's resolved kernel mappings, threaded into the executed
    steps: ``decode_block`` and ``decode_split`` are the contiguous
    sweep's ``block_s`` and split width (the contiguous pool and the
    gather-then-sweep read), ``paged_decode_block`` and
    ``paged_decode_split`` the fused paged sweep's (``None`` for an
    unpaged engine), ``prefill_blocks`` the flash tiles at the bucket's
    own length; each ``*_info`` is the tuner's provenance of its plan
    (``None`` where the row did not apply).  The prefill tiles that run
    are resolved per prompt bucket by ``BucketRouter.prefill_tiles``."""

    bucket: Bucket
    sig: Optional[WorkloadSignature] = None
    decode_block: Optional[int] = None       # None: attention-free
    decode_split: Optional[int] = None
    decode_info: Optional[ResolveInfo] = None
    prefill_blocks: Optional[tuple] = None
    prefill_info: Optional[ResolveInfo] = None
    paged_decode_block: Optional[int] = None  # None: unpaged or no attention
    paged_decode_split: Optional[int] = None
    paged_decode_info: Optional[ResolveInfo] = None

    @property
    def probes(self) -> int:
        return sum(i.probes for i in (self.decode_info, self.prefill_info,
                                      self.paged_decode_info)
                   if i is not None)


@dataclasses.dataclass(frozen=True)
class KernelRow:
    """One row of the router's kernel table: which tuner kernel a bucket
    resolves, when it applies, how its workload description is built
    from the bucket, and which ``BucketPlan`` fields its plan fills.

    ``desc`` receives the router's page geometry as its fourth argument
    (``None`` for an unpaged router); a row with ``needs_geometry``
    resolves to ``None`` without one.  A ``cache_kernel`` streams the KV
    pool, so its description takes the pool's storage dtype (int8 codes
    under a quantised pool), not the model's.  ``extract`` gives the
    plan's values in ``fields`` order.

    Example::

        KernelRow(kernel="decode_attention",
                  applies=lambda cfg: not cfg.is_attention_free,
                  desc=lambda cfg, b, db, geo: {"s": b.kv_len, ...},
                  extract=lambda plan: tuple(plan),
                  fields=("decode_block", "decode_split"),
                  info="decode_info")
    """

    kernel: str                  # KERNEL_REGISTRY name
    applies: Any                 # (cfg) -> bool
    desc: Any                    # (cfg, bucket, dtype_bytes, geo) -> dict
    extract: Any                 # plan -> values of ``fields``
    fields: tuple                # BucketPlan fields the plan's values fill
    info: str                    # BucketPlan field of its ResolveInfo
    needs_geometry: bool = False
    cache_kernel: bool = False


def _decode_desc(cfg, b, db):
    return {"s": b.kv_len, "d": cfg.head_dim,
            "rows": b.slots * cfg.num_kv_heads,
            "heads_per_group": cfg.heads_per_group, "dtype": cfg.dtype,
            "dtype_bytes": db}


#: the per-bucket kernel set: a bucket-tuned kernel is one row here and
#: its ``BucketPlan`` fields
KERNEL_TABLE: tuple[KernelRow, ...] = (
    KernelRow(
        kernel="decode_attention",
        applies=lambda cfg: not cfg.is_attention_free,
        desc=lambda cfg, b, db, geo: _decode_desc(cfg, b, db),
        extract=tuple, fields=("decode_block", "decode_split"),
        info="decode_info",
        cache_kernel=True),
    KernelRow(
        kernel="flash_attention",
        applies=lambda cfg: not cfg.is_attention_free,
        # one prompt at a time: the kernel's batch is its query heads
        desc=lambda cfg, b, db, geo: {
            "seq_q": b.kv_len, "seq_kv": b.kv_len,
            "head_dim": cfg.head_dim, "dtype": cfg.dtype,
            "dtype_bytes": db, "causal": True, "batch": cfg.num_heads},
        extract=lambda plan: ((plan.block_q, plan.block_k),),
        fields=("prefill_blocks",), info="prefill_info"),
    KernelRow(
        kernel="paged_decode",
        applies=lambda cfg: not cfg.is_attention_free,
        desc=lambda cfg, b, db, geo: {**_decode_desc(cfg, b, db), **geo},
        extract=tuple, fields=("paged_decode_block", "paged_decode_split"),
        info="paged_decode_info", needs_geometry=True, cache_kernel=True),
)


def kernel_desc(row: KernelRow, cfg, bucket: Bucket, dtype_bytes: int,
                geo: Optional[dict], kv_spec) -> dict:
    """The workload description ``row`` resolves at ``bucket``: the
    router's (``BucketRouter.row_desc``) and, from a trace's meta, the
    serving feedback's (``obs.feedback``), so both build one signature.
    ``cfg`` needs the model's ``head_dim``, ``num_heads``,
    ``num_kv_heads``, ``heads_per_group`` and ``dtype``."""
    desc = row.desc(cfg, bucket, dtype_bytes, geo)
    if row.cache_kernel and kv_spec.quantized:
        # the sweep reads int8 codes: the tuner sees their byte width
        # (and a signature of its own), so the quantised pool may
        # resolve another plan than the fp32 pool on one bucket
        desc["dtype"] = kv_spec.dtype
        desc["dtype_bytes"] = kv_spec.bytes
    return desc


@dataclasses.dataclass
class RouterStats:
    """Per-router resolution accounting.

    Example::

        >>> RouterStats().probes
        0
    """

    cold: int = 0            # resolutions that consulted the tuner
    warm: int = 0            # served from the router's own plan table
    probes: int = 0          # refine probes spent across all resolutions
    cache_hits: int = 0      # tuner resolutions answered by the TuningCache
    swaps: int = 0           # plans swapped in place (``swap_plan``)


class BucketRouter:
    """Maps live (batch, need_len) geometry to tuned per-bucket plans.

    The router is the engine's window into the tuner: it owns the
    lattice, builds each bucket's ``WorkloadSignature``, and resolves the
    bucket's kernel plans through ``tuner.resolve_plan`` (seed -> cache
    -> refine -> memoise), so a warm bucket spends no probe.  ``policy``
    defaults to TUNED; ``cache`` to the tuner's process-wide cache;
    ``measure`` ("off", "cached", "live") and ``store`` pass to the
    tuner, a live measurement timed on ``device``.  ``page_block=None``
    is an unpaged engine (no paged plan); ``kv_dtype`` is the pool's
    storage ("fp32" or "int8"), on which the cache kernels resolve.
    ``tracer`` (default: the ambient tracer at construction, the null
    tracer unless one is installed) receives every resolution.

    Example::

        router = BucketRouter(cfg, BucketSpec(max_len=256), slots=4,
                              hw=detect("cuda"), page_block=16)
        plan = router.resolve(router.bucket(need_len))
        tiles = router.prefill_tiles(router.quantize_prompt(plen))
    """

    def __init__(self, cfg: ModelConfig, spec: BucketSpec, *, slots: int,
                 hw: Optional[GpuParams] = None,
                 policy: MappingPolicy | str = MappingPolicy.TUNED,
                 cache: Optional[TuningCache] = None,
                 measure: str = "off", store: Optional[Any] = None,
                 page_block: Optional[int] = 16, kv_dtype: str = "fp32",
                 device="cuda", tracer: Optional[Any] = None):
        self.cfg = cfg
        self.spec = spec
        self.slots = slots
        self.kv_spec = kv_dtype_spec(kv_dtype)
        self.device = device
        self.hw = hw if hw is not None else detect(device)
        self.policy = MappingPolicy(policy)
        self.cache = cache
        self.measure = measure
        self.store = store
        self.page_block = None if page_block is None else int(page_block)
        self.obs = tracer if tracer is not None else get_tracer()
        self.stats = RouterStats()
        self._plans: dict[str, BucketPlan] = {}
        self._prefill_tiles: dict[int, tuple[int, int]] = {}

    def _geometry(self) -> Optional[dict]:
        """The table geometry the paged plan is keyed on: the page size
        and the widest block table any bucket can need (the lattice cap's
        pages), so one plan stays legal as the pool grows."""
        if self.page_block is None:
            return None
        pb = self.page_block
        return {"page_block": pb,
                "max_blocks_per_row": -(-self.spec.max_len // pb)}

    @property
    def plans(self) -> tuple[BucketPlan, ...]:
        """The bucket plans resolved so far."""
        return tuple(self._plans.values())

    @property
    def prefill_plans(self) -> dict[int, tuple[int, int]]:
        """Prompt bucket -> the flash tiles resolved so far."""
        return dict(self._prefill_tiles)

    # -- lattice ----------------------------------------------------------

    def bucket(self, need_len: int) -> Bucket:
        """The lattice point covering a pool-length requirement."""
        return Bucket(self.slots, self.spec.quantize(need_len))

    def quantize_prompt(self, prompt_len: int) -> int:
        """The prompt bucket a prefill pads to (same lattice)."""
        return self.spec.quantize(prompt_len)

    # -- resolution -------------------------------------------------------

    def signature(self, bucket: Bucket) -> WorkloadSignature:
        """The bucket's canonical identity in the tuning namespace."""
        return workload_signature(
            "serve_decode",
            shapes=[(bucket.slots, bucket.kv_len)],
            dtypes=[self.cfg.dtype],
            policy=self.policy,
            kv_heads=max(self.cfg.num_kv_heads, 1),
            head_dim=self.cfg.head_dim,
            layers=self.cfg.num_layers,
            kv_dtype=self.kv_spec.name)

    def _dtype_bytes(self) -> int:
        return 2 if self.cfg.dtype == "bfloat16" else 4

    def _resolve_kernel(self, kernel: str, desc: dict):
        kw = {}
        if self.measure != "off":
            kw = dict(measure=self.measure, store=self.store,
                      measure_opts={"device": self.device})
        plan, info = resolve_plan(kernel, self.hw, self.policy, desc,
                                  self.cache, **kw)
        self.stats.probes += info.probes
        if info.source == "cache":
            self.stats.cache_hits += 1
        return plan, info

    def row_desc(self, row: KernelRow, bucket: Bucket) -> dict:
        """The workload description ``row`` resolves at ``bucket``."""
        return kernel_desc(row, self.cfg, bucket, self._dtype_bytes(),
                           self._geometry(), self.kv_spec)

    def resolve(self, bucket: Bucket) -> BucketPlan:
        """Per-bucket kernel plans, memoised on the bucket signature; each
        applicable ``KERNEL_TABLE`` row resolves through the tuner."""
        sig = self.signature(bucket)
        hit = self._plans.get(sig.key)
        if hit is not None:
            self.stats.warm += 1
            self.obs.instant("bucket_resolve", bucket=bucket.kv_len,
                             provenance="warm")
            return hit
        self.stats.cold += 1
        # the cold resolution runs under this router's tracer, so the
        # tuner's resolve_plan spans nest beneath this one
        with self.obs.span("bucket_resolve", bucket=bucket.kv_len,
                           provenance="cold") as sp, \
                using_tracer(self.obs):
            fields: dict[str, Any] = {}
            for row in KERNEL_TABLE:
                if not row.applies(self.cfg) or (row.needs_geometry
                                                 and self.page_block is None):
                    continue
                kplan, info = self._resolve_kernel(row.kernel,
                                                   self.row_desc(row, bucket))
                fields.update(zip(row.fields, row.extract(kplan)))
                fields[row.info] = info
            plan = BucketPlan(bucket=bucket, sig=sig, **fields)
            sp.set(decode_block=plan.decode_block,
                   decode_split=plan.decode_split,
                   prefill_blocks=plan.prefill_blocks,
                   paged_decode_block=plan.paged_decode_block,
                   paged_decode_split=plan.paged_decode_split,
                   probes=plan.probes)
        self._plans[sig.key] = plan
        return plan

    #: each retunable kernel's ``BucketPlan`` fields, the pair (block_s,
    #: split W) its value fills (the prefill tiles are resolved per prompt
    #: bucket and the retune trial measures decode ticks, so only the
    #: decode kernels swap)
    SWAP_FIELDS = {r.kernel: r.fields for r in KERNEL_TABLE
                   if r.kernel != "flash_attention"}

    def swap_plan(self, bucket: Bucket, kernel: str, value) -> BucketPlan:
        """Swap one decode kernel's value, a (block_s, split) pair, into a
        bucket's memoised plan, legalised by the kernel's own rule (the
        retune controller's actuation path, ``serve.retune``).  The
        engine's next ``resolve`` of the bucket returns it warm; other
        buckets keep theirs.  Returns the new plan.

        Example::

            router.swap_plan(router.bucket(256), "paged_decode", (16, 64))
        """
        if kernel not in self.SWAP_FIELDS:
            raise ValueError(f"{kernel!r} does not swap: the prefill tiles "
                             f"are resolved per prompt bucket; only the "
                             f"decode plans swap")
        row = next(r for r in KERNEL_TABLE if r.kernel == kernel)
        plan = self.resolve(bucket)
        kplan = KERNEL_REGISTRY[kernel].plan_from_value(
            self.row_desc(row, bucket), self.hw, value)
        new = dataclasses.replace(plan, **dict(zip(row.fields,
                                                   row.extract(kplan))))
        self._plans[plan.sig.key] = new
        self.stats.swaps += 1
        self.obs.instant("plan_swap", bucket=bucket.kv_len, kernel=kernel,
                         field=row.fields[0],
                         value=tuple(getattr(new, f) for f in row.fields))
        self.obs.count("plan_swaps")
        return new

    def prefill_tiles(self, prompt_bucket: int) -> Optional[tuple[int, int]]:
        """The EXECUTED prefill mapping for one prompt bucket: the flash
        (block_q, block_k) resolved through the tuner at the bucket's own
        (seq, seq) geometry, from the table's flash row, and memoised per
        length; ``None`` for attention-free families (no flash sweep to
        map)."""
        row = next(r for r in KERNEL_TABLE if r.kernel == "flash_attention")
        if not row.applies(self.cfg):
            return None
        hit = self._prefill_tiles.get(prompt_bucket)
        if hit is not None:
            self.stats.warm += 1
            self.obs.instant("prefill_resolve", bucket=prompt_bucket,
                             provenance="warm")
            return hit
        self.stats.cold += 1
        with self.obs.span("prefill_resolve", bucket=prompt_bucket,
                           provenance="cold") as sp, \
                using_tracer(self.obs):
            plan, _ = self._resolve_kernel(
                row.kernel, self.row_desc(row, Bucket(self.slots,
                                                      prompt_bucket)))
            tiles = row.extract(plan)[0]
            sp.set(tiles=tiles)
        self._prefill_tiles[prompt_bucket] = tiles
        return tiles
