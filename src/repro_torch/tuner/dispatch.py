"""Kernel dispatch: Eq. 1 seed -> cache -> refine -> memoise.

Every op of ``kernels.ops`` and every bucket of the serving router
resolves its launch plan here.  Under ``MappingPolicy.TUNED``:

  1. build the workload's signature and the card's hardware key
     (``tuner.signature``), the latter with a digest of the cost models
     (``cache_hw_key``);
  2. look the pair up in the ``TuningCache``: a warm hit rebuilds the
     plan from the cached decision value with no probe at all;
  3. on a miss, take the Eq. 1 plan (``core.mapper``) as the seed and
     refine it with ``core.autotune.refine_discrete`` against the
     kernel's roofline cost over ``GpuParams`` (``core.roofline``);
  4. cache the winner's decision value (the plan's other fields are
     rebuilt by the kernel's legaliser, so an entry outlives a change to
     how a plan is derived).

``NAIVE``, ``FIXED`` and ``AUTO`` skip the cache and call the planners.

``measure="cached"|"live"`` changes step 3: the roofline ranks the
candidates and its top K are judged by measured times from the
``repro_torch.profiler`` trace store ("cached": recorded times only,
"live": unrecorded candidates are timed on the device with CUDA events
and recorded).  Step 2 is the same in every mode: a warm hit never
measures.

**The registered kernels** are the JAX package's (``repro.tuner``),
the mesh tier aside; the gathers and the SSD are not registered there
and keep their Eq. 1 plans.  Each decision value is the variable of the
port's legaliser in ``core.mapper``:

  * ``vecadd``, ``saxpy``: ``lws`` (``vector_plan_for_block``);
  * ``matmul``: ``lws``, BN = 2 ``lws`` on the dtype's route
    (``matmul_plan_for_blocks``);
  * ``flash_attention``: ``(block_q, block_k)``
    (``attention_plan_for_blocks``), at the head_dims built;
  * ``rmsnorm``: ``lws`` (``row_plan_for_block``);
  * ``decode_attention``, ``paged_decode``: ``(block_s, split W)``
    (``decode_block_for``, W whole ``block_s``, ``check_split``; the
    paged ``block_s`` whole pages);
  * ``gaussian_blur``: ``lws`` (``stencil_plan_for_block``);
  * ``gcn_agg``: ``lws`` (``gcn_plan_for_block``);
  * ``nn_search``: ``lws`` (``nn_plan_for_block``).

Each cost is written from the port's kernel: a plan whose shared memory
passes ``smem_per_block`` (the legaliser raises) costs infinity; bytes
and operations at the route's rate; waves at the kernel's residency,
which on the card comes from the wrappers' occupancy queries
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and elsewhere from
the plan's own estimate.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import importlib
import pathlib
import sys
import time
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.core import autotune, hw as _hw, mapper, roofline, workload
from repro_torch.core.autotune import refine_discrete
from repro_torch.core.hw import GpuParams, ceil_div, detect, round_up
from repro_torch.core.mapper import (
    CTA_THREADS, NN_CTAS_PER_SM, MappingPolicy, attention_plan_for_blocks,
    decode_block_for, decode_ctas_per_sm, decode_head_chunks,
    gcn_plan_for_block,
    matmul_plan_for_blocks, nn_plan_for_block, plan_attention_blocks,
    plan_cache_block, plan_decode_split, plan_gcn, plan_matmul_blocks,
    plan_nn, plan_paged_block, plan_rows, plan_stencil, plan_vector_blocks,
    row_plan_for_block, stencil_plan_for_block, vector_plan_for_block)
from repro_torch.core.roofline import kernel_roofline_seconds
from repro_torch.tuner.cache import TuningCache, default_cache_path
from repro_torch.tuner.signature import (WorkloadSignature, hardware_key,
                                         workload_signature)

__all__ = [
    "COST_DIGEST",
    "KernelSpec",
    "KERNEL_REGISTRY",
    "MEASURE_MODES",
    "ResolveInfo",
    "register_kernel",
    "cache_hw_key",
    "plan_for",
    "resolve_plan",
    "tuned_call",
    "get_default_cache",
    "set_default_cache",
]

_INF = float("inf")


# --------------------------------------------------------------------------- #
# Cache keys
# --------------------------------------------------------------------------- #

#: digest of the source that decides a TUNED plan: this module's seeds,
#: legalisers, costs and candidates, the planners of ``core.mapper``,
#: ``core.roofline``'s cost, ``core.autotune``'s search and ``core.hw``'s
#: rates.  It is part of every cache key (``cache_hw_key``): after a
#: change to any of them a cache written before it misses, and the tuner
#: decides anew instead of replaying the old model's picks.
COST_DIGEST = hashlib.sha256(b"".join(
    pathlib.Path(m.__file__).read_bytes()
    for m in (sys.modules[__name__], mapper, roofline, autotune, _hw))
).hexdigest()[:16]


def cache_hw_key(hw: GpuParams) -> str:
    """The hardware half of a cache key: every ``GpuParams`` field
    (``hardware_key``) and the cost models' ``COST_DIGEST``.  The trace
    store keys its times by ``hardware_key`` alone: a time does not
    depend on the model that ranked it.

    Example::

        entry = cache.get(cache_hw_key(hw), sig)
    """
    return f"{hardware_key(hw)}|cost={COST_DIGEST}"


# --------------------------------------------------------------------------- #
# Default cache
# --------------------------------------------------------------------------- #

_default_cache: Optional[TuningCache] = None


def get_default_cache() -> TuningCache:
    """Process-wide cache, created lazily at ``default_cache_path()``.

    Example::

        print(get_default_cache().stats.as_dict())
    """
    global _default_cache
    if _default_cache is None:
        _default_cache = TuningCache(default_cache_path())
    return _default_cache


def set_default_cache(cache: Optional[TuningCache]) -> None:
    """Swap the process-wide cache (None resets it to the lazy default).

    Example::

        set_default_cache(TuningCache(path=None))   # memory only
    """
    global _default_cache
    _default_cache = cache


# --------------------------------------------------------------------------- #
# Kernel registry
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """How one kernel plugs into the dispatcher.

    ``describe``        (*args, **kw) -> desc dict of static parameters
    ``sig``             (desc, policy) -> WorkloadSignature
    ``seed_plan``       (desc, hw, policy) -> plan from core.mapper
    ``plan_value``      plan -> JSON-able decision value
    ``plan_from_value`` (desc, hw, value) -> full plan (legalises; raises
                        where no legal plan exists)
    ``cost_model``      (desc, hw) -> cost(value) -> seconds
    ``candidates``      (desc, hw, seed_value) -> values to probe
    ``run``             (plan, hw, *args, **kw) -> the kernel wrapper's
                        result

    Example::

        register_kernel(KernelSpec(name="mykernel", describe=...,
                                   sig=..., seed_plan=..., ...))
    """

    name: str
    describe: Callable[..., dict]
    sig: Callable[[dict, Any], WorkloadSignature]
    seed_plan: Callable[[dict, GpuParams, MappingPolicy], Any]
    plan_value: Callable[[Any], Any]
    plan_from_value: Callable[[dict, GpuParams, Any], Any]
    cost_model: Callable[[dict, GpuParams], Callable[[Any], float]]
    candidates: Callable[[dict, GpuParams, Any], Sequence[Any]]
    run: Callable[..., Any]


KERNEL_REGISTRY: dict[str, KernelSpec] = {}


def register_kernel(spec: KernelSpec) -> KernelSpec:
    """Install a ``KernelSpec`` in the registry (and return it).

    Example::

        SPEC = register_kernel(KernelSpec(name="mykernel", ...))
    """
    KERNEL_REGISTRY[spec.name] = spec
    return spec


# --------------------------------------------------------------------------- #
# Resolution
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ResolveInfo:
    """Provenance of one resolved plan.

    Example::

        plan, info = resolve_plan("vecadd", hw, "tuned", desc)
        assert info.source in ("cache", "refined", "measured")
    """

    source: str      # planner | cache | refined | measured
    probes: int      # refine probes spent by THIS resolution
    refine_time_s: float = 0.0
    cost: Optional[float] = None
    seed_cost: Optional[float] = None
    sig_key: Optional[str] = None
    measured: int = 0  # live measurements taken by THIS resolution


# Warm-path memos.  ``_KEY_MEMO`` keeps (signature, hardware key, cache
# key) per (kernel, desc, hw); ``_PLAN_MEMO`` the rebuilt plan and its
# ResolveInfo per cache entry.  Both only skip recomputing pure functions
# of their keys: the TuningCache stays the source of truth (its stats
# still count every warm dispatch as a hit), and a changed cached value
# invalidates the plan memo.
_MEMO_CAP = 65536
_KEY_MEMO: dict[tuple, tuple[WorkloadSignature, str, str]] = {}
_PLAN_MEMO: dict[str, tuple[Any, Any, ResolveInfo]] = {}


def _memo_keys(spec: KernelSpec, desc: dict, policy: MappingPolicy,
               hw: GpuParams) -> tuple[WorkloadSignature, str, str]:
    try:
        mk = (spec.name, tuple(sorted(desc.items())), hw)
        hit = _KEY_MEMO.get(mk)
    except TypeError:                 # an unhashable desc value: no memo
        mk = hit = None
    if hit is not None:
        return hit
    sig = spec.sig(desc, policy)
    hwk = cache_hw_key(hw)
    keys = (sig, hwk, TuningCache.full_key(hwk, sig))
    if mk is not None:
        if len(_KEY_MEMO) > _MEMO_CAP:
            _KEY_MEMO.clear()
        _KEY_MEMO[mk] = keys
    return keys


#: ``measure=`` modes: "off" refines on the roofline alone; "cached"
#: re-ranks the roofline's top K by recorded times (no device work);
#: "live" times the unrecorded ones on the device and records them.  A
#: warm cache hit measures in no mode.
MEASURE_MODES = ("off", "cached", "live")


def resolve_plan(
    kernel: str,
    hw: GpuParams,
    policy: MappingPolicy | str,
    desc: dict,
    cache: Optional[TuningCache] = None,
    *,
    measure: str = "off",
    store: Optional[Any] = None,
    measure_opts: Optional[dict] = None,
) -> tuple[Any, ResolveInfo]:
    """Resolve the plan of one workload under one policy.  Where a
    tracer is ambient (``obs.trace``; the serving router installs its own
    around a cold resolution) the resolution is a ``resolve_plan`` span
    carrying its source, probes and live measurements; with the null
    tracer the cost is one attribute check.

    Example::

        desc = {"n": 1 << 20, "dtype": "float32", "dtype_bytes": 4}
        plan, info = resolve_plan("vecadd", hw, MappingPolicy.TUNED, desc)
    """
    # lazy import: obs sits above the tuner in the layering
    from repro_torch.obs.trace import get_tracer

    tracer = get_tracer()
    if not tracer.enabled:
        return _resolve_plan_impl(kernel, hw, policy, desc, cache,
                                  measure=measure, store=store,
                                  measure_opts=measure_opts)
    with tracer.span("resolve_plan", kernel=kernel, measure=measure) as sp:
        plan, info = _resolve_plan_impl(kernel, hw, policy, desc, cache,
                                        measure=measure, store=store,
                                        measure_opts=measure_opts)
        sp.set(source=info.source, probes=info.probes,
               measured=info.measured)
        return plan, info


def _resolve_plan_impl(
    kernel: str,
    hw: GpuParams,
    policy: MappingPolicy | str,
    desc: dict,
    cache: Optional[TuningCache] = None,
    *,
    measure: str = "off",
    store: Optional[Any] = None,
    measure_opts: Optional[dict] = None,
) -> tuple[Any, ResolveInfo]:
    """Seed -> cache -> refine -> memoise."""
    spec = KERNEL_REGISTRY[kernel]
    if measure not in MEASURE_MODES:
        raise ValueError(f"measure must be one of {MEASURE_MODES}, "
                         f"got {measure!r}")
    policy = MappingPolicy(policy)
    if policy is not MappingPolicy.TUNED:
        return spec.seed_plan(desc, hw, policy), ResolveInfo("planner", 0)

    cache = cache if cache is not None else get_default_cache()
    sig, hwk, fk = _memo_keys(spec, desc, policy, hw)
    entry = cache.get_by_key(fk)
    if entry is not None:
        value = entry["plan"]["value"]
        memo = _PLAN_MEMO.get(fk)
        if memo is not None and memo[0] == value:
            return memo[1], memo[2]
        plan = spec.plan_from_value(desc, hw, value)
        info = ResolveInfo("cache", 0, cost=entry.get("cost"),
                           seed_cost=entry.get("seed_cost"), sig_key=sig.key)
        if len(_PLAN_MEMO) > _MEMO_CAP:
            _PLAN_MEMO.clear()
        _PLAN_MEMO[fk] = (value, plan, info)
        return plan, info

    if measure != "off":
        return _resolve_measured(spec, desc, hw, cache, sig, hwk, measure,
                                 store, measure_opts)

    t0 = time.perf_counter()
    cost_fn = spec.cost_model(desc, hw)
    seed_value = spec.plan_value(spec.seed_plan(desc, hw, policy))
    cands = spec.candidates(desc, hw, seed_value)
    res = refine_discrete(seed_value, cost_fn, candidates=cands)
    dt = time.perf_counter() - t0
    plan = spec.plan_from_value(desc, hw, res.best)
    cache.put(hwk, sig, {"value": spec.plan_value(plan)},
              cost=res.best_cost, seed_cost=res.seed_cost,
              probes=res.probes, refine_time_s=dt)
    return plan, ResolveInfo("refined", res.probes, refine_time_s=dt,
                             cost=res.best_cost, seed_cost=res.seed_cost,
                             sig_key=sig.key)


def _resolve_measured(spec, desc, hw, cache, sig, hwk, measure, store,
                      measure_opts):
    """TUNED cache miss under ``measure="cached"|"live"``: the roofline
    prunes, the recorded or live times pick (``profiler.cost``).  With no
    time recorded for any survivor in "cached" mode the roofline's
    winner stands; in "live" mode a candidate that fails to build or
    launch raises."""
    # lazy import: the profiler builds on the tuner, not the reverse
    from repro_torch.profiler.cost import hybrid_refine
    from repro_torch.profiler.store import get_default_store

    store = store if store is not None else get_default_store()
    t0 = time.perf_counter()
    res = hybrid_refine(spec.name, desc, hw, store=store, mode=measure,
                        measure_opts=measure_opts)
    dt = time.perf_counter() - t0
    plan = spec.plan_from_value(desc, hw, res.value)
    measured_seed = None
    if res.source == "measured":
        # seed_cost: the measured time of the roofline's winner, where
        # recorded: cost / seed_cost is then what measuring gained
        m = store.get(hardware_key(hw), sig.key, res.roofline.best)
        measured_seed = m.median_s if m is not None else None
        cost = res.measured_cost
    else:
        cost, measured_seed = res.roofline_cost, res.roofline.seed_cost
    cache.put(hwk, sig, {"value": spec.plan_value(plan)},
              cost=cost, seed_cost=measured_seed, probes=res.probes,
              refine_time_s=dt,
              extra={"measured": res.source == "measured",
                     "measure_mode": measure})
    source = "measured" if res.source == "measured" else "refined"
    return plan, ResolveInfo(source, res.probes, refine_time_s=dt,
                             cost=cost, seed_cost=measured_seed,
                             sig_key=sig.key,
                             measured=res.live_measurements)


def _device_of(args) -> torch.device:
    return next(a.device for a in reversed(args)
                if isinstance(a, torch.Tensor))


def plan_for(
    kernel: str,
    *args: Any,
    hw: Optional[GpuParams] = None,
    policy: MappingPolicy | str = MappingPolicy.TUNED,
    cache: Optional[TuningCache] = None,
    measure: str = "off",
    store: Optional[Any] = None,
    measure_opts: Optional[dict] = None,
    **kwargs: Any,
) -> tuple[Any, ResolveInfo]:
    """The plan ``tuned_call`` launches ``kernel`` with for these
    arguments, and its ``ResolveInfo``: the one place an op's plan is
    made, under every policy.

    Example::

        plan, info = plan_for("matmul", a, b, hw=hw, policy="auto")

    ``hw`` defaults to ``detect()`` of the last tensor's device, the
    cache to the process-wide default.  Under ``measure`` a miss is
    timed on that device (``measure_opts["device"]`` wins).
    """
    spec = KERNEL_REGISTRY[kernel]
    device = _device_of(args)
    hw = hw if hw is not None else detect(device)
    if measure != "off":
        measure_opts = {"device": device, **(measure_opts or {})}
    return resolve_plan(kernel, hw, policy, spec.describe(*args, **kwargs),
                        cache, measure=measure, store=store,
                        measure_opts=measure_opts)


def tuned_call(
    kernel: str,
    *args: Any,
    hw: Optional[GpuParams] = None,
    policy: MappingPolicy | str = MappingPolicy.TUNED,
    cache: Optional[TuningCache] = None,
    measure: str = "off",
    store: Optional[Any] = None,
    measure_opts: Optional[dict] = None,
    **kwargs: Any,
) -> Any:
    """Run ``kernel`` at the plan ``plan_for`` resolves for its arguments.

    Example::

        out = tuned_call("vecadd", x, y, hw=hw, policy="tuned")

    A warm hit is one dict lookup in every ``measure`` mode.
    """
    hw = hw if hw is not None else detect(_device_of(args))
    plan, _ = plan_for(kernel, *args, hw=hw, policy=policy, cache=cache,
                       measure=measure, store=store,
                       measure_opts=measure_opts, **kwargs)
    return KERNEL_REGISTRY[kernel].run(plan, hw, *args, **kwargs)


# --------------------------------------------------------------------------- #
# Shared helpers for the registered kernels
# --------------------------------------------------------------------------- #


def _legal_int(v: float, lo: int, quantum: int,
               hi: Optional[int] = None) -> int:
    v = max(lo, int(v) // quantum * quantum)
    return min(v, hi) if hi is not None else v


def _scaled_candidates(seed: int, lo: int, quantum: int,
                       hi: Optional[int] = None) -> list[int]:
    """The seed's neighbourhood (the paper's §3): x1/8 ... x8 and one or
    two quanta either side, so the search sees both a change of regime
    and a rounding effect."""
    cands = {_legal_int(seed * f, lo, quantum, hi)
             for f in (0.125, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0)}
    cands |= {_legal_int(seed + d * quantum, lo, quantum, hi)
              for d in (-2, -1, 1, 2)}
    return sorted(cands)


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _itemsize(t: torch.Tensor) -> int:
    return t.element_size()


def _dt(t: torch.Tensor) -> str:
    return str(t.dtype).rsplit(".", 1)[-1]


def _on_card(hw: GpuParams) -> bool:
    """Residency comes from the CUDA runtime for a card's parameters
    where a card is present; the CPU stand-in plans with the estimate."""
    return hw.name != "cpu" and torch.cuda.is_available()


def _estimate(hw: GpuParams, threads: int = CTA_THREADS) -> int:
    """The plans' own residency: full residency by threads (``rounds``)."""
    return max(1, hw.warps_per_sm * hw.warp_size // threads)


@functools.lru_cache(maxsize=None)
def _queried(kernel: str, *key) -> int:
    """Resident CTAs per SM from a wrapper's occupancy query, memoised on
    the query's arguments (a ctypes call into the built kernel)."""
    from repro_torch.kernels import (gcn_agg, matmul, nn_search, rmsnorm,
                                     saxpy, stencil, vecadd)

    fn = {"vecadd": vecadd.occupancy, "saxpy": saxpy.occupancy,
          "matmul": matmul.occupancy_for, "rmsnorm": rmsnorm.occupancy_for,
          "stencil": stencil.occupancy, "gcn_agg": gcn_agg.occupancy,
          "nn_search": nn_search.occupancy}[kernel]
    return max(1, int(fn(*key)))


def _kernels(module: str):
    """The wrapper module ``kernels.<module>``, looked up at each run so a
    run calls whatever the module holds then."""
    return importlib.import_module(f"repro_torch.kernels.{module}")


def _roofline(flops, byts, ctas, hw, rate, per_sm) -> float:
    return kernel_roofline_seconds(flops, byts, ctas, hw, rate=rate,
                                   ctas_per_sm=per_sm)


def _illegal_is_inf(plan_from_value):
    """A value the legaliser refuses (no tile fits shared memory, a split
    the kernel cannot take) costs infinity."""
    def plan_or_none(desc, hw, value):
        try:
            return plan_from_value(desc, hw, value)
        except ValueError:
            return None
    return plan_or_none


# --------------------------------------------------------------------------- #
# 1-D elementwise kernels (vecadd, saxpy)
# --------------------------------------------------------------------------- #


def _register_vector(name: str):
    def describe(*args, **kwargs):
        x = args[-2]  # the last two args are the equal-shape vectors
        return {"n": int(x.numel()), "dtype": _dt(x),
                "dtype_bytes": _itemsize(x)}

    def sig(desc, policy):
        return workload_signature(name, shapes=[(desc["n"],)],
                                  dtypes=[desc["dtype"]], policy=policy)

    def wl(desc):
        return getattr(workload, name)(desc["n"], desc["dtype_bytes"])

    def seed_plan(desc, hw, policy):
        return plan_vector_blocks(wl(desc), hw, policy)

    def plan_from_value(desc, hw, value):
        return vector_plan_for_block(wl(desc), hw, int(value),
                                     MappingPolicy.TUNED)

    def cost_model(desc, hw):
        w = wl(desc)
        v = 16 // desc["dtype_bytes"]

        def cost(lws):
            plan = plan_from_value(desc, hw, lws)
            vector = plan.lws >= v
            per_sm = _queried(name, _torch_dtype(desc["dtype"]), vector) \
                if _on_card(hw) else _estimate(hw)
            return _roofline(w.total_flops, w.total_bytes, plan.grid, hw,
                             hw.peak_flops_fp32, per_sm)

        return cost

    def candidates(desc, hw, seed_value):
        return _scaled_candidates(int(seed_value), 1, 1,
                                  ceil_div(desc["n"], CTA_THREADS))

    def run(plan, hw, *args, **kwargs):
        return getattr(_kernels(name), name)(*args, plan=plan, **kwargs)

    return register_kernel(KernelSpec(
        name=name, describe=describe, sig=sig, seed_plan=seed_plan,
        plan_value=lambda p: int(p.lws), plan_from_value=plan_from_value,
        cost_model=cost_model, candidates=candidates, run=run))


# --------------------------------------------------------------------------- #
# Matmul
# --------------------------------------------------------------------------- #

def _register_matmul():
    from repro_torch.core.mapper import MM_TC_LWS, MM_TF32_LWS

    def describe(a, b, **kwargs):
        return {"m": int(a.shape[0]), "k": int(a.shape[1]),
                "n": int(b.shape[1]), "dtype": _dt(a),
                "dtype_bytes": _itemsize(a)}

    def sig(desc, policy):
        return workload_signature(
            "matmul", shapes=[(desc["m"], desc["k"]), (desc["k"], desc["n"])],
            dtypes=[desc["dtype"]], policy=policy)

    def route(desc):
        return _kernels("matmul").dtype_route(_torch_dtype(desc["dtype"]))

    def seed_plan(desc, hw, policy):
        return plan_matmul_blocks(desc["m"], desc["n"], desc["k"], hw,
                                  policy, kernel=route(desc))

    def plan_from_value(desc, hw, value):
        return matmul_plan_for_blocks(desc["m"], desc["n"], desc["k"], hw,
                                      int(value), MappingPolicy.TUNED,
                                      kernel=route(desc))

    legal = _illegal_is_inf(plan_from_value)

    def cost_model(desc, hw):
        m, n, k, es = desc["m"], desc["n"], desc["k"], desc["dtype_bytes"]
        tf32 = route(desc) == "tf32x3"

        def cost(value):
            plan = legal(desc, hw, value)
            if plan is None:
                return _INF
            gn, gm = plan.grid
            mp, np_, kp = gm * plan.bm, gn * plan.bn, round_up(k, plan.bk)
            # A streamed once per column of tiles, B once per row of
            # tiles, C written once
            byts = (mp * kp * gn + kp * np_ * gm) * es + m * n * es
            flops = 2.0 * mp * np_ * kp * (3 if tf32 else 1)
            rate = hw.peak_flops_tf32 if tf32 else hw.peak_flops_bf16
            per_sm = _queried("matmul", plan, k, n) if _on_card(hw) \
                else _estimate(hw, plan.threads)
            return _roofline(flops, byts, gn * gm, hw, rate, per_sm)

        return cost

    def candidates(desc, hw, seed_value):
        lo, hi = MM_TF32_LWS if route(desc) == "tf32x3" else MM_TC_LWS
        return [1 << e for e in range(lo.bit_length() - 1, hi.bit_length())]

    def run(plan, hw, a, b, **kwargs):
        return _kernels("matmul").matmul(a, b, plan=plan, **kwargs)

    return register_kernel(KernelSpec(
        name="matmul", describe=describe, sig=sig, seed_plan=seed_plan,
        plan_value=lambda p: int(p.lws), plan_from_value=plan_from_value,
        cost_model=cost_model, candidates=candidates, run=run))


# --------------------------------------------------------------------------- #
# Flash attention (prefill)
# --------------------------------------------------------------------------- #


def _flash_call(q, k, v, *, block_q, block_k, causal=True, scale=None):
    """Single-head flash attention over leading dims, the JAX package's
    ``ops.flash_attention`` layout (q (..., sq, d), k/v (..., skv, d)),
    on the kernel's grouped layout at the given tiles; causal queries sit
    at the end of the keys."""
    sq, d = q.shape[-2:]
    skv = k.shape[-2]
    if causal and sq > skv:
        raise ValueError(f"causal flash_attention needs sq <= skv, got "
                         f"{sq} > {skv}")
    out = _kernels("flash_attention").flash_attention(
        q.reshape(-1, sq, 1, 1, d).contiguous(),
        k.reshape(-1, skv, 1, d).contiguous(),
        v.reshape(-1, skv, 1, d).contiguous(), block_q=block_q,
        block_k=block_k, q_offset=skv - sq if causal else 0, scale=scale,
        causal=causal)
    return out.reshape(q.shape)


def _register_flash_attention():
    from repro_torch.core.mapper import (MAX_BLOCK_Q, TILE_QUANTUM,
                                         flash_f32_lanes)
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    def describe(q, k, v, *, causal=True, **kwargs):
        sq, d = q.shape[-2:]
        return {"seq_q": int(sq), "seq_kv": int(k.shape[-2]),
                "head_dim": int(d), "dtype": _dt(q),
                "dtype_bytes": _itemsize(q), "causal": bool(causal),
                "batch": int(q.numel() // max(1, sq * d))}

    def sig(desc, policy):
        return workload_signature(
            "flash_attention",
            shapes=[(desc["seq_q"], desc["head_dim"]),
                    (desc["seq_kv"], desc["head_dim"])],
            dtypes=[desc["dtype"]], policy=policy, causal=desc["causal"],
            batch=desc["batch"])

    def seed_plan(desc, hw, policy):
        return plan_attention_blocks(desc["seq_q"], desc["seq_kv"],
                                     desc["head_dim"], hw)

    def plan_from_value(desc, hw, value):
        bq, bk = (int(v) for v in value)
        return attention_plan_for_blocks(desc["seq_q"], desc["seq_kv"],
                                         desc["head_dim"], hw, bq, bk)

    legal = _illegal_is_inf(plan_from_value)

    def cost_model(desc, hw):
        sq, skv, hd = desc["seq_q"], desc["seq_kv"], desc["head_dim"]
        db, batch = desc["dtype_bytes"], desc["batch"]
        bf16 = desc["dtype"] == "bfloat16"
        built = hd in HEAD_DIMS.get(_torch_dtype(desc["dtype"]), ())
        half = 0.5 if desc["causal"] else 1.0

        def cost(value):
            plan = legal(desc, hw, value)
            if plan is None or not built:
                return _INF
            bq, bk = plan.block_q, plan.block_k
            gq = ceil_div(sq, bq)
            # q and o once; k and v once per query tile (the causal half)
            byts = (2 * sq * hd + 2 * skv * hd * gq * half) * db * batch
            flops = 4.0 * sq * skv * hd * half * batch
            # the kernel the dtype launches: bf16 two threads a row on
            # mma.sync, f32 one or two lanes a row (csrc/flash_attention.cu)
            if bf16:
                threads, smem = 2 * bq, 2 * 2 * bk * (hd + 8) * 2
                rate = hw.peak_flops_bf16
            else:
                lanes = flash_f32_lanes(hd)
                threads = round_up(bq * lanes, 32)
                smem = 4 * (2 * bk * hd + threads // lanes * (bk + 1))
                rate = hw.peak_flops_fp32
            per_sm = max(1, min(hw.smem_per_sm // (smem + 1024),
                                hw.warps_per_sm * hw.warp_size // threads))
            return _roofline(flops, byts, gq * batch, hw, rate, per_sm)

        return cost

    def candidates(desc, hw, seed_value):
        tiles = (32, 64, MAX_BLOCK_Q)
        keys = {min(t, round_up(desc["seq_kv"], TILE_QUANTUM))
                for t in (32, 64, 128)}
        return sorted({tuple(int(v) for v in seed_value)}
                      | {(bq, bk) for bq in tiles for bk in keys})

    def run(plan, hw, q, k, v, **kwargs):
        return _flash_call(q, k, v, block_q=plan.block_q,
                           block_k=plan.block_k, **kwargs)

    return register_kernel(KernelSpec(
        name="flash_attention", describe=describe, sig=sig,
        seed_plan=seed_plan,
        plan_value=lambda p: (int(p.block_q), int(p.block_k)),
        plan_from_value=plan_from_value, cost_model=cost_model,
        candidates=candidates, run=run))


# --------------------------------------------------------------------------- #
# RMSNorm
# --------------------------------------------------------------------------- #


def _register_rmsnorm():
    from repro_torch.kernels.rmsnorm import VEC_BYTES, WARPS

    def describe(x, gamma, **kwargs):
        return {"tokens": int(x.shape[0]), "d": int(x.shape[1]),
                "dtype": _dt(x), "dtype_bytes": _itemsize(x)}

    def sig(desc, policy):
        return workload_signature("rmsnorm",
                                  shapes=[(desc["tokens"], desc["d"])],
                                  dtypes=[desc["dtype"]], policy=policy)

    def seed_plan(desc, hw, policy):
        return plan_rows(desc["tokens"], hw, policy)

    def plan_from_value(desc, hw, value):
        return row_plan_for_block(desc["tokens"], hw, int(value),
                                  MappingPolicy.TUNED)

    def cost_model(desc, hw):
        t, d, es = desc["tokens"], desc["d"], desc["dtype_bytes"]
        row = d * es
        # the path of 16-byte-aligned operands (kernels.rmsnorm.row_path)
        path = "vector" if row % VEC_BYTES == 0 \
            and (WARPS + 1) * row <= hw.smem_per_block else "scalar"

        def cost(lws):
            plan = plan_from_value(desc, hw, lws)
            per_sm = _queried("rmsnorm", d, _torch_dtype(desc["dtype"]),
                              path) if _on_card(hw) else _estimate(hw)
            return _roofline(4.0 * t * d, (2 * t * d + d) * es, plan.grid,
                             hw, hw.peak_flops_fp32, per_sm)

        return cost

    def candidates(desc, hw, seed_value):
        return _scaled_candidates(int(seed_value), 1, 1,
                                  ceil_div(desc["tokens"], WARPS))

    def run(plan, hw, x, gamma, **kwargs):
        return _kernels("rmsnorm").rmsnorm(x, gamma, plan=plan, **kwargs)

    return register_kernel(KernelSpec(
        name="rmsnorm", describe=describe, sig=sig, seed_plan=seed_plan,
        plan_value=lambda p: int(p.lws), plan_from_value=plan_from_value,
        cost_model=cost_model, candidates=candidates, run=run))


# --------------------------------------------------------------------------- #
# Decode: (block_s, split W), contiguous and paged
# --------------------------------------------------------------------------- #


def _register_decode(name: str, paged: bool):
    """The split-KV decode sweep's plan is the pair (block_s, W): W a
    whole number of block_s (of pages on the paged path), at most the row
    rounded up to it, and cutting the row into at most 65,535 splits
    (``check_split``)."""
    from repro_torch.kernels.decode_attention import check_split

    def describe(q, k_cache, v_cache, *args, page_block=None, **kwargs):
        b, g, r, d = q.shape
        desc = {"s": int(k_cache.shape[1]), "d": int(d), "rows": int(b * g),
                "heads_per_group": int(r), "dtype": _dt(k_cache),
                "dtype_bytes": _itemsize(k_cache)}
        if paged:
            tables = args[0]
            desc.update(page_block=int(page_block),
                        max_blocks_per_row=int(tables.shape[-1]))
        return desc

    def sig(desc, policy):
        extras = dict(rows=desc["rows"],
                      heads_per_group=desc["heads_per_group"])
        if paged:
            extras.update(page_block=desc["page_block"],
                          max_blocks_per_row=desc["max_blocks_per_row"])
        return workload_signature(name, shapes=[(desc["s"], desc["d"])],
                                  dtypes=[desc["dtype"]], policy=policy,
                                  **extras)

    def quantum(desc):
        return desc["page_block"] if paged else 16

    def plan_from_value(desc, hw, value):
        bs, w = (int(v) for v in value)
        s = desc["s"]
        bs = decode_block_for(s, desc["d"], hw, bs, desc["heads_per_group"],
                              quantum=quantum(desc))
        w = min(round_up(max(w, bs), bs), round_up(max(1, s), bs))
        check_split(s, bs, w)
        return (bs, w)

    def seed_plan(desc, hw, policy):
        s, d, r = desc["s"], desc["d"], desc["heads_per_group"]
        pb = desc.get("page_block")
        if paged:
            bs = plan_paged_block(s, d, pb, hw, heads_per_group=r)
        else:
            bs = plan_cache_block(s, d, hw, policy, heads_per_group=r)
        w = plan_decode_split(s, desc["rows"], bs, d, hw, policy,
                              heads_per_group=r, page_block=pb)
        check_split(s, bs, w)      # the kernels' check, once per plan
        return (bs, w)

    legal = _illegal_is_inf(plan_from_value)

    def cost_model(desc, hw):
        s, d, rows = desc["s"], desc["d"], desc["rows"]
        r, cb = desc["heads_per_group"], desc["dtype_bytes"]
        per_sm = decode_ctas_per_sm(d, r, hw, desc.get("page_block"))
        runs = decode_head_chunks(d, r)      # CTAs a (row, group) a split

        def cost(value):
            plan = legal(desc, hw, value)
            if plan is None:
                return _INF
            n_split = ceil_div(s, plan[1])
            byts = 2.0 * rows * s * d * cb
            if n_split > 1:            # each split's partial, out and back
                byts += 2.0 * rows * n_split * r * (d + 2) * 4
            flops = 4.0 * rows * r * s * d
            return _roofline(flops, byts, rows * runs * n_split, hw,
                             hw.peak_flops_fp32, per_sm)

        return cost

    def candidates(desc, hw, seed_value):
        bs, w = (int(v) for v in seed_value)
        whole = round_up(max(1, desc["s"]), bs)
        ws = {min(whole, max(bs, _legal_int(w * f, bs, bs)))
              for f in (0.25, 0.5, 1.0, 2.0, 4.0, 8.0)}
        ws |= {min(whole, max(bs, w + dw * bs)) for dw in (-2, -1, 1, 2)}
        ws.add(whole)
        return sorted((bs, x) for x in ws)

    def run(plan, hw, q, k_cache, v_cache, *args, **kwargs):
        bs, w = plan
        module = "paged_decode_attention" if paged else "decode_attention"
        return getattr(_kernels(module), module)(
            q, k_cache, v_cache, *args, block_s=bs, split=w, **kwargs)

    return register_kernel(KernelSpec(
        name=name, describe=describe, sig=sig, seed_plan=seed_plan,
        plan_value=lambda p: (int(p[0]), int(p[1])),
        plan_from_value=plan_from_value, cost_model=cost_model,
        candidates=candidates, run=run))


# --------------------------------------------------------------------------- #
# Gaussian blur (two passes, one plan)
# --------------------------------------------------------------------------- #


def _register_stencil():
    from repro_torch.core.mapper import STENCIL_VEC_BYTES

    def describe(img, *, ksize=5, **kwargs):
        return {"h": int(img.shape[0]), "w": int(img.shape[1]),
                "ksize": int(ksize), "dtype": _dt(img),
                "dtype_bytes": _itemsize(img),
                "aligned": img.data_ptr() % STENCIL_VEC_BYTES == 0}

    def sig(desc, policy):
        return workload_signature("gaussian_blur",
                                  shapes=[(desc["h"], desc["w"])],
                                  dtypes=[desc["dtype"]], policy=policy,
                                  ksize=desc["ksize"],
                                  aligned=desc["aligned"])

    def seed_plan(desc, hw, policy):
        return plan_stencil(desc["h"], desc["w"], desc["ksize"], hw, policy,
                            elem_bytes=desc["dtype_bytes"],
                            aligned=desc["aligned"])

    def plan_from_value(desc, hw, value):
        return stencil_plan_for_block(desc["h"], desc["w"], desc["ksize"],
                                      hw, int(value), MappingPolicy.TUNED,
                                      elem_bytes=desc["dtype_bytes"],
                                      aligned=desc["aligned"])

    legal = _illegal_is_inf(plan_from_value)

    def cost_model(desc, hw):
        h, w, k, es = desc["h"], desc["w"], desc["ksize"], desc["dtype_bytes"]
        dtype = _torch_dtype(desc["dtype"])

        def cost(lws):
            plan = legal(desc, hw, lws)
            if plan is None:
                return _INF
            t = 0.0
            for p in ("rows", "cols"):     # each pass reads and writes h w
                per_sm = _queried("stencil", p, plan, dtype) \
                    if _on_card(hw) else _estimate(hw, plan.threads)
                t += _roofline(2.0 * k * h * w, 2.0 * h * w * es, plan.grid,
                               hw, hw.peak_flops_fp32, per_sm)
            return t

        return cost

    def candidates(desc, hw, seed_value):
        vec = STENCIL_VEC_BYTES // desc["dtype_bytes"]
        return _scaled_candidates(int(seed_value), 1, vec,
                                  desc["h"] * vec)

    def run(plan, hw, img, **kwargs):
        return _kernels("stencil").gaussian_blur(img, plan=plan, **kwargs)

    return register_kernel(KernelSpec(
        name="gaussian_blur", describe=describe, sig=sig,
        seed_plan=seed_plan, plan_value=lambda p: int(p.lws),
        plan_from_value=plan_from_value, cost_model=cost_model,
        candidates=candidates, run=run))


# --------------------------------------------------------------------------- #
# GCN aggregation and nearest-neighbour search
# --------------------------------------------------------------------------- #

#: the JAX kernels' tiles of the sources (GCN) and of the refs (nn), which
#: their signatures carry; the port's kernels have neither (a warp streams
#: its whole A row; the refs are split by the plan), but the signatures
#: keep them so one workload has one key in both packages
_GCN_BLOCK_S = 256
_NN_BLOCK_R = 512


def _register_gcn():
    def describe(adj, feats, **kwargs):
        return {"n": int(adj.shape[0]), "f": int(feats.shape[1]),
                "block_s": _GCN_BLOCK_S, "dtype": _dt(feats),
                "dtype_bytes": _itemsize(feats)}

    def sig(desc, policy):
        return workload_signature(
            "gcn_agg", shapes=[(desc["n"], desc["n"]),
                               (desc["n"], desc["f"])],
            dtypes=[desc["dtype"]], policy=policy, block_s=desc["block_s"])

    def seed_plan(desc, hw, policy):
        return plan_gcn(desc["n"], desc["f"], hw, policy)

    def plan_from_value(desc, hw, value):
        return gcn_plan_for_block(desc["n"], desc["f"], hw, int(value),
                                  MappingPolicy.TUNED)

    def cost_model(desc, hw):
        n, f, es = desc["n"], desc["f"], desc["dtype_bytes"]
        dtype = _torch_dtype(desc["dtype"])

        def cost(lws):
            plan = plan_from_value(desc, hw, lws)
            tiles = plan.grid[1]         # each feature tile reads A again
            per_sm = _queried("gcn_agg", plan, dtype) if _on_card(hw) \
                else _estimate(hw, plan.threads)
            # A streamed once a feature tile, X and the output once; a
            # warp tests each element of its row (the ballot)
            return _roofline(float(n) * n * tiles,
                             (n * n * tiles + 2 * n * f) * es,
                             plan.grid[0] * tiles, hw, hw.peak_flops_fp32,
                             per_sm)

        return cost

    def candidates(desc, hw, seed_value):
        return _scaled_candidates(int(seed_value), 1, 1,
                                  ceil_div(desc["n"], 8))

    def run(plan, hw, adj, feats, **kwargs):
        return _kernels("gcn_agg").gcn_agg(adj, feats, plan=plan)

    return register_kernel(KernelSpec(
        name="gcn_agg", describe=describe, sig=sig, seed_plan=seed_plan,
        plan_value=lambda p: int(p.lws), plan_from_value=plan_from_value,
        cost_model=cost_model, candidates=candidates, run=run))


def _register_nn_search():
    from repro_torch.core.mapper import NN_MAX_MT

    def describe(queries, refs, **kwargs):
        return {"nq": int(queries.shape[0]), "nr": int(refs.shape[0]),
                "d": int(queries.shape[1]), "block_r": _NN_BLOCK_R,
                "dtype": _dt(queries), "dtype_bytes": _itemsize(queries)}

    def sig(desc, policy):
        return workload_signature(
            "nn_search", shapes=[(desc["nq"], desc["d"]),
                                 (desc["nr"], desc["d"])],
            dtypes=[desc["dtype"]], policy=policy, block_r=desc["block_r"])

    def seed_plan(desc, hw, policy):
        return plan_nn(desc["nq"], desc["nr"], desc["d"], hw, policy,
                       elem_bytes=desc["dtype_bytes"])

    def plan_from_value(desc, hw, value):
        return nn_plan_for_block(desc["nq"], desc["nr"], desc["d"], hw,
                                 int(value), MappingPolicy.TUNED,
                                 elem_bytes=desc["dtype_bytes"])

    legal = _illegal_is_inf(plan_from_value)

    def cost_model(desc, hw):
        nq, nr, d, es = desc["nq"], desc["nr"], desc["d"], desc["dtype_bytes"]
        f32 = es == 4

        def cost(lws):
            plan = legal(desc, hw, lws)
            if plan is None:
                return _INF
            tiles = plan.grid[0]         # the refs are read once a tile
            byts = (nq * d + nr * d * tiles) * es + 8 * nq
            # the dots on the tensor cores (f32 as three TF32 products),
            # the epilogue's 3 operations a pair on the CUDA cores; the
            # longer of the two, in seconds (rate 1)
            dots = 2.0 * nq * nr * d
            ops_s = max(3 * dots / hw.peak_flops_tf32 if f32
                        else dots / hw.peak_flops_bf16,
                        3.0 * nq * nr / hw.peak_flops_fp32)
            per_sm = _queried("nn_search", plan) if _on_card(hw) \
                else NN_CTAS_PER_SM
            return kernel_roofline_seconds(
                ops_s, byts, plan.grid[0] * plan.grid[1], hw, rate=1.0,
                ctas_per_sm=per_sm)

        return cost

    def candidates(desc, hw, seed_value):
        return [2 * mt for mt in range(1, NN_MAX_MT + 1)]

    def run(plan, hw, queries, refs, **kwargs):
        return _kernels("nn_search").nn_search(queries, refs, plan=plan)

    return register_kernel(KernelSpec(
        name="nn_search", describe=describe, sig=sig, seed_plan=seed_plan,
        plan_value=lambda p: int(p.lws), plan_from_value=plan_from_value,
        cost_model=cost_model, candidates=candidates, run=run))


# --------------------------------------------------------------------------- #
# Populate the registry
# --------------------------------------------------------------------------- #


def _populate() -> None:
    _register_vector("vecadd")
    _register_vector("saxpy")
    _register_matmul()
    _register_flash_attention()
    _register_rmsnorm()
    _register_decode("decode_attention", paged=False)
    _register_decode("paged_decode", paged=True)
    _register_stencil()
    _register_gcn()
    _register_nn_search()


_populate()
