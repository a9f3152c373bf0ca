"""Measured time as the objective of ``autotune.refine_discrete``.

The roofline is quick but blind to what it does not model (a partial
wave's real cost, the cache, the host).  This module lets a refinement
judge observed seconds instead:

  * ``MeasuredCost``: a cost callable ``value -> seconds`` over a
    ``TraceStore``.  ``mode="cached"`` serves recorded medians and
    returns +inf for an unrecorded value (no device work);
    ``mode="live"`` times an unrecorded value on the device (CUDA
    events) and records it.  A live measurement that fails to build or
    launch raises.
  * ``hybrid_refine``: the roofline ranks the candidates, its top K are
    judged by measurement.  The roofline's winner is always among them,
    so where both are recorded the hybrid's measured time is at most the
    roofline winner's.

With nothing recorded for a workload in "cached" mode the result is the
roofline's (``source="roofline"``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.autotune import RefineResult, refine_discrete
from repro_torch.core.hw import GpuParams
from repro_torch.profiler.measure import (SYNTH_REGISTRY, canon_value,
                                          measure_value)
from repro_torch.profiler.store import TraceStore

__all__ = ["MeasuredCost", "HybridResult", "hybrid_refine"]

_INF = float("inf")

#: roofline survivors judged by measurement in ``hybrid_refine``.
DEFAULT_TOP_K = 4


class MeasuredCost:
    """``value -> median seconds`` from recorded (or live) measurements.

    Counters say how much measuring a resolution cost (the warm-hit
    checks read them).  ``measure_opts`` go to ``measure_value``
    (``device``, default "cuda"; ``warmup``, ``reps``); a record counts
    only where it was taken on the same device type.
    """

    def __init__(
        self,
        kernel: str,
        desc: dict,
        hw: GpuParams,
        *,
        store: TraceStore,
        mode: str = "cached",
        sig_key: Optional[str] = None,
        hw_key: Optional[str] = None,
        measure_opts: Optional[dict] = None,
    ):
        if mode not in ("cached", "live"):
            raise ValueError(f"mode must be 'cached' or 'live', got {mode!r}")
        self.kernel = kernel
        self.desc = desc
        self.hw = hw
        self.store = store
        self.mode = mode
        self.measure_opts = dict(measure_opts or {})
        if sig_key is None or hw_key is None:
            from repro_torch.tuner.dispatch import KERNEL_REGISTRY
            from repro_torch.tuner.signature import hardware_key
            sig_key = sig_key or KERNEL_REGISTRY[kernel].sig(desc, "tuned").key
            hw_key = hw_key or hardware_key(hw)
        self.sig_key = sig_key
        self.hw_key = hw_key
        # a kernel with no synthesiser can never measure live
        self._can_measure = kernel in SYNTH_REGISTRY
        self._backend = torch.device(
            self.measure_opts.get("device", "cuda")).type
        # counters
        self.served_cached = 0
        self.measured_live = 0
        self.unmeasured = 0
        self.mode_mismatched = 0

    def _mode_matches(self, m) -> bool:
        """A record without a backend (built by hand) always counts; a
        recorded one only where it was taken on this device type."""
        return not m.backend or m.backend == self._backend

    def __call__(self, value: Any) -> float:
        value = canon_value(value)
        m = self.store.get(self.hw_key, self.sig_key, value)
        if m is not None and not self._mode_matches(m):
            self.mode_mismatched += 1
            m = None
        if m is not None:
            self.served_cached += 1
            return m.median_s
        if self.mode == "live" and self._can_measure:
            m = measure_value(self.kernel, self.desc, value, self.hw,
                              **self.measure_opts)
            self.store.add(m)
            self.measured_live += 1
            return m.median_s
        self.unmeasured += 1
        return _INF

    @property
    def observations(self) -> int:
        """Values this callable answered from evidence (cache or live)."""
        return self.served_cached + self.measured_live


@dataclasses.dataclass(frozen=True)
class HybridResult:
    """Outcome of one roofline-prune + measured-pick resolution."""

    value: Any                     # the winning decision value
    source: str                    # "measured" | "roofline"
    roofline: RefineResult         # the full analytic pass
    measured: Optional[RefineResult]   # the top-K measured pass (or None)
    top_k: tuple                   # candidates that survived the prune
    measured_hits: int             # measured values served from the store
    live_measurements: int         # measurements taken during this call

    @property
    def probes(self) -> int:
        extra = self.measured.probes if self.measured is not None else 0
        return self.roofline.probes + extra

    @property
    def measured_cost(self) -> Optional[float]:
        if self.measured is None or self.measured.best_cost == _INF:
            return None
        return self.measured.best_cost

    @property
    def roofline_cost(self) -> float:
        return self.roofline.best_cost


def hybrid_refine(
    kernel: str,
    desc: dict,
    hw: GpuParams,
    *,
    store: TraceStore,
    mode: str = "cached",
    top_k: int = DEFAULT_TOP_K,
    measure_opts: Optional[dict] = None,
) -> HybridResult:
    """Refine one workload: roofline prunes, measurement decides.

    1. Seed with the Eq. 1 plan and rank the kernel's full candidate
       neighbourhood under its analytic cost model (``refine_discrete``
       records every evaluation).
    2. Keep the ``top_k`` cheapest *feasible* candidates — always
       including the roofline winner.
    3. Re-refine over just those against ``MeasuredCost``.  In
       ``cached`` mode unmeasured survivors cost +inf (store-only); in
       ``live`` mode they are measured and recorded.
    4. If no survivor has a time, keep the roofline's winner
       (``source="roofline"``).
    """
    from repro_torch.tuner.dispatch import KERNEL_REGISTRY

    spec = KERNEL_REGISTRY[kernel]

    from repro_torch.core.mapper import MappingPolicy
    seed_value = canon_value(
        spec.plan_value(spec.seed_plan(desc, hw, MappingPolicy.TUNED)))
    cost_fn = spec.cost_model(desc, hw)
    cands = [canon_value(c) for c in spec.candidates(desc, hw, seed_value)]
    roofline = refine_discrete(seed_value, cost_fn, candidates=cands)

    ranked = [(v, c) for v, c in roofline.ranked() if c != _INF]
    survivors = [v for v, _ in ranked[:max(1, top_k)]]
    if canon_value(roofline.best) not in survivors:
        survivors.append(canon_value(roofline.best))

    mc = MeasuredCost(kernel, desc, hw, store=store, mode=mode,
                      measure_opts=measure_opts)
    measured = refine_discrete(canon_value(roofline.best), mc,
                               candidates=survivors)
    if mc.observations == 0:                     # no evidence at all
        return HybridResult(
            value=canon_value(roofline.best), source="roofline",
            roofline=roofline, measured=measured, top_k=tuple(survivors),
            measured_hits=mc.served_cached,
            live_measurements=mc.measured_live)
    return HybridResult(
        value=canon_value(measured.best), source="measured",
        roofline=roofline, measured=measured, top_k=tuple(survivors),
        measured_hits=mc.served_cached,
        live_measurements=mc.measured_live)
