"""Roofline-drift detection: measured serving cost vs the model that
picked the plan.

A port of the JAX package's ``obs/drift.py``.  The tuner chose every
executed plan by ranking candidates under the kernel's roofline cost
(``tuner.dispatch.KERNEL_REGISTRY``, over ``GpuParams``).  If the model were
exact, measured per-bucket step cost would be a constant multiple of
the prediction across all buckets (the constant absorbs everything a
serving step includes beyond the one modelled kernel: the other layers'
MLPs, sampling, dispatch).  Buckets that *deviate from that constant*
are where the model is wrong: the buckets a live-retune pass
(``serve.retune``) revisits first.

So the detector normalizes by the fleet: ``ratio = measured/predicted``
per bucket, ``drift = ratio / median(ratio)``, ranked by ``|log
drift|``.  A bucket at drift 2.0 costs twice what the model's ranking
implied *relative to its peers*: the model may be mis-ordering
candidates there, and a replay of measurements would fix it.  Where the
step is bound by the host rather than the kernel (the port's serving
tick on the card), every bucket's ratio is far above 1 and the buckets
whose kernel is cheapest drift most.

Example::

    tracer = load_trace("serve-trace.jsonl")
    rep = drift_report(tracer.spans(), tracer.meta, hw)
    print(rep.format())
    for r in rep.candidates(threshold=1.5):
        print("retune candidate:", r.kernel, r.bucket)
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Any, Iterable, Optional

from repro_torch.obs.feedback import BucketObs, _kernel_desc, aggregate
from repro_torch.obs.trace import SpanRecord

__all__ = [
    "DriftRecord",
    "DriftReport",
    "drift_report",
    "fmt_seconds",
]


def fmt_seconds(t: float) -> str:
    """Seconds at a readable unit (the JAX package's ``core.roofline``
    helper)."""
    if t == 0:
        return "0"
    exp = int(math.floor(math.log10(abs(t))))
    if exp >= 0:
        return f"{t:.3f}s"
    if exp >= -3:
        return f"{t*1e3:.3f}ms"
    if exp >= -6:
        return f"{t*1e6:.2f}us"
    return f"{t*1e9:.1f}ns"


@dataclasses.dataclass(frozen=True)
class DriftRecord:
    """Measured-vs-predicted cost for one (kernel, bucket, plan).

    ``measured_s`` is per-layer step seconds (median), ``predicted_s``
    the roofline cost of the executed plan value, ``ratio`` their
    quotient, and ``drift`` the ratio normalized by the report's fleet
    median — 1.0 means "exactly as mispredicted as everything else".

    Example::

        r = rep.rows[0]
        print(f"{r.kernel}@{r.bucket}: drift {r.drift:.2f}x")
    """

    phase: str
    kernel: str
    bucket: int
    value: Any
    n: int
    measured_s: float
    predicted_s: float
    ratio: float
    drift: float


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """Ranked drift rows plus the fleet-median model ratio.

    Rows are sorted most-drifted first (by ``|log drift|``).

    Example::

        rep = drift_report(tracer.spans(), tracer.meta, hw)
        print(rep.format())
    """

    rows: tuple[DriftRecord, ...]
    median_ratio: float

    def candidates(self, threshold: float = 1.5) -> list[DriftRecord]:
        """Rows drifted beyond ``threshold`` (in either direction) —
        the retune shortlist.

        Example::

            hot = rep.candidates(threshold=1.5)
        """
        if threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        t = math.log(threshold)
        return [r for r in self.rows if abs(math.log(r.drift)) > t]

    def format(self) -> str:
        """Human-readable drift table (most drifted first).

        Example::

            print(drift_report(spans, meta, hw).format())
        """
        lines = [f"# model ratio (median measured/predicted): "
                 f"{self.median_ratio:.3g}",
                 "phase,kernel,bucket,value,n,measured,predicted,drift"]
        for r in self.rows:
            lines.append(
                f"{r.phase},{r.kernel},{r.bucket},{r.value},{r.n},"
                f"{fmt_seconds(r.measured_s)},{fmt_seconds(r.predicted_s)},"
                f"{r.drift:.3f}")
        return "\n".join(lines)


def _predicted_seconds(kernel: str, desc: dict, hw, value) -> Optional[float]:
    """Roofline seconds of one executed plan value (None when the kernel
    has no cost model or rejects the value: an illegal value costs
    infinity)."""
    from repro_torch.tuner.dispatch import KERNEL_REGISTRY

    spec = KERNEL_REGISTRY.get(kernel)
    if spec is None or spec.cost_model is None:
        return None
    try:
        t = spec.cost_model(desc, hw)(value)
    except (KeyError, TypeError, ValueError):
        return None
    if not math.isfinite(t) or t <= 0.0:
        return None
    return t


def drift_report(spans: Iterable[SpanRecord], meta: dict,
                 hw) -> DriftReport:
    """Compare measured per-bucket serving cost against the roofline.

    Aggregates the trace (``obs.feedback.aggregate``), rebuilds each
    group's tuner desc from ``meta``, evaluates the kernel's own cost
    model at the *executed* plan value, and ranks the normalized
    deviation.  Groups with no kernel, no reconstructible desc, or no
    cost model are skipped.

    Example::

        rep = drift_report(tracer.spans(), tracer.meta, hw)
        assert all(r.drift > 0 for r in rep.rows)
    """
    layers = max(1, int(meta.get("layers", 1) or 1))
    pre: list[tuple[BucketObs, float, float]] = []
    for ob in aggregate(spans):
        if ob.kernel is None:
            continue
        desc = _kernel_desc(ob, meta)
        if desc is None:
            continue
        predicted = _predicted_seconds(ob.kernel, desc, hw, ob.value)
        if predicted is None:
            continue
        measured = ob.median_s / layers
        if measured <= 0.0:
            continue
        pre.append((ob, measured, predicted))
    if not pre:
        return DriftReport(rows=(), median_ratio=0.0)
    med = statistics.median(m / p for _, m, p in pre)
    rows = []
    for ob, measured, predicted in pre:
        ratio = measured / predicted
        rows.append(DriftRecord(
            phase=ob.phase, kernel=ob.kernel, bucket=ob.bucket,
            value=ob.value, n=ob.n, measured_s=measured,
            predicted_s=predicted, ratio=ratio,
            drift=ratio / med if med > 0 else 1.0))
    rows.sort(key=lambda r: abs(math.log(r.drift)), reverse=True)
    return DriftReport(rows=tuple(rows), median_ratio=med)
