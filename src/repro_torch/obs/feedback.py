"""Serving-trace feedback: per-bucket step timings into the TraceStore.

This is the paper's loop closed at serving time.  The profiler records
kernel times measured on synthetic operands (``profiler.measure``); this
module turns the spans the engine emitted while serving traffic into the
same ``Measurement`` records, keyed under the real hardware key, so the
next cold resolution with ``measure="cached"`` re-ranks its candidates
against what serving observed (``profiler.cost.hybrid_refine`` replays
the store directly).  A port of the JAX package's ``obs/feedback.py``.

Attribution, as the reference's:

  * a ``decode_tick`` span times one whole model step (every layer's
    attention sweep, the MLPs, sampling, and the wait for the device), so
    the recorded per-kernel seconds are the span's duration over the
    layer count: the per-layer cost of the step whose attention plan the
    record names;
  * the record's ``value`` is the plan the step *executed*: the fused
    paged sweep's ``(block_s, split W)`` on a paged engine that reads
    through the tables, the contiguous sweep's pair otherwise (a span
    without its split names no plan);
  * ``backend=""`` and ``source="serving"``: the empty backend counts in
    every replay (``MeasuredCost``), the source keeps the provenance.

The description a record is keyed by is rebuilt from the trace's meta
through the router's own ``KERNEL_TABLE`` rows (``serve.buckets.
kernel_desc``), so its signature is the one the router resolved and the
store's records are replayed by the next resolution of that bucket.

Example::

    tracer = load_trace("serve-trace.jsonl")
    store = TraceStore("serving-traces.jsonl")
    n = feedback_to_store(tracer.spans(), tracer.meta, hw, store)
"""

from __future__ import annotations

import dataclasses
import statistics
import time
import types
from typing import Any, Iterable, Optional

from repro_torch.obs.trace import SpanRecord
from repro_torch.profiler.measure import (SYNTH_REGISTRY, Measurement,
                                          TimingStats, canon_value)

__all__ = [
    "BucketObs",
    "aggregate",
    "serve_measurements",
    "feedback_to_store",
]

#: span names the serve engine emits for its two timed phases.
DECODE_SPAN = "decode_tick"
PREFILL_SPAN = "prefill"


@dataclasses.dataclass(frozen=True)
class BucketObs:
    """Aggregated step timings for one (phase, bucket, executed plan).

    ``kernel``/``value`` name the plan the steps executed
    (``paged_decode`` or ``decode_attention`` with its (block_s, split)
    pair, ``flash_attention`` with its tiles for a whole-prompt
    prefill); both are ``None`` for attention-free families.  Durations
    are whole steps (all layers), seconds.

    Example::

        for ob in aggregate(tracer.spans()):
            print(ob.phase, ob.bucket, ob.kernel, ob.n, ob.median_s)
    """

    phase: str                  # "decode" | "prefill"
    bucket: int                 # kv_len (decode) or prompt bucket (prefill)
    kernel: Optional[str]
    value: Any                  # executed plan value (canonical)
    n: int
    total_s: float
    mean_s: float
    median_s: float
    samples: tuple[float, ...]


def _span_kernel(s: SpanRecord) -> tuple[Optional[str], Any]:
    """The kernel and plan value one serving span executed."""
    a = s.attrs
    if s.name == PREFILL_SPAN:
        tiles = a.get("tiles")
        if tiles is None:
            return None, None
        return "flash_attention", canon_value(tiles)
    for kernel, block, split in (
            ("paged_decode", "paged_decode_block", "paged_decode_split"),
            ("decode_attention", "decode_block", "decode_split")):
        if a.get(block) is not None:
            if a.get(split) is None:
                return None, None
            return kernel, canon_value((a[block], a[split]))
    return None, None


def aggregate(spans: Iterable[SpanRecord]) -> list[BucketObs]:
    """Group serving spans by (phase, bucket, executed plan).

    Only ``decode_tick``/``prefill`` spans with a ``bucket`` attribute
    take part; everything else in the trace is ignored.

    Example::

        rows = aggregate(load_trace("serve-trace.jsonl").spans())
    """
    groups: dict[tuple, list[float]] = {}
    for s in spans:
        if s.name not in (DECODE_SPAN, PREFILL_SPAN):
            continue
        bucket = s.attrs.get("bucket")
        if bucket is None:
            continue
        phase = "prefill" if s.name == PREFILL_SPAN else "decode"
        kernel, value = _span_kernel(s)
        groups.setdefault((phase, int(bucket), kernel, value),
                          []).append(s.dur)
    out = []
    for (phase, bucket, kernel, value), durs in sorted(
            groups.items(),
            key=lambda kv: (kv[0][0], kv[0][1], str(kv[0][3]))):
        out.append(BucketObs(
            phase=phase, bucket=bucket, kernel=kernel, value=value,
            n=len(durs), total_s=sum(durs),
            mean_s=statistics.fmean(durs),
            median_s=statistics.median(durs), samples=tuple(durs)))
    return out


def _kernel_desc(ob: BucketObs, meta: dict) -> Optional[dict]:
    """Rebuild the workload description the router resolved an
    observation's kernel at, from the trace's meta (None when the meta
    lacks the geometry, as a trace of the JAX engine does)."""
    from repro_torch.core.dtypes import kv_dtype_spec
    from repro_torch.serve.buckets import KERNEL_TABLE, Bucket, kernel_desc

    row = next((r for r in KERNEL_TABLE if r.kernel == ob.kernel), None)
    if row is None:
        return None
    try:
        heads, kv_heads = int(meta["heads"]), int(meta["kv_heads"])
        cfg = types.SimpleNamespace(
            head_dim=int(meta["head_dim"]), num_heads=heads,
            num_kv_heads=kv_heads, heads_per_group=heads // max(kv_heads, 1),
            dtype=str(meta["dtype"]))
        db, slots = int(meta["dtype_bytes"]), int(meta["slots"])
        kv_spec = kv_dtype_spec(str(meta.get("kv_dtype", "fp32")))
        geo = None
        if row.needs_geometry:
            geo = {"page_block": int(meta["page_block"]),
                   "max_blocks_per_row": int(meta["max_blocks_per_row"])}
    except (KeyError, TypeError, ValueError):
        return None
    return kernel_desc(row, cfg, Bucket(slots, ob.bucket), db, geo, kv_spec)


def serve_measurements(spans: Iterable[SpanRecord], meta: dict,
                       hw) -> list[Measurement]:
    """Turn serving spans into ``Measurement`` records under ``hw``.

    One record per (phase, bucket, executed plan) group: per-layer step
    seconds (span duration / ``meta["layers"]``), the kernel's own
    signature at the rebuilt description, the analytic features of
    ``SYNTH_REGISTRY``.  Groups whose kernel or geometry cannot be
    rebuilt are skipped, never fatal.

    Example::

        for m in serve_measurements(tracer.spans(), tracer.meta, hw):
            store.add(m)
    """
    from repro_torch.tuner.dispatch import KERNEL_REGISTRY
    from repro_torch.tuner.signature import hardware_key

    hwk = hardware_key(hw)
    layers = max(1, int(meta.get("layers", 1) or 1))
    out = []
    for ob in aggregate(spans):
        if ob.kernel is None:
            continue
        desc = _kernel_desc(ob, meta)
        spec = KERNEL_REGISTRY.get(ob.kernel)
        if desc is None or spec is None:
            continue
        per_layer = tuple(t / layers for t in ob.samples)
        flops = byts = None
        synth = SYNTH_REGISTRY.get(ob.kernel)
        if synth is not None:
            try:
                f, b = synth.features(desc)
                flops, byts = float(f), float(b)
            except (KeyError, TypeError):
                pass
        out.append(Measurement(
            kernel=ob.kernel, hw_key=hwk,
            sig_key=spec.sig(desc, "tuned").key,
            value=ob.value,
            stats=TimingStats.from_samples(list(per_layer), warmup=0),
            desc=desc, programs=None, flops=flops, hbm_bytes=byts,
            backend="",                 # counts in every replay
            interpret=False, source="serving", created=time.time()))
    return out


def feedback_to_store(spans: Iterable[SpanRecord], meta: dict, hw,
                      store) -> int:
    """Append serving feedback to a profiler ``TraceStore``.

    Returns the number of records the store accepted (its dedupe may
    drop replays of one key).  The store is then read directly by
    ``hybrid_refine(..., mode="cached")``.

    Example::

        store = TraceStore("serving-traces.jsonl")
        n = feedback_to_store(tracer.spans(), tracer.meta, hw, store)
        print(f"recorded {n} serving observations")
    """
    added = 0
    for m in serve_measurements(spans, meta, hw):
        if store.add(m):
            added += 1
    return added
