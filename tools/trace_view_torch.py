#!/usr/bin/env python
"""Render a trace of the PyTorch port's engine: spans, buckets, retune
decisions and roofline drift.

    PYTHONPATH=src python tools/trace_view_torch.py serve-trace.json
    PYTHONPATH=src python tools/trace_view_torch.py serve-trace.jsonl \\
        --hw detect --top 10
    PYTHONPATH=src python tools/trace_view_torch.py serve-trace.json \\
        --require-buckets --require-drift      # assertion mode

Reads either form ``repro_torch.obs.export`` writes (Perfetto/Chrome JSON
or versioned JSONL; the JAX package's traces too), counts the spans by
name, aggregates the serving spans per (phase, bucket, executed plan),
lists the retune controller's decisions, and, when the trace's meta
carries the model's geometry, ranks measured-vs-roofline drift per
bucket (``repro_torch.obs.drift``) on the ``--hw`` part: a
``GPU_REGISTRY`` name, or ``detect`` (the CUDA device where one is
present, else the CPU stand-in).  The ``--require-*`` flags turn a
missing section into exit code 1.  The port of ``tools/trace_view.py``.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

# tools/ scripts run from the repo root; make src/ importable even
# without PYTHONPATH
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)


def _hw(name: str):
    import torch

    from repro_torch.core.hw import GPU_REGISTRY, detect
    if name == "detect":
        return detect("cuda" if torch.cuda.is_available() else "cpu")
    return GPU_REGISTRY[name]


def main(argv=None) -> int:
    from repro_torch.obs import aggregate, drift_report, load_trace
    from repro_torch.obs.drift import fmt_seconds

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="trace file (.json Perfetto or JSONL)")
    ap.add_argument("--hw", default="h100_sxm",
                    help="GPU_REGISTRY part name or 'detect' (drift "
                         "predictions are evaluated on this part)")
    ap.add_argument("--top", type=int, default=20,
                    help="max drift rows to print")
    ap.add_argument("--require-buckets", action="store_true",
                    help="exit 1 unless the trace yields per-bucket rows")
    ap.add_argument("--require-drift", action="store_true",
                    help="exit 1 unless a non-empty drift report parses")
    ap.add_argument("--require-swaps", action="store_true",
                    help="exit 1 unless the trace records at least one "
                         "concluded retune decision")
    args = ap.parse_args(argv)

    tracer = load_trace(args.trace)
    spans = tracer.spans()
    meta = tracer.meta
    print(f"# {args.trace}: {len(spans)} spans, "
          f"arch={meta.get('arch', '?')} hw_meta={meta.get('hw', '?')} "
          f"kv_dtype={meta.get('kv_dtype', 'fp32')}")
    if tracer.counters():
        print("# counters: " + " ".join(
            f"{k}={v:g}" for k, v in sorted(tracer.counters().items())))

    by_name: dict[str, list[float]] = collections.defaultdict(list)
    for s in spans:
        by_name[s.name].append(s.dur)
    print("\nspan,n,total,mean")
    for name, durs in sorted(by_name.items()):
        print(f"{name},{len(durs)},{fmt_seconds(sum(durs))},"
              f"{fmt_seconds(sum(durs) / len(durs))}")

    rows = aggregate(spans)
    print("\nphase,bucket,kernel,value,n,total,mean,median")
    for ob in rows:
        print(f"{ob.phase},{ob.bucket},{ob.kernel or '-'},"
              f"{ob.value if ob.value is not None else '-'},{ob.n},"
              f"{fmt_seconds(ob.total_s)},{fmt_seconds(ob.mean_s)},"
              f"{fmt_seconds(ob.median_s)}")
    if not rows:
        print("(no decode_tick/prefill spans with bucket attribution)")
        if args.require_buckets:
            print("trace_view_torch: FAIL — per-bucket rows required",
                  file=sys.stderr)
            return 1

    decisions = [s.attrs for s in spans if s.name == "retune_decision"]
    n_adopted = sum(1 for d in decisions if d.get("adopted"))
    print(f"\n# retune: {len(decisions)} decisions "
          f"(adopted={n_adopted} rejected={len(decisions) - n_adopted}, "
          f"trial spans={sum(1 for s in spans if s.name == 'retune_trial')})")
    if decisions:
        print("bucket,kernel,incumbent,candidate,incumbent_us,"
              "candidate_us,verdict,reason")
        for d in decisions:
            cus = d.get("candidate_us")
            print(f"{d.get('bucket')},{d.get('kernel')},"
                  f"{d.get('incumbent')},{d.get('candidate')},"
                  f"{d.get('incumbent_us', 0.0):.1f},"
                  f"{'-' if cus is None else f'{cus:.1f}'},"
                  f"{'ADOPTED' if d.get('adopted') else 'reverted'},"
                  f"{d.get('reason')}")
    else:
        print("(no retune_decision spans: controller off, or no trial "
              "concluded in this window)")
        if args.require_swaps:
            print("trace_view_torch: FAIL — retune decisions required",
                  file=sys.stderr)
            return 1

    rep = drift_report(spans, meta, _hw(args.hw))
    print(f"\n# drift vs roofline on --hw {args.hw} "
          f"(top {args.top} of {len(rep.rows)})")
    if rep.rows:
        print("\n".join(rep.format().splitlines()[:args.top + 2]))
        hot = rep.candidates(threshold=1.5)
        if hot:
            print("# retune candidates (>1.5x off fleet median): "
                  + ", ".join(f"{r.kernel}@{r.bucket}" for r in hot))
    else:
        print("(no drift rows: trace meta lacks model geometry, or no "
              "kernel-attributed spans)")
        if args.require_drift:
            print("trace_view_torch: FAIL — drift report required",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
