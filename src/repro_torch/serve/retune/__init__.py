"""Live in-flight retuning — the actuation half of the runtime loop.

The port of the JAX package's ``serve.retune``.  ``repro_torch.obs``
measures serving (spans -> ``TraceStore`` feedback ->
``drift_report``); this package ACTS on those measurements while the
engine keeps serving: a ``RetuneController`` runs between decode ticks,
re-resolves drift-flagged buckets via ``hybrid_refine(mode="cached")``
over the serving-fed store, and hot-swaps the bucket's plan in the
``BucketRouter`` under an A/B guard — the candidate is trial-executed on
real ticks and a slower plan is never adopted.

Example::

    from repro_torch.serve import ServeEngine
    eng = ServeEngine("smollm-135m", retune="inline")
    report = eng.run()
    for d in eng.retune.decisions:
        print(d.bucket, d.incumbent, "->", d.candidate, d.adopted)
"""

from repro_torch.serve.retune.controller import (RETUNE_MODES,
                                                 RetuneConfig,
                                                 RetuneController,
                                                 RetuneStats, SwapDecision)

__all__ = ["RETUNE_MODES", "RetuneConfig", "RetuneController",
           "RetuneStats", "SwapDecision"]
