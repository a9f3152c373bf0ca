"""repro_torch.obs: serving-time observability (spans, feedback, drift).

The port of the JAX package's ``obs``, the observation substrate the
runtime layers report through:

  * ``obs.trace``    — ``Tracer``: nestable spans, counters/gauges,
    bounded ring, injectable clock; ``NULL_TRACER`` when off;
  * ``obs.export``   — Perfetto JSON / versioned JSONL trace files;
  * ``obs.feedback`` — per-bucket serving timings -> profiler
    ``TraceStore`` records (replayed by ``hybrid_refine``);
  * ``obs.drift``    — measured-vs-roofline drift ranking, the
    live retune's trigger (``serve.retune``).

Example::

    from repro_torch.obs import Tracer, write_trace
    tracer = Tracer()
    engine = ServeEngine("smollm-135m", slots=2, max_len=128,
                         device="cpu", tracer=tracer)
    ...
    write_trace(tracer, "serve-trace.json")
"""

from repro_torch.obs.drift import DriftRecord, DriftReport, drift_report
from repro_torch.obs.export import chrome_trace, load_trace, write_trace
from repro_torch.obs.feedback import (BucketObs, aggregate,
                                      feedback_to_store, serve_measurements)
from repro_torch.obs.trace import (NULL_TRACER, OBS_SCHEMA_VERSION,
                                   NullTracer, Span, SpanRecord, Tracer,
                                   get_tracer, set_tracer, using_tracer)

__all__ = [
    "OBS_SCHEMA_VERSION",
    "SpanRecord",
    "Span",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "get_tracer",
    "set_tracer",
    "using_tracer",
    "chrome_trace",
    "write_trace",
    "load_trace",
    "BucketObs",
    "aggregate",
    "serve_measurements",
    "feedback_to_store",
    "DriftRecord",
    "DriftReport",
    "drift_report",
]
