"""repro_torch.profiler: on-device observation closing the tuner's loop.

  ``measure``  timed runs of kernel plans (warm-up, repeats, CUDA events
               with the L2 flushed before each, median and IQR; the
               operands made from the workload's description),
  ``store``    a versioned, hardware-keyed JSONL store of measurements
               (append, dedupe, atomic merge), per checkout by default,
  ``cost``     ``MeasuredCost`` and ``hybrid_refine``: the roofline
               prunes the candidates, measurement picks the winner,
  ``calibrate`` the roofline's rates and launch time, and the Vortex
               trace model's constants, fitted to measured records.

Reached through dispatch as ``tuned_call(..., measure="cached"|"live")``
or ``ServeEngine(measure=...)``; a warm cache hit never measures.  The
serving engine feeds the store too (``obs.feedback``).
"""

from repro_torch.profiler.calibrate import (RooflineFit, TracesimFit,
                                            fit_roofline, fit_tracesim,
                                            mean_abs_log_error)
from repro_torch.profiler.cost import HybridResult, MeasuredCost, \
    hybrid_refine
from repro_torch.profiler.measure import (Measurement, TimingStats,
                                          canon_value, measure_value,
                                          supported_kernels, time_callable,
                                          value_key)
from repro_torch.profiler.store import (TRACE_SCHEMA_VERSION, StoreStats,
                                        TraceStore, default_store_path,
                                        get_default_store, set_default_store)

__all__ = [
    "TimingStats",
    "Measurement",
    "time_callable",
    "measure_value",
    "canon_value",
    "value_key",
    "supported_kernels",
    "TRACE_SCHEMA_VERSION",
    "StoreStats",
    "TraceStore",
    "default_store_path",
    "get_default_store",
    "set_default_store",
    "MeasuredCost",
    "HybridResult",
    "hybrid_refine",
    "RooflineFit",
    "TracesimFit",
    "fit_roofline",
    "fit_tracesim",
    "mean_abs_log_error",
]
