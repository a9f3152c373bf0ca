"""Fit cost-model parameters to measured traces: model meets evidence.

A port of the JAX package's ``profiler/calibrate.py``.  Two fits, each
reporting the model's error against the measurements *before and after*,
so every calibration is also a validation:

  * ``fit_roofline``: the tuner's per-kernel cost is
    ``core.roofline.kernel_roofline_seconds(flops, bytes, ctas, hw,
    rate=, ctas_per_sm=)`` over the route's peak rate, ``mem_bw`` and the
    launch terms ``launch_s`` and ``wave_s``.  The fit frees the
    effective rate (one scale on the three peaks, so every route keeps
    its ratio to the others), the effective memory bandwidth, and the
    launch's fixed time; ``wave_s`` stays.  Data-sheet rates are upper
    bounds, not observations; the fit replaces them with what the
    attached device achieves on the records given.  A record's rate is
    its route's (``route_rate``); it carries no residency, so its waves
    are counted at one CTA an SM.
  * ``fit_tracesim``: anchors the Vortex trace model's free constants
    (seconds per cycle, the per-call dispatch overhead) to measured
    1-D kernel records, the recorded ``lws`` playing the model's
    ``lws``.  Hardware-free: the JAX package's fit.

Both fitters are deterministic and dependency-free (a coarse-to-fine
grid in log space, the inner parameters in closed form) and guarantee
``err_after <= err_before``: the uncalibrated parameters are always one
of the candidates.

Example::

    fit = fit_roofline(store.records(), detect("cuda"))
    print(fit.err_before, "->", fit.err_after, fit.hw_after.mem_bw)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Sequence

from repro_torch.core.hw import GpuParams, VortexParams
from repro_torch.core.roofline import kernel_roofline_seconds
from repro_torch.profiler.measure import Measurement

__all__ = [
    "RooflineFit",
    "fit_roofline",
    "route_rate",
    "record_seconds",
    "TracesimFit",
    "fit_tracesim",
    "mean_abs_log_error",
]


def mean_abs_log_error(pairs: Sequence[tuple[float, float]]) -> float:
    """``mean(|ln(model / measured)|)``: scale-free, outlier-tolerant.

    0.0 is a perfect model; 0.69 is "off by 2x on average".
    """
    if not pairs:
        raise ValueError("no (model, measured) pairs")
    total = 0.0
    for model, measured in pairs:
        if model <= 0 or measured <= 0:
            total += 20.0                     # degenerate: heavy penalty
        else:
            total += abs(math.log(model / measured))
    return total / len(pairs)


# --------------------------------------------------------------------------- #
# Roofline fit
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class RooflineFit:
    hw_before: GpuParams
    hw_after: GpuParams
    err_before: float
    err_after: float
    n_records: int
    #: (kernel, value, measured_s, model_before_s, model_after_s)
    table: tuple = ()

    @property
    def improvement(self) -> float:
        return self.err_before / self.err_after if self.err_after else math.inf


def route_rate(kernel: str, dtype: Optional[str], hw: GpuParams) -> float:
    """The peak rate a record's operations run at, by the route its
    kernel takes for its dtype (as the tuner's costs read them): bf16
    products on the tensor cores, f32 products as three TF32 products
    (the matmul's and nn_search's 3xTF32 route), everything else on the
    CUDA cores."""
    products = kernel in ("matmul", "nn_search", "flash_attention")
    if products and dtype == "bfloat16":
        return hw.peak_flops_bf16
    if kernel in ("matmul", "nn_search") and dtype == "float32":
        return hw.peak_flops_tf32 / 3.0
    return hw.peak_flops_fp32


def _dtype(m: Measurement) -> Optional[str]:
    return (m.desc or {}).get("dtype")


def record_seconds(m: Measurement, hw: GpuParams,
                   launch: bool = True) -> float:
    """The roofline's seconds for one record (without the launch's fixed
    time when ``launch`` is False)."""
    t = kernel_roofline_seconds(m.flops, m.hbm_bytes, m.programs, hw,
                                rate=route_rate(m.kernel, _dtype(m), hw),
                                ctas_per_sm=1)
    return t if launch else t - hw.launch_s


def _usable(records: Iterable[Measurement]) -> list[Measurement]:
    return [m for m in records
            if m.flops and m.hbm_bytes and m.programs
            and m.stats.median_s > 0]


def _roofline_err(recs: list[Measurement], hw: GpuParams) -> float:
    return mean_abs_log_error([(record_seconds(m, hw), m.stats.median_s)
                               for m in recs])


def _fit_launch(recs: list[Measurement], hw: GpuParams) -> float:
    """Closed-form launch time (seconds) given the roofs: the median
    positive residual."""
    res = sorted(max(m.stats.median_s - record_seconds(m, hw, launch=False),
                     0.0) for m in recs)
    return res[len(res) // 2]


def fit_roofline(records: Iterable[Measurement], hw: GpuParams,
                 *, grid_points: int = 17,
                 grid_decades: float = 4.0) -> RooflineFit:
    """Fit (effective rate, memory bandwidth, launch time) to records.

    A coarse-to-fine grid over multiplicative scales of the rate and the
    bandwidth (log-spaced, ``±grid_decades`` decades); the launch time
    falls out in closed form at each point.  The uncalibrated ``hw`` is
    always a candidate, so the result can only improve on it.
    """
    recs = _usable(records)
    if len(recs) < 2:
        raise ValueError(f"need >=2 usable records, got {len(recs)}")
    if grid_points < 2:
        raise ValueError(f"grid_points must be >= 2, got {grid_points}")

    err_before = _roofline_err(recs, hw)

    def candidate(scale_f: float, scale_b: float) -> tuple[float, GpuParams]:
        trial = dataclasses.replace(
            hw, peak_flops_fp32=hw.peak_flops_fp32 * scale_f,
            peak_flops_bf16=hw.peak_flops_bf16 * scale_f,
            peak_flops_tf32=hw.peak_flops_tf32 * scale_f,
            mem_bw=hw.mem_bw * scale_b)
        fitted = dataclasses.replace(trial,
                                     launch_s=_fit_launch(recs, trial))
        return _roofline_err(recs, fitted), fitted

    def search(center_f: float, center_b: float,
               decades: float) -> tuple[float, GpuParams, float, float]:
        best = (math.inf, hw, center_f, center_b)
        for i in range(grid_points):
            ef = -decades + 2 * decades * i / (grid_points - 1)
            for j in range(grid_points):
                eb = -decades + 2 * decades * j / (grid_points - 1)
                sf, sb = center_f * 10 ** ef, center_b * 10 ** eb
                err, fitted = candidate(sf, sb)
                if err < best[0]:
                    best = (err, fitted, sf, sb)
        return best

    err, fitted, sf, sb = search(1.0, 1.0, grid_decades)
    # refine around the coarse winner (one grid step, then a tenth)
    for decades in (grid_decades / (grid_points - 1) * 2, 0.1):
        err2, fitted2, sf2, sb2 = search(sf, sb, decades)
        if err2 < err:
            err, fitted, sf, sb = err2, fitted2, sf2, sb2

    if err_before <= err:                    # never regress
        err, fitted = err_before, hw

    table = tuple((m.kernel, m.value, m.stats.median_s,
                   record_seconds(m, hw), record_seconds(m, fitted))
                  for m in recs)
    return RooflineFit(hw_before=hw, hw_after=fitted,
                       err_before=err_before, err_after=err,
                       n_records=len(recs), table=table)


# --------------------------------------------------------------------------- #
# Tracesim fit
# --------------------------------------------------------------------------- #

#: kernels whose (desc -> Workload) mapping the tracesim fit understands.
_WORKLOAD_BUILDERS = {
    "vecadd": lambda d: _wl("vecadd", d),
    "saxpy": lambda d: _wl("saxpy", d),
}


def _wl(name: str, desc: dict):
    from repro_torch.core import workload as W
    return getattr(W, name)(desc["n"], dtype_bytes=desc["dtype_bytes"])


@dataclasses.dataclass(frozen=True)
class TracesimFit:
    cfg_before: VortexParams
    cfg_after: VortexParams
    seconds_per_cycle: float
    err_before: float
    err_after: float
    n_records: int


def fit_tracesim(records: Iterable[Measurement], cfg: VortexParams,
                 *, overhead_grid: Optional[Sequence[int]] = None
                 ) -> TracesimFit:
    """Anchor the Vortex trace model to measured 1-D kernel records.

    For each usable record (a kernel with a known Workload builder and a
    stored ``desc``), the recorded ``lws`` plays ``lws`` and the model
    predicts ``seconds_per_cycle x simulate(...).cycles``.  The scale is
    a closed-form log-least-squares; ``call_overhead_cycles`` is
    grid-searched with the existing value always included.
    """
    from repro_torch.core.tracesim import simulate

    recs = [m for m in records
            if m.kernel in _WORKLOAD_BUILDERS and m.desc
            and m.stats.median_s > 0 and not isinstance(m.value, tuple)]
    if len(recs) < 2:
        raise ValueError(f"need >=2 usable 1D records, got {len(recs)}")

    def fit_scale(trial: VortexParams) -> tuple[float, float]:
        logs, cycles = [], []
        for m in recs:
            w = _WORKLOAD_BUILDERS[m.kernel](m.desc)
            c = max(simulate(w, trial, int(m.value)).cycles, 1)
            cycles.append(c)
            logs.append(math.log(m.stats.median_s) - math.log(c))
        scale = math.exp(sum(logs) / len(logs))
        err = mean_abs_log_error([
            (scale * c, m.stats.median_s) for c, m in zip(cycles, recs)])
        return err, scale

    grid = list(overhead_grid) if overhead_grid is not None else \
        [0, 24, 48, 96, 192, 384, 768, 1536, 3072, 6144]
    if cfg.call_overhead_cycles not in grid:
        grid.append(cfg.call_overhead_cycles)

    err_before, scale_before = fit_scale(cfg)
    best = (err_before, cfg, scale_before)
    for oh in grid:
        trial = dataclasses.replace(cfg, call_overhead_cycles=int(oh))
        err, scale = fit_scale(trial)
        if err < best[0]:
            best = (err, trial, scale)
    err_after, fitted, scale = best
    return TracesimFit(cfg_before=cfg, cfg_after=fitted,
                       seconds_per_cycle=scale,
                       err_before=err_before, err_after=err_after,
                       n_records=len(recs))
