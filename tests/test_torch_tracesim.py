"""The port's Vortex trace model (``core.tracesim``), ``refine_lws`` and
calibration fits (``profiler.calibrate``) against the JAX package's.

``simulate``, ``simulate_policy`` (TUNED through ``refine_lws``),
``sweep_configs`` and ``paper_config_grid`` are host arithmetic copied
from the reference: they must agree with it exactly over the paper's 450
configurations and every kernel of ``PAPER_KERNELS``, trace events
included on the paper's Fig. 1 configuration.  ``fit_tracesim`` is
hardware-free and must equal the reference's on the same records.
``fit_roofline`` fits the port's own cost (``GpuParams``: the route's
rate, ``mem_bw``, the launch terms), so it is held to the properties of
``tests/test_profiler.py``: it recovers a model that generated the
records, never ends worse than it began, and refuses too few records.
"""

import dataclasses

import pytest

from repro.core import tracesim as jax_tracesim
from repro.core.autotune import refine_lws as jax_refine_lws
from repro.core.hw import VortexParams as JaxVortexParams
from repro.core.workload import PAPER_KERNELS as JAX_PAPER_KERNELS
from repro.core.workload import vecadd as jax_vecadd
from repro.profiler import Measurement as JaxMeasurement
from repro.profiler import TimingStats as JaxTimingStats
from repro.profiler import fit_tracesim as jax_fit_tracesim

from repro_torch.core import tracesim
from repro_torch.core.autotune import refine_lws
from repro_torch.core.hw import GPU_REGISTRY, VortexParams
from repro_torch.core.mapper import Regime, resolve_lws
from repro_torch.core.workload import MATH_KERNELS, PAPER_KERNELS, vecadd
from repro_torch.profiler import (Measurement, TimingStats, fit_roofline,
                                  fit_tracesim)
from repro_torch.profiler.calibrate import record_seconds

HW = GPU_REGISTRY["cpu"]


def _sim(r):
    """A SimResult as plain data (the regime by its value)."""
    d = dataclasses.asdict(r)
    d["regime"] = r.regime.value
    return d


def test_the_paper_suite_is_the_references():
    assert list(PAPER_KERNELS) == list(JAX_PAPER_KERNELS)
    for name, w in PAPER_KERNELS.items():
        assert dataclasses.asdict(w) == dataclasses.asdict(
            JAX_PAPER_KERNELS[name]), name


def test_the_config_grid_is_the_references():
    mine = tracesim.paper_config_grid()
    theirs = jax_tracesim.paper_config_grid()
    assert len(mine) == len(theirs) == 450
    assert [dataclasses.asdict(c) for c in mine] == \
        [dataclasses.asdict(c) for c in theirs]


@pytest.mark.parametrize("name", list(PAPER_KERNELS))
def test_sweep_equals_the_references(name):
    """naive, fixed and auto at every configuration of the grid."""
    mine = list(tracesim.sweep_configs(PAPER_KERNELS[name]))
    theirs = list(jax_tracesim.sweep_configs(JAX_PAPER_KERNELS[name]))
    assert mine == theirs and len(mine) == 450


@pytest.mark.parametrize("name", list(PAPER_KERNELS))
def test_tuned_policy_and_refine_lws_equal_the_references(name):
    w, jw = PAPER_KERNELS[name], JAX_PAPER_KERNELS[name]
    for cfg, jcfg in zip(tracesim.paper_config_grid(),
                         jax_tracesim.paper_config_grid()):
        assert dataclasses.asdict(refine_lws(w, cfg)) == \
            dataclasses.asdict(jax_refine_lws(jw, jcfg))
        assert _sim(tracesim.simulate_policy(w, cfg, "tuned")) == \
            _sim(jax_tracesim.simulate_policy(jw, jcfg, "tuned"))


@pytest.mark.parametrize("lws", [1, 2, 16, 32, 64, 128])
def test_fig1_trace_events_equal_the_references(lws):
    cfg, jcfg = VortexParams(1, 2, 4), JaxVortexParams(1, 2, 4)
    mine = tracesim.simulate(vecadd(128), cfg, lws, trace=True)
    theirs = jax_tracesim.simulate(jax_vecadd(128), jcfg, lws, trace=True)
    assert _sim(mine) == _sim(theirs)
    assert mine.events and max(e.call for e in mine.events) == mine.calls - 1


def test_unknown_policy_raises():
    with pytest.raises(ValueError):
        tracesim.simulate_policy(vecadd(128), VortexParams(1, 2, 4), "best")


class TestFig1Regimes:
    """The paper's Fig. 1 experiment: vecadd(128) on 1c2w4t."""

    CFG = VortexParams(cores=1, warps=2, threads=4)
    W = vecadd(128)

    def test_call_counts(self):
        assert tracesim.simulate(self.W, self.CFG, 1).calls == 16
        assert tracesim.simulate(self.W, self.CFG, 16).calls == 1

    def test_regimes(self):
        sim = tracesim.simulate
        assert sim(self.W, self.CFG, 1).regime is Regime.OVERSUBSCRIBED
        assert sim(self.W, self.CFG, 16).regime is Regime.EXACT
        assert sim(self.W, self.CFG, 64).regime is Regime.UNDERSUBSCRIBED

    def test_eq1_is_optimal_here(self):
        lws_opt = resolve_lws(self.W.gws, self.CFG.hp)
        c_opt = tracesim.simulate(self.W, self.CFG, lws_opt).cycles
        for lws in (1, 2, 4, 32, 64, 128):
            assert tracesim.simulate(self.W, self.CFG, lws).cycles >= c_opt


def test_math_kernels_are_the_references():
    from repro.core.workload import MATH_KERNELS as JAX_MATH

    assert MATH_KERNELS == JAX_MATH


# --------------------------------------------------------------------------- #
# Calibration
# --------------------------------------------------------------------------- #


def _stats(median):
    return dict(reps=3, warmup=1, median_s=median, iqr_s=median / 10,
                mean_s=median, min_s=median * 0.9, max_s=median * 1.1)


def _records(rows):
    """The same records in both packages' types."""
    mine, theirs = [], []
    for kernel, sig, value, median, desc in rows:
        kw = dict(kernel=kernel, hw_key="hw", sig_key=sig, value=value,
                  desc=desc, created=1.0)
        mine.append(Measurement(stats=TimingStats(**_stats(median)), **kw))
        theirs.append(JaxMeasurement(stats=JaxTimingStats(**_stats(median)),
                                     **kw))
    return mine, theirs


FIT_RECORDS = {
    "vecadd": [("vecadd", f"vecadd|{n}", blk, 1e-4 * (n / blk),
                {"n": n, "dtype": "float32", "dtype_bytes": 4})
               for n in (4096, 16384) for blk in (1024, 2048)],
    "mixed": [("vecadd", "v|4096", 32, 3e-5,
               {"n": 4096, "dtype": "float32", "dtype_bytes": 4}),
              ("saxpy", "s|65536", 256, 7e-5,
               {"n": 65536, "dtype": "bfloat16", "dtype_bytes": 2}),
              ("saxpy", "s|65536", 1, 9e-4,
               {"n": 65536, "dtype": "bfloat16", "dtype_bytes": 2}),
              ("matmul", "m|64", 16, 1e-3, {"m": 64}),        # not 1-D
              ("vecadd", "v|8192", (1, 2), 1e-3,               # a pair
               {"n": 8192, "dtype": "float32", "dtype_bytes": 4})],
}


@pytest.mark.parametrize("rows", list(FIT_RECORDS))
@pytest.mark.parametrize("grid", [None, (0, 100, 1000)])
def test_fit_tracesim_equals_the_references(rows, grid):
    mine, theirs = _records(FIT_RECORDS[rows])
    cfg = dict(cores=16, warps=8, threads=16)
    a = fit_tracesim(mine, VortexParams(**cfg), overhead_grid=grid)
    b = jax_fit_tracesim(theirs, JaxVortexParams(**cfg), overhead_grid=grid)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.err_after <= a.err_before


def test_fit_tracesim_needs_records():
    mine, _ = _records(FIT_RECORDS["vecadd"][:1])
    with pytest.raises(ValueError, match="usable"):
        fit_tracesim(mine, VortexParams(cores=16, warps=8, threads=16))


def _meas(value, median, **kw):
    return Measurement(kernel="vecadd", hw_key="hw", sig_key="vecadd|x",
                       value=value, stats=TimingStats(**_stats(median)),
                       created=1.0, **kw)


def test_fit_roofline_recovers_perturbed_model():
    """Records made exactly by the port's model under other constants:
    the fit lands near them and beats the starting error."""
    true = dataclasses.replace(HW, peak_flops_fp32=HW.peak_flops_fp32 / 50,
                               peak_flops_bf16=HW.peak_flops_bf16 / 50,
                               peak_flops_tf32=HW.peak_flops_tf32 / 50,
                               mem_bw=HW.mem_bw / 20, launch_s=2e-4)
    recs = []
    for i, (f, b, p) in enumerate([(1e9, 1e6, 4), (1e7, 1e8, 16),
                                   (5e8, 5e7, 2), (1e6, 1e5, 64),
                                   (2e9, 2e6, 1), (3e7, 3e8, 8)]):
        m = _meas(128 * (i + 1), 1.0, flops=f, hbm_bytes=b, programs=p)
        recs.append(dataclasses.replace(
            m, stats=TimingStats(**_stats(record_seconds(m, true)))))
    fit = fit_roofline(recs, HW)
    assert fit.err_after <= fit.err_before
    assert fit.err_after < 0.2                     # near-perfect recovery
    assert fit.n_records == 6 and len(fit.table) == 6


def test_fit_roofline_never_regresses():
    recs = []
    for v in (1, 2, 4, 8):
        m = _meas(v, 1.0, flops=1e6 * v, hbm_bytes=1e4 * v, programs=v)
        recs.append(dataclasses.replace(
            m, stats=TimingStats(**_stats(record_seconds(m, HW)))))
    fit = fit_roofline(recs, HW)                   # already a perfect model
    assert fit.err_after <= fit.err_before
    assert fit.err_before == pytest.approx(0.0, abs=1e-9)
    assert fit.hw_after == HW


def test_fit_roofline_needs_records():
    with pytest.raises(ValueError, match="usable records"):
        fit_roofline([_meas(1, 1e-3)], HW)         # no flops/bytes features
