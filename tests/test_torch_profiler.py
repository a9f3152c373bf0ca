"""The port's profiler (``repro_torch.profiler``) on the CPU: timing
statistics, the trace store's rules (the JAX package's: round trip,
dedupe, version, torn lines, concurrent writers, one file format),
``measure_value`` on the plain versions, measured refinement
(``MeasuredCost``, ``hybrid_refine``: the roofline prunes, the recorded
times pick), the dispatch's ``measure=`` modes (a warm hit never
measures) and no silent fallback: a candidate that fails raises.

Every test uses a memory-only cache and store, or files under
``tmp_path``.
"""

import dataclasses
import json
import threading

import pytest
import torch

from repro.profiler import TraceStore as JaxTraceStore

from repro_torch.core.hw import GPU_REGISTRY
from repro_torch.kernels import ops
from repro_torch.profiler import (TRACE_SCHEMA_VERSION, Measurement,
                                  MeasuredCost, TimingStats, TraceStore,
                                  canon_value, hybrid_refine, measure_value,
                                  set_default_store, supported_kernels,
                                  time_callable, value_key)
from repro_torch.tuner import (KERNEL_REGISTRY, TuningCache, hardware_key,
                               register_kernel, resolve_plan,
                               set_default_cache, tuned_call)

CPU = GPU_REGISTRY["cpu"]
HWK = hardware_key(CPU)
VEC = {"n": 100_000, "dtype": "float32", "dtype_bytes": 4}
VEC_SIG = KERNEL_REGISTRY["vecadd"].sig(VEC, "tuned").key
#: fast settings for measurements on the CPU
FAST = {"device": "cpu", "warmup": 0, "reps": 1}


@pytest.fixture(autouse=True)
def _memory_defaults():
    set_default_cache(TuningCache(path=None))
    set_default_store(TraceStore(path=None))
    yield
    set_default_cache(None)
    set_default_store(None)


def _stats(median=1e-3) -> TimingStats:
    return TimingStats(reps=3, warmup=1, median_s=median, iqr_s=median / 10,
                       mean_s=median, min_s=median * 0.9,
                       max_s=median * 1.1)


def _meas(value, median, created=1.0, sig_key=VEC_SIG, backend="",
          **kw) -> Measurement:
    return Measurement(kernel="vecadd", hw_key=HWK, sig_key=sig_key,
                       value=canon_value(value), stats=_stats(median),
                       created=created, backend=backend, **kw)


# --------------------------------------------------------------------------- #
# Timing and records
# --------------------------------------------------------------------------- #


def test_timing_stats_median_iqr_and_roundtrip():
    s = TimingStats.from_samples([1.0, 2.0, 3.0, 4.0, 100.0], warmup=1)
    assert s.median_s == 3.0 and s.min_s == 1.0 and s.max_s == 100.0
    assert s.reps == 5 and s.iqr_s > 0
    assert TimingStats.from_dict(json.loads(json.dumps(s.as_dict()))) == s


def test_time_callable_counts_reps_on_the_cpu():
    calls = []
    s = time_callable(lambda: calls.append(1), warmup=2, reps=4,
                      device="cpu")
    assert len(calls) == 6 and s.reps == 4 and s.warmup == 2


def test_canon_value_and_key():
    assert canon_value([16, 48]) == (16, 48) and canon_value(7.0) == 7
    assert value_key((16, 48)) == "16x48" and value_key(5) == "5"


@pytest.mark.parametrize("kernel", ["vecadd", "paged_decode"])
def test_measure_value_record_round_trips_through_the_store(kernel,
                                                            tmp_path):
    desc = VEC if kernel == "vecadd" else {
        "s": 64, "d": 32, "rows": 4, "heads_per_group": 2,
        "dtype": "int8", "dtype_bytes": 1, "page_block": 16,
        "max_blocks_per_row": 8}
    spec = KERNEL_REGISTRY[kernel]
    value = spec.plan_value(spec.seed_plan(desc, CPU, "tuned"))
    m = measure_value(kernel, desc, value, CPU, **FAST)
    assert m.backend == "cpu" and m.median_s > 0 and m.programs >= 1
    assert m.xla_flops is None and m.xla_bytes is None and not m.interpret
    assert Measurement.from_record(json.loads(json.dumps(m.to_record()))) \
        == m
    path = str(tmp_path / "traces.jsonl")
    TraceStore(path).add(m)
    back = TraceStore(path).get(HWK, spec.sig(desc, "tuned").key, value)
    assert back == m


def test_every_registered_kernel_has_a_synthesiser():
    assert supported_kernels() == sorted(KERNEL_REGISTRY)


def test_measure_value_rejects_unknown_kernels():
    with pytest.raises(KeyError):
        measure_value("nope", VEC, 1, CPU, **FAST)
    spec = KERNEL_REGISTRY["vecadd"]
    register_kernel(dataclasses.replace(spec, name="_nosynth"))
    try:
        with pytest.raises(ValueError, match="no input synthesiser"):
            measure_value("_nosynth", VEC, 1, CPU, **FAST)
    finally:
        del KERNEL_REGISTRY["_nosynth"]


# --------------------------------------------------------------------------- #
# Trace store
# --------------------------------------------------------------------------- #


def test_store_dedupe_newest_wins():
    st = TraceStore(path=None)
    assert st.add(_meas(4, 1e-3, created=2.0))
    assert not st.add(_meas(4, 9e-3, created=1.0))     # older: dropped
    assert st.add(_meas(4, 5e-3, created=3.0))
    assert st.get(HWK, VEC_SIG, 4).median_s == 5e-3
    assert st.stats.dropped_stale == 1


def test_store_version_mismatch_and_torn_lines(tmp_path):
    path = str(tmp_path / "traces.jsonl")
    TraceStore(path).add(_meas(4, 1e-3))
    with open(path, "a") as f:
        f.write('{"torn": \n')
    assert len(TraceStore(path)) == 1
    lines = open(path).read().splitlines()
    head = json.loads(lines[0])
    head["version"] = TRACE_SCHEMA_VERSION + 1
    open(path, "w").write("\n".join([json.dumps(head)] + lines[1:]) + "\n")
    assert len(TraceStore(path)) == 0


def test_store_file_reads_in_both_packages(tmp_path):
    path = str(tmp_path / "traces.jsonl")
    TraceStore(path).add(_meas((16, 48), 2e-5))
    assert JaxTraceStore(path).get(HWK, VEC_SIG, (16, 48)).median_s == 2e-5


def test_store_concurrent_writers_merge(tmp_path):
    path = str(tmp_path / "traces.jsonl")

    def writer(i):
        TraceStore(path).add(_meas(100 + i, 1e-3))

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    merged = TraceStore(path)
    assert len(merged.lookup(HWK, VEC_SIG)) == 8


# --------------------------------------------------------------------------- #
# Measured refinement
# --------------------------------------------------------------------------- #


def _roofline_ranked(desc=VEC):
    spec = KERNEL_REGISTRY["vecadd"]
    seed = spec.plan_value(spec.seed_plan(desc, CPU, "tuned"))
    cost = spec.cost_model(desc, CPU)
    cands = spec.candidates(desc, CPU, seed)
    return sorted({c: cost(c) for c in [seed, *cands]}.items(),
                  key=lambda vc: vc[1])


def test_hybrid_picks_the_measured_best_of_the_rooflines_top_k():
    ranked = _roofline_ranked()
    top = [v for v, _ in ranked[:4]]
    outside = ranked[-1][0]
    st = TraceStore(path=None)
    for i, v in enumerate(top):          # the roofline's 3rd is fastest
        st.add(_meas(v, 1e-3 if i != 2 else 1e-4))
    st.add(_meas(outside, 1e-6))         # pruned: never consulted
    res = hybrid_refine("vecadd", VEC, CPU, store=st, mode="cached",
                        measure_opts={"device": "cpu"})
    assert res.source == "measured" and res.value == top[2]
    assert res.live_measurements == 0 and set(res.top_k) == set(top)
    assert res.measured_cost == pytest.approx(1e-4)


def test_hybrid_with_an_empty_store_returns_the_rooflines_pick():
    res = hybrid_refine("vecadd", VEC, CPU, store=TraceStore(path=None),
                        mode="cached", measure_opts={"device": "cpu"})
    plan, _ = resolve_plan("vecadd", CPU, "tuned", VEC,
                           TuningCache(path=None))
    assert res.source == "roofline" and res.live_measurements == 0
    assert res.value == KERNEL_REGISTRY["vecadd"].plan_value(plan)


def test_measured_cost_counts_only_records_of_its_device_type():
    st = TraceStore(path=None)
    st.add(_meas(4, 1e-3, backend="cuda"))
    st.add(_meas(8, 2e-3, backend="cpu"))
    st.add(_meas(16, 3e-3))                       # no backend: counts
    mc = MeasuredCost("vecadd", VEC, CPU, store=st, mode="cached",
                      measure_opts={"device": "cpu"})
    assert mc(4) == float("inf") and mc(8) == 2e-3 and mc(16) == 3e-3
    assert mc.mode_mismatched == 1 and mc.served_cached == 2


def test_live_mode_records_what_it_measures():
    st = TraceStore(path=None)
    mc = MeasuredCost("vecadd", VEC, CPU, store=st, mode="live",
                      measure_opts=FAST)
    t = mc(64)
    assert t > 0 and mc.measured_live == 1 and len(st) == 1
    assert mc(64) == t and mc.served_cached == 1 and len(st) == 1


def test_a_live_candidate_that_fails_raises():
    """No silent fallback: the failure is neither scored infinity nor run
    as the plain version."""
    spec = KERNEL_REGISTRY["vecadd"]

    def broken(plan, hw, *args, **kw):
        raise RuntimeError("launch failed")

    register_kernel(dataclasses.replace(spec, name="_broken", run=broken))
    from repro_torch.profiler.measure import SYNTH_REGISTRY
    SYNTH_REGISTRY["_broken"] = SYNTH_REGISTRY["vecadd"]
    try:
        with pytest.raises(RuntimeError, match="launch failed"):
            resolve_plan("_broken", CPU, "tuned", VEC,
                         TuningCache(path=None), measure="live",
                         store=TraceStore(path=None), measure_opts=FAST)
    finally:
        del KERNEL_REGISTRY["_broken"], SYNTH_REGISTRY["_broken"]


# --------------------------------------------------------------------------- #
# Dispatch modes
# --------------------------------------------------------------------------- #


def test_resolve_plan_rejects_a_bad_measure_mode():
    with pytest.raises(ValueError, match="measure"):
        resolve_plan("vecadd", CPU, "tuned", VEC, TuningCache(path=None),
                     measure="sometimes")


def test_live_then_a_warm_hit_measures_nothing():
    cache, st = TuningCache(path=None), TraceStore(path=None)
    x = torch.arange(5000, dtype=torch.float32)
    out = tuned_call("vecadd", x, x, hw=CPU, cache=cache, measure="live",
                     store=st, measure_opts={"warmup": 0, "reps": 1})
    assert torch.equal(out, 2 * x)
    recorded, lookups = st.stats.recorded, st.stats.lookups
    assert recorded > 0
    desc = KERNEL_REGISTRY["vecadd"].describe(x, x)
    _, info = resolve_plan("vecadd", CPU, "tuned", desc, cache,
                           measure="live", store=st)
    assert info.source == "cache" and info.probes == 0 and info.measured == 0
    assert (st.stats.recorded, st.stats.lookups) == (recorded, lookups)


def test_cached_mode_replays_the_store_with_no_measurement():
    st = TraceStore(path=None)
    ranked = _roofline_ranked()
    best = ranked[1][0]
    for v, _ in ranked[:4]:
        st.add(_meas(v, 1e-4 if v == best else 1e-3, backend="cpu"))
    plan, info = resolve_plan("vecadd", CPU, "tuned", VEC,
                              TuningCache(path=None), measure="cached",
                              store=st, measure_opts={"device": "cpu"})
    assert info.source == "measured" and info.measured == 0
    assert plan.lws == best and info.cost == pytest.approx(1e-4)


def test_ops_measuring_routes_the_default_store():
    st = TraceStore(path=None)
    set_default_store(st)
    x = torch.arange(3000, dtype=torch.float32)
    with ops.policy("tuned"), ops.measuring("live"):
        assert torch.equal(ops.vecadd(x, x), 2 * x)
    assert st.stats.recorded > 0
    assert all(m.backend == "cpu" for m in st.records())
