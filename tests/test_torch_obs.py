"""The port's observability (``repro_torch.obs``) against the JAX
package's ``repro.obs`` on the CPU.

The classes of ``tests/test_obs.py`` on the port's tracer (nesting under
an injected clock, the bounded ring, locked counters, the null tracer),
its export (JSONL and Perfetto forms) and its serving integration (spans
carrying the bucket and the executed plan, feedback records a cached
replay lands on, the drift ranking), plus:

  * a trace written by either package loads in the other's
    ``load_trace`` with equal spans, counters, gauges and meta;
  * the port's engine and the JAX engine, fed the same weights and
    requests, emit the same span names, the same attribute keys (the
    port's decode spans add the split widths, ``decode_split`` and
    ``paged_decode_split``) and the same counters and gauges;
  * a traced engine calls the same kernels the same number of times, at
    the same plans, with the same token streams as an untraced one (in
    place of the reference's HLO identity: tracing is host bookkeeping
    between device waits);
  * ``tools/trace_view_torch.py`` renders a port trace with
    ``--require-drift``.

Reduced smollm-135m in float32; the engines share module-scoped runs and
keep their tuning caches in memory.
"""

import dataclasses
import importlib.util
import json
import math
import pathlib
import threading

import numpy as np
import pytest

import jax

from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.obs import Tracer as JaxTracer
from repro.obs import load_trace as jax_load_trace
from repro.obs import write_trace as jax_write_trace
from repro.serve import ServeEngine as JaxServeEngine
from repro.tuner import TuningCache as JaxTuningCache

from repro_torch.configs import get_config
from repro_torch.core.hw import GPU_REGISTRY
from repro_torch.obs import (NULL_TRACER, OBS_SCHEMA_VERSION, NullTracer,
                             Tracer, aggregate, chrome_trace, drift_report,
                             feedback_to_store, get_tracer, load_trace,
                             set_tracer, using_tracer, write_trace)
from repro_torch.obs.feedback import _kernel_desc
from repro_torch.serve import ServeEngine
from repro_torch.serve.buckets import KERNEL_TABLE
from repro_torch.tuner import TuningCache
from repro_torch.weights import params_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: four requests through two slots (one recycles mid-decode), every
#: arrival at 0 so both engines admit in one order
PROMPTS = [list(range(1, 5)), list(range(1, 8)), list(range(1, 6)),
           list(range(1, 4))]
MAX_NEW = [3, 2, 4, 2]
#: whole-prompt prefill and chunks of 4 (a fixed width: the engines'
#: "auto" widths come from their own hardware and may differ)
CHUNKS = {"whole": None, "chunked": 4}


class FakeClock:
    """Deterministic injectable clock: advances by ``step`` per read."""

    def __init__(self, step=1.0):
        self.t = 0.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


# --------------------------------------------------------------------------- #
# Tracer core
# --------------------------------------------------------------------------- #


class TestTracer:
    def test_span_records_duration_from_injected_clock(self):
        tr = Tracer(clock=FakeClock(step=1.0))
        with tr.span("work", bucket=64):
            pass
        (rec,) = tr.spans()
        assert rec.name == "work"
        assert rec.attrs == {"bucket": 64}
        assert rec.dur == 1.0
        assert rec.parent is None
        assert rec.t1 == rec.t0 + rec.dur

    def test_nested_spans_record_parentage(self):
        tr = Tracer(clock=FakeClock())
        with tr.span("outer") as outer:
            with tr.span("inner"):
                pass
            tr.instant("point")
        inner, point, outer_rec = tr.spans()
        assert [r.name for r in tr.spans()] == ["inner", "point", "outer"]
        assert inner.parent == outer.sid
        assert point.parent == outer.sid
        assert point.dur == 0.0
        assert outer_rec.parent is None
        assert len({r.sid for r in tr.spans()}) == 3

    def test_set_attaches_attrs_to_open_span(self):
        tr = Tracer(clock=FakeClock())
        with tr.span("resolve", kernel="vecadd") as sp:
            sp.set(source="cache", probes=0)
        (rec,) = tr.spans()
        assert rec.attrs == {"kernel": "vecadd", "source": "cache",
                             "probes": 0}

    def test_ring_is_bounded_oldest_evicted(self):
        tr = Tracer(clock=FakeClock(), capacity=4)
        for i in range(10):
            tr.instant("ev", i=i)
        assert len(tr) == 4
        assert [r.attrs["i"] for r in tr.spans()] == [6, 7, 8, 9]

    def test_capacity_must_be_positive(self):
        with pytest.raises(ValueError):
            Tracer(capacity=0)

    def test_counters_are_thread_safe(self):
        tr = Tracer()
        n_threads, n_inc = 8, 2000

        def work():
            for _ in range(n_inc):
                tr.count("ticks")

        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert tr.counters() == {"ticks": n_threads * n_inc}

    def test_gauge_keeps_last_value(self):
        tr = Tracer()
        tr.gauge("live", 1)
        tr.gauge("live", 3)
        assert tr.gauges() == {"live": 3}

    def test_clear_keeps_meta(self):
        tr = Tracer(clock=FakeClock(), meta={"arch": "x"})
        tr.instant("a")
        tr.count("c")
        tr.clear()
        assert len(tr) == 0 and tr.counters() == {}
        assert tr.meta == {"arch": "x"}


class TestNullTracerProtocol:
    def test_ambient_default_is_null(self):
        assert get_tracer() is NULL_TRACER
        assert not get_tracer().enabled

    def test_using_tracer_installs_and_restores(self):
        tr = Tracer()
        with using_tracer(tr):
            assert get_tracer() is tr
        assert get_tracer() is NULL_TRACER

    def test_using_tracer_restores_on_exception(self):
        tr = Tracer()
        with pytest.raises(RuntimeError):
            with using_tracer(tr):
                raise RuntimeError("boom")
        assert get_tracer() is NULL_TRACER

    def test_set_tracer_none_resets_to_null(self):
        set_tracer(Tracer())
        try:
            assert get_tracer() is not NULL_TRACER
        finally:
            set_tracer(None)
        assert get_tracer() is NULL_TRACER

    def test_null_tracer_is_inert(self):
        t = NullTracer()
        with t.span("anything", x=1) as sp:
            sp.set(y=2)
        t.instant("e")
        t.count("c", 5)
        t.gauge("g", 1)
        t.meta["k"] = "v"              # writes never stick
        assert t.spans() == [] and t.counters() == {} and t.meta == {}
        assert len(t) == 0


# --------------------------------------------------------------------------- #
# Export round trip, and across the two packages
# --------------------------------------------------------------------------- #


def _sample_tracer(cls=Tracer):
    tr = cls(clock=FakeClock(), meta={"arch": "toy", "layers": 2})
    with tr.span("decode_tick", bucket=64, decode_block=128,
                 paged_decode_block=32, tiles=(32, 128)):
        tr.instant("pool_grow", kv_len=128)
    tr.count("decode_ticks", 3)
    tr.gauge("live_slots", 2)
    return tr


class TestExport:
    def test_jsonl_round_trip(self, tmp_path):
        tr = _sample_tracer()
        path = write_trace(tr, str(tmp_path / "t.jsonl"))
        back = load_trace(path)
        assert back.meta == {"arch": "toy", "layers": 2}
        assert back.counters() == {"decode_ticks": 3}
        assert back.gauges() == {"live_slots": 2}
        a, b = tr.spans(), back.spans()
        assert [r.name for r in b] == [r.name for r in a]
        assert [r.sid for r in b] == [r.sid for r in a]
        assert [r.parent for r in b] == [r.parent for r in a]
        assert b[1].dur == a[1].dur
        assert b[1].attrs["bucket"] == 64
        # JSON has no tuples: tuple attrs come back as lists
        assert b[1].attrs["tiles"] == [32, 128]

    def test_jsonl_header_first_line(self, tmp_path):
        path = write_trace(_sample_tracer(), str(tmp_path / "t.jsonl"))
        header = json.loads(open(path).readline())
        assert header["kind"] == "repro-obs-trace"
        assert header["version"] == OBS_SCHEMA_VERSION == 1
        assert header["meta"]["arch"] == "toy"

    def test_version_skew_rejected(self, tmp_path):
        path = write_trace(_sample_tracer(), str(tmp_path / "t.jsonl"))
        lines = open(path).read().splitlines()
        header = json.loads(lines[0])
        header["version"] = OBS_SCHEMA_VERSION + 1
        lines[0] = json.dumps(header)
        (tmp_path / "skew.jsonl").write_text("\n".join(lines))
        with pytest.raises(ValueError, match="version"):
            load_trace(str(tmp_path / "skew.jsonl"))

    def test_wrong_kind_rejected(self, tmp_path):
        p = tmp_path / "other.jsonl"
        p.write_text('{"version": 1, "kind": "something-else"}\n')
        with pytest.raises(ValueError, match="not a"):
            load_trace(str(p))

    def test_torn_lines_skipped_not_fatal(self, tmp_path):
        path = write_trace(_sample_tracer(), str(tmp_path / "t.jsonl"))
        with open(path, "a") as f:
            f.write('{"type": "span", "name": "torn", "t0": ')  # torn write
        back = load_trace(path)
        assert [r.name for r in back.spans()] == ["pool_grow", "decode_tick"]

    def test_chrome_trace_shape(self):
        doc = chrome_trace(_sample_tracer())
        by_ph = {}
        for ev in doc["traceEvents"]:
            by_ph.setdefault(ev["ph"], []).append(ev)
        (span,) = by_ph["X"]
        assert span["name"] == "decode_tick"
        assert span["dur"] == pytest.approx(2e6)     # two 1 s clock steps
        assert span["args"]["bucket"] == 64
        (inst,) = by_ph["i"]
        assert inst["name"] == "pool_grow"
        assert {ev["name"] for ev in by_ph["C"]} == \
            {"decode_ticks", "live_slots"}
        assert doc["otherData"] == {"arch": "toy", "layers": 2}

    def test_chrome_json_round_trip(self, tmp_path):
        tr = _sample_tracer()
        path = write_trace(tr, str(tmp_path / "t.json"))
        back = load_trace(path)
        assert back.meta == {"arch": "toy", "layers": 2}
        names = [r.name for r in back.spans()]
        assert "decode_tick" in names and "pool_grow" in names
        dt = next(r for r in back.spans() if r.name == "decode_tick")
        assert dt.attrs["decode_block"] == 128
        assert dt.dur == pytest.approx(2.0)

    def test_empty_file_rejected(self, tmp_path):
        p = tmp_path / "empty.jsonl"
        p.write_text("")
        with pytest.raises(ValueError, match="empty"):
            load_trace(str(p))


def _content(tracer):
    """What a trace holds, comparable across the two packages."""
    return ([(s.name, s.t0, s.dur, s.attrs, s.sid, s.parent, s.tid)
             for s in tracer.spans()],
            tracer.counters(), tracer.gauges(), tracer.meta)


@pytest.mark.parametrize("suffix", [".jsonl", ".json"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_traces_cross_between_the_packages(writer, suffix, tmp_path):
    """A trace written by one package loads in the other's ``load_trace``
    with equal spans, counters, gauges and meta (each package's own
    reading of the file is the reference)."""
    write, reread, other = ((write_trace, load_trace, jax_load_trace)
                            if writer == "port" else
                            (jax_write_trace, jax_load_trace, load_trace))
    tr = _sample_tracer(Tracer if writer == "port" else JaxTracer)
    path = write(tr, str(tmp_path / f"t{suffix}"))
    assert _content(other(path)) == _content(reread(path))
    assert len(other(path).spans()) == 2


# --------------------------------------------------------------------------- #
# Serving integration
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_get_config("smollm-135m").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                               dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams))


class KernelSpy:
    """Every attention kernel call the port's model makes, with its plan
    (on the CPU the wrappers run their plain versions, so the calls stand
    in for launches)."""

    NAMES = ("flash_attention", "decode_attention", "paged_decode_attention")
    PLAN_KEYS = ("block_q", "block_k", "block_s", "split", "page_block")

    def __init__(self, mp):
        import repro_torch.models.attention as attn

        self.calls = []
        for name in self.NAMES:
            fn = getattr(attn, name)

            def spy(*a, _fn=fn, _name=name, **kw):
                self.calls.append((_name, tuple(
                    (k, kw[k]) for k in self.PLAN_KEYS if k in kw)))
                return _fn(*a, **kw)

            mp.setattr(attn, name, spy)


def _port_run(weights, chunk, tracer=None, **kw):
    *_, tcfg, tparams = weights
    eng = ServeEngine(tcfg, slots=2, max_len=64, params=tparams,
                      device="cpu", tuning_cache=TuningCache(path=None),
                      prefill_chunk=chunk, tracer=tracer, **kw)
    with pytest.MonkeyPatch.context() as mp:
        spy = KernelSpy(mp)
        reqs = [eng.submit(p, max_new_tokens=m)
                for p, m in zip(PROMPTS, MAX_NEW)]
        rep = eng.run()
    return eng, [rep.outputs[r.rid] for r in reqs], rep, spy.calls


@pytest.fixture(scope="module", params=list(CHUNKS))
def runs(request, weights):
    """For each prefill mode: the port's engine traced and untraced and
    the JAX engine traced, on the same weights and requests."""
    chunk = CHUNKS[request.param]
    jcfg, jparams, *_ = weights
    traced = _port_run(weights, chunk, tracer=Tracer())
    plain = _port_run(weights, chunk)
    jtracer = JaxTracer()
    jeng = JaxServeEngine(jcfg, slots=2, max_len=64, params=jparams,
                          tuning_cache=JaxTuningCache(path=None),
                          prefill_chunk=chunk, tracer=jtracer)
    jreqs = [jeng.submit(p, max_new_tokens=m)
             for p, m in zip(PROMPTS, MAX_NEW)]
    jrep = jeng.run()
    return dict(mode=request.param, traced=traced, plain=plain,
                jax=(jtracer, [jrep.outputs[r.rid] for r in jreqs]))


class TestServingSpans:
    def test_every_decode_tick_carries_bucket_and_executed_plan(self, runs):
        eng, _, rep, _ = runs["traced"]
        ticks = [s for s in eng.obs.spans() if s.name == "decode_tick"]
        assert ticks, "run produced no decode ticks"
        for s in ticks:
            a = s.attrs
            assert a["bucket"] == eng.pool.kv_len
            # the fused paged sweep is the default: its pair rides along
            assert (a["paged_decode_block"], a["paged_decode_split"]) == (
                rep.paged_decode_blocks[a["bucket"]],
                rep.paged_decode_splits[a["bucket"]])
            assert a["decode_block"] and a["decode_split"]
            assert 0 < a["live"] <= a["slots"]

    def test_every_prefill_carries_bucket_and_tiles(self, runs):
        eng, *_ = runs["traced"]
        name = "prefill" if runs["mode"] == "whole" else "prefill_chunk"
        pres = [s for s in eng.obs.spans() if s.name == name]
        if runs["mode"] == "whole":
            assert len(pres) == len(PROMPTS)       # one per admission
        else:
            assert len(pres) == sum(-(-len(p) // 4) for p in PROMPTS)
        for s in pres:
            assert s.attrs["bucket"] >= s.attrs.get("prompt_len", 0)
            bq, bkv = s.attrs["tiles"]
            assert bq >= 1 and bkv >= 1

    def test_resolution_spans_nest_and_attribute(self, runs):
        eng, *_ = runs["traced"]
        spans = eng.obs.spans()
        names = {s.name for s in spans}
        assert {"bucket_resolve", "resolve_plan", "slot_recycle"} <= names
        cold = [s for s in spans if s.name == "bucket_resolve"
                and s.attrs.get("provenance") == "cold"]
        assert cold, "no cold bucket resolution recorded"
        nested = [s for s in spans if s.name == "resolve_plan"
                  and s.parent in {c.sid for c in cold}]
        assert {s.attrs["kernel"] for s in nested} == {
            "decode_attention", "flash_attention", "paged_decode"}
        for s in nested:
            assert s.attrs["source"] in ("cache", "refined")
            assert s.attrs["measured"] == 0

    def test_counters_and_meta(self, runs):
        eng, *_ = runs["traced"]
        c = eng.obs.counters()
        assert c["admits"] == len(PROMPTS)
        assert c["decode_ticks"] >= 1
        assert c["tokens_decoded"] >= c["decode_ticks"]
        m = eng.obs.meta
        assert m["layers"] == eng.cfg.num_layers
        assert m["head_dim"] == eng.cfg.head_dim
        assert m["hw"] == eng.router.hw.name
        assert m["paged"] and m["fused_decode"]

    def test_aggregate_groups_by_bucket_and_kernel(self, runs):
        eng, *_ = runs["traced"]
        rows = aggregate(eng.obs.spans())
        phases = {(r.phase, r.kernel) for r in rows}
        assert ("decode", "paged_decode") in phases
        if runs["mode"] == "whole":
            assert ("prefill", "flash_attention") in phases
        for r in rows:
            assert r.n == len(r.samples)
            assert r.total_s == pytest.approx(sum(r.samples))
            assert r.median_s <= r.total_s

    def test_same_spans_attributes_and_counters_as_the_jax_engine(self,
                                                                  runs):
        eng, streams, _, _ = runs["traced"]
        jtracer, jstreams = runs["jax"]
        assert streams == jstreams
        extra = {"decode_tick": {"decode_split", "paged_decode_split"},
                 "bucket_resolve": {"decode_split", "paged_decode_split"}}

        def keys(tracer):
            out = {}
            for s in tracer.spans():
                out.setdefault(s.name, set()).update(s.attrs)
            return out

        mine, theirs = keys(eng.obs), keys(jtracer)
        assert set(mine) == set(theirs)
        for name, ks in mine.items():
            assert ks - extra.get(name, set()) == theirs[name], name
        assert eng.obs.counters() == jtracer.counters()
        assert eng.obs.gauges() == jtracer.gauges()

    def test_tracing_changes_no_launch_plan_or_stream(self, runs):
        """In place of the reference's HLO identity: the traced engine
        calls the same kernels, the same number of times, at the same
        plans, and serves the same streams as the untraced one."""
        import repro_torch.kernels.flash_attention as fa
        import repro_torch.kernels.paged_decode_attention as pda

        t_eng, t_streams, t_rep, t_calls = runs["traced"]
        p_eng, p_streams, p_rep, p_calls = runs["plain"]
        assert t_eng.obs.enabled and not p_eng.obs.enabled
        assert t_streams == p_streams
        assert t_calls == p_calls and t_calls
        assert t_rep.paged_decode_blocks == p_rep.paged_decode_blocks
        assert t_rep.paged_decode_splits == p_rep.paged_decode_splits
        assert t_rep.prefill_tiles == p_rep.prefill_tiles
        # no launch on the CPU either way: the plain versions ran
        assert pda.paged_decode_attention.launches == 0
        assert fa.flash_attention.launches == 0


class TestFeedbackLoop:
    def test_rebuilt_desc_is_the_routers(self, runs):
        """The feedback's description of each observation is the one the
        router resolved, so the records' signatures are the router's."""
        eng, *_ = runs["traced"]
        rows = aggregate(eng.obs.spans())
        assert rows
        for ob in rows:
            if ob.kernel is None:
                continue
            row = next(r for r in KERNEL_TABLE if r.kernel == ob.kernel)
            want = eng.router.row_desc(row, eng.router.bucket(ob.bucket))
            assert _kernel_desc(ob, eng.obs.meta) == want

    def test_feedback_lands_replayable_measured_records(self, runs,
                                                        tmp_path):
        from repro_torch.profiler import TraceStore, hybrid_refine

        eng, *_ = runs["traced"]
        store = TraceStore(str(tmp_path / "serving.jsonl"), autosave=False)
        n = feedback_to_store(eng.obs.spans(), eng.obs.meta, eng.router.hw,
                              store)
        assert n > 0
        store.save()
        for m in store.records():
            assert m.source == "serving" and m.backend == ""
            assert m.median_s > 0

        rows = [r for r in aggregate(eng.obs.spans()) if r.phase == "decode"]
        ob = max(rows, key=lambda r: r.n)
        replay = TraceStore(str(tmp_path / "serving.jsonl"))
        res = hybrid_refine(ob.kernel, _kernel_desc(ob, eng.obs.meta),
                            eng.router.hw, store=replay, mode="cached")
        # the engine executed the roofline's winner, so the serving record
        # is among the survivors: the replay lands on measurement
        assert res.source == "measured"
        assert res.value == ob.value

    def test_drift_report_ranks_buckets(self, runs):
        eng, *_ = runs["traced"]
        rep = drift_report(eng.obs.spans(), eng.obs.meta, eng.router.hw)
        assert rep.rows, "no drift rows from a traced run"
        assert rep.median_ratio > 0
        mags = [abs(math.log(r.drift)) for r in rep.rows]
        assert mags == sorted(mags, reverse=True), "rows not ranked"
        for r in rep.rows:
            assert r.ratio == pytest.approx(r.measured_s / r.predicted_s)
            assert isinstance(r.value, tuple) or r.kernel == "flash_attention"
        assert all(abs(math.log(c.drift)) > math.log(10.0)
                   for c in rep.candidates(threshold=10.0))
        assert "drift" in rep.format()

    def test_drift_empty_without_meta(self, runs):
        eng, *_ = runs["traced"]
        assert drift_report(eng.obs.spans(), {}, eng.router.hw).rows == ()


# --------------------------------------------------------------------------- #
# trace_view_torch CLI
# --------------------------------------------------------------------------- #


@pytest.fixture()
def trace_view():
    path = ROOT / "tools" / "trace_view_torch.py"
    spec = importlib.util.spec_from_file_location("trace_view_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("suffix", [".json", ".jsonl"])
def test_trace_view_renders_a_port_trace(trace_view, runs, suffix, tmp_path,
                                         capsys):
    eng, *_ = runs["traced"]
    path = write_trace(eng.obs, str(tmp_path / f"serve{suffix}"))
    rc = trace_view.main([path, "--hw", "cpu", "--require-buckets",
                          "--require-drift"])
    out = capsys.readouterr().out
    assert rc == 0
    assert f"decode,{eng.pool.kv_len},paged_decode,(" in out
    assert "drift vs roofline" in out and "decode_tick," in out


def test_trace_view_prints_the_radix_section_of_a_cli_trace(
        trace_view, tmp_path, capsys):
    """The serving CLI's trace with the radix on: the radix section lists
    each hit, and ``--require-prefix-hits`` passes on it and fails on a
    trace without hits."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.profiler import TraceStore, set_default_store
    from repro_torch.tuner import set_default_cache

    path = str(tmp_path / "radix.jsonl")
    # the CLI's TUNED plans from a memory-only cache and trace store
    set_default_cache(TuningCache(path=None))
    set_default_store(TraceStore(path=None))
    try:
        out = serve_main(["--device", "cpu", "--prefix-cache",
                          "--shared-prefix", "24", "--mode", "closed",
                          "--requests", "6", "--slots", "2",
                          "--max-len", "96", "--max-new", "4",
                          "--trace", path])
    finally:
        set_default_cache(None)
        set_default_store(None)
    capsys.readouterr()
    rc = trace_view.main([path, "--hw", "cpu", "--require-prefix-hits"])
    text = capsys.readouterr().out
    assert rc == 0
    rx = out["radix"]
    assert (f"# radix: {rx['hits']}/{rx['lookups']} lookups hit, "
            f"{rx['hit_tokens']} prompt tokens served from shared blocks"
            in text)
    assert "rid,tokens,shared_blocks,tail" in text
    bare = Tracer(clock=FakeClock())
    with bare.span("unrelated"):
        pass
    bare_path = write_trace(bare, str(tmp_path / "bare.jsonl"))
    assert trace_view.main([bare_path, "--require-prefix-hits"]) == 1
    capsys.readouterr()


def test_trace_view_require_flags_fail_on_a_bare_trace(trace_view, tmp_path,
                                                       capsys):
    bare = Tracer(clock=FakeClock())
    with bare.span("unrelated"):
        pass
    path = write_trace(bare, str(tmp_path / "bare.jsonl"))
    assert trace_view.main([path]) == 0
    assert trace_view.main([path, "--require-buckets"]) == 1
    assert trace_view.main([path, "--require-drift"]) == 1
    assert trace_view.main([path, "--require-swaps"]) == 1
    capsys.readouterr()


def test_trace_view_takes_registry_parts_and_detect(trace_view):
    import torch

    from repro_torch.core.hw import detect

    assert trace_view._hw("h100_sxm") is GPU_REGISTRY["h100_sxm"]
    assert trace_view._hw("detect") == detect(
        "cuda" if torch.cuda.is_available() else "cpu")
