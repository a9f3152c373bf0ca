"""The port's live retune (``repro_torch.serve.retune``) on the CPU,
against the JAX package's ``repro.serve.retune``.

The classes of ``tests/test_retune.py`` on the port, where a decode plan
is the pair (block_s, split W): the router's swap (one kernel's pair of
one bucket, legalised, visible to the next resolve), the A/B guard
(adopts a faster candidate, never a slower one, never swaps without the
incumbent's evidence, reverts a trial whose bucket went cold, cools a
bucket down, discards warm-up ticks, persists an adoption), the drift
scan's edge cases, and the engine (streams exact with the controller on,
a trial on real ticks).  Beside them:

  * the port's and the JAX controller, fed one script of
    ``observe_tick`` seconds, reach the same decisions at the same ticks;
  * ``retune="inline"`` serves the streams of the port without it and of
    the JAX engine with it, calling the same kernels at the same plans;
  * an adopted pair is written under the tuner's ``cache_hw_key`` and a
    fresh router on the same ``TuningCache`` resolves to it;
  * the background worker replays the store and issues no CUDA op;
  * a drift scan over serving spans counter-proposes the roofline's best
    non-incumbent pair.

Reduced smollm-135m; the engine runs are float32 and module-scoped, each
engine's tuning cache in memory.
"""

import dataclasses
import math
import time

import numpy as np
import pytest

import jax

from repro.configs.base import get_config as jax_get_config
from repro.core.hw import TPU_REGISTRY
from repro.models import build_model as jax_build_model
from repro.obs import Tracer as JaxTracer
from repro.serve import BucketRouter as JaxBucketRouter
from repro.serve import BucketSpec as JaxBucketSpec
from repro.serve import RetuneConfig as JaxRetuneConfig
from repro.serve import RetuneController as JaxRetuneController
from repro.serve import ServeEngine as JaxServeEngine
from repro.tuner import TuningCache as JaxTuningCache

from repro_torch.configs import get_config
from repro_torch.core.hw import GPU_REGISTRY
from repro_torch.obs import Tracer, drift_report
from repro_torch.obs.drift import DriftRecord, DriftReport
from repro_torch.serve import BucketRouter, BucketSpec, ServeEngine
from repro_torch.serve.retune import RetuneConfig, RetuneController
from repro_torch.tuner import TuningCache
from repro_torch.tuner.dispatch import cache_hw_key
from repro_torch.weights import params_from_jax

HW = GPU_REGISTRY["cpu"]
KERNELS = ("decode_attention", "paged_decode")


def _router(cache=None, tracer=None):
    cfg = get_config("smollm-135m").reduced()
    return BucketRouter(cfg, BucketSpec(max_len=256), slots=2, hw=HW,
                        cache=cache if cache is not None
                        else TuningCache(path=None),
                        device="cpu", tracer=tracer)


@pytest.fixture()
def router():
    return _router()


def _controller(router, **kw):
    kw.setdefault("mode", "inline")
    kw.setdefault("min_samples", 4)
    kw.setdefault("trial_ticks", 3)
    kw.setdefault("warmup_ticks", 1)
    kw.setdefault("cooldown_ticks", 8)
    kw.setdefault("interval_ticks", 10_000)   # drift scan out of the way
    return RetuneController(router, config=RetuneConfig(**kw),
                            tracer=Tracer(), cache=TuningCache(path=None))


def _incumbent(router, kv=128, kernel="decode_attention"):
    plan = router.resolve(router.bucket(kv))
    return tuple(getattr(plan, f) for f in router.SWAP_FIELDS[kernel])


def _candidate(router, kv=128, kernel="decode_attention"):
    """A legal pair other than the incumbent, with its block_s: only the
    split changes, which the plain versions do not read."""
    bs, w = _incumbent(router, kv, kernel)
    return (bs, bs) if w != bs else (bs, 2 * bs)


def _bank(ctl, kv, kernel, value, dur, n=6):
    for _ in range(n):
        ctl.observe_tick(kv, kernel, value, dur)


# --------------------------------------------------------------------------- #
# Router swap
# --------------------------------------------------------------------------- #


class TestSwapPlan:
    @pytest.mark.parametrize("kernel", KERNELS)
    def test_swap_replaces_one_kernels_pair_visibly(self, router, kernel):
        b = router.bucket(128)
        before = router.resolve(b)
        cand = _candidate(router, kernel=kernel)
        new = router.swap_plan(b, kernel, cand)
        assert _incumbent(router, kernel=kernel) == cand
        other = next(k for k in KERNELS if k != kernel)
        fields = router.SWAP_FIELDS[other]
        assert [getattr(new, f) for f in fields] == \
            [getattr(before, f) for f in fields]
        assert new.prefill_blocks == before.prefill_blocks
        assert new.sig.key == before.sig.key
        assert router.stats.swaps == 1

    def test_swap_is_per_bucket(self, router):
        b1, b2 = router.bucket(64), router.bucket(128)
        assert b1.kv_len != b2.kv_len
        before2 = _incumbent(router, 128)
        router.swap_plan(b1, "decode_attention", _candidate(router, 64))
        assert _incumbent(router, 128) == before2

    def test_prefill_tiles_do_not_swap(self, router):
        with pytest.raises(ValueError):
            router.swap_plan(router.bucket(128), "flash_attention", (8, 8))

    def test_swap_emits_obs_instant(self):
        tr = Tracer()
        r = _router(tracer=tr)
        cand = _candidate(r)
        r.swap_plan(r.bucket(128), "decode_attention", cand)
        swaps = [s for s in tr.spans() if s.name == "plan_swap"]
        assert len(swaps) == 1
        assert swaps[0].attrs["kernel"] == "decode_attention"
        assert swaps[0].attrs["value"] == cand
        assert tr.counters()["plan_swaps"] == 1


# --------------------------------------------------------------------------- #
# The A/B guard
# --------------------------------------------------------------------------- #


class TestABGuard:
    def test_adopts_strictly_faster_candidate(self, router):
        ctl = _controller(router)
        inc, cand = _incumbent(router), _candidate(router)
        _bank(ctl, 128, "decode_attention", inc, 1e-3)
        ctl.propose(128, "decode_attention", cand)
        assert ctl.poll()                       # trial starts: plan swapped
        assert _incumbent(router) == cand       # candidate is live
        _bank(ctl, 128, "decode_attention", cand, 1e-4)   # 10x faster
        assert not ctl.poll()                   # adopt keeps the live plan
        assert _incumbent(router) == cand
        assert ctl.stats.adopted == 1 and ctl.stats.rejected == 0
        (d,) = ctl.decisions
        assert d.adopted and d.reason == "adopted"
        assert d.candidate_s < d.incumbent_s

    def test_never_adopts_slower_candidate(self, router):
        ctl = _controller(router)
        inc, cand = _incumbent(router), _candidate(router)
        _bank(ctl, 128, "decode_attention", inc, 1e-4)
        ctl.propose(128, "decode_attention", cand)
        assert ctl.poll()
        _bank(ctl, 128, "decode_attention", cand, 1e-3)   # 10x slower
        assert ctl.poll()                       # revert swaps incumbent back
        assert _incumbent(router) == inc
        assert ctl.stats.rejected == 1 and ctl.stats.adopted == 0
        (d,) = ctl.decisions
        assert not d.adopted and d.reason == "slower"

    def test_hysteresis_keeps_incumbent_on_marginal_wins(self, router):
        ctl = _controller(router, hysteresis=0.98)
        inc, cand = _incumbent(router), _candidate(router)
        _bank(ctl, 128, "decode_attention", inc, 1.00e-3)
        ctl.propose(128, "decode_attention", cand)
        assert ctl.poll()
        _bank(ctl, 128, "decode_attention", cand, 0.99e-3)
        ctl.poll()
        assert _incumbent(router) == inc
        assert ctl.stats.rejected == 1

    def test_never_swaps_without_incumbent_evidence(self, router):
        ctl = _controller(router)                 # min_samples=4, none banked
        inc = _incumbent(router)
        ctl.propose(128, "decode_attention", _candidate(router))
        assert not ctl.poll()
        assert _incumbent(router) == inc
        assert ctl.stats.trials == 0 and ctl.stats.skipped == 1

    def test_a_candidate_the_legaliser_refuses_is_skipped(self, router):
        ctl = _controller(router)
        inc = _incumbent(router)
        _bank(ctl, 128, "decode_attention", inc, 1e-3)
        ctl.propose(128, "decode_attention", (16,))     # no split
        assert not ctl.poll()
        assert _incumbent(router) == inc
        assert ctl.stats.trials == 0 and ctl.stats.skipped == 1

    def test_candidate_is_legalised_before_its_trial(self, router):
        """(block_s, W) with W not a whole block_s runs as the legaliser
        rounds it: the trial measures the pair that executes."""
        ctl = _controller(router)
        inc = _incumbent(router)
        bs = inc[0]
        _bank(ctl, 128, "decode_attention", inc, 1e-3)
        ctl.propose(128, "decode_attention", (bs, bs + 1))
        assert ctl.poll()
        live = _incumbent(router)
        assert live == (bs, 2 * bs) and ctl._trial.candidate == live

    def test_cooldown_blocks_immediate_reproposal(self, router):
        ctl = _controller(router, cooldown_ticks=50)
        inc, cand = _incumbent(router), _candidate(router)
        _bank(ctl, 128, "decode_attention", inc, 1e-4)
        ctl.propose(128, "decode_attention", cand)
        ctl.poll()
        _bank(ctl, 128, "decode_attention", cand, 1e-3)
        ctl.poll()                                # verdict: rejected
        assert ctl.stats.trials == 1
        ctl.propose(128, "decode_attention", cand)   # immediately again
        assert not ctl.poll()                     # cooling: dropped
        assert ctl.stats.trials == 1
        _bank(ctl, 128, "decode_attention", inc, 1e-4, n=60)  # cooldown ends
        ctl.propose(128, "decode_attention", cand)
        assert ctl.poll()                         # now it trials again
        assert ctl.stats.trials == 2

    def test_trial_timeout_reverts_cold_bucket(self, router):
        ctl = _controller(router, trial_timeout_ticks=5)
        inc, cand = _incumbent(router), _candidate(router)
        _bank(ctl, 128, "decode_attention", inc, 1e-3)
        ctl.propose(128, "decode_attention", cand)
        assert ctl.poll()
        _bank(ctl, 256, "decode_attention", _incumbent(router, 256), 1e-3,
              n=10)
        assert ctl.poll()                         # timeout: incumbent back
        assert _incumbent(router) == inc
        assert ctl.stats.reverted == 1
        (d,) = ctl.decisions
        assert d.reason == "timeout" and math.isnan(d.candidate_s)

    def test_noop_when_candidate_equals_incumbent(self, router):
        ctl = _controller(router)
        inc = _incumbent(router)
        _bank(ctl, 128, "decode_attention", inc, 1e-3)
        ctl.propose(128, "decode_attention", inc)
        assert not ctl.poll()
        assert ctl.stats.noop == 1 and ctl.stats.trials == 0

    def test_adoption_persists_with_retune_provenance(self, router):
        cache = TuningCache(path=None)
        ctl = _controller(router)
        ctl._cache = cache
        inc, cand = _incumbent(router), _candidate(router)
        _bank(ctl, 128, "decode_attention", inc, 1e-3)
        ctl.propose(128, "decode_attention", cand)
        ctl.poll()
        _bank(ctl, 128, "decode_attention", cand, 1e-4)
        ctl.poll()
        assert ctl.stats.adopted == 1
        ((key, e),) = [(k, e) for k, e in cache._mem.items()
                       if e.get("source") == "retune"]
        assert key.startswith(cache_hw_key(HW) + "::")
        assert tuple(e["plan"]["value"]) == cand
        assert e["cost"] < e["seed_cost"]       # adopted means faster
        assert e["probes"] == 0                 # measured on real traffic
        assert tuple(e["incumbent"]) == inc

    def test_warmup_ticks_discard_first_launch_tick(self, router):
        ctl = _controller(router, trial_ticks=2, warmup_ticks=1)
        inc, cand = _incumbent(router), _candidate(router)
        _bank(ctl, 128, "decode_attention", inc, 1e-3)
        ctl.propose(128, "decode_attention", cand)
        ctl.poll()
        # the first candidate tick pays the first launch: it must not count
        ctl.observe_tick(128, "decode_attention", cand, 10.0)
        ctl.observe_tick(128, "decode_attention", cand, 1e-4)
        ctl.observe_tick(128, "decode_attention", cand, 1e-4)
        ctl.poll()
        (d,) = ctl.decisions
        assert d.adopted, "the warm-up tick leaked into the trial median"

    def test_config_validation(self):
        with pytest.raises(ValueError):
            RetuneConfig(mode="sometimes")
        with pytest.raises(ValueError):
            RetuneConfig(hysteresis=1.5)
        with pytest.raises(ValueError):
            RetuneConfig(trial_ticks=0)


def test_an_adopted_pair_is_read_back_by_a_fresh_router():
    cache = TuningCache(path=None)
    r = _router(cache=cache)
    ctl = RetuneController(r, config=RetuneConfig(
        min_samples=2, trial_ticks=2, warmup_ticks=0, cooldown_ticks=0,
        interval_ticks=10_000), tracer=Tracer())
    for kernel in KERNELS:
        inc, cand = _incumbent(r, kernel=kernel), _candidate(r, kernel=kernel)
        _bank(ctl, 128, kernel, inc, 1e-3, n=2)
        ctl.propose(128, kernel, cand)
        assert ctl.poll()
        _bank(ctl, 128, kernel, cand, 1e-4, n=2)
        ctl.poll()
        assert ctl.decisions[-1].adopted
        fresh = _router(cache=cache)
        plan = fresh.resolve(fresh.bucket(128))
        assert _incumbent(fresh, kernel=kernel) == cand
        info = getattr(plan, {"decode_attention": "decode_info",
                              "paged_decode": "paged_decode_info"}[kernel])
        assert info.source == "cache" and info.probes == 0


# --------------------------------------------------------------------------- #
# The port's controller against the JAX one
# --------------------------------------------------------------------------- #

#: scripts of controller events: ("inc"|"cand"|"cold", seconds, count),
#: ("propose",) or ("propose_inc",), and ("poll",)
SCRIPTS = {
    "adopt": [("inc", 1e-3, 6), ("propose",), ("poll",), ("cand", 1e-4, 4),
              ("poll",)],
    "slower": [("inc", 1e-4, 6), ("propose",), ("poll",), ("cand", 1e-3, 4),
               ("poll",)],
    "marginal": [("inc", 1e-3, 6), ("propose",), ("poll",),
                 ("cand", 0.99e-3, 4), ("poll",)],
    "warmup": [("inc", 1e-3, 6), ("propose",), ("poll",), ("cand", 10.0, 1),
               ("cand", 1e-4, 3), ("poll",)],
    "blind": [("inc", 1e-3, 2), ("propose",), ("poll",), ("inc", 1e-3, 4),
              ("propose",), ("poll",), ("cand", 2e-3, 4), ("poll",)],
    "timeout": [("inc", 1e-3, 6), ("propose",), ("poll",), ("cold", 1e-3, 9),
                ("poll",)],
    "cooldown": [("inc", 1e-4, 6), ("propose",), ("poll",), ("cand", 1e-3, 4),
                 ("poll",), ("propose",), ("poll",), ("inc", 1e-4, 8),
                 ("propose",), ("poll",), ("cand", 1e-5, 2), ("poll",),
                 ("cand", 1e-5, 2), ("poll",)],
    "noop": [("inc", 1e-3, 6), ("propose_inc",), ("poll",), ("inc", 1e-3, 2),
             ("poll",)],
}


def _play(script, ctl, router, kernel, inc, cand, cold_kv, cold_value):
    """Run one script; returns each poll's result and the decisions."""
    polls = []
    for step in script:
        if step[0] in ("inc", "cand", "cold"):
            kv, value = ((cold_kv, cold_value) if step[0] == "cold"
                         else (128, inc if step[0] == "inc" else cand))
            for _ in range(step[2]):
                ctl.observe_tick(kv, kernel, value, step[1])
        elif step[0] == "propose":
            ctl.propose(128, kernel, cand)
        elif step[0] == "propose_inc":
            ctl.propose(128, kernel, inc)
        else:
            polls.append(ctl.poll())
    return polls, [(d.tick, d.adopted, d.reason, d.incumbent_s,
                    None if math.isnan(d.candidate_s) else d.candidate_s)
                   for d in ctl.decisions], dataclasses.asdict(ctl.stats)


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_same_decisions_at_the_same_ticks_as_the_jax_controller(script):
    cfg = dict(mode="inline", min_samples=4, trial_ticks=3, warmup_ticks=1,
               cooldown_ticks=8, interval_ticks=10_000,
               trial_timeout_ticks=5)
    r = _router()
    ctl = RetuneController(r, config=RetuneConfig(**cfg), tracer=Tracer(),
                           cache=TuningCache(path=None))
    got = _play(SCRIPTS[script], ctl, r, "decode_attention", _incumbent(r),
                _candidate(r), 256, _incumbent(r, 256))

    jr = JaxBucketRouter(jax_get_config("smollm-135m").reduced(),
                         JaxBucketSpec(max_len=256), slots=2,
                         hw=TPU_REGISTRY["cpu_sim"],
                         cache=JaxTuningCache(path=None))
    jctl = JaxRetuneController(jr, config=JaxRetuneConfig(**cfg),
                               tracer=JaxTracer(),
                               cache=JaxTuningCache(path=None))
    jinc = jr.resolve(jr.bucket(128)).decode_block
    jcold = jr.resolve(jr.bucket(256)).decode_block
    want = _play(SCRIPTS[script], jctl, jr, "decode_attention", jinc,
                 16 if jinc != 16 else 32, 256, jcold)
    assert got == want
    assert got[1] or script in ("noop",)


# --------------------------------------------------------------------------- #
# The background worker, and the drift scan
# --------------------------------------------------------------------------- #


def test_background_worker_replays_the_store_without_cuda(router,
                                                          monkeypatch):
    import torch

    import repro_torch.profiler.cost as cost

    cuda_calls = []

    def no_cuda(*a, **kw):
        cuda_calls.append(a)
        raise AssertionError("the retune worker touched CUDA")

    def no_measure(*a, **kw):
        raise AssertionError("the retune worker measured")

    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    monkeypatch.setattr(cost, "measure_value", no_measure)
    ctl = _controller(router, mode="background")
    try:
        inc = _incumbent(router)
        _bank(ctl, 128, "decode_attention", inc, 1e-3)
        ctl._submit_job(128, "decode_attention", inc)
        deadline = time.monotonic() + 30.0
        while ctl._proposals.empty() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ctl.poll()                       # the worker's proposal
    finally:
        ctl.close()
    assert not cuda_calls
    assert ctl.stats.trials == 1
    trial = [s for s in ctl.obs.spans() if s.name == "retune_trial"]
    assert trial[0].attrs["source"] == "roofline-alt"
    assert _incumbent(router) != inc


def test_drift_scan_counter_proposes_the_rooflines_best_other_pair(router):
    """Serving spans with one bucket far off the fleet: the scan feeds the
    store, flags the bucket and trials the roofline's best non-incumbent
    pair (the store holds evidence for the incumbent alone)."""
    tr = Tracer(meta=dict(layers=1, head_dim=router.cfg.head_dim,
                          heads=router.cfg.num_heads,
                          kv_heads=router.cfg.num_kv_heads,
                          dtype=router.cfg.dtype, dtype_bytes=2, slots=2))
    ctl = RetuneController(router, config=RetuneConfig(
        interval_ticks=1, min_samples=2, drift_threshold=1.25),
        tracer=tr)
    for kv, dur in ((64, 1e-3), (128, 1e-3), (256, 1e-1)):
        inc = _incumbent(router, kv)
        for _ in range(3):
            _tick_span(tr, kv, inc, dur)
            ctl.observe_tick(kv, "decode_attention", inc, dur)
    rep = drift_report(tr.spans(), tr.meta, HW)
    assert [r.bucket for r in rep.candidates(1.25)] == [256]
    inc = _incumbent(router, 256)
    assert ctl.poll()
    assert ctl.stats.scans == 1 and ctl.stats.trials == 1
    assert len(ctl.store) == 3                 # one record per bucket
    (t,) = [s for s in tr.spans() if s.name == "retune_trial"]
    assert t.attrs["bucket"] == 256 and t.attrs["source"] == "roofline-alt"
    assert _incumbent(router, 256) != inc


# --------------------------------------------------------------------------- #
# Drift-candidate edge cases (the scan's input)
# --------------------------------------------------------------------------- #

META = {"layers": 1, "head_dim": 64, "heads": 9, "kv_heads": 3,
        "dtype": "float32", "dtype_bytes": 4, "slots": 2}


def _tick_span(tracer, bucket, pair, dur):
    with tracer.span("decode_tick", bucket=bucket, decode_block=pair[0],
                     decode_split=pair[1]):
        pass
    rec = tracer._ring.pop()                # rewrite the recorded duration
    tracer._ring.append(dataclasses.replace(rec, dur=dur))


class TestDriftCandidateEdges:
    def test_empty_trace_yields_empty_report(self):
        rep = drift_report([], META, HW)
        assert rep.rows == ()
        assert rep.candidates(1.5) == []

    def test_single_sample_bucket_is_its_own_fleet(self):
        tr = Tracer()
        _tick_span(tr, 128, (64, 64), 1e-3)
        rep = drift_report(tr.spans(), META, HW)
        (row,) = rep.rows
        assert row.n == 1 and row.value == (64, 64)
        assert row.drift == pytest.approx(1.0)
        assert rep.candidates(1.0 + 1e-9) == []

    def test_a_span_without_its_split_names_no_plan(self):
        tr = Tracer()
        with tr.span("decode_tick", bucket=128, decode_block=64):
            pass
        assert drift_report(tr.spans(), META, HW).rows == ()

    def test_threshold_boundary_is_strict(self):
        row = DriftRecord(phase="decode", kernel="decode_attention",
                          bucket=128, value=(64, 64), n=8, measured_s=2e-3,
                          predicted_s=1e-3, ratio=2.0, drift=2.0)
        rep = DriftReport(rows=(row,), median_ratio=1.0)
        assert rep.candidates(threshold=2.0) == []
        assert rep.candidates(threshold=1.999) == [row]
        low = dataclasses.replace(row, ratio=0.5, drift=0.5)
        rep2 = DriftReport(rows=(low,), median_ratio=1.0)
        assert rep2.candidates(threshold=2.0) == []
        assert rep2.candidates(threshold=1.999) == [low]

    def test_threshold_must_be_positive(self):
        rep = DriftReport(rows=(), median_ratio=0.0)
        with pytest.raises(ValueError):
            rep.candidates(threshold=0.0)
        with pytest.raises(ValueError):
            rep.candidates(threshold=-1.5)

    def test_zero_roofline_estimate_skips_row(self, monkeypatch):
        from repro_torch.tuner import dispatch

        tr = Tracer()
        _tick_span(tr, 128, (64, 64), 1e-3)
        spec = dispatch.KERNEL_REGISTRY["decode_attention"]
        broken = dataclasses.replace(
            spec, cost_model=lambda desc, hw: (lambda v: 0.0))
        monkeypatch.setitem(dispatch.KERNEL_REGISTRY, "decode_attention",
                            broken)
        rep = drift_report(tr.spans(), META, HW)
        assert rep.rows == ()
        assert rep.candidates(1.5) == []


# --------------------------------------------------------------------------- #
# Engine integration
# --------------------------------------------------------------------------- #

PROMPTS = [[7, 3, 99], [11, 5, 2, 42, 17, 101, 9], [250, 1],
           [33, 44, 55, 66]]


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_get_config("smollm-135m").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                               dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _serve(eng, prompts, max_new=4):
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    rep = eng.run()
    assert rep.summary.n_completed == len(prompts)
    return [rep.outputs[r.rid] for r in reqs], rep


@pytest.fixture(scope="module")
def engines(weights):
    """The port's engine with retuning off and inline, each with its
    attention calls recorded, and the JAX engine with it inline."""
    from test_torch_obs import KernelSpy

    jcfg, jparams, tcfg, tparams = weights
    out = {}
    for label, retune in (("off", "off"), ("inline", "inline")):
        eng = ServeEngine(tcfg, slots=2, max_len=64, params=tparams,
                          device="cpu", tuning_cache=TuningCache(path=None),
                          retune=retune)
        with pytest.MonkeyPatch.context() as mp:
            spy = KernelSpy(mp)
            streams, rep = _serve(eng, PROMPTS)
        out[label] = (eng, streams, rep, spy.calls)
    jeng = JaxServeEngine(jcfg, slots=2, max_len=64, params=jparams,
                          tuning_cache=JaxTuningCache(path=None),
                          retune="inline")
    out["jax"] = _serve(jeng, PROMPTS)
    return out


class TestEngineIntegration:
    def test_token_streams_exact_with_retuning_on(self, engines):
        _, off, rep_off, _ = engines["off"]
        eng, on, rep_on, _ = engines["inline"]
        jstreams, jrep = engines["jax"]
        assert on == off == jstreams
        assert rep_off.retune is None
        assert rep_on.retune is not None
        assert rep_on.retune["stats"] == jrep.retune["stats"]
        assert eng.obs.enabled                  # the private tracer

    def test_same_kernels_at_the_same_plans_with_controller_enabled(
            self, engines):
        """No bucket was swapped in this run, so the controller changes
        nothing the device sees: the same calls at the same plans."""
        *_, calls_off = engines["off"]
        eng, _, rep, calls_on = engines["inline"]
        assert rep.retune["stats"]["trials"] == 0
        assert calls_on == calls_off and calls_on

    def test_engine_trial_on_real_ticks_adopts_or_reverts(self, weights):
        """A trial driven by ``propose`` runs on real decode ticks and
        concludes either way; the plan table ends at whichever pair the
        measurement favoured, the candidate ran in ``decode_tick`` spans
        and kernel calls, and the streams are the untraced engine's."""
        from test_torch_obs import KernelSpy

        *_, tcfg, tparams = weights
        rc = RetuneConfig(mode="inline", interval_ticks=10_000,
                          min_samples=2, trial_ticks=2, warmup_ticks=1,
                          cooldown_ticks=4)
        prompts = [list(range(1, 9)), list(range(3, 9))]

        def engine(**kw):
            return ServeEngine(tcfg, slots=2, max_len=64, params=tparams,
                               device="cpu",
                               tuning_cache=TuningCache(path=None), **kw)

        want, _ = _serve(engine(), prompts, max_new=24)
        eng = engine(retune=rc)
        fired = {"n": 0, "cand": None}
        orig = eng._decode_tick

        def tick():
            orig()
            fired["n"] += 1
            if fired["n"] == 4:
                kv = eng.pool.kv_len
                bs, w = _incumbent(eng.router, kv, "paged_decode")
                fired["cand"] = (bs, bs) if w != bs else (bs, 2 * bs)
                eng.retune.propose(kv, "paged_decode", fired["cand"])

        eng._decode_tick = tick
        with pytest.MonkeyPatch.context() as mp:
            spy = KernelSpy(mp)
            got, rep = _serve(eng, prompts, max_new=24)
        assert got == want
        assert eng.retune.stats.trials == 1
        (d,) = eng.retune.decisions
        assert d.candidate == fired["cand"]
        live = _incumbent(eng.router, eng.pool.kv_len, "paged_decode")
        assert live == (d.candidate if d.adopted else d.incumbent)
        assert rep.router_stats["swaps"] >= 1
        assert rep.retune["stats"]["trials"] == 1
        ran = {(s.attrs["paged_decode_block"], s.attrs["paged_decode_split"])
               for s in eng.obs.spans() if s.name == "decode_tick"}
        assert d.candidate in ran
        calls = {dict(p).get("split") for n, p in spy.calls
                 if n == "paged_decode_attention"}
        assert d.candidate[1] in calls
