"""The retune controller: drift-triggered re-resolve + A/B-guarded swap.

A port of the JAX package's ``serve/retune/controller.py``.  A plan here
is the decode sweep's pair ``(block_s, split W)``: candidates are
legalised by the kernel's own rule (``KernelSpec.plan_from_value``)
before a trial, so the value a trial measures is the value that runs.

Control loop (all between decode ticks, on the host: a bucket whose plan
is not swapped launches the same kernels at the same plans with the
controller on; ``tests/test_torch_retune.py`` holds this):

  1. **observe** — the engine reports every decode tick's (bucket,
     executed kernel, executed plan value, wall seconds, closed after
     the device finished the step); the controller keeps a rolling
     window per (bucket, kernel, value) — the incumbent's evidence for
     the A/B guard.
  2. **scan** — every ``interval_ticks``, new spans are fed to the
     profiler ``TraceStore`` (``obs.feedback.feedback_to_store``) and
     ``obs.drift_report`` ranks measured-vs-roofline deviation; rows
     past ``drift_threshold`` with enough samples become re-resolve
     jobs.
  3. **re-resolve** — a job replays ``hybrid_refine(mode="cached")``
     over the serving-fed store (inline, or on the background worker
     thread, which only reads the store and ranks on the host: it
     issues no CUDA op; trials run on the serving thread's own ticks).
     When the store only holds evidence for the incumbent the
     measured pass can only re-confirm it — but drift says that very
     evidence contradicts the model's ranking, so the controller
     counter-proposes the roofline's best *non-incumbent* candidate:
     the trial below then generates the missing measured evidence
     (measured feedback overrides analytic when they diverge).
  4. **A/B trial** — the candidate value is hot-swapped into the
     bucket's ``BucketPlan`` (``BucketRouter.swap_plan``) and executed
     on real ticks.  After ``trial_ticks`` measured samples (the first
     ``warmup_ticks`` are discarded: they pay the new split's first
     launch, its workspace and ticket buffers), the candidate's median
     must beat the incumbent's rolling
     median by the ``hysteresis`` margin or the incumbent is swapped
     straight back.  Either way the bucket enters ``cooldown_ticks`` of
     freeze, so it cannot flap.
  5. **persist** — adopted values are written to the ``TuningCache``
     under the kernel's real signature and the tuner's key
     (``cache_hw_key``: the hardware and the cost models' digest) with
     ``source="retune"`` provenance, so the next cold router on that
     cache starts from what serving measured.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import queue
import statistics
import threading
from typing import Any, Optional

__all__ = ["RETUNE_MODES", "RetuneConfig", "RetuneController",
           "RetuneStats", "SwapDecision"]

RETUNE_MODES = ("off", "inline", "background")


@dataclasses.dataclass(frozen=True)
class RetuneConfig:
    """Knobs of the live-retune control loop.

    Example::

        RetuneConfig(mode="inline", interval_ticks=32,
                     drift_threshold=1.2, trial_ticks=8)
    """

    mode: str = "inline"             # "inline" | "background"
    interval_ticks: int = 64         # drift-scan cadence (decode ticks)
    drift_threshold: float = 1.25    # DriftReport.candidates threshold
    min_samples: int = 8             # evidence floor per drift row AND
    #                                  for the incumbent's rolling median
    trial_ticks: int = 6             # measured candidate ticks per trial
    warmup_ticks: int = 1            # leading trial ticks discarded
    #                                  (the candidate's first launch)
    trial_timeout_ticks: int = 512   # abort a trial whose bucket went
    #                                  cold before producing samples
    hysteresis: float = 0.98         # adopt iff cand < inc * hysteresis
    cooldown_ticks: int = 256        # per-bucket freeze after a verdict
    history: int = 64                # rolling window per (bucket, value)

    def __post_init__(self):
        if self.mode not in RETUNE_MODES[1:]:
            raise ValueError(f"mode must be one of {RETUNE_MODES[1:]}, "
                             f"got {self.mode!r}")
        if not 0 < self.hysteresis <= 1.0:
            raise ValueError(f"hysteresis must be in (0, 1], got "
                             f"{self.hysteresis}")
        if self.trial_ticks < 1 or self.warmup_ticks < 0:
            raise ValueError("need trial_ticks >= 1 and warmup_ticks >= 0")


@dataclasses.dataclass(frozen=True)
class SwapDecision:
    """One concluded A/B trial (or a proposal that never reached one).

    ``reason`` is one of ``adopted`` / ``slower`` / ``timeout``.  Costs
    are median whole-step seconds; ``candidate_s`` is NaN when the trial
    produced no measured samples.  Values are (block_s, split) pairs.

    Example::

        d = eng.retune.decisions[0]
        print(f"{d.bucket}: {d.incumbent} -> {d.candidate} "
              f"({'kept' if d.adopted else 'reverted'})")
    """

    tick: int
    bucket: int
    kernel: str
    incumbent: Any
    candidate: Any
    incumbent_s: float
    candidate_s: float
    adopted: bool
    reason: str


@dataclasses.dataclass
class RetuneStats:
    """Controller accounting (the smoke and the tests read it).

    Example::

        >>> RetuneStats().adopted
        0
    """

    scans: int = 0
    proposals: int = 0
    trials: int = 0
    adopted: int = 0
    rejected: int = 0
    reverted: int = 0        # trial timeouts (bucket went cold)
    noop: int = 0            # re-resolve confirmed the incumbent
    skipped: int = 0         # no incumbent evidence (never swap blind),
    #                          or a candidate no legal plan takes


@dataclasses.dataclass(frozen=True)
class _Proposal:
    bucket_kv: int
    kernel: str
    incumbent: Any
    value: Any
    source: str


@dataclasses.dataclass
class _Trial:
    bucket_kv: int
    kernel: str
    incumbent: Any
    candidate: Any
    incumbent_s: float
    started_tick: int
    seen: int = 0                                  # candidate ticks seen
    samples: list = dataclasses.field(default_factory=list)


class RetuneController:
    """Drift-triggered re-resolve with an A/B-guarded plan hot-swap.

    The engine drives it with two calls: ``observe_tick`` after every
    decode tick (the measurement) and ``poll`` between ticks (the
    actuation — returns True when the router's plan table changed so
    the engine invalidates its plan memo).  ``propose`` injects a
    candidate directly, bypassing the drift scan — the deterministic
    entry point tests, benchmarks, and the demo use.

    Example::

        ctl = RetuneController(router, tracer=tracer)
        ctl.observe_tick(256, "paged_decode", (16, 48), 0.004)
        if ctl.poll():
            ...  # plan table changed: drop any memoized plan
    """

    def __init__(self, router, *, config: Optional[RetuneConfig] = None,
                 tracer=None, store=None, cache=None):
        from repro_torch.obs.trace import get_tracer
        from repro_torch.profiler.store import TraceStore

        self.router = router
        self.cfg = config or RetuneConfig()
        self.obs = tracer if tracer is not None else get_tracer()
        #: the serving-fed evidence store ``hybrid_refine`` replays;
        #: in-memory by default (pass a path-backed store to persist)
        self.store = store if store is not None \
            else TraceStore(None, autosave=False)
        self._cache = cache
        self.stats = RetuneStats()
        self.decisions: list[SwapDecision] = []

        self._ticks = 0
        self._last_scan = 0
        self._last_sid = -1
        self._hist: dict[tuple, collections.deque] = {}
        self._trial: Optional[_Trial] = None
        self._cooldown: dict[int, int] = {}      # bucket_kv -> expiry tick
        self._proposals: "queue.SimpleQueue[_Proposal]" = queue.SimpleQueue()
        self._inflight = 0                       # queued re-resolve jobs
        self._jobs: Optional[queue.SimpleQueue] = None
        self._worker: Optional[threading.Thread] = None
        if self.cfg.mode == "background":
            self._jobs = queue.SimpleQueue()
            self._worker = threading.Thread(target=self._worker_loop,
                                            name="retune-worker",
                                            daemon=True)
            self._worker.start()

    # -- engine-facing ----------------------------------------------------

    def observe_tick(self, bucket_kv: int, kernel: Optional[str],
                     value: Any, dur_s: float) -> None:
        """Record one decode tick's executed mapping + wall seconds.
        ``kernel=None`` (attention-free families) counts the tick for
        cadence but records no evidence — there is nothing to retune."""
        self._ticks += 1
        if kernel is None:
            return
        key = (bucket_kv, kernel, value)
        h = self._hist.get(key)
        if h is None:
            h = self._hist[key] = collections.deque(
                maxlen=self.cfg.history)
        h.append(dur_s)
        t = self._trial
        if (t is not None and t.bucket_kv == bucket_kv
                and t.kernel == kernel and value == t.candidate):
            t.seen += 1
            if t.seen > self.cfg.warmup_ticks:
                t.samples.append(dur_s)

    def poll(self) -> bool:
        """Advance the control loop at a tick boundary.  Returns True
        when the router's plan table changed (trial start or revert) —
        the engine must then invalidate its memoized current plan."""
        changed = False
        if self._trial is not None:
            changed |= self._conclude_if_due()
        if self._trial is None:
            changed |= self._start_next_trial()
        if (self._trial is None and self._inflight == 0
                and self._ticks - self._last_scan >= self.cfg.interval_ticks):
            self._scan()
            changed |= self._start_next_trial()
        return changed

    def propose(self, bucket_kv: int, kernel: str, value: Any,
                *, incumbent: Any = None, source: str = "manual") -> None:
        """Inject a candidate for ``bucket_kv``'s ``kernel`` directly —
        it still goes through the full A/B guard (trial, hysteresis,
        cooldown), only the drift scan is bypassed."""
        if incumbent is None:
            incumbent = self._plan_value(bucket_kv, kernel)
        self._proposals.put(_Proposal(bucket_kv, kernel, incumbent,
                                      value, source))
        self._inflight += 1
        self.stats.proposals += 1

    def close(self) -> None:
        """Stop the background worker (no-op in inline mode)."""
        if self._jobs is not None:
            self._jobs.put(None)
            if self._worker is not None:
                self._worker.join(timeout=5.0)
            self._jobs = None
            self._worker = None

    # -- internals --------------------------------------------------------

    def _plan_value(self, bucket_kv: int, kernel: str) -> Any:
        plan = self.router.resolve(self.router.bucket(bucket_kv))
        return tuple(getattr(plan, f)
                     for f in self.router.SWAP_FIELDS[kernel])

    def _bucket_desc(self, bucket_kv: int, kernel: str) -> dict:
        """The kernel's tuner workload desc at one bucket, from the
        router's own ``row_desc`` (one source of truth with cold
        resolution)."""
        from repro_torch.serve.buckets import KERNEL_TABLE

        row = next(r for r in KERNEL_TABLE if r.kernel == kernel)
        return self.router.row_desc(row, self.router.bucket(bucket_kv))

    def _legal(self, bucket_kv: int, kernel: str, value: Any) -> Any:
        """``value`` as the kernel's legaliser takes it (what a swap
        installs); None when no legal plan takes it."""
        from repro_torch.profiler.measure import canon_value
        from repro_torch.tuner.dispatch import KERNEL_REGISTRY

        spec = KERNEL_REGISTRY[kernel]
        try:
            plan = spec.plan_from_value(self._bucket_desc(bucket_kv, kernel),
                                        self.router.hw, value)
        except (TypeError, ValueError):
            return None
        return canon_value(spec.plan_value(plan))

    def _cooling(self, bucket_kv: int) -> bool:
        return self._cooldown.get(bucket_kv, -1) > self._ticks

    def _incumbent_median(self, bucket_kv: int, kernel: str,
                          value: Any) -> Optional[float]:
        h = self._hist.get((bucket_kv, kernel, value))
        if h is None or len(h) < self.cfg.min_samples:
            return None
        return statistics.median(h)

    def _decide(self, trial: _Trial, adopted: bool, reason: str,
                candidate_s: float) -> None:
        d = SwapDecision(tick=self._ticks, bucket=trial.bucket_kv,
                         kernel=trial.kernel, incumbent=trial.incumbent,
                         candidate=trial.candidate,
                         incumbent_s=trial.incumbent_s,
                         candidate_s=candidate_s, adopted=adopted,
                         reason=reason)
        self.decisions.append(d)
        self.obs.instant(
            "retune_decision", bucket=d.bucket, kernel=d.kernel,
            incumbent=d.incumbent, candidate=d.candidate,
            incumbent_us=d.incumbent_s * 1e6,
            candidate_us=(None if math.isnan(d.candidate_s)
                          else d.candidate_s * 1e6),
            adopted=d.adopted, reason=d.reason)
        self.obs.count("retune_adopted" if adopted else "retune_rejected")
        self._cooldown[trial.bucket_kv] = self._ticks + self.cfg.cooldown_ticks
        self._trial = None

    def _conclude_if_due(self) -> bool:
        """Trial verdict: adopt (keep the already-swapped candidate) or
        revert (swap the incumbent back).  Returns True when the plan
        table changed (i.e. on revert)."""
        t = self._trial
        if len(t.samples) < self.cfg.trial_ticks:
            if self._ticks - t.started_tick > self.cfg.trial_timeout_ticks:
                # the bucket stopped ticking (traffic moved on): revert
                # rather than leave an unmeasured candidate live
                self.router.swap_plan(self.router.bucket(t.bucket_kv),
                                      t.kernel, t.incumbent)
                self.stats.reverted += 1
                self._decide(t, False, "timeout", float("nan"))
                return True
            return False
        cand_s = statistics.median(t.samples)
        if cand_s < t.incumbent_s * self.cfg.hysteresis:
            self.stats.adopted += 1
            self._persist(t, cand_s)
            self._decide(t, True, "adopted", cand_s)
            return False                 # candidate already in the table
        self.router.swap_plan(self.router.bucket(t.bucket_kv),
                              t.kernel, t.incumbent)
        self.stats.rejected += 1
        self._decide(t, False, "slower", cand_s)
        return True

    def _start_next_trial(self) -> bool:
        """Consume finished re-resolve jobs until one yields a viable
        trial (guardable incumbent, un-cooled bucket, a genuinely new
        value).  Returns True when a trial started (plan swapped)."""
        while self._trial is None:
            try:
                p = self._proposals.get_nowait()
            except queue.Empty:
                return False
            self._inflight = max(0, self._inflight - 1)
            if self._cooling(p.bucket_kv):
                continue
            incumbent = self._plan_value(p.bucket_kv, p.kernel)
            value = None if p.value is None \
                else self._legal(p.bucket_kv, p.kernel, p.value)
            if p.value is not None and value is None:
                self.stats.skipped += 1          # no legal plan takes it
                continue
            if value is None or value == incumbent:
                self.stats.noop += 1
                self._cooldown[p.bucket_kv] = (self._ticks
                                               + self.cfg.cooldown_ticks)
                continue
            inc_s = self._incumbent_median(p.bucket_kv, p.kernel, incumbent)
            if inc_s is None:
                # no guard without incumbent evidence — never swap blind
                self.stats.skipped += 1
                continue
            self.router.swap_plan(self.router.bucket(p.bucket_kv),
                                  p.kernel, value)
            self._trial = _Trial(bucket_kv=p.bucket_kv, kernel=p.kernel,
                                 incumbent=incumbent, candidate=value,
                                 incumbent_s=inc_s,
                                 started_tick=self._ticks)
            self.stats.trials += 1
            self.obs.instant("retune_trial", bucket=p.bucket_kv,
                             kernel=p.kernel, incumbent=incumbent,
                             candidate=value, source=p.source)
            self.obs.count("retune_trials")
            return True
        return False

    def _scan(self) -> None:
        """Feed new spans to the store, rank drift, queue ONE re-resolve
        job for the worst un-cooled decode candidate."""
        from repro_torch.obs.drift import drift_report
        from repro_torch.obs.feedback import feedback_to_store

        self._last_scan = self._ticks
        self.stats.scans += 1
        self.obs.count("retune_scans")
        spans = self.obs.spans()
        meta, hw = self.obs.meta, self.router.hw
        fresh = [s for s in spans if s.sid > self._last_sid]
        if fresh:
            self._last_sid = max(s.sid for s in fresh)
            feedback_to_store(fresh, meta, hw, self.store)
        rep = drift_report(spans, meta, hw)
        for r in rep.candidates(self.cfg.drift_threshold):
            if (r.phase != "decode" or r.n < self.cfg.min_samples
                    or self._cooling(r.bucket)
                    or r.kernel not in self.router.SWAP_FIELDS):
                continue
            self._submit_job(r.bucket, r.kernel, r.value)
            break                        # one in-flight re-resolve at a time

    def _submit_job(self, bucket_kv: int, kernel: str, incumbent) -> None:
        self._inflight += 1
        self.stats.proposals += 1
        if self._jobs is not None:
            self._jobs.put((bucket_kv, kernel, incumbent))
        else:
            self._proposals.put(self._re_resolve(bucket_kv, kernel,
                                                 incumbent))

    def _worker_loop(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            try:
                self._proposals.put(self._re_resolve(*job))
            except Exception:            # a dead worker would stall the
                self._inflight -= 1      # loop forever; drop the job
                continue

    def _re_resolve(self, bucket_kv: int, kernel: str,
                    incumbent) -> _Proposal:
        """Replay ``hybrid_refine`` over the serving-fed store.  When the
        measured pass can only re-confirm the incumbent (the store holds
        evidence for nothing else), counter-propose the roofline's best
        non-incumbent candidate — the A/B trial then generates the
        measured evidence the store is missing.  Host arithmetic and
        store reads only: no CUDA op (the background worker runs it)."""
        from repro_torch.profiler.cost import hybrid_refine
        from repro_torch.profiler.measure import canon_value

        desc = self._bucket_desc(bucket_kv, kernel)
        res = hybrid_refine(kernel, desc, self.router.hw,
                            store=self.store, mode="cached")
        value, source = res.value, res.source
        incumbent = canon_value(incumbent)
        if value == incumbent:
            alts = [v for v, c in res.roofline.ranked()
                    if canon_value(v) != incumbent and math.isfinite(c)]
            if alts:
                value, source = alts[0], "roofline-alt"
        return _Proposal(bucket_kv, kernel, incumbent, value, source)

    def _persist(self, trial: _Trial, cand_s: float) -> None:
        """Write the adopted value to the TuningCache under the kernel's
        real signature and the tuner's own key (``cache_hw_key``: an entry
        under ``hardware_key`` alone would never be read back) with
        retune provenance: the next cold router on the cache resolves
        straight to what serving measured."""
        from repro_torch.tuner.dispatch import (KERNEL_REGISTRY,
                                                cache_hw_key,
                                                get_default_cache)

        cache = self._cache if self._cache is not None else self.router.cache
        if cache is None:
            cache = get_default_cache()
        spec = KERNEL_REGISTRY[trial.kernel]
        desc = self._bucket_desc(trial.bucket_kv, trial.kernel)
        sig = spec.sig(desc, self.router.policy)
        cache.put(cache_hw_key(self.router.hw), sig,
                  {"value": trial.candidate},
                  cost=cand_s, seed_cost=trial.incumbent_s, probes=0,
                  extra={"source": "retune", "bucket": trial.bucket_kv,
                         "trial_ticks": len(trial.samples),
                         "incumbent": trial.incumbent})
