"""Latency / throughput accounting for the serving engine (a copy of the
JAX package's ``serve/metrics.py``).

Pure bookkeeping over timestamps the engine supplies (monotonic seconds;
the engine owns the clock so tests and the device-free benchmark can
inject virtual time).  Per request we keep the canonical serving marks —
arrival, admission, first token, completion — and derive the standard
metrics: TTFT, queue wait, per-output-token latency (TPOT), end-to-end
latency, plus pool-level throughput and decode-step utilization.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["RequestRecord", "StepRecord", "ServeSummary", "ServeMetrics",
           "percentile"]


def percentile(values: list[float], q: float) -> float:
    """Linear-interpolated percentile, dependency-free; 0.0 on empty.

    Example::

        >>> percentile([1.0, 2.0, 3.0], 50)
        2.0
    """
    if not values:
        return 0.0
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    x = (len(v) - 1) * (q / 100.0)
    lo = int(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


@dataclasses.dataclass
class RequestRecord:
    """One request's canonical serving marks (seconds, engine clock).

    Example::

        rec = engine.metrics.records[req.rid]
        print(rec.ttft, rec.tpot)
    """

    rid: int
    prompt_tokens: int
    arrival: float
    admitted: Optional[float] = None
    first_token: Optional[float] = None
    done: Optional[float] = None
    output_tokens: int = 0

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (arrival -> first token), or None."""
        if self.first_token is None:
            return None
        return self.first_token - self.arrival

    @property
    def queue_wait(self) -> Optional[float]:
        """Seconds spent queued before admission, or None."""
        if self.admitted is None:
            return None
        return self.admitted - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        """Seconds per output token after the first (decode cadence)."""
        if self.done is None or self.first_token is None \
                or self.output_tokens < 2:
            return None
        return (self.done - self.first_token) / (self.output_tokens - 1)


@dataclasses.dataclass
class StepRecord:
    """One decode tick: timestamp + live/total slot occupancy."""

    t: float
    live: int
    slots: int


@dataclasses.dataclass
class ServeSummary:
    """Aggregated run metrics (the ``report.summary`` payload).

    Example::

        s = engine.run().summary
        print(f"{s.tokens_per_s:.1f} tok/s, ttft p50 {s.ttft_p50_s}s")
    """

    n_requests: int
    n_completed: int
    prompt_tokens: int
    output_tokens: int
    makespan_s: float
    tokens_per_s: float          # output tokens / makespan
    ttft_p50_s: float
    ttft_p95_s: float
    tpot_p50_s: float
    tpot_p95_s: float
    queue_wait_p50_s: float
    utilization: float           # useful decode-row fraction across steps
    decode_steps: int
    prefill_s: float
    decode_s: float
    decode_tick_p50_s: float     # median wall time of one decode tick

    def as_dict(self) -> dict:
        """Plain-dict form (JSON-friendly, benchmark CSV rows)."""
        return dataclasses.asdict(self)


class ServeMetrics:
    """Collects request marks + step counters; summarizes on demand.

    Example::

        m = ServeMetrics()
        m.on_submit(rid=0, t=0.0, prompt_tokens=7)
        m.on_admit(0, 0.1); m.on_first_token(0, 0.2)
        m.on_done(0, 0.5, output_tokens=8)
        summary = m.summary()
    """

    def __init__(self):
        self.records: dict[int, RequestRecord] = {}
        self.steps: list[StepRecord] = []
        self.prefill_s = 0.0
        self.decode_s = 0.0
        #: wall seconds of every decode tick, in order
        self.decode_ticks_s: list[float] = []
        self._t0: Optional[float] = None
        self._t_end = 0.0

    def _touch(self, t: float) -> None:
        if self._t0 is None or t < self._t0:
            self._t0 = t
        self._t_end = max(self._t_end, t)

    # -- request marks ----------------------------------------------------

    def on_submit(self, rid: int, t: float, prompt_tokens: int) -> None:
        """Record a request's arrival."""
        self.records[rid] = RequestRecord(rid=rid,
                                          prompt_tokens=prompt_tokens,
                                          arrival=t)
        self._touch(t)

    def on_admit(self, rid: int, t: float) -> None:
        """Record admission (end of queue wait)."""
        self.records[rid].admitted = t
        self._touch(t)

    def on_first_token(self, rid: int, t: float) -> None:
        """Record the first generated token (the TTFT mark)."""
        self.records[rid].first_token = t
        self._touch(t)

    def on_done(self, rid: int, t: float, output_tokens: int) -> None:
        """Record completion + the request's output token count."""
        r = self.records[rid]
        r.done = t
        r.output_tokens = output_tokens
        self._touch(t)

    # -- engine counters --------------------------------------------------

    def on_step(self, t: float, live: int, slots: int) -> None:
        """Record one decode tick's slot occupancy (utilization)."""
        self.steps.append(StepRecord(t, live, slots))
        self._touch(t)

    def add_prefill_time(self, dt: float) -> None:
        """Accumulate wall seconds spent in prefill calls."""
        self.prefill_s += dt

    def add_decode_time(self, dt: float) -> None:
        """Accumulate wall seconds spent in decode steps (one tick)."""
        self.decode_s += dt
        self.decode_ticks_s.append(dt)

    # -- summary ----------------------------------------------------------

    def summary(self) -> ServeSummary:
        """Fold all marks into a ``ServeSummary`` (pure; callable any
        time)."""
        recs = list(self.records.values())
        done = [r for r in recs if r.done is not None]
        ttfts = [r.ttft for r in recs if r.ttft is not None]
        tpots = [r.tpot for r in recs if r.tpot is not None]
        waits = [r.queue_wait for r in recs if r.queue_wait is not None]
        out_tokens = sum(r.output_tokens for r in done)
        makespan = (self._t_end - self._t0) if self._t0 is not None else 0.0
        util = 0.0
        if self.steps:
            util = (sum(s.live for s in self.steps)
                    / sum(s.slots for s in self.steps))
        return ServeSummary(
            n_requests=len(recs),
            n_completed=len(done),
            prompt_tokens=sum(r.prompt_tokens for r in done),
            output_tokens=out_tokens,
            makespan_s=makespan,
            tokens_per_s=out_tokens / makespan if makespan > 0 else 0.0,
            ttft_p50_s=percentile(ttfts, 50),
            ttft_p95_s=percentile(ttfts, 95),
            tpot_p50_s=percentile(tpots, 50),
            tpot_p95_s=percentile(tpots, 95),
            queue_wait_p50_s=percentile(waits, 50),
            utilization=util,
            decode_steps=len(self.steps),
            prefill_s=self.prefill_s,
            decode_s=self.decode_s,
            decode_tick_p50_s=percentile(self.decode_ticks_s, 50),
        )
