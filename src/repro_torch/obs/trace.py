"""Structured serving-time telemetry: spans, counters, gauges.

The paper's method is trace observation driving runtime mapping: the
engine cannot retune what it cannot see.  This module is the seeing
half, a copy of the JAX package's ``obs/trace.py``: a dependency-free
``Tracer`` every runtime layer threads its events through.

  * **nestable spans**: ``with tracer.span("decode_tick", bucket=256)``
    records a timed interval carrying attributes (the bucket key, the
    executed plan, occupancy); a span opened inside an open span records
    its parent, so a ``resolve_plan`` span nests under the
    ``bucket_resolve`` that triggered it;
  * **injectable clock**: the tracer's clock is a constructor argument
    (default ``time.perf_counter``), as the serve engine's is, so tests
    produce deterministic traces;
  * **bounded ring**: finished spans land in a ``deque(maxlen=capacity)``;
    a long-running server traces forever in bounded memory, oldest spans
    evicted first;
  * **locked counters and gauges**: monotonic counters
    (``count("tokens", 4)``) and last-value gauges
    (``gauge("live_slots", 3)``) behind one lock;
  * **no cost when off**: the module-level default tracer is a
    ``NullTracer`` whose ``span``/``instant``/``count`` are constant
    no-ops.  Tracing is host bookkeeping between device waits: it never
    changes which kernels launch, at which plans, or how often
    (``tests/test_torch_obs.py`` holds this).

Export (Perfetto JSON / JSONL), per-bucket aggregation into the
profiler's ``TraceStore`` and drift detection live in ``obs.export``,
``obs.feedback`` and ``obs.drift``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Iterator, Optional

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
]

#: trace event schema version, part of the JSONL header (``obs.export``)
#: as ``profiler.store.TRACE_SCHEMA_VERSION`` is; the JAX package's value,
#: so each package reads the other's files.  Bump on record field changes:
#: old files are then refused wholesale.
OBS_SCHEMA_VERSION = 1

#: default ring-buffer capacity (finished spans kept before eviction).
DEFAULT_CAPACITY = 65536


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One finished span (or instant event, ``dur == 0.0``).

    Times are seconds on the owning tracer's clock.  ``attrs`` carries
    the structured payload — for serving spans, the bucket key and the
    executed plan values (``obs.feedback`` aggregates on them).

    Example::

        rec = tracer.spans()[0]
        print(rec.name, rec.dur, rec.attrs.get("bucket"))
    """

    name: str
    t0: float
    dur: float
    attrs: dict
    sid: int
    parent: Optional[int]
    tid: int

    @property
    def t1(self) -> float:
        """End timestamp (``t0 + dur``)."""
        return self.t0 + self.dur

    def as_dict(self) -> dict:
        """Plain-dict form (the JSONL record body)."""
        return {"name": self.name, "t0": self.t0, "dur": self.dur,
                "attrs": dict(self.attrs), "sid": self.sid,
                "parent": self.parent, "tid": self.tid}

    @classmethod
    def from_dict(cls, d: dict) -> "SpanRecord":
        """Rebuild a record from its JSONL form."""
        return cls(name=str(d["name"]), t0=float(d["t0"]),
                   dur=float(d["dur"]), attrs=dict(d.get("attrs") or {}),
                   sid=int(d.get("sid", 0)),
                   parent=(None if d.get("parent") is None
                           else int(d["parent"])),
                   tid=int(d.get("tid", 0)))


class Span:
    """A live span handle — context manager returned by ``Tracer.span``.

    Attributes set at open time or via ``set`` land in the finished
    ``SpanRecord``; the record is appended to the tracer's ring on exit.

    Example::

        with tracer.span("decode_tick", bucket=256) as sp:
            ...
            sp.set(live=3)
    """

    __slots__ = ("_tracer", "name", "attrs", "t0", "sid", "parent", "tid")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.sid = 0
        self.parent: Optional[int] = None
        self.tid = 0

    def set(self, **attrs: Any) -> "Span":
        """Attach/overwrite attributes on the open span (returns self)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._tracer._open(self)
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._close(self)
        return False


class _NullSpan:
    """The shared no-op span: enter/exit/set all do nothing."""

    __slots__ = ()

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Span / counter / gauge collector with a bounded ring buffer.

    ``clock`` is injectable (seconds, monotonic); ``meta`` is a free
    dict of run-level context the exporters embed in the trace header —
    the serve engine fills it with the model geometry (``head_dim``,
    ``layers``, page geometry, hardware name) that ``obs.feedback`` and
    ``obs.drift`` need to rebuild kernel workload descriptions offline.

    Example::

        tracer = Tracer()
        with tracer.span("decode_tick", bucket=128, decode_block=256):
            step()
        tracer.count("tokens", 4)
        print(len(tracer.spans()), tracer.counters())
    """

    enabled = True

    def __init__(self, *, clock: Optional[Callable[[], float]] = None,
                 capacity: int = DEFAULT_CAPACITY,
                 meta: Optional[dict] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.clock = clock if clock is not None else time.perf_counter
        self.meta: dict = dict(meta or {})
        self._lock = threading.Lock()
        self._ring: collections.deque[SpanRecord] = \
            collections.deque(maxlen=capacity)
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._local = threading.local()
        self._next_sid = 0
        self._next_tid = 0

    # -- span plumbing ----------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
            with self._lock:
                self._next_tid += 1
                self._local.tid = self._next_tid
        return st

    def _open(self, span: Span) -> None:
        st = self._stack()
        with self._lock:
            self._next_sid += 1
            span.sid = self._next_sid
        span.tid = self._local.tid
        span.parent = st[-1].sid if st else None
        st.append(span)
        span.t0 = self.clock()

    def _close(self, span: Span) -> None:
        t1 = self.clock()
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        rec = SpanRecord(name=span.name, t0=span.t0,
                         dur=max(0.0, t1 - span.t0),
                         attrs=span.attrs, sid=span.sid,
                         parent=span.parent, tid=span.tid)
        with self._lock:
            self._ring.append(rec)

    # -- public API -------------------------------------------------------

    def span(self, name: str, **attrs: Any) -> Span:
        """Open a timed span (use as a context manager).

        Example::

            with tracer.span("prefill", bucket=64) as sp:
                sp.set(tiles=(64, 128))
        """
        return Span(self, name, attrs)

    def instant(self, name: str, **attrs: Any) -> None:
        """Record a zero-duration point event (pool growth, recycle).

        Example::

            tracer.instant("pool_grow", kv_len=128)
        """
        st = self._stack()
        t = self.clock()
        with self._lock:
            self._next_sid += 1
            sid = self._next_sid
            self._ring.append(SpanRecord(
                name=name, t0=t, dur=0.0, attrs=attrs, sid=sid,
                parent=st[-1].sid if st else None, tid=self._local.tid))

    def count(self, name: str, n: float = 1) -> None:
        """Add ``n`` to a monotonic counter (thread-safe).

        Example::

            tracer.count("tokens_decoded", 4)
        """
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        """Set a last-value gauge (thread-safe).

        Example::

            tracer.gauge("live_slots", 3)
        """
        with self._lock:
            self._gauges[name] = value

    def counters(self) -> dict[str, float]:
        """Snapshot of all counters."""
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> dict[str, float]:
        """Snapshot of all gauges."""
        with self._lock:
            return dict(self._gauges)

    def spans(self) -> list[SpanRecord]:
        """Snapshot of finished spans, oldest first (ring order)."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        """Drop all finished spans, counters and gauges (keep ``meta``)."""
        with self._lock:
            self._ring.clear()
            self._counters.clear()
            self._gauges.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class NullTracer:
    """The disabled tracer: every operation is a constant no-op.

    Instrumented call sites write unconditionally against this
    interface — ``tracer.span(...)`` returns one shared null context
    manager — so no hot path ever branches on "is tracing on".

    Example::

        t = NullTracer()
        with t.span("anything", x=1):
            pass
        assert t.spans() == [] and not t.enabled
    """

    enabled = False

    @property
    def meta(self) -> dict:
        """Always a fresh empty dict (writes never stick)."""
        return {}

    def span(self, name: str, **attrs: Any) -> _NullSpan:
        """Return the shared no-op span."""
        return _NULL_SPAN

    def instant(self, name: str, **attrs: Any) -> None:
        """No-op."""

    def count(self, name: str, n: float = 1) -> None:
        """No-op."""

    def gauge(self, name: str, value: float) -> None:
        """No-op."""

    def counters(self) -> dict[str, float]:
        """Always empty."""
        return {}

    def gauges(self) -> dict[str, float]:
        """Always empty."""
        return {}

    def spans(self) -> list[SpanRecord]:
        """Always empty."""
        return []

    def clear(self) -> None:
        """No-op."""

    def __len__(self) -> int:
        return 0


#: the process-wide disabled tracer (identity matters: ``get_tracer()``
#: returning ``NULL_TRACER`` means "tracing is off").
NULL_TRACER = NullTracer()

_current: Any = NULL_TRACER


def get_tracer():
    """The ambient tracer (``NULL_TRACER`` unless one was installed).

    Instrumented modules that have no tracer handle of their own
    (``tuner.dispatch``) read this; the serve router installs its own
    tracer around cold resolutions so dispatch spans nest beneath them.

    Example::

        get_tracer().instant("checkpoint_saved", step=100)
    """
    return _current


def set_tracer(tracer: Optional[Any]) -> None:
    """Install ``tracer`` as the ambient tracer (``None`` resets to the
    null tracer).

    Example::

        set_tracer(Tracer())
    """
    global _current
    _current = tracer if tracer is not None else NULL_TRACER


@contextlib.contextmanager
def using_tracer(tracer: Any) -> Iterator[Any]:
    """Scope the ambient tracer to a block (always restores the prior).

    Example::

        with using_tracer(tracer):
            resolve_plan("vecadd", hw, "tuned", desc)
    """
    global _current
    prev = _current
    _current = tracer if tracer is not None else NULL_TRACER
    try:
        yield _current
    finally:
        _current = prev
