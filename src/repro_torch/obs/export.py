"""Trace export/import: Perfetto (Chrome trace) JSON and JSONL logs.

Two on-disk forms, picked by extension in ``write_trace``:

  * ``*.json`` — Chrome trace-event format (open in Perfetto UI or
    ``chrome://tracing``): spans become ``ph:"X"`` complete events,
    instants ``ph:"i"``, counters/gauges ``ph:"C"`` counter samples.
    Span attributes ride in ``args`` so the bucket key and executed
    plan are visible in the UI's detail pane.
  * anything else (``*.jsonl`` by convention) — the repo's native
    versioned JSONL log, same header/atomic-replace discipline as
    ``profiler/store.py`` and the JAX package's format (each package
    loads the other's files): line one is
    ``{"version": 1, "kind": "repro-obs-trace", "meta": {...}}``,
    every further line one span/counter/gauge record.  ``load_trace``
    round-trips it (and also reads the Chrome form back).

Example::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --requests 8 --trace serve.json     # then open in ui.perfetto.dev
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Any

from repro_torch.obs.trace import OBS_SCHEMA_VERSION, SpanRecord, Tracer
from repro_torch.tuner.cache import file_lock

__all__ = [
    "chrome_trace",
    "write_trace",
    "load_trace",
]

_KIND = "repro-obs-trace"


def _jsonable(v: Any) -> Any:
    """Best-effort conversion of attr values to JSON-safe types."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


def chrome_trace(tracer: Tracer) -> dict:
    """Render a tracer's contents as a Chrome trace-event dict.

    Spans map to ``ph:"X"`` (ts/dur in microseconds), instants to
    ``ph:"i"``, counters and gauges to one ``ph:"C"`` sample each at
    the trace end.  ``tracer.meta`` lands under ``otherData``.

    Example::

        doc = chrome_trace(tracer)
        json.dump(doc, open("trace.json", "w"))
    """
    events: list[dict] = []
    spans = tracer.spans()
    t_end = max((s.t1 for s in spans), default=0.0)
    for s in spans:
        ev = {"name": s.name, "pid": 1, "tid": s.tid,
              "ts": s.t0 * 1e6, "args": _jsonable(s.attrs)}
        if s.dur > 0.0:
            ev.update(ph="X", dur=s.dur * 1e6)
        else:
            ev.update(ph="i", s="t")
        events.append(ev)
    for name, val in sorted(tracer.counters().items()):
        events.append({"name": name, "ph": "C", "pid": 1, "tid": 0,
                       "ts": t_end * 1e6, "args": {name: val}})
    for name, val in sorted(tracer.gauges().items()):
        events.append({"name": name, "ph": "C", "pid": 1, "tid": 0,
                       "ts": t_end * 1e6, "args": {name: val}})
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": _jsonable(dict(tracer.meta))}


def _jsonl_lines(tracer: Tracer) -> list[str]:
    header = {"version": OBS_SCHEMA_VERSION, "kind": _KIND,
              "meta": _jsonable(dict(tracer.meta))}
    lines = [json.dumps(header, sort_keys=True)]
    for s in tracer.spans():
        rec = s.as_dict()
        rec["attrs"] = _jsonable(rec["attrs"])
        lines.append(json.dumps({"type": "span", **rec}, sort_keys=True))
    for name, val in sorted(tracer.counters().items()):
        lines.append(json.dumps({"type": "counter", "name": name,
                                 "value": val}, sort_keys=True))
    for name, val in sorted(tracer.gauges().items()):
        lines.append(json.dumps({"type": "gauge", "name": name,
                                 "value": val}, sort_keys=True))
    return lines


def write_trace(tracer: Tracer, path: str) -> str:
    """Write the tracer's contents to ``path`` and return the path.

    ``*.json`` gets the Chrome/Perfetto form, anything else the native
    JSONL log.  Both publish via lock + tempfile + ``os.replace`` —
    the same discipline as ``TraceStore.save`` — so a reader never
    observes a torn file.

    Example::

        write_trace(tracer, "serve-trace.json")
    """
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    if path.endswith(".json"):
        payload = json.dumps(chrome_trace(tracer), sort_keys=True)
    else:
        payload = "\n".join(_jsonl_lines(tracer)) + "\n"
    with file_lock(path + ".lock"):
        fd, tmp = tempfile.mkstemp(prefix=".obs-trace.", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            os.replace(tmp, path)
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise
    return path


def _load_chrome(doc: dict) -> Tracer:
    tracer = Tracer(meta=dict(doc.get("otherData") or {}))
    sid = 0
    for ev in doc.get("traceEvents", []):
        ph = ev.get("ph")
        name = str(ev.get("name", ""))
        args = dict(ev.get("args") or {})
        if ph == "X":
            sid += 1
            tracer._ring.append(SpanRecord(
                name=name, t0=float(ev.get("ts", 0.0)) / 1e6,
                dur=float(ev.get("dur", 0.0)) / 1e6, attrs=args,
                sid=sid, parent=None, tid=int(ev.get("tid", 0))))
        elif ph == "i":
            sid += 1
            tracer._ring.append(SpanRecord(
                name=name, t0=float(ev.get("ts", 0.0)) / 1e6, dur=0.0,
                attrs=args, sid=sid, parent=None,
                tid=int(ev.get("tid", 0))))
        elif ph == "C":
            for k, v in args.items():
                tracer._gauges[str(k)] = float(v)
    return tracer


def load_trace(path: str) -> Tracer:
    """Read a trace file (either form) back into an offline ``Tracer``.

    Used by ``tools/trace_view_torch.py`` and the feedback/drift analyses:
    the returned tracer holds the spans, counters/gauges, and ``meta``
    of the original run.  Raises ``ValueError`` on a JSONL header with
    the wrong kind or version (no migration, mirroring the profiler
    store); unparseable JSONL body lines are skipped, not fatal.

    Example::

        tracer = load_trace("serve-trace.jsonl")
        print(len(tracer.spans()), tracer.meta.get("arch"))
    """
    with open(path) as f:
        text = f.read()
    if text.lstrip().startswith("{"):
        # a whole-file JSON object is the Chrome form; JSONL parses line
        # by line (its header alone is also a JSON object, so dispatch
        # on the traceEvents key, not on parseability)
        try:
            doc = json.loads(text)
        except json.JSONDecodeError:
            doc = None
        if isinstance(doc, dict) and "traceEvents" in doc:
            return _load_chrome(doc)
    lines = text.splitlines()
    if not lines:
        raise ValueError(f"{path}: empty trace file")
    try:
        header = json.loads(lines[0])
    except json.JSONDecodeError as e:
        raise ValueError(f"{path}: bad trace header: {e}") from None
    if not isinstance(header, dict) or header.get("kind") != _KIND:
        raise ValueError(f"{path}: not a {_KIND} file")
    if header.get("version") != OBS_SCHEMA_VERSION:
        raise ValueError(
            f"{path}: version {header.get('version')!r} != "
            f"{OBS_SCHEMA_VERSION} (no migration)")
    tracer = Tracer(meta=dict(header.get("meta") or {}))
    for line in lines[1:]:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
            kind = rec.get("type")
            if kind == "span":
                tracer._ring.append(SpanRecord.from_dict(rec))
            elif kind == "counter":
                tracer._counters[str(rec["name"])] = float(rec["value"])
            elif kind == "gauge":
                tracer._gauges[str(rec["name"])] = float(rec["value"])
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            continue                          # torn line: skip, not fatal
    return tracer
