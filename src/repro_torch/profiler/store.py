"""Versioned, hardware-keyed JSONL store of kernel measurements.

The durable half of the observation loop: every ``Measurement`` taken by
``profiler.measure`` can be kept here and replayed by ``profiler.cost``
(``measure="cached"``) with no device work at all.

The default file lies in the checkout, beside the built kernels and the
tuning cache (``build/repro_torch/traces.jsonl``, git-ignored), so two
checkouts on one machine never share measurements;
``$REPRO_TORCH_TRACE_STORE`` names another file.

File format — line one is a header, every further line one record::

    {"version": 1, "kind": "repro-trace-store"}
    {"kernel": "vecadd", "hw_key": "...", "sig_key": "...", "value": 4096,
     "stats": {"median_s": ..., "iqr_s": ..., ...}, "programs": 16,
     "flops": ..., "hbm_bytes": ..., "created": ...}

Semantics mirror ``tuner/cache.py``:

  * a record's identity is ``hw_key :: sig_key :: value``: a time taken
    on one card is never served for another;
  * a version mismatch discards the file wholesale (no migration);
  * duplicate keys dedupe with newest ``created`` winning;
  * saves lock a ``.lock`` sidecar, merge with the on-disk state, and
    publish via atomic ``os.replace`` — concurrent sweepers both keep
    their records and a torn read cannot be observed;
  * unparseable lines are skipped, not fatal (a killed appender leaves a
    valid store).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
from typing import Any, Iterator, Optional

from repro_torch.profiler.measure import Measurement, record_key
from repro_torch.tuner.cache import file_lock

__all__ = [
    "TRACE_SCHEMA_VERSION",
    "StoreStats",
    "TraceStore",
    "default_store_path",
    "get_default_store",
    "set_default_store",
]

#: trace-store file format version (header line); bump on record changes.
TRACE_SCHEMA_VERSION = 1

_KIND = "repro-trace-store"       # the JAX package's header, one format


def default_store_path() -> str:
    """``$REPRO_TORCH_TRACE_STORE``, else ``traces.jsonl`` in the kernels'
    build directory (``kernels._build.build_dir()``)."""
    env = os.environ.get("REPRO_TORCH_TRACE_STORE")
    if env:
        return env
    from repro_torch.kernels._build import build_dir
    return str(build_dir() / "traces.jsonl")


@dataclasses.dataclass
class StoreStats:
    """Counters surfaced by ``TraceStore.stats`` (a warm dispatch leaves
    ``lookups`` and ``recorded`` untouched)."""

    recorded: int = 0        # measurements added this process
    dropped_stale: int = 0   # adds refused because an equal-or-newer
    #                          record already held the key
    lookups: int = 0
    hits: int = 0
    misses: int = 0
    saves: int = 0

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


class TraceStore:
    """In-memory dict of measurements + JSONL on disk.

    ``path=None`` keeps the store in memory only.
    ``autosave`` persists after every accepted ``add`` — a measurement
    costs orders of magnitude more than a save.
    """

    def __init__(self, path: Optional[str] = None, *, autosave: bool = True):
        self.path = path
        self.autosave = autosave and path is not None
        self.stats = StoreStats()
        self._mem: dict[str, Measurement] = {}
        if path is not None and os.path.exists(path):
            self._merge(self._read_disk())

    # -- keys --------------------------------------------------------------

    @staticmethod
    def full_key(hw_key: str, sig_key: str, value: Any) -> str:
        return record_key(hw_key, sig_key, value)

    # -- core --------------------------------------------------------------

    def add(self, m: Measurement) -> bool:
        """Insert one measurement; returns False when an equal-or-newer
        record already holds the key (dedupe, newest ``created`` wins)."""
        k = m.key
        mine = self._mem.get(k)
        if mine is not None and mine.created >= m.created:
            self.stats.dropped_stale += 1
            return False
        self._mem[k] = m
        self.stats.recorded += 1
        if self.autosave:
            self.save()
        return True

    def get(self, hw_key: str, sig_key: str, value: Any) -> Optional[Measurement]:
        self.stats.lookups += 1
        m = self._mem.get(self.full_key(hw_key, sig_key, value))
        if m is None:
            self.stats.misses += 1
        else:
            self.stats.hits += 1
        return m

    def lookup(self, hw_key: str, sig_key: str) -> list[Measurement]:
        """Every recorded decision value for one (hardware, workload)."""
        prefix = f"{hw_key}::{sig_key}::"
        return sorted((m for k, m in self._mem.items()
                       if k.startswith(prefix)), key=lambda m: str(m.key))

    def records(self) -> Iterator[Measurement]:
        yield from self._mem.values()

    def kernels(self) -> list[str]:
        return sorted({m.kernel for m in self._mem.values()})

    def __len__(self) -> int:
        return len(self._mem)

    def __contains__(self, key: str) -> bool:
        return key in self._mem

    def clear(self) -> None:
        self._mem.clear()

    # -- persistence -------------------------------------------------------

    def _read_disk(self) -> dict[str, Measurement]:
        """Records from ``self.path``; {} on missing/corrupt/version skew."""
        assert self.path is not None
        try:
            with open(self.path) as f:
                lines = f.read().splitlines()
        except OSError:
            return {}
        if not lines:
            return {}
        try:
            header = json.loads(lines[0])
        except json.JSONDecodeError:
            return {}
        if (not isinstance(header, dict)
                or header.get("kind") != _KIND
                or header.get("version") != TRACE_SCHEMA_VERSION):
            return {}
        out: dict[str, Measurement] = {}
        for line in lines[1:]:
            line = line.strip()
            if not line:
                continue
            try:
                m = Measurement.from_record(json.loads(line))
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                continue                      # torn/foreign line: skip
            mine = out.get(m.key)
            if mine is None or m.created > mine.created:
                out[m.key] = m
        return out

    def _merge(self, disk: dict[str, Measurement]) -> None:
        for k, m in disk.items():
            mine = self._mem.get(k)
            if mine is None or m.created > mine.created:
                self._mem[k] = m

    def save(self) -> None:
        """Merge-with-disk then atomically replace the JSONL file."""
        if self.path is None:
            return
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        with file_lock(self.path + ".lock"):
            self._merge(self._read_disk())
            fd, tmp = tempfile.mkstemp(prefix=".traces.", dir=d)
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(json.dumps({"version": TRACE_SCHEMA_VERSION,
                                        "kind": _KIND}) + "\n")
                    for k in sorted(self._mem):
                        f.write(json.dumps(self._mem[k].to_record(),
                                           sort_keys=True) + "\n")
                os.replace(tmp, self.path)
            except BaseException:
                with contextlib.suppress(OSError):
                    os.unlink(tmp)
                raise
        self.stats.saves += 1


# --------------------------------------------------------------------------- #
# Process-wide default (mirrors tuner.dispatch's default cache)
# --------------------------------------------------------------------------- #

_default_store: Optional[TraceStore] = None


def get_default_store() -> TraceStore:
    """Process-wide store, created lazily at the default path."""
    global _default_store
    if _default_store is None:
        _default_store = TraceStore(default_store_path())
    return _default_store


def set_default_store(store: Optional[TraceStore]) -> None:
    """Swap the process-wide store (None resets to lazy default)."""
    global _default_store
    _default_store = store
