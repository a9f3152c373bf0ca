"""Persistent, hardware-keyed store of refined kernel mappings.

Two layers, one namespace:

  * an in-memory LRU (``capacity`` entries, a get refreshes the order)
    that serves warm dispatches with a dict lookup;
  * an optional JSON file, so a refinement survives the process: the
    paper's runtime analysis amortised across runs.

The default file lies in the checkout, beside the built kernels
(``build/repro_torch/tuning_cache.json``, git-ignored), not in the home
directory: two checkouts on one machine never replay each other's
decisions.  ``$REPRO_TORCH_TUNER_CACHE`` names another file; deleting
the file starts from an empty cache.

File format (the JAX package's)::

    {"version": <SCHEMA_VERSION>, "entries": {"<hw_key>::<sig_key>": {
        "plan": {...},             # tuned decision variables only
        "cost": 1.2e-5,            # model cost of the winner (or null)
        "seed_cost": 1.9e-5,       # model cost of the Eq. 1 seed
        "probes": 7,               # refine probes spent finding it
        "refine_time_s": 0.003,
        "created": 1700000000.0
    }, ...}}

A version mismatch discards the whole file (no migration).  Concurrent
writers are safe: a save takes an ``fcntl`` lock on a sidecar ``.lock``
file, merges the entries on disk with those in memory (the newest
``created`` wins), and publishes by an atomic ``os.replace``, so no torn
read is ever seen and two processes refining different workloads both
keep their results.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
from collections import OrderedDict
from typing import Any, Optional, Union

from repro_torch.tuner.signature import SCHEMA_VERSION, WorkloadSignature

__all__ = ["CacheStats", "TuningCache", "default_cache_path", "file_lock"]


def default_cache_path() -> str:
    """``$REPRO_TORCH_TUNER_CACHE``, else ``tuning_cache.json`` in the
    kernels' build directory (``kernels._build.build_dir()``: the
    checkout's ``build/repro_torch/``).

    Example::

        cache = TuningCache(default_cache_path())
    """
    env = os.environ.get("REPRO_TORCH_TUNER_CACHE")
    if env:
        return env
    from repro_torch.kernels._build import build_dir
    return str(build_dir() / "tuning_cache.json")


@dataclasses.dataclass
class CacheStats:
    """Counters surfaced by ``TuningCache.stats``.

    Example::

        >>> CacheStats(hits=3, misses=1).hit_rate
        0.75
    """

    hits: int = 0
    misses: int = 0
    puts: int = 0
    evictions: int = 0
    refine_probes: int = 0
    refine_time_s: float = 0.0

    @property
    def hit_rate(self) -> float:
        """hits / (hits + misses); 0.0 before any lookup."""
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def as_dict(self) -> dict[str, Any]:
        """Plain-dict form including the derived ``hit_rate``."""
        return dict(dataclasses.asdict(self), hit_rate=self.hit_rate)


def _sig_key(sig: Union[WorkloadSignature, str]) -> str:
    return sig.key if isinstance(sig, WorkloadSignature) else str(sig)


@contextlib.contextmanager
def file_lock(path: str):
    """Advisory lock around load-merge-replace; no-op where fcntl is
    unavailable (the atomic replace still prevents torn reads).  Shared
    with ``profiler.store``, which persists with the same semantics.

    The ``.lock`` sidecar is removed on release so saves don't litter
    zero-byte files next to every store.  Removal is safe against the
    unlink/reopen race: the holder re-checks (by inode) that the file it
    locked is still the file at ``path`` — a waiter that locked a
    just-unlinked sidecar retries on a fresh one."""
    try:
        import fcntl
    except ImportError:          # non-POSIX: rely on os.replace atomicity
        yield
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    while True:
        f = open(path, "a")
        try:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                if os.stat(path).st_ino != os.fstat(f.fileno()).st_ino:
                    continue     # holder unlinked it under us: retry
            except FileNotFoundError:
                continue
            try:
                yield
            finally:
                # unlink BEFORE unlock: the name disappears while we
                # still hold the lock, so no new waiter can lock the
                # doomed inode after we let go
                with contextlib.suppress(FileNotFoundError):
                    os.unlink(path)
                fcntl.flock(f, fcntl.LOCK_UN)
            return
        finally:
            f.close()


class TuningCache:
    """In-memory LRU + JSON-on-disk store of refined plans.

    ``path=None`` keeps the cache memory-only (tests, throwaway runs).
    ``autosave`` persists after every ``put`` — refinement is orders of
    magnitude more expensive than a save, so the write is noise.

    Example::

        cache = TuningCache(path=None)          # memory-only (tests)
        cache.put(hw_key, sig, {"block": 256}, probes=4)
        entry = cache.get(hw_key, sig)          # {"plan": ..., ...}
    """

    def __init__(self, path: Optional[str] = None, *, capacity: int = 4096,
                 autosave: bool = True):
        self.path = path
        self.capacity = max(1, capacity)
        self.autosave = autosave and path is not None
        self.stats = CacheStats()
        self._mem: OrderedDict[str, dict] = OrderedDict()
        if path is not None and os.path.exists(path):
            self._merge(self._read_disk())

    # -- keys --------------------------------------------------------------

    @staticmethod
    def full_key(hw_key: str, sig: Union[WorkloadSignature, str]) -> str:
        """The on-disk/in-memory key: ``<hardware_key>::<sig.key>``."""
        return f"{hw_key}::{_sig_key(sig)}"

    # -- core --------------------------------------------------------------

    def get(self, hw_key: str,
            sig: Union[WorkloadSignature, str]) -> Optional[dict]:
        """Return the cached entry dict (not just the plan) or None."""
        return self.get_by_key(self.full_key(hw_key, sig))

    def get_by_key(self, full_key: str) -> Optional[dict]:
        """``get`` with a key the caller built: the warm dispatch path
        (dispatch memoises the key string)."""
        entry = self._mem.get(full_key)
        if entry is None:
            self.stats.misses += 1
            return None
        self._mem.move_to_end(full_key)
        self.stats.hits += 1
        return entry

    def put(self, hw_key: str, sig: Union[WorkloadSignature, str],
            plan: dict, *, cost: Optional[float] = None,
            seed_cost: Optional[float] = None, probes: int = 0,
            refine_time_s: float = 0.0,
            extra: Optional[dict] = None) -> dict:
        """Memoize a refined plan (+ provenance riders via ``extra``);
        evicts LRU past ``capacity`` and autosaves when configured."""
        k = self.full_key(hw_key, sig)
        entry = {
            "plan": dict(plan),
            "cost": cost,
            "seed_cost": seed_cost,
            "probes": int(probes),
            "refine_time_s": float(refine_time_s),
            "created": time.time(),
        }
        if extra:
            # provenance riders (e.g. the profiler's measured=True flag);
            # the reserved fields above always win on a name clash
            entry = {**dict(extra), **entry}
        self._mem[k] = entry
        self._mem.move_to_end(k)
        self.stats.puts += 1
        self.stats.refine_probes += int(probes)
        self.stats.refine_time_s += float(refine_time_s)
        while len(self._mem) > self.capacity:
            self._mem.popitem(last=False)
            self.stats.evictions += 1
        if self.autosave:
            self.save()
        return entry

    def clear(self) -> None:
        """Drop every in-memory entry (the disk file is untouched)."""
        self._mem.clear()

    def __len__(self) -> int:
        return len(self._mem)

    def __contains__(self, key: str) -> bool:
        return key in self._mem

    # -- persistence -------------------------------------------------------

    def _read_disk(self) -> dict[str, dict]:
        """Entries from ``self.path``; {} on missing/corrupt/version skew."""
        assert self.path is not None
        try:
            with open(self.path) as f:
                blob = json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}
        if not isinstance(blob, dict) or blob.get("version") != SCHEMA_VERSION:
            return {}
        entries = blob.get("entries", {})
        return entries if isinstance(entries, dict) else {}

    def _merge(self, disk: dict[str, dict]) -> None:
        """Fold disk entries in; on collision the newest ``created`` wins."""
        for k, v in disk.items():
            mine = self._mem.get(k)
            if mine is None or v.get("created", 0) > mine.get("created", 0):
                self._mem[k] = v
        while len(self._mem) > self.capacity:
            self._mem.popitem(last=False)
            self.stats.evictions += 1

    def save(self) -> None:
        """Merge-with-disk then atomically replace the cache file."""
        if self.path is None:
            return
        d = os.path.dirname(self.path) or "."
        os.makedirs(d, exist_ok=True)
        with file_lock(self.path + ".lock"):
            self._merge(self._read_disk())
            blob = {"version": SCHEMA_VERSION, "entries": dict(self._mem)}
            fd, tmp = tempfile.mkstemp(prefix=".tuning_cache.", dir=d)
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(blob, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except BaseException:
                with contextlib.suppress(OSError):
                    os.unlink(tmp)
                raise
