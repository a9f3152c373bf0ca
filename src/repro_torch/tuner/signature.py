"""Canonical workload signatures and hardware keys for the tuning cache.

The mapping decision is a pure function of (workload, hardware); to
memoise it both sides need stable string keys:

  * ``WorkloadSignature``: kernel name, shapes, dtypes, policy and the
    sorted extra statics (``causal=true``).  Descriptions of one logical
    workload (torch tensors, numpy arrays or shape tuples; torch, numpy
    or string dtypes; keywords in any order) give one key, and the same
    key as the JAX package's ``repro.tuner.signature`` renders: a torch
    dtype is written under its numpy name (``torch.bfloat16`` as
    ``"bfloat16"``, which ``np.dtype`` alone does not know).
  * ``hardware_key``: every ``GpuParams`` field, since any of them can
    reach a planner or a cost model (shared memory clamps tiles, the SM
    count sets waves, the launch terms weigh them), so a cache written
    on one card is never replayed on another.

``SCHEMA_VERSION`` is written into the cache file; a file of another
version is dropped whole (``tuner.cache``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.hw import GpuParams

__all__ = [
    "SCHEMA_VERSION",
    "WorkloadSignature",
    "workload_signature",
    "hardware_key",
]

#: version of the signature and plan encoding; part of the cache file.
SCHEMA_VERSION = 1


def _canon_shape(s: Any) -> tuple[int, ...]:
    """Accept an int, a shape sequence, or anything with ``.shape``."""
    if hasattr(s, "shape"):
        s = s.shape
    if isinstance(s, int):
        return (s,)
    return tuple(int(d) for d in s)


def _canon_dtype(d: Any) -> str:
    """Accept a torch or numpy dtype, a dtype name (``"bfloat16"``,
    ``"torch.float32"``), a numpy scalar type, or anything with
    ``.dtype``; return the numpy name."""
    if isinstance(d, torch.dtype):
        return str(d).rsplit(".", 1)[-1]
    if isinstance(d, str):
        name = d.rsplit(".", 1)[-1]
        try:
            return np.dtype(name).name
        except TypeError:            # bfloat16 without a numpy extension
            return name
    if isinstance(d, (np.dtype, type)):
        return np.dtype(d).name
    return _canon_dtype(d.dtype)     # tensors and arrays


def _canon_value(v: Any) -> str:
    """Stable scalar rendering for extras (bool before int: bool is int)."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return repr(v)
    if v is None:
        return "none"
    return str(v)


@dataclasses.dataclass(frozen=True)
class WorkloadSignature:
    """Canonical identity of one kernel invocation's static parameters.

    Example::

        >>> workload_signature("vecadd", shapes=[1024],
        ...                    dtypes=[torch.float32], policy="tuned").key
        'vecadd|1024|float32|tuned|'
    """

    kernel: str
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[str, ...]
    policy: str
    extras: tuple[tuple[str, str], ...] = ()

    @property
    def key(self) -> str:
        """The canonical string rendering (memoised; the cache key)."""
        cached = self.__dict__.get("_key")
        if cached is None:
            shp = ";".join("x".join(map(str, s)) for s in self.shapes)
            ext = ";".join(f"{k}={v}" for k, v in self.extras)
            cached = (f"{self.kernel}|{shp}|{','.join(self.dtypes)}"
                      f"|{self.policy}|{ext}")
            object.__setattr__(self, "_key", cached)  # frozen: memoise once
        return cached

    def __str__(self) -> str:
        return self.key

    def as_dict(self) -> dict:
        """JSON-able form; ``from_dict`` round-trips it exactly."""
        return {
            "kernel": self.kernel,
            "shapes": [list(s) for s in self.shapes],
            "dtypes": list(self.dtypes),
            "policy": self.policy,
            "extras": [list(kv) for kv in self.extras],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadSignature":
        """Inverse of ``as_dict``."""
        return cls(
            kernel=d["kernel"],
            shapes=tuple(tuple(int(x) for x in s) for s in d["shapes"]),
            dtypes=tuple(d["dtypes"]),
            policy=d["policy"],
            extras=tuple((k, v) for k, v in d["extras"]),
        )


def workload_signature(
    kernel: str,
    *,
    shapes: Sequence[Any],
    dtypes: Sequence[Any],
    policy: Any = "tuned",
    **extras: Any,
) -> WorkloadSignature:
    """Build a canonical signature: ``shapes`` entries may be ints,
    shape tuples or tensors; ``dtypes`` entries dtypes, names or tensors;
    ``policy`` a string or a ``MappingPolicy``; ``extras`` are sorted by
    name, so keyword order never matters.

    Example::

        sig = workload_signature("flash_attention",
                                 shapes=[(256, 64), (256, 64)],
                                 dtypes=[torch.bfloat16], causal=True)
    """
    pol = getattr(policy, "value", policy)
    return WorkloadSignature(
        kernel=kernel,
        shapes=tuple(_canon_shape(s) for s in shapes),
        dtypes=tuple(_canon_dtype(d) for d in dtypes),
        policy=str(pol),
        extras=tuple(sorted((k, _canon_value(v)) for k, v in extras.items())),
    )


@functools.lru_cache(maxsize=64)
def hardware_key(hw: GpuParams) -> str:
    """Every ``GpuParams`` field, rendered in field order; memoised
    (``GpuParams`` is frozen) since it sits on the warm dispatch path.

    Example::

        full_key = TuningCache.full_key(hardware_key(detect()), sig)
    """
    return "|".join(f"{f.name}={_canon_value(getattr(hw, f.name))}"
                    for f in dataclasses.fields(hw))
