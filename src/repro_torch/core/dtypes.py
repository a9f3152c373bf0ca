"""KV-cache dtype descriptors — one vocabulary for every layer.

A copy of the JAX package's ``core/dtypes.py`` (the port imports nothing
of it).  Every layer that asks "what does the KV pool store" routes
through this module:

  * ``KVDtypeSpec.name`` — canonical name (``"fp32"`` or ``"int8"``);
  * ``.dtype`` — the dtype *string* the cache arrays are allocated
    with, or ``None`` meaning "the model's compute dtype" (the fp32/
    default case: the pool stores whatever the model computes in);
  * ``.bytes`` — bytes per cache element, or ``None`` meaning "model
    dtype bytes";
  * ``.quantized`` — whether per-(block, head) scales ride alongside
    the block table.

``kv_dtype_spec`` accepts every historical spelling: ``None``,
``"default"``, ``"fp32"``, ``"float32"`` all mean the unquantized pool;
``"int8"`` means the symmetric per-block-scale pool.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["KVDtypeSpec", "KV_FP32", "KV_INT8", "KV_DTYPES",
           "kv_dtype_spec"]


@dataclasses.dataclass(frozen=True)
class KVDtypeSpec:
    """How the KV pool stores cache elements (see module docstring)."""

    name: str                       # canonical: "fp32" | "int8"
    dtype: Optional[str]            # allocation dtype; None = model dtype
    bytes: Optional[int]            # bytes/element; None = model dtype
    quantized: bool                 # per-(block, head) scales present


KV_FP32 = KVDtypeSpec(name="fp32", dtype=None, bytes=None, quantized=False)
KV_INT8 = KVDtypeSpec(name="int8", dtype="int8", bytes=1, quantized=True)

#: every accepted spelling -> descriptor (historical aliases included)
KV_DTYPES = {
    None: KV_FP32,
    "default": KV_FP32,
    "fp32": KV_FP32,
    "float32": KV_FP32,
    "int8": KV_INT8,
}


def kv_dtype_spec(name) -> KVDtypeSpec:
    """Resolve any accepted kv-dtype spelling to its descriptor."""
    if isinstance(name, KVDtypeSpec):
        return name
    try:
        return KV_DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown kv_dtype {name!r}: expected one of "
            f"{sorted(k for k in KV_DTYPES if isinstance(k, str))}"
        ) from None
