"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every wrapper takes the plain version for a CPU tensor and launches its
CUDA kernel for a CUDA tensor (or raises).  ``force("plain")`` is the one
explicit, scoped switch that runs the plain versions on the card too —
the counterpart of the JAX package's ``ops.force("ref")``.  The tests and
``chip_smoke.py`` use it to hold each kernel against its plain version;
nothing on the serving path sets it.

    with kernels.force("plain"):
        out = paged_decode_attention(q, kc, vc, tables, clen, ...)
"""

from __future__ import annotations

import contextlib

__all__ = ["force", "use_plain"]

_MODES = ("kernel", "plain")
_mode = "kernel"


@contextlib.contextmanager
def force(mode: str):
    """Run every wrapper in ``mode`` ("plain" or "kernel") inside the
    block, restoring the previous mode on exit."""
    global _mode
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    prev, _mode = _mode, mode
    try:
        yield
    finally:
        _mode = prev


def use_plain(t) -> bool:
    """True when a wrapper given tensor ``t`` must run its plain version:
    ``t`` lies on the CPU, or ``force("plain")`` is in effect."""
    return t.device.type == "cpu" or _mode == "plain"
