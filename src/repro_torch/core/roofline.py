"""The per-kernel roofline the tuner's cost models are built from.

One definition over ``GpuParams``, so every registered kernel's cost
(``repro_torch.tuner.dispatch``) reads the same rates and the same two
launch terms: the launch's fixed time (``GpuParams.launch_s``) and the
time of each wave of CTAs (``GpuParams.wave_s``), a wave being
``SMs x resident CTAs an SM`` CTAs.  Both constants were measured on
the card by ``tools/launch_probe.py`` (``PERF.md`` §6).  The JAX
package's model of a whole training step (HLO costs, collectives) waits
for the training stack's port.
"""

from __future__ import annotations

from repro_torch.core.hw import GpuParams, ceil_div

__all__ = ["kernel_roofline_seconds", "waves"]


def waves(ctas: int, ctas_per_sm: int, hw: GpuParams) -> int:
    """Waves of ``ctas`` CTAs at ``ctas_per_sm`` resident on each SM."""
    return ceil_div(max(1, int(ctas)), hw.sm_count * max(1, int(ctas_per_sm)))


def kernel_roofline_seconds(flops: float, byts: float, ctas: int,
                            hw: GpuParams, *, rate: float,
                            ctas_per_sm: int) -> float:
    """``max(flops / rate, bytes / mem_bw) / busy + launch_s + waves x
    wave_s``.

    ``rate`` is the route's peak (the bf16 or TF32 tensor cores, or the
    CUDA cores), ``ctas_per_sm`` the kernel's residency (the CUDA
    runtime's occupancy query on the card, the plan's estimate
    elsewhere).
    ``busy`` is the share of the resident-CTA slots the launch fills
    over its waves, ``ctas / (waves x SMs x ctas_per_sm)``: a partial
    wave, the last of several or a single one, costs the time of a
    whole one.

    Example::

        >>> from repro_torch.core.hw import GPU_REGISTRY
        >>> h = GPU_REGISTRY["h100_sxm"]
        >>> t = kernel_roofline_seconds(0, 3.35e9, 1056, h, rate=67e12,
        ...                             ctas_per_sm=8)
        >>> round((t - h.launch_s - h.wave_s) * 1e3, 6)
        1.0
    """
    slots = hw.sm_count * max(1, int(ctas_per_sm))
    ctas = max(1, int(ctas))
    n = waves(ctas, ctas_per_sm, hw)
    busy = ctas / (n * slots)
    t = max(flops / rate, byts / hw.mem_bw)
    return t / busy + hw.launch_s + n * hw.wave_s
