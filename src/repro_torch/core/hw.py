"""Hardware parameter introspection — the micro-architecture side of Eq. 1.

The paper reads device properties (cores, warps, threads) at runtime and
resolves the kernel mapping from them.  On a CUDA GPU they map one to
one: ``hp = cores x warps x threads`` is streaming multiprocessors x
resident warps per SM x 32 lanes.  ``detect(device)`` reads them from
``torch.cuda.get_device_properties``; the registry keeps the published
H100 SXM figures (the rates used for roofline bounds and the launch
terms of the tuner's roofline, which the device properties do not
carry) and a small ``"cpu"`` stand-in under which the CPU tests plan.
``VortexParams`` is the paper's own hardware model (``<c>c<w>w<t>t``
Vortex configurations), on which the trace model ``core.tracesim``
runs.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["GpuParams", "GPU_REGISTRY", "VortexParams", "detect",
           "resolve_device", "ceil_div", "round_up"]


@dataclasses.dataclass(frozen=True)
class GpuParams:
    """Micro-architecture parameters of one GPU.

    Bandwidth is bytes/s, compute FLOP/s.  ``smem_per_block`` is the
    opt-in dynamic shared memory one block may claim, ``smem_per_sm``
    what an SM shares among its resident blocks (each also keeps 1 KB
    for the runtime).
    """

    name: str
    sm_count: int                    # "cores" in Eq. 1
    warps_per_sm: int                # resident warps per SM ("warps")
    warp_size: int = 32              # lanes per warp ("threads")
    smem_per_block: int = 232_448    # 227 KB opt-in on Hopper
    smem_per_sm: int = 233_472       # 228 KB on Hopper
    l2_bytes: int = 50 * 1024**2
    mem_bytes: int = 80 * 1024**3
    mem_bw: float = 3.35e12
    peak_flops_bf16: float = 989e12  # dense tensor-core rate
    peak_flops_fp32: float = 67e12   # CUDA-core rate (no tensor cores)
    peak_flops_tf32: float = 495e12  # dense tensor-core rate, TF32 inputs
    # the roofline's launch terms (``core.roofline``), measured on an
    # NVIDIA H100 80GB HBM3 at 700 W by ``tools/launch_probe.py`` (PERF.md
    # §6): one launch of an empty CTA (CUDA events), and the slope of
    # the time over 1 to 16 waves of empty 256-thread CTAs
    launch_s: float = 5.12e-6
    wave_s: float = 6.33e-7

    def hp(self) -> int:
        """Eq. 1's ``hp = cores x warps x threads`` on a GPU."""
        return self.sm_count * self.warps_per_sm * self.warp_size

    def peak_flops(self, dtype: torch.dtype) -> float:
        """Peak rate for arithmetic on inputs of ``dtype``."""
        return self.peak_flops_fp32 if dtype == torch.float32 \
            else self.peak_flops_bf16


@dataclasses.dataclass(frozen=True)
class VortexParams:
    """The paper's native hardware model: ``<c>c<w>w<t>t`` configurations
    (a copy of the JAX package's).

    Used by ``core.tracesim`` to reproduce the 450-configuration
    validation.  Bandwidth and overhead defaults are calibrated to
    reproduce the three execution regimes of the paper's Fig. 1.
    """

    cores: int
    warps: int
    threads: int
    # one instruction issued per core per cycle (in-order scalar issue)
    issue_width: int = 1
    # global memory bytes per cycle for the whole device
    mem_bw_bytes_per_cycle: float = 16.0
    # round-trip memory latency in cycles; hidden only by warp interleaving
    mem_latency: int = 200
    # cycles to set up and tear down one kernel call (runtime dispatch,
    # Fig. 1's "init"/"ret" sections between wavefronts), calibrated with
    # mem_latency so the 450-configuration sweep reproduces the paper's
    # aggregate claims (naive 1.3x, fixed 3.7x, ~20x tails)
    call_overhead_cycles: int = 192

    @property
    def hp(self) -> int:
        """Eq. 1: hardware parallelism."""
        return self.cores * self.warps * self.threads

    @property
    def tag(self) -> str:
        return f"{self.cores}c{self.warps}w{self.threads}t"


GPU_REGISTRY: dict[str, GpuParams] = {
    # NVIDIA H100 SXM data sheet figures (700 W part)
    "h100_sxm": GpuParams(name="h100_sxm", sm_count=132, warps_per_sm=64),
    # CPU stand-in so planning runs (and is tested) without a card; the
    # geometry is Hopper's, scaled to a few SMs
    "cpu": GpuParams(name="cpu", sm_count=8, warps_per_sm=64,
                     mem_bytes=8 * 1024**3, mem_bw=50e9,
                     peak_flops_bf16=1e12, peak_flops_fp32=1e12,
                     peak_flops_tf32=1e12),
}


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (every entry
    point's default) raises when no CUDA device is present instead of
    carrying on silently on the CPU; ``"cpu"`` runs the kernels' plain
    versions."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


def detect(device="cuda") -> GpuParams:
    """Runtime hardware introspection (paper §2: "evaluated at runtime
    based on the hardware properties").  A CUDA device is read from its
    properties; rates the properties do not carry (bandwidth, peak FLOP/s)
    come from the registry entry for the part.  The CPU gets the stand-in.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        return GPU_REGISTRY["cpu"]
    props = torch.cuda.get_device_properties(dev)
    base = GPU_REGISTRY["h100_sxm"]
    smem = getattr(props, "shared_memory_per_block_optin", None) or \
        props.shared_memory_per_multiprocessor - 1024
    return dataclasses.replace(
        base,
        name=props.name,
        sm_count=props.multi_processor_count,
        warps_per_sm=props.max_threads_per_multi_processor // props.warp_size,
        warp_size=props.warp_size,
        smem_per_block=int(smem),
        smem_per_sm=int(props.shared_memory_per_multiprocessor),
        l2_bytes=props.L2_cache_size,
        mem_bytes=props.total_memory,
    )


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, quantum: int) -> int:
    return ceil_div(x, quantum) * quantum
