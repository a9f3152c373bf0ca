"""Probe: the two launch terms of the tuner's roofline on one GPU.

    python3 tools/launch_probe.py

``core.roofline.kernel_roofline_seconds`` adds ``GpuParams.launch_s``
(the fixed time of one launch) and ``GpuParams.wave_s`` (the time each
wave of CTAs adds) to a kernel's bytes and operations.  This probe times
an empty kernel of 256-thread CTAs (``EMPTY_SRC`` below, built with
``_build``'s ``nvcc`` and flags into the port's build directory) with
``chip_smoke.Timer`` (CUDA events, L2 flushed, the host's enqueue
outside the events):

  * ``launch_s``: one CTA, the median over ``RUNS`` runs;
  * ``wave_s``: grids of k waves, k in ``WAVES``, a wave being SMs x the
    resident CTAs an SM that the CUDA runtime reports; the slope of the
    least-squares line through (k, time), whose intercept is printed
    beside it.

Prints one JSON line with both constants, each reading and the card's
name and power limit.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

THREADS = 256
RUNS = 101
WAVES = (1, 2, 3, 4, 6, 8, 12, 16)

EMPTY_SRC = r"""
#include <cuda_runtime.h>

// An empty CTA: the launch and the CTA's start and end, nothing else.
__global__ void __launch_bounds__(256) empty_kernel(int* sink) {
  if (sink != nullptr && threadIdx.x == 0) sink[blockIdx.x] = 0;
}

extern "C" int launch_empty(int grid, int threads, void* stream) {
  empty_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      nullptr);
  return (int)cudaGetLastError();
}

extern "C" int empty_occupancy(int threads, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, empty_kernel, threads, 0);
}
"""


def build():
    from repro_torch.kernels import _build

    out_dir = _build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(EMPTY_SRC.encode()).hexdigest()[:16]
    so = out_dir / f"launch_probe-{digest}.so"
    if not so.exists():
        src = out_dir / f"launch_probe-{digest}.cu"
        src.write_text(EMPTY_SRC)
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                        str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.launch_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.launch_empty.restype = ctypes.c_int
    lib.empty_occupancy.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.empty_occupancy.restype = ctypes.c_int
    return lib


def fit(xs, ys):
    """Least-squares (slope, intercept) of ys over xs."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
    return slope, my - slope * mx


def measure(device) -> dict:
    """Both constants on ``device``, in seconds, with their readings."""
    import chip_smoke as cs
    from repro_torch.kernels import _build

    lib = build()
    timer = cs.Timer(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    blocks = ctypes.c_int(0)
    _build.check(lib.empty_occupancy(THREADS, ctypes.byref(blocks)),
                 "empty_occupancy")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    wave = sms * blocks.value

    def launch(grid):
        return lambda: _build.check(lib.launch_empty(grid, THREADS, stream),
                                    "launch_empty")

    one_ms = timer.ms(launch(1), runs=RUNS, head_start=True)
    wave_ms = {k: timer.ms(launch(k * wave), runs=RUNS, head_start=True)
               for k in WAVES}
    slope, icpt = fit(list(wave_ms), list(wave_ms.values()))
    return {"launch_s": one_ms / 1e3, "wave_s": slope / 1e3,
            "wave_fit_intercept_s": icpt / 1e3,
            "one_cta_ms": one_ms,
            "wave_ms": {str(k): v for k, v in wave_ms.items()},
            "ctas_a_wave": wave, "resident_ctas_per_sm": blocks.value,
            "threads": THREADS, "runs": RUNS}


def main() -> int:
    if not torch.cuda.is_available():
        print("launch_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = {"probe": "launch", "card": cs.nvidia_smi(), **measure(device)}
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
