"""Build and load the port's CUDA C++ kernels (``src/repro_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use by ``nvcc`` into its own shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so \\
         csrc/<name>.cu

Build directory: ``build/repro_torch/`` at the repository root (listed
in ``.gitignore``), or ``$REPRO_TORCH_BUILD_DIR`` when set.  Rebuild
rule: the library's file name carries the first 16 hex digits of the
SHA-256 of its source and of every header in ``csrc/`` (``*.cuh``,
e.g. the decode sweep both decode kernels include), so a library is
rebuilt exactly when its source or a header changed, and a stale one is
never loaded.  ``nvcc``'s ``-Xptxas -v``
report (registers, shared memory, spills) is kept beside the library as
``<name>-<hash>.log``.  A failed build raises with the compiler's output;
nothing here catches it.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on a non-zero code, because a refused launch (too many
threads, too much shared memory) never runs and no later synchronise
reports it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

__all__ = ["SOURCES", "CSRC", "NVCC_FLAGS", "nvcc", "build_dir", "build_all",
           "load", "check"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("paged_decode_attention", "flash_attention", "vecadd", "saxpy",
           "rmsnorm", "stencil", "nn_search", "gcn_agg", "decode_attention",
           "paged_gather", "ssd", "matmul_tc", "matmul_tf32x3")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    """The path of ``nvcc``; raises where the CUDA toolkit is missing."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return build_dir() / f"{name}-{digest}.so"


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every stale library at once, one ``nvcc`` per source, all
    started together.  Returns seconds per source (0.0 when current)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        log = open(so.with_suffix(".log"), "w")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), tmp, so, log)
    secs = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, so, log) in procs.items():
        rc = proc.wait()
        log.close()
        secs[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append((name, so.with_suffix(".log").read_text()))
            continue
        os.replace(tmp, so)              # atomic: a half-written .so never loads
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n} ---\n{text}" for n, text in failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first when
    its source changed."""
    lib = _libs.get(name)
    if lib is None:
        so = _target(name)
        if not so.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
    return lib


def ptxas_report(name: str) -> str:
    """``nvcc -Xptxas -v`` output of the current build of ``name``."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
