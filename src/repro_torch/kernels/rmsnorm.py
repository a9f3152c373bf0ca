"""Fused RMSNorm over ``(tokens, d)`` rows: ``x * rsqrt(mean x^2 + eps) *
gamma`` in float32, rounded once to x's dtype.

The CUDA kernel (``csrc/rmsnorm.cu``) replaces the JAX package's
``kernels/rmsnorm.py::_rmsnorm_kernel``.  Its launch — ``plan.lws`` rows
per warp, ``8 * plan.lws`` consecutive rows per CTA — comes from
``core.mapper.plan_rows`` under one of the mapping policies.  Inside a
warp, ``row_path`` picks how a row is read: 16-byte vectors staged in
shared memory by ``cp.async`` ("vector", x read from device memory
once), or scalars ("scalar": a pointer off a 16-byte boundary, a row of
bytes not a multiple of 16, or 8 rows and gamma past the device's
shared memory a block).

``rmsnorm_plain`` is the plain version over the plan's row blocks: the
rows are padded to whole CTA blocks, as the JAX kernel pads to whole
row blocks, and each block is normalised in float32.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.core.hw import detect, round_up
from repro_torch.core.mapper import BlockPlan
from repro_torch.kernels import _build
from repro_torch.kernels.vecadd import DTYPES

__all__ = ["rmsnorm", "rmsnorm_plain", "occupancy", "occupancy_for",
           "row_path"]

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
    + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_PATHS = {"scalar": 0, "vector": 1}
VEC_BYTES = 16
WARPS = 8                   # a CTA's warps: rows staged at once


def _rows_per_cta(plan: BlockPlan) -> int:
    return plan.threads // 32 * plan.lws


@functools.lru_cache(maxsize=None)
def _smem_per_block(device: torch.device) -> int:
    return detect(device).smem_per_block


def row_path(x: torch.Tensor, gamma: torch.Tensor) -> str:
    """How the kernel reads a row of ``x`` (tokens, d): "vector" where x
    and gamma sit on 16-byte boundaries, a row is whole 16-byte vectors
    and a CTA's 8 rows and gamma fit the shared memory a block of x's
    device may claim (``GpuParams.smem_per_block``); else "scalar"."""
    row_bytes = x.shape[-1] * x.element_size()
    vector = not (row_bytes % VEC_BYTES or x.data_ptr() % VEC_BYTES
                  or gamma.data_ptr() % VEC_BYTES)
    fits = (WARPS + 1) * row_bytes <= _smem_per_block(x.device)
    return "vector" if vector and fits else "scalar"


def rmsnorm_plain(x: torch.Tensor, gamma: torch.Tensor, *, eps: float,
                  plan: BlockPlan) -> torch.Tensor:
    tokens, d = x.shape
    rows = _rows_per_cta(plan)
    padded = round_up(max(tokens, 1), rows)
    xf = F.pad(x.float(), (0, 0, 0, padded - tokens)).view(-1, rows, d)
    rms = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    out = (xf * rms * gamma.float()).reshape(padded, d)[:tokens]
    return out.to(x.dtype)


def _check(x, gamma, plan):
    if x.dtype not in DTYPES:
        raise TypeError(f"rmsnorm takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or gamma.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm takes x (tokens, d) and gamma (d,), got "
                         f"{tuple(x.shape)} and {tuple(gamma.shape)}")
    if gamma.dtype != x.dtype or gamma.device != x.device \
            or not (x.is_contiguous() and gamma.is_contiguous()):
        raise ValueError("rmsnorm: x and gamma must be contiguous, of one "
                         "dtype and device")
    if plan.grid * _rows_per_cta(plan) < x.shape[0]:
        raise ValueError(f"rmsnorm: plan {plan} does not cover "
                         f"{x.shape[0]} rows")


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, *, eps: float = 1e-6,
            plan: BlockPlan) -> torch.Tensor:
    """x (tokens, d), gamma (d,).  CPU tensors (or
    ``kernels.force("plain")``) run the plain version; CUDA tensors launch
    the kernel on ``row_path(x, gamma)``, whose launch count is
    ``rmsnorm.launches``."""
    if kernels.use_plain(x):
        return rmsnorm_plain(x, gamma, eps=eps, plan=plan)
    _check(x, gamma, plan)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = _build.load("rmsnorm").rmsnorm
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(x.data_ptr(), gamma.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], plan.lws, plan.grid, float(eps), DTYPES[x.dtype],
            _PATHS[row_path(x, gamma)],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


def occupancy(x: torch.Tensor, gamma: torch.Tensor) -> int:
    """Resident CTAs per SM that the CUDA runtime reports for the kernel
    that ``rmsnorm(x, gamma)`` launches."""
    return occupancy_for(x.shape[-1], x.dtype, row_path(x, gamma))


def occupancy_for(d: int, dtype: torch.dtype, path: str) -> int:
    """Resident CTAs per SM that the CUDA runtime reports for the kernel
    of rows of ``d`` ``dtype`` values read on ``path`` ("vector" or
    "scalar")."""
    fn = _build.load("rmsnorm").rmsnorm_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    _build.check(fn(d, DTYPES[dtype], _PATHS[path], ctypes.byref(blocks)),
                 "rmsnorm_occupancy")
    return blocks.value
