"""Tiled matmul ``C[m,n] = A[m,k] @ B[k,n]`` with a float32 accumulator.

The CUDA kernel (``csrc/matmul.cu``) replaces the JAX package's
``kernels/matmul.py::_matmul_kernel``.  Its launch — a ``tm x tn``
register micro-tile per thread (``lws = tm * tn`` outputs), a
``(16 tm) x (16 tn)`` output tile per CTA, K swept in ``bk`` steps —
comes from ``core.mapper.plan_matmul_blocks`` under one of the mapping
policies.

``matmul_plain`` is the plain version on the plan's K steps: float32
partial products over ``bk``-wide chunks of K, accumulated in float32
in order, rounded once to ``out_dtype`` (default: a's dtype).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core.mapper import MatmulPlan
from repro_torch.kernels import _build
from repro_torch.kernels.vecadd import DTYPES

__all__ = ["matmul", "matmul_plain", "occupancy"]

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *, plan: MatmulPlan,
                 out_dtype=None) -> torch.Tensor:
    m, k = a.shape
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, plan.bk):
        acc += a[:, k0:k0 + plan.bk].float() @ b[k0:k0 + plan.bk].float()
    return acc.to(out_dtype or a.dtype)


def _check(a, b, plan, out_dtype):
    if a.dtype not in DTYPES or out_dtype not in DTYPES:
        raise TypeError(f"matmul takes and returns float32 or bfloat16, got "
                        f"{a.dtype} -> {out_dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul takes A (m, k) and B (k, n), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if b.dtype != a.dtype or b.device != a.device \
            or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul: A and B must be contiguous, of one dtype "
                         "and device")
    m, n = a.shape[0], b.shape[1]
    if plan.grid[0] * plan.bn < n or plan.grid[1] * plan.bm < m \
            or plan.grid[1] > 65535:
        raise ValueError(f"matmul: plan {plan} does not cover ({m}, {n}) "
                         f"within grid.y <= 65535")


def matmul(a: torch.Tensor, b: torch.Tensor, *, plan: MatmulPlan,
           out_dtype=None) -> torch.Tensor:
    """``a @ b``.  CPU tensors (or ``kernels.force("plain")``) run the
    plain version; CUDA tensors launch the kernel, whose launch count is
    ``matmul.launches``."""
    if kernels.use_plain(a):
        return matmul_plain(a, b, plan=plan, out_dtype=out_dtype)
    out_dtype = out_dtype or a.dtype
    _check(a, b, plan, out_dtype)
    m, k = a.shape
    n = b.shape[1]
    if k == 0:
        return torch.zeros((m, n), dtype=out_dtype, device=a.device)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    fn = _build.load("matmul").matmul
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, plan.tm,
            plan.tn, plan.bk, DTYPES[a.dtype], DTYPES[out_dtype],
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "matmul")
    matmul.launches += 1
    return out


matmul.launches = 0


def occupancy(plan: MatmulPlan, dtype: torch.dtype) -> int:
    """Resident CTAs per SM that the CUDA runtime reports for the plan's
    instantiation (its micro-tile's registers and its shared memory)."""
    fn = _build.load("matmul").matmul_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    _build.check(fn(plan.tm, plan.tn, plan.bk, DTYPES[dtype],
                    ctypes.byref(blocks)), "matmul_occupancy")
    return blocks.value
