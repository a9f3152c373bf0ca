"""Tiled matmul ``C[m,n] = A[m,k] @ B[k,n]`` with a float32 accumulator.

Two CUDA kernels replace the JAX package's
``kernels/matmul.py::_matmul_kernel``, and ``route`` picks one from the
operands' dtype, shape and alignment before anything is launched:

  * "tensor_core" (``csrc/matmul_tc.cu``): bfloat16 A and B that TMA can
    take — K and N multiples of 8 (16-byte row strides), both pointers
    16-byte aligned.  TMA stages, ``wgmma`` products, f32 accumulators;
    a ``bm x bn`` tile of ``bm / 64`` warpgroups.  Counted in
    ``matmul.tc_launches``.
  * "cuda_core" (``csrc/matmul.cu``): float32 operands and every other
    bfloat16 shape — a ``tm x tn`` register micro-tile per thread
    (``lws = tm * tn`` outputs), a ``(16 tm) x (16 tn)`` output tile per
    CTA, K swept in ``bk`` steps.  Counted in ``matmul.launches``.

``plan_for`` plans the launch of the operands' route under one of the
mapping policies (``core.mapper.plan_matmul_blocks`` with ``kernel=``
the route); the wrapper raises when the plan's kernel is not the
operands' route.

``matmul_plain`` is the plain version on the plan's K steps: float32
partial products over ``bk``-wide chunks of K, accumulated in float32
in order, rounded once to ``out_dtype`` (default: a's dtype).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core.hw import GpuParams
from repro_torch.core.mapper import MappingPolicy, MatmulPlan, \
    plan_matmul_blocks
from repro_torch.kernels import _build
from repro_torch.kernels.vecadd import DTYPES

__all__ = ["matmul", "matmul_plain", "occupancy", "plan_for", "route"]

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_TC_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                + [ctypes.c_void_p])


def route(a: torch.Tensor, b: torch.Tensor) -> str:
    """"tensor_core" for bfloat16 operands that TMA can take (2-D,
    contiguous, K and N multiples of 8, 16-byte-aligned pointers), else
    "cuda_core"."""
    if a.dtype == b.dtype == torch.bfloat16 and a.dim() == b.dim() == 2 \
            and a.is_contiguous() and b.is_contiguous() \
            and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0 \
            and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0:
        return "tensor_core"
    return "cuda_core"


def plan_for(a: torch.Tensor, b: torch.Tensor, hw: GpuParams,
             policy: MappingPolicy | str) -> MatmulPlan:
    """The plan of ``a @ b`` under ``policy``, for the kernel of the
    operands' ``route``."""
    return plan_matmul_blocks(a.shape[0], b.shape[1], a.shape[1], hw,
                              policy, kernel=route(a, b))


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
    if plan.kernel != route(a, b):
        raise ValueError(f"matmul: a {plan.kernel} plan for operands whose "
                         f"route is {route(a, b)}")
    m, n = a.shape[0], b.shape[1]
    if plan.grid[0] * plan.bn < n or plan.grid[1] * plan.bm < m \
            or plan.grid[1] > 65535:
        raise ValueError(f"matmul: plan {plan} does not cover ({m}, {n}) "
                         f"within grid.y <= 65535")


def matmul(a: torch.Tensor, b: torch.Tensor, *, plan: MatmulPlan,
           out_dtype=None) -> torch.Tensor:
    """``a @ b``.  CPU tensors (or ``kernels.force("plain")``) run the
    plain version; CUDA tensors launch the plan's kernel: the tensor-core
    kernel (counted in ``matmul.tc_launches``) or the CUDA-core kernel
    (``matmul.launches``)."""
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
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if plan.kernel == "tensor_core":
        fn = _build.load("matmul_tc").matmul_tc
        fn.argtypes, fn.restype = _TC_ARGTYPES, ctypes.c_int
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                plan.bm, plan.bn, plan.stages, DTYPES[out_dtype], stream)
        _build.check(rc, "matmul_tc")
        matmul.tc_launches += 1
        return out
    fn = _build.load("matmul").matmul
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, plan.tm,
            plan.tn, plan.bk, DTYPES[a.dtype], DTYPES[out_dtype], stream)
    _build.check(rc, "matmul")
    matmul.launches += 1
    return out


matmul.launches = 0
matmul.tc_launches = 0


def occupancy(plan: MatmulPlan, dtype: torch.dtype) -> int:
    """Resident CTAs per SM that the CUDA runtime reports for the plan's
    instantiation (its registers and its shared memory)."""
    blocks = ctypes.c_int(0)
    if plan.kernel == "tensor_core":
        fn = _build.load("matmul_tc").matmul_tc_occupancy
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _build.check(fn(plan.bm, plan.bn, plan.stages, ctypes.byref(blocks)),
                     "matmul_tc_occupancy")
        return blocks.value
    fn = _build.load("matmul").matmul_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(plan.tm, plan.tn, plan.bk, DTYPES[dtype],
                    ctypes.byref(blocks)), "matmul_occupancy")
    return blocks.value
