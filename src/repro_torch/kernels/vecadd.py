"""vecadd — ``x + y`` over a 1-D vector, the paper's Fig. 1 kernel.

The CUDA kernel (``csrc/vecadd.cu``, on ``csrc/vector_map.cuh``, which
``csrc/saxpy.cu`` shares) replaces the JAX package's
``kernels/vecadd.py::_vecadd_kernel``.  Its launch — ``plan.lws``
elements per thread over ``plan.grid`` CTAs of 256 threads — comes from
``core.mapper.plan_vector_blocks`` under one of the mapping policies
(``kernels.ops.vecadd`` resolves it).  ``vector_steps`` decides how a
thread takes its elements: as ``ceil(lws / v)`` 16-byte vectors of
``v`` elements (4 f32, 8 bf16) where ``lws >= v`` and every operand
starts on 16 bytes, else as ``lws`` scalars (NAIVE's one element a
thread).

``vecadd_plain`` is the plain version: the sum in float32, rounded once
to the inputs' dtype, which is what the kernel computes.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core.mapper import BlockPlan
from repro_torch.kernels import _build

__all__ = ["vecadd", "vecadd_plain", "occupancy", "check_vector_args",
           "vector_steps"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
VECTOR_BYTES = 16


def vecadd_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x.float() + y.float()).to(x.dtype)


def check_vector_args(name: str, plan: BlockPlan, *ts: torch.Tensor) -> None:
    """Raise on what the vector kernels do not take."""
    x = ts[0]
    if x.dtype not in DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 1:
        raise ValueError(f"{name} takes 1-D vectors, got {tuple(x.shape)}")
    for t in ts:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous vectors "
                             f"of one shape, dtype and device")
    if plan.grid * plan.threads * plan.lws < x.numel():
        raise ValueError(f"{name}: plan {plan} does not cover "
                         f"{x.numel()} elements")


def vector_steps(plan: BlockPlan, *ts: torch.Tensor) -> int:
    """The 16-byte vectors each thread of the kernel takes: ``ceil(lws /
    v)`` for ``v = 16 / element size`` when ``plan.lws >= v`` and every
    tensor of ``ts`` starts on 16 bytes; 0 when the kernel takes
    ``plan.lws`` scalars a thread instead.  Thread ``t`` of ``T = grid x
    256`` takes vectors ``t, t + T, ...`` below ``n // v``, and threads
    ``0 ... n % v - 1`` one element each of the tail."""
    v = VECTOR_BYTES // ts[0].element_size()
    if plan.lws < v or any(t.data_ptr() % VECTOR_BYTES for t in ts):
        return 0
    return -(-plan.lws // v)


def vecadd(x: torch.Tensor, y: torch.Tensor, *,
           plan: BlockPlan) -> torch.Tensor:
    """``x + y``.  CPU tensors (or ``kernels.force("plain")``) run the
    plain version; CUDA tensors launch the kernel, whose launch count is
    ``vecadd.launches``."""
    if kernels.use_plain(x):
        return vecadd_plain(x, y)
    check_vector_args("vecadd", plan, x, y)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = _build.load("vecadd").vecadd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(), plan.lws,
            plan.grid, vector_steps(plan, x, y, out), DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "vecadd")
    vecadd.launches += 1
    return out


vecadd.launches = 0


def occupancy(dtype: torch.dtype, vector: bool) -> int:
    """Resident CTAs per SM that the CUDA runtime reports for the vector
    or the scalar kernel."""
    fn = _build.load("vecadd").vecadd_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    _build.check(fn(DTYPES[dtype], int(vector), ctypes.byref(blocks)),
                 "vecadd_occupancy")
    return blocks.value
