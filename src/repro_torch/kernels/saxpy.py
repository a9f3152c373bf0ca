"""saxpy — ``a * x + y`` over a 1-D vector.

The CUDA kernel (``csrc/saxpy.cu``) replaces the JAX package's
``kernels/saxpy.py::_saxpy_kernel``, with ``kernels/vecadd.py``'s
mapping (``core.mapper.plan_vector_blocks``) and vector design
(``csrc/vector_map.cuh``): ``vecadd.vector_steps`` 16-byte vectors a
thread where ``lws >= v`` and every operand starts on 16 bytes, else
``lws`` scalars.  The scalar ``a`` is rounded to x's dtype first, as
``saxpy_pallas`` does.

``saxpy_plain`` is the plain version, rounding where the JAX kernel's
arithmetic in x's dtype rounds and the CUDA kernel does: the product,
computed in float32, rounded to x's dtype, then the sum, computed in
float32, rounded to x's dtype (for float32 both roundings are float32's
own).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core.mapper import BlockPlan
from repro_torch.kernels import _build
from repro_torch.kernels.vecadd import DTYPES, check_vector_args, \
    vector_steps

__all__ = ["saxpy", "saxpy_plain", "occupancy"]

_ARGTYPES = [ctypes.c_float] + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _scalar(a, dtype: torch.dtype) -> float:
    """``a`` rounded to ``dtype`` (``a`` a number or a one-element
    tensor), as a Python float."""
    return torch.as_tensor(a).detach().to("cpu", dtype).reshape(()).item()


def saxpy_plain(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    ax = (_scalar(a, x.dtype) * x.float()).to(x.dtype)
    return (ax.float() + y.float()).to(x.dtype)


def saxpy(a, x: torch.Tensor, y: torch.Tensor, *,
          plan: BlockPlan) -> torch.Tensor:
    """``a * x + y``.  CPU tensors (or ``kernels.force("plain")``) run the
    plain version; CUDA tensors launch the kernel, whose launch count is
    ``saxpy.launches``."""
    if kernels.use_plain(x):
        return saxpy_plain(a, x, y)
    check_vector_args("saxpy", plan, x, y)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = _build.load("saxpy").saxpy
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(_scalar(a, x.dtype), x.data_ptr(), y.data_ptr(), out.data_ptr(),
            x.numel(), plan.lws, plan.grid, vector_steps(plan, x, y, out),
            DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "saxpy")
    saxpy.launches += 1
    return out


saxpy.launches = 0


def occupancy(dtype: torch.dtype, vector: bool) -> int:
    """Resident CTAs per SM that the CUDA runtime reports for the vector
    or the scalar kernel."""
    fn = _build.load("saxpy").saxpy_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    _build.check(fn(DTYPES[dtype], int(vector), ctypes.byref(blocks)),
                 "saxpy_occupancy")
    return blocks.value
