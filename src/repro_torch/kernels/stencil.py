"""Separable Gaussian blur of an ``(h, w)`` image: a row pass along the
width, then a column pass along the height, zero ("same") padding.

The CUDA kernels (``csrc/stencil.cu``) replace the JAX package's
``kernels/stencil.py::_row_pass_kernel`` and ``::_col_pass_kernel``; each
pass has its own wrapper and launch count (``stencil_rows.launches``,
``stencil_cols.launches``).  Both passes take one launch from one
``core.mapper.plan_stencil`` plan (the tuner's
``dispatch.plan_for("gaussian_blur", img, ...)`` makes it for an image)
under one of the mapping policies: a CTA of 256 threads streams down
``plan.rows`` rows of a strip ``plan.tile_w`` columns wide, each thread
one 16-byte vector of each row (``plan.route`` "vector": 4 float32 or 8
bfloat16 columns) or one column ("scalar"), the next rows' loads in
flight while the current rows' taps run, through a ring of row slots in
shared memory whose size does not depend on ``lws``.  The vector route
needs the image on 16 bytes and its rows whole vectors; the wrappers
raise on a vector plan an image does not allow (``route``).  Both routes
give the same bits.

The plain versions compute what the JAX kernels compute: each pass sums
``tap * x`` over the taps in order in float32 and rounds once to the
image's dtype, so the column pass reads an intermediate rounded to the
image's dtype, as the JAX row pass writes an ``img.dtype`` output.  In
bfloat16 this differs from ``ref.gaussian_blur``, which keeps the
intermediate in float32; the port follows the Pallas kernels.  The
kernels repeat these roundings and are equal to the plain versions bit
for bit.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.core.hw import ceil_div
from repro_torch.core.mapper import STENCIL_VEC_BYTES, StencilPlan
from repro_torch.kernels import _build
from repro_torch.kernels.vecadd import DTYPES

__all__ = ["gaussian_kernel_1d", "gaussian_blur", "route",
           "stencil_rows", "stencil_cols", "stencil_rows_plain",
           "stencil_cols_plain", "occupancy"]

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def route(x: torch.Tensor, plan: StencilPlan) -> str:
    """The plan's route for ``x``: "vector" (16-byte vectors) or "scalar";
    raises where ``x`` does not allow a vector plan (off 16 bytes, or rows
    not whole vectors)."""
    if plan.route == "vector" and (
            x.data_ptr() % STENCIL_VEC_BYTES
            or (x.shape[1] * x.element_size()) % STENCIL_VEC_BYTES):
        raise ValueError(f"gaussian_blur: a vector plan for an image whose "
                         f"rows are not 16-byte vectors on 16 bytes "
                         f"(width {x.shape[1]}, {x.data_ptr() % 16} bytes "
                         f"off 16); plan for the image (tuner.dispatch.plan_for)")
    return plan.route


def gaussian_kernel_1d(ksize: int = 5, sigma: float = 1.0) -> torch.Tensor:
    """Normalised float32 taps on the host (``ref.gaussian_kernel_1d``)."""
    half = (ksize - 1) / 2.0
    x = torch.arange(ksize, dtype=torch.float32) - half
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _taps_on(taps: torch.Tensor, like: torch.Tensor) -> list[torch.Tensor]:
    t = taps.to(device=like.device, dtype=torch.float32)
    return [t[i] for i in range(t.numel())]


def stencil_rows_plain(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    half = (taps.numel() - 1) // 2
    w = x.shape[1]
    xp = F.pad(x.float(), (half, half))
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i, c in enumerate(_taps_on(taps, x)):
        acc = acc + c * xp[:, i:i + w]
    return acc.to(x.dtype)


def stencil_cols_plain(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    half = (taps.numel() - 1) // 2
    h = x.shape[0]
    xp = F.pad(x.float(), (0, 0, half, half))
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i, c in enumerate(_taps_on(taps, x)):
        acc = acc + c * xp[i:i + h]
    return acc.to(x.dtype)


def _check(x: torch.Tensor, taps: torch.Tensor, plan: StencilPlan) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"gaussian_blur takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"gaussian_blur takes a contiguous (h, w) image, "
                         f"got {tuple(x.shape)}")
    if taps.numel() != 2 * plan.halo + 1:
        raise ValueError(f"gaussian_blur: {taps.numel()} taps against the "
                         f"plan's halo {plan.halo}")
    if x.element_size() != plan.elem_bytes:
        raise ValueError(f"gaussian_blur: a plan for {plan.elem_bytes}-byte "
                         f"elements, got {x.dtype}")
    h, w = x.shape
    if x.numel() and plan.grid != ceil_div(h, plan.rows) \
            * ceil_div(w, plan.tile_w):
        raise ValueError(f"gaussian_blur: plan {plan} does not cover "
                         f"({h}, {w})")


def _launch(name: str, x: torch.Tensor, taps: torch.Tensor,
            plan: StencilPlan) -> torch.Tensor:
    _check(x, taps, plan)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    route(x, plan)
    fn = getattr(_build.load("stencil"), name)
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    host = (ctypes.c_float * taps.numel())(*taps.float().cpu().tolist())
    rc = fn(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], plan.rows,
            plan.vec, plan.grid, taps.numel(), host, DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, name)
    globals()[name].launches += 1
    return out


def stencil_rows(x: torch.Tensor, taps: torch.Tensor, *,
                 plan: StencilPlan) -> torch.Tensor:
    """The row pass.  CPU tensors (or ``kernels.force("plain")``) run the
    plain version; CUDA tensors launch the kernel, whose launch count is
    ``stencil_rows.launches``."""
    if kernels.use_plain(x):
        return stencil_rows_plain(x, taps)
    return _launch("stencil_rows", x, taps, plan)


def stencil_cols(x: torch.Tensor, taps: torch.Tensor, *,
                 plan: StencilPlan) -> torch.Tensor:
    """The column pass; as ``stencil_rows``."""
    if kernels.use_plain(x):
        return stencil_cols_plain(x, taps)
    return _launch("stencil_cols", x, taps, plan)


stencil_rows.launches = 0
stencil_cols.launches = 0


def gaussian_blur(img: torch.Tensor, *, ksize: int = 5, sigma: float = 1.0,
                  plan: StencilPlan) -> torch.Tensor:
    """Both passes under one plan; output in the image's dtype."""
    taps = gaussian_kernel_1d(ksize, sigma)
    return stencil_cols(stencil_rows(img, taps, plan=plan), taps, plan=plan)


def occupancy(pass_: str, plan: StencilPlan, dtype: torch.dtype) -> int:
    """Resident CTAs per SM that the CUDA runtime reports for one pass
    (``"rows"`` or ``"cols"``) at the plan's route and ksize (its
    registers and shared memory)."""
    fn = _build.load("stencil").stencil_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    _build.check(fn({"rows": 0, "cols": 1}[pass_], plan.vec,
                    2 * plan.halo + 1, DTYPES[dtype], ctypes.byref(blocks)),
                 "stencil_occupancy")
    return blocks.value
