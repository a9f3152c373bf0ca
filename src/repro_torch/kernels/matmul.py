"""Tiled matmul ``C[m,n] = A[m,k] @ B[k,n]`` with a float32 accumulator.

Two CUDA kernels replace the JAX package's
``kernels/matmul.py::_matmul_kernel``, and ``route`` picks one from the
operands' dtype before anything is launched:

  * "tf32x3" (``csrc/matmul_tf32x3.cu``): every float32 A and B.  Two
    launches: the split pass writes each operand's TF32 big and small
    halves into padded K-major workspaces (``tf32_split``, counted in
    ``matmul.split_launches``), then TMA stages feed three ``wgmma``
    TF32 products a K step, small ones first, into a partial that the
    CUDA cores add to an f32 sum after each step (``tf32_product``,
    counted in ``matmul.tf32_launches``); a ``bm x bn`` tile of
    ``bm / 64`` warpgroups, K in steps of 32.
  * "tensor_core" (``csrc/matmul_tc.cu``): every bfloat16 A and B, of
    any shape and alignment.  Shared-memory stages, ``wgmma`` products,
    f32 accumulators; a ``bm x bn`` tile of ``bm / 64`` warpgroups, K in
    steps of 64.  An operand whose pointer and row stride (K columns of
    A, N of B) lie on 16 bytes is loaded by TMA, any other by the CTA's
    own copies of 8, 4 or 2 bytes into the same swizzled stages.
    Counted in ``matmul.tc_launches``.

The tuner's ``dispatch.plan_for("matmul", a, b, ...)`` plans the launch
of the operands' route under a mapping policy
(``core.mapper.plan_matmul_blocks`` with ``kernel=`` the route); the
wrapper raises when the plan's kernel is not the operands' route.

``matmul_plain`` is the plain version on the plan's K steps: float32
partial products over ``bk``-wide chunks of K, accumulated in float32
in order, rounded once to ``out_dtype`` (default: a's dtype).
``tf32_split_plain`` is the split's plain version (round to TF32,
nearest with ties away from zero, on the float32 bits), and
``tf32_split`` / ``tf32_product`` run the route's two launches apart
(on the CPU their plain versions: the padded workspaces, and the
three products summed in float32).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core.hw import round_up
from repro_torch.core.mapper import MatmulPlan
from repro_torch.kernels import _build
from repro_torch.kernels.vecadd import DTYPES

__all__ = ["matmul", "matmul_plain", "loader_bytes", "occupancy",
           "occupancy_for", "dtype_route", "route", "tf32_split",
           "tf32_split_plain", "tf32_product"]

_TC_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                + [ctypes.c_void_p])
_SPLIT_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
_TF32_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                  + [ctypes.c_void_p])
_TF32_LOW = 0x1FFF          # the 13 mantissa bits TF32 drops
_TF32_NAN = 0x7FFFE000      # the split's NaN: quiet, its 13 low bits clear


_ROUTES = {torch.float32: "tf32x3", torch.bfloat16: "tensor_core"}


def route(a: torch.Tensor, b: torch.Tensor) -> str:
    """"tf32x3" for float32 operands, "tensor_core" for bfloat16, whatever
    their shape or alignment; raises on operands of two dtypes or of
    another dtype."""
    if a.dtype != b.dtype:
        raise TypeError(f"matmul takes A and B of one dtype, got {a.dtype} "
                        f"and {b.dtype}")
    return dtype_route(a.dtype)


def dtype_route(dtype: torch.dtype) -> str:
    """The route of operands of ``dtype``; raises on a dtype other than
    float32 and bfloat16."""
    if dtype not in _ROUTES:
        raise TypeError(f"matmul takes float32 or bfloat16, got {dtype}")
    return _ROUTES[dtype]


def loader_bytes(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    """The bytes a copy of A and of B moves in ``csrc/matmul_tc.cu``
    (``copy_width``): 16 where the pointer and the row stride (K columns
    of A, N of B) lie on 16 bytes, which TMA loads; else 8, 4 or 2, the
    widest that divides both, by the CTA's own copies."""
    def width(t):
        x = t.data_ptr() | 2 * t.shape[1]
        return next(w for w in (16, 8, 4, 2) if x % w == 0)
    return width(a), width(b)


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *, plan: MatmulPlan,
                 out_dtype=None) -> torch.Tensor:
    m, k = a.shape
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, plan.bk):
        acc += a[:, k0:k0 + plan.bk].float() @ b[k0:k0 + plan.bk].float()
    return acc.to(out_dtype or a.dtype)


def tf32_split_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(big, small)`` of float32 ``x``: ``big`` is ``x`` rounded to TF32
    (10 mantissa bits, nearest with ties away from zero, as
    ``cvt.rna.tf32.f32``), ``small`` the same rounding of ``x - big``;
    ``big + small`` keeps about 21 of ``x``'s 24 bits.  Integer ops on the
    bits: half of the dropped 13 bits' range is added to the magnitude,
    then the 13 bits are cleared.  A finite ``x`` that would round to
    infinity is cut toward zero instead; an infinity is its own ``big``,
    a NaN becomes the quiet NaN ``0x7fffe000``, and both have ``small``
    0, as the kernel's split."""
    def bits(v):
        return v.contiguous().view(torch.int32)

    def rna(v):
        return ((bits(v) + (_TF32_LOW + 1) // 2) & ~_TF32_LOW) \
            .view(torch.float32)

    xf = x.float()
    finite = xf.isfinite()
    big = rna(xf)
    big = torch.where(finite & ~big.isfinite(),
                      (bits(xf) & ~_TF32_LOW).view(torch.float32), big)
    nan = torch.tensor(_TF32_NAN, dtype=torch.int32).view(torch.float32)
    big = torch.where(finite, big, torch.where(xf.isnan(), nan, xf))
    small = torch.where(finite, rna(torch.where(finite, xf - big, 0.0)), 0.0)
    return big, small


def tf32_split(a: torch.Tensor, b: torch.Tensor, plan: MatmulPlan
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The route's first launch: ``(a_ws, b_ws)``, ``a_ws[0]`` /
    ``a_ws[1]`` A's big / small halves (m, kp), ``b_ws[0]`` / ``b_ws[1]``
    B's transposed (np, kp); K padded with zeros to ``kp``, a multiple of
    the plan's ``bk`` (32), and N to ``np``, a multiple of its ``bn``.
    Counted in ``matmul.split_launches``."""
    (m, k), n = a.shape, b.shape[1]
    kp, np_ = round_up(max(k, 1), plan.bk), round_up(n, plan.bn)
    a_shape, b_shape = (2, m, kp), (2, np_, kp)
    if kernels.use_plain(a):
        a_ws = a.new_zeros(a_shape, dtype=torch.float32)
        b_ws = a.new_zeros(b_shape, dtype=torch.float32)
        for i, half in enumerate(tf32_split_plain(a)):
            a_ws[i, :, :k] = half
        for i, half in enumerate(tf32_split_plain(b)):
            b_ws[i, :n, :k] = half.T
        return a_ws, b_ws
    _check(a, b, plan, torch.float32)
    a_ws = torch.empty(a_shape, dtype=torch.float32, device=a.device)
    b_ws = torch.empty(b_shape, dtype=torch.float32, device=a.device)
    fn = _build.load("matmul_tf32x3").tf32x3_split
    fn.argtypes, fn.restype = _SPLIT_ARGTYPES, ctypes.c_int
    rc = fn(a.data_ptr(), b.data_ptr(), a_ws.data_ptr(), b_ws.data_ptr(), m,
            n, k, np_, kp, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "tf32x3_split")
    matmul.split_launches += 1
    return a_ws, b_ws


def tf32_product(a_ws: torch.Tensor, b_ws: torch.Tensor, n: int,
                 plan: MatmulPlan, out_dtype=torch.float32) -> torch.Tensor:
    """The route's second launch: the (m, n) product of the split's
    workspaces, ``a_small b_big + a_big b_small + a_big b_big`` summed
    in float32.  Counted in ``matmul.tf32_launches``."""
    m, np_, kp = a_ws.shape[1], b_ws.shape[1], b_ws.shape[2]
    if kernels.use_plain(a_ws):
        (ab, as_), (bb, bs) = a_ws, b_ws[:, :n]
        return (as_ @ bb.T + ab @ bs.T + ab @ bb.T).to(out_dtype)
    if a_ws.shape != (2, m, kp) or b_ws.shape != (2, np_, kp) \
            or not 0 < n <= np_ or out_dtype not in DTYPES \
            or a_ws.dtype != torch.float32 or b_ws.dtype != torch.float32 \
            or a_ws.device != b_ws.device \
            or not (a_ws.is_contiguous() and b_ws.is_contiguous()):
        raise ValueError(f"tf32_product takes the workspaces tf32_split "
                         f"writes, got {tuple(a_ws.shape)} and "
                         f"{tuple(b_ws.shape)} for n = {n}")
    out = torch.empty((m, n), dtype=out_dtype, device=a_ws.device)
    fn = _build.load("matmul_tf32x3").tf32x3_product
    fn.argtypes, fn.restype = _TF32_ARGTYPES, ctypes.c_int
    rc = fn(a_ws.data_ptr(), b_ws.data_ptr(), out.data_ptr(), m, n, np_, kp,
            plan.bm, plan.bn, plan.stages, DTYPES[out_dtype],
            torch.cuda.current_stream(a_ws.device).cuda_stream)
    _build.check(rc, "tf32x3_product")
    matmul.tf32_launches += 1
    return out


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
    plain version; CUDA tensors launch the plan's kernel: the split pass
    and the 3xTF32 product (``matmul.split_launches``,
    ``matmul.tf32_launches``) or the bf16 tensor-core kernel
    (``matmul.tc_launches``)."""
    if kernels.use_plain(a):
        return matmul_plain(a, b, plan=plan, out_dtype=out_dtype)
    out_dtype = out_dtype or a.dtype
    _check(a, b, plan, out_dtype)
    m, k = a.shape
    n = b.shape[1]
    if k == 0:
        return torch.zeros((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=out_dtype, device=a.device)
    if plan.kernel == "tf32x3":
        return tf32_product(*tf32_split(a, b, plan), n, plan, out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    fn = _build.load("matmul_tc").matmul_tc
    fn.argtypes, fn.restype = _TC_ARGTYPES, ctypes.c_int
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, plan.bm,
            plan.bn, plan.stages, DTYPES[out_dtype],
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "matmul_tc")
    matmul.tc_launches += 1
    return out


matmul.tc_launches = 0
matmul.split_launches = 0
matmul.tf32_launches = 0


def occupancy(plan: MatmulPlan, a: torch.Tensor, b: torch.Tensor) -> int:
    """Resident CTAs per SM that the CUDA runtime reports for the
    instantiation that ``a @ b`` launches under ``plan`` (its registers
    and its shared memory; for bf16, its operands' loaders)."""
    return _occupancy(plan, a.data_ptr(), b.data_ptr(), b.shape[1],
                      a.shape[1])


def occupancy_for(plan: MatmulPlan, k: int, n: int) -> int:
    """``occupancy`` for operands that start on 16 bytes (as a fresh
    allocation does): A of ``k`` columns, B of ``n``."""
    return _occupancy(plan, 0, 0, n, k)


def _occupancy(plan: MatmulPlan, a_ptr: int, b_ptr: int, n: int,
               k: int) -> int:
    blocks = ctypes.c_int(0)
    if plan.kernel == "tensor_core":
        fn = _build.load("matmul_tc").matmul_tc_occupancy
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _build.check(fn(a_ptr, b_ptr, n, k, plan.bm, plan.bn, plan.stages,
                        ctypes.byref(blocks)), "matmul_tc_occupancy")
        return blocks.value
    fn = _build.load("matmul_tf32x3").tf32x3_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(plan.bm, plan.bn, plan.stages, ctypes.byref(blocks)),
                 "tf32x3_occupancy")
    return blocks.value
