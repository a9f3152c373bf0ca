"""The paged KV pool's layout invariant, and the block-table gathers.

The serving pool's physical KV store is a block grid: each pool row of
length T holds T / block_size blocks, and physical block ids map onto it
column-major, so pool growth appends new ids without moving live blocks:

    pid  ->  (row = pid % slots, offset = (pid // slots) * block_size)

The paged scatter writes (``models.attention``), the engine's prefill
page map, the decode kernel's page addressing and the gathers below all
go through these functions or this formula, so writers and readers can
never disagree.

The gathers materialise a request-logical view of the pool, the read
half of the gather-then-sweep decode (``fused_decode=False``).  The CUDA
kernels (``csrc/paged_gather.cu``) replace the JAX package's
``kernels/paged_gather.py::_gather_kernel`` (a bit-exact page copy) and
``::_dequant_gather_kernel`` (int8 codes times each page's per-group
scale).  Both are bound by bytes: every page read once, the view written
once.  Unmapped (-1) table entries clamp to block 0, as in the JAX
reference, so the view holds block 0's data there; the decode that reads
the view masks it by cache length.

Each kernel takes a ``core.mapper.GatherPlan``: the view cut into items
of ``width`` (the copy: the widest of 16, 8, 4, 2 or 1 bytes that
divides a page's bytes and both pointers; the dequant gather: the int8
codes behind one 16-byte store, 8 for a bfloat16 output and 4 for
float32, else 4 or 1, by D and the codes' pointer: ``DEQUANT_WIDTHS``),
``lws`` items a thread at a stride of the grid's threads over ``grid``
CTAs of 256 threads, each thread's loads of a batch of four issued
before its stores.
``plan=None`` is Eq. 1 for the cache's device (``plan_gather`` under
``detect``, legal by construction); a given plan is checked against the
tensors.  The launched
plan is ``fn.last_plan`` and its grid ``fn.last_grid``.

``*_plain`` are the plain PyTorch versions; the wrappers take them for
CPU tensors and under ``kernels.force("plain")``, and launch the kernel
or raise for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch import kernels
from repro_torch.core.hw import ceil_div, detect
from repro_torch.core.mapper import (DEQUANT_WIDTHS, GATHER_THREADS,
                                     GATHER_WIDTHS, GatherPlan, gather_width,
                                     plan_gather)
from repro_torch.kernels import _build

__all__ = ["flat_position", "paged_flat_indices", "paged_gather",
           "paged_gather_plain", "paged_dequant_gather",
           "paged_dequant_gather_plain"]

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GATHER_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
    + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_DEQUANT_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 \
    + [ctypes.c_void_p]


def flat_position(pid, pos, slots: int, kv_len: int, block_size: int):
    """The flat (slots * kv_len) cache position of logical token ``pos``
    inside physical block ``pid`` — pure arithmetic over numpy arrays or
    torch tensors."""
    return ((pid % slots) * kv_len + (pid // slots) * block_size
            + pos % block_size)


def paged_flat_indices(tables: torch.Tensor, slots: int, kv_len: int,
                       block_size: int) -> torch.Tensor:
    """Flat (slots * kv_len) positions of each row's logical tokens:
    ``tables`` (slots, nb) of physical block ids (-1 = unmapped, clamped
    to block 0 — callers mask by cache length) -> (slots, kv_len) int64.
    """
    t = torch.arange(kv_len, device=tables.device)
    pid = tables[:, t // block_size].long().clamp_min(0)
    return flat_position(pid, t, slots, kv_len, block_size)


def paged_gather_plain(cache: torch.Tensor, tables: torch.Tensor,
                       block_size: int) -> torch.Tensor:
    """Plain version: cache (B, T, ...) on the physical grid -> the
    (B, T, ...) logical view, one ``index_select`` over the flat
    positions (the JAX reference's one-take schedule)."""
    b, t = cache.shape[:2]
    idx = paged_flat_indices(tables[:, :ceil_div(t, block_size)], b, t,
                             block_size)
    flat = cache.reshape((b * t,) + cache.shape[2:])
    return flat.index_select(0, idx.reshape(-1)).reshape(cache.shape)


def paged_dequant_gather_plain(cache: torch.Tensor, scale: torch.Tensor,
                               tables: torch.Tensor, block_size: int,
                               out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the int8 gather: codes (B, T, G, D) on the
    physical grid, scales (B, T / block_size, G) f32 at physical
    coordinates -> the logical view ``codes * scale`` in ``out_dtype``.
    The scale is rounded to ``out_dtype`` and the product, exact in
    float32, rounded once: the JAX reference's multiply in ``out_dtype``."""
    b, t = cache.shape[:2]
    nb = ceil_div(t, block_size)
    codes = paged_gather_plain(cache, tables, block_size)
    # each logical page's flat block of the (B * nb, ...) grid, which
    # indexes the scales as it does the codes
    pid = tables[:, :nb].long().clamp_min(0)
    fb = ((pid % b) * nb + pid // b).reshape(-1)
    sc = scale.reshape(b * nb, -1).index_select(0, fb).reshape(b, nb, -1)
    sc = sc.repeat_interleave(block_size, dim=1)[:, :t]          # (B, T, G)
    sc = sc.to(out_dtype).float()
    return (codes.float() * sc[..., None]).to(out_dtype)


def _check_tables(b, t, tables, pb, what):
    if tables.dtype != torch.int32 or tables.dim() != 2 \
            or tables.shape[0] != b:
        raise TypeError(f"{what}: tables must be (B, nb) int32")
    if t % pb or tables.shape[1] < t // pb:
        raise ValueError(f"{what}: T={t} must be whole pages of {pb} and "
                         f"the table at least {t // pb} wide")


def _pointer_alignment(*ts: torch.Tensor) -> int:
    """The largest power of two up to 16 on which every tensor of ``ts``
    starts."""
    a = 16
    for t in ts:
        while t.data_ptr() % a:
            a //= 2
    return a


@functools.lru_cache(maxsize=64)
def _auto_plan(size: int, unit: int, align: int, widths: tuple,
               device: torch.device) -> GatherPlan:
    """Eq. 1 for ``device`` (``plan_gather`` under ``detect``) at the
    widest of ``widths`` that ``unit`` and ``align`` allow, worked out
    once a shape: the serving loop gathers the same shapes every tick."""
    return plan_gather(size, gather_width(unit, align, widths),
                       detect(device))


def _check_plan(plan, size, unit, align, widths, what):
    """Raise on a plan the tensors do not allow: its width must be one of
    ``widths`` dividing ``unit`` and ``align``, and it must cover the
    ``size // width`` items of the view."""
    if not isinstance(plan, GatherPlan) or plan.width not in widths \
            or unit % plan.width or align % plan.width:
        raise ValueError(f"{what}: plan {plan} does not fit items of "
                         f"{widths} dividing {unit} with pointers on "
                         f"{align} bytes")
    if plan.gws != size // plan.width or plan.threads != GATHER_THREADS \
            or min(plan.lws, plan.grid) < 1 \
            or plan.grid * plan.threads * plan.lws < plan.gws:
        raise ValueError(f"{what}: plan {plan} does not cover the view's "
                         f"{size // plan.width} items")


def paged_gather(cache: torch.Tensor, tables: torch.Tensor,
                 block_size: int, *,
                 plan: GatherPlan | None = None) -> torch.Tensor:
    """Gather the logical view of a paged cache (any dtype, bit-exact).
    CPU tensors (or ``kernels.force("plain")``) run the plain version;
    CUDA tensors launch the kernel under ``plan`` (None: Eq. 1 for the
    device), whose launch count is ``paged_gather.launches``."""
    if kernels.use_plain(cache):
        return paged_gather_plain(cache, tables, block_size)
    b, t = cache.shape[:2]
    pb = int(block_size)
    _check_tables(b, t, tables, pb, "paged_gather")
    if tables.device != cache.device or not cache.is_contiguous() \
            or not tables.is_contiguous():
        raise ValueError("paged_gather: operands must be contiguous on one "
                         "device")
    out = torch.empty_like(cache)
    if cache.numel() == 0:
        return out
    page_bytes = pb * math.prod(cache.shape[2:]) * cache.element_size()
    size = cache.numel() * cache.element_size()
    align = _pointer_alignment(cache, out)
    if plan is None:
        plan = _auto_plan(size, page_bytes, align, GATHER_WIDTHS,
                          cache.device)
    else:
        _check_plan(plan, size, page_bytes, align, GATHER_WIDTHS,
                    "paged_gather")
    fn = _build.load("paged_gather").paged_gather
    fn.argtypes, fn.restype = _GATHER_ARGTYPES, ctypes.c_int
    rc = fn(cache.data_ptr(), tables.data_ptr(), out.data_ptr(), b, t // pb,
            tables.shape[1], page_bytes, plan.width, plan.lws, plan.grid,
            torch.cuda.current_stream(cache.device).cuda_stream)
    _build.check(rc, "paged_gather")
    paged_gather.launches += 1
    paged_gather.last_plan, paged_gather.last_grid = plan, (plan.grid,)
    return out


def paged_dequant_gather(cache: torch.Tensor, scale: torch.Tensor,
                         tables: torch.Tensor, block_size: int, *,
                         out_dtype=torch.float32,
                         plan: GatherPlan | None = None) -> torch.Tensor:
    """Gather and dequantise the int8 pool's logical view in
    ``out_dtype`` (float32 or bfloat16).  CPU tensors (or
    ``kernels.force("plain")``) run the plain version; CUDA tensors
    launch the kernel under ``plan`` (None: Eq. 1 for the device), whose
    launch count is ``paged_dequant_gather.launches``."""
    if kernels.use_plain(cache):
        return paged_dequant_gather_plain(cache, scale, tables, block_size,
                                          out_dtype=out_dtype)
    b, t, g, d = cache.shape
    pb = int(block_size)
    _check_tables(b, t, tables, pb, "paged_dequant_gather")
    if cache.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("paged_dequant_gather takes int8 codes and float32 "
                        "scales")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"paged_dequant_gather writes float32 or bfloat16, "
                        f"got {out_dtype}")
    if scale.shape != (b, t // pb, g):
        raise ValueError(f"scales {tuple(scale.shape)} are not "
                         f"(B, T / page, G) = {(b, t // pb, g)}")
    for x in (cache, scale, tables):
        if x.device != cache.device or not x.is_contiguous():
            raise ValueError("paged_dequant_gather: operands must be "
                             "contiguous on one device")
    out = torch.empty(cache.shape, dtype=out_dtype, device=cache.device)
    if cache.numel() == 0:
        return out
    # the output is this call's own allocation, so only the codes'
    # pointer can narrow the item
    align = _pointer_alignment(cache)
    widths = DEQUANT_WIDTHS[out.element_size()]
    if plan is None:
        plan = _auto_plan(cache.numel(), d, align, widths, cache.device)
    else:
        _check_plan(plan, cache.numel(), d, align, widths,
                    "paged_dequant_gather")
    fn = _build.load("paged_gather").paged_dequant_gather
    fn.argtypes, fn.restype = _DEQUANT_ARGTYPES, ctypes.c_int
    rc = fn(cache.data_ptr(), scale.data_ptr(), tables.data_ptr(),
            out.data_ptr(), b, t // pb, tables.shape[1], pb, g, d,
            plan.width, plan.lws, plan.grid, _OUT_DTYPES[out_dtype],
            torch.cuda.current_stream(cache.device).cuda_stream)
    _build.check(rc, "paged_dequant_gather")
    paged_dequant_gather.launches += 1
    paged_dequant_gather.last_plan = plan
    paged_dequant_gather.last_grid = (plan.grid,)
    return out


paged_gather.launches = 0
paged_gather.last_plan = paged_gather.last_grid = None
paged_dequant_gather.launches = 0
paged_dequant_gather.last_plan = paged_dequant_gather.last_grid = None
