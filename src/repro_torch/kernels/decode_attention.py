"""Contiguous grouped flash decode: one new token per pool row against
the row's contiguous (T, G, D) cache, masked by the row's cache length.

The CUDA kernel (``csrc/decode_attention.cu``) replaces the JAX
package's ``kernels/decode_attention.py::_decode_kernel``, which the JAX
package vmaps over (row, KV group, query head).  What bounds it on the
H100 is bytes — the K/V rows of every row's live prefix — and, at
serving sizes, the latency of the loads one CTA walks.  Its design is
the split-KV sweep of ``csrc/decode_sweep.cuh``: the grid is
(B, G, ceil(T / split)), each CTA stages the K/V rows of ``split``
positions of one (row, group) once for all R query heads by cp.async
into a ring and stops at ``cache_len``, and the last split of a row to
finish merges the row's partials, in the same launch.  ``block_s`` and
``split`` are the mapper's plan (``plan_cache_block``,
``plan_decode_split``), both required.  It is the read
of the engine's contiguous pool (``paged=False``), of both
gather-then-sweep paths (``fused_decode=False``, after
``kernels.paged_gather``) and of ``kernels.ops.decode_attention``.

``decode_attention_plain`` is the plain PyTorch version: the JAX
package's ``models/attention.py::blocked_decode_attention`` schedule
(``block_s`` windows, an online softmax across them) over the grouped
layout.  The wrapper takes it for CPU tensors and under
``kernels.force("plain")``; for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels
from repro_torch.core.hw import GpuParams, ceil_div, detect
from repro_torch.core.mapper import (CACHE_BLOCK_QUANTUM, decode_smem_bytes,
                                     decode_splits)
from repro_torch.kernels import _build

__all__ = ["decode_attention", "decode_attention_plain", "split_buffers",
           "check_split", "hw_of"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_R, _MAX_D = 8, 128
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_MAX_SPLITS = 65535          # the grid's z extent
#: (device, stream) -> (tickets, partials) of the split merge: int32
#: tickets, zeroed when allocated (every launch leaves them zero), and
#: the f32 partials workspace, each grown when a launch needs more.
#: Launches on one stream run in order, so they share both.
_SCRATCH: dict = {}


@functools.lru_cache(maxsize=None)
def hw_of(device: torch.device) -> GpuParams:
    """The card's parameters, read once per device."""
    return detect(device)


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point with its argument types, set once."""
    fn = _build.load("decode_attention").decode_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def split_buffers(q: torch.Tensor, n_split: int, stream: int):
    """Scratch of the split sweep for q (B, G, R, D) on ``stream``: the
    f32 partials, at least B G n_split x R x (D + 2) values (from
    ``torch.empty``), and at least B G int32 (row, group) tickets
    (zeroed), kept per device and stream and reallocated only when this
    launch needs more; the kernel leaves the tickets zero."""
    b, g, r, d = q.shape
    key = (q.device, stream)
    tickets, ws = _SCRATCH.get(key, (None, None))
    need = b * g * n_split * r * (d + 2)
    if tickets is None or tickets.numel() < b * g or ws.numel() < need:
        if tickets is None or tickets.numel() < b * g:
            tickets = torch.zeros(max(b * g, 256), dtype=torch.int32,
                                  device=q.device)
        if ws is None or ws.numel() < need:
            ws = torch.empty(max(need, 1 << 16), dtype=torch.float32,
                             device=q.device)
        _SCRATCH[key] = (tickets, ws)
    return ws, tickets


def decode_attention_plain(q, k_cache, v_cache, cache_len, *, block_s: int,
                           scale=None) -> torch.Tensor:
    """Plain version: q (B, G, R, D); caches (B, T, G, D); cache_len (B,)
    int.  Sweeps ``block_s`` windows up to the longest live row (later
    windows are fully masked and change nothing).  Returns (B, G, R, D)
    in q's dtype, accumulated in float32; a row of length 0 gives
    zeros."""
    b, t = k_cache.shape[:2]
    g, r, d = q.shape[1:]
    scale = d ** -0.5 if scale is None else scale
    block_s = max(1, min(int(block_s), t))
    qf = q.float() * scale
    clen = cache_len.to(q.device).long().reshape(b, 1)
    n = ceil_div(min(int(clen.max()), t), block_s) if b else 0
    m = torch.full((b, g, r), float("-inf"), device=q.device)
    l = torch.zeros((b, g, r), device=q.device)
    acc = torch.zeros((b, g, r, d), device=q.device)
    for ci in range(n):
        lo, hi = ci * block_s, min((ci + 1) * block_s, t)
        kb = k_cache[:, lo:hi].float()
        vb = v_cache[:, lo:hi].float()
        s = torch.einsum("bgrd,bcgd->bgrc", qf, kb)
        pos = torch.arange(lo, hi, device=q.device)
        ok = pos[None, :] < clen                                 # (B, c)
        s = s.masked_fill(~ok[:, None, None, :], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]),
                        0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrc,bcgd->bgrd", p, vb)
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _check(q, k_cache, v_cache, cache_len, block_s):
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError("q must be (B, G, R, D) and the caches (B, T, G, D)")
    b, g, r, d = q.shape
    t = k_cache.shape[1]
    if k_cache.shape != (b, t, g, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("q and the caches must share one dtype")
    if cache_len.dtype != torch.int32 or cache_len.shape != (b,):
        raise TypeError("cache_len must be (B,) int32")
    if block_s < CACHE_BLOCK_QUANTUM or block_s % CACHE_BLOCK_QUANTUM:
        raise ValueError(f"block_s={block_s} must be a positive multiple "
                         f"of {CACHE_BLOCK_QUANTUM}")
    if r > _MAX_R or d > _MAX_D:
        raise ValueError(f"kernel takes R <= {_MAX_R} and D <= {_MAX_D}, "
                         f"got R={r}, D={d}")
    smem = decode_smem_bytes(d, r, cache_bytes=q.element_size())
    if smem > hw_of(q.device).smem_per_block:
        raise ValueError(f"the sweep stages {smem} B of shared memory, "
                         f"over the block's limit")
    for x in (q, k_cache, v_cache, cache_len):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")


def check_split(t: int, block_s: int, split: int) -> int:
    """Raise unless ``split`` is a whole number of ``block_s`` that cuts
    a row of ``t`` into at most 65,535 splits; return the split count.
    The planners call it once per plan (the router per bucket); a launch
    is refused by the kernel's own entry point as well."""
    if split < block_s or split % block_s:
        raise ValueError(f"split={split} must be a whole number of "
                         f"block_s={block_s}")
    n_split = decode_splits(t, split)
    if n_split > _MAX_SPLITS:
        raise ValueError(f"split={split} cuts T={t} into more than "
                         f"{_MAX_SPLITS} splits")
    return n_split


def decode_attention(q, k_cache, v_cache, cache_len, *, block_s: int,
                     split: int, scale=None) -> torch.Tensor:
    """Contiguous grouped decode.  CPU tensors (or
    ``kernels.force("plain")``) run the plain version, which ``split``
    does not change; CUDA tensors launch the kernel on the grid
    (B, G, ceil(T / split)), ``split`` the mapper's width, with the
    launch count in ``decode_attention.launches`` and the grid in
    ``decode_attention.last_grid``."""
    if kernels.use_plain(q):
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      block_s=block_s, scale=scale)
    block_s = int(block_s)
    _check(q, k_cache, v_cache, cache_len, block_s)
    b, g, r, d = q.shape
    t = k_cache.shape[1]
    split = int(split)
    n_split = decode_splits(t, split)
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws, tickets = split_buffers(q, n_split, stream)
    rc = _entry()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  cache_len.data_ptr(), out.data_ptr(), ws.data_ptr(),
                  tickets.data_ptr(), b, t, g, r, d, block_s, split, n_split,
                  float(scale), _DTYPES[q.dtype], stream)
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    decode_attention.last_grid = (b, g, n_split)
    return out


decode_attention.launches = 0
decode_attention.last_grid = None
