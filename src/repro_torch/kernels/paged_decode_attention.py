"""Fused paged flash decode: one new token per pool row, read through
the row's block table with no logical view of the cache materialised.

The CUDA kernel (``csrc/paged_decode_attention.cu``) replaces the JAX
package's ``kernels/paged_decode_attention.py::_paged_decode_kernel``.
What bounds it on the H100 is bytes — the K/V rows of every row's live
prefix — and its design reads each of those bytes once: one CTA per
(row, KV group) walks its own block table, stages ``block_s`` positions
of pages at a time in shared memory for all R query heads of the group,
and stops at ``cache_len``.

``paged_decode_attention_plain`` is the plain PyTorch version: the JAX
reference's blocked schedule (``block_s`` windows, each gathering only
its own pages through ``paged_flat_indices``, an online softmax across
windows).  The wrapper takes it for CPU tensors and under
``kernels.force("plain")``; for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core.hw import ceil_div
from repro_torch.kernels import _build
from repro_torch.kernels.paged_gather import paged_flat_indices

__all__ = ["paged_decode_attention", "paged_decode_attention_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_R, _MAX_D = 8, 128
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def paged_decode_attention_plain(q, k_cache, v_cache, tables, cache_len, *,
                                 page_block: int, block_s: int,
                                 scale=None) -> torch.Tensor:
    """Plain version: q (B, G, R, D); caches (B, T, G, D) on the physical
    grid; tables (B, nb) int (-1 = unmapped); cache_len (B,) int.  The
    sweep covers the windows up to the longest live row (later windows
    are fully masked and change nothing).  Returns (B, G, R, D) in q's
    dtype, accumulated in float32."""
    b, t = k_cache.shape[:2]
    g, r, d = q.shape[1:]
    scale = d ** -0.5 if scale is None else scale
    pb = int(page_block)
    block_s = max(pb, min(int(block_s), ceil_div(t, pb) * pb))
    idx = paged_flat_indices(tables[:, :ceil_div(t, pb)], b, t, pb)
    tp = ceil_div(t, block_s) * block_s
    if tp != t:
        # padded positions clamp to flat index 0 and lie past cache_len
        idx = torch.nn.functional.pad(idx, (0, tp - t))
    kf = k_cache.float().reshape(b * t, g, d)
    vf = v_cache.float().reshape(b * t, g, d)
    qf = q.float() * scale
    clen = cache_len.to(q.device).long().reshape(b, 1)
    n = ceil_div(min(int(clen.max()), t), block_s) if b else 0
    m = torch.full((b, g, r), float("-inf"), device=q.device)
    l = torch.zeros((b, g, r), device=q.device)
    acc = torch.zeros((b, g, r, d), device=q.device)
    for ci in range(n):
        ix = idx[:, ci * block_s:(ci + 1) * block_s].reshape(-1)
        kb = kf[ix].reshape(b, block_s, g, d)
        vb = vf[ix].reshape(b, block_s, g, d)
        s = torch.einsum("bgrd,bcgd->bgrc", qf, kb)
        pos = ci * block_s + torch.arange(block_s, device=q.device)
        ok = pos[None, :] < clen                                 # (B, bs)
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


def _check(q, k_cache, v_cache, tables, cache_len, pb, block_s):
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_decode_attention takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError("q must be (B, G, R, D) and the caches (B, T, G, D)")
    b, g, r, d = q.shape
    t = k_cache.shape[1]
    if k_cache.shape != (b, t, g, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("q and the caches must share one dtype")
    if tables.dtype != torch.int32 or cache_len.dtype != torch.int32:
        raise TypeError("tables and cache_len must be int32")
    if tables.dim() != 2 or tables.shape[0] != b or cache_len.shape != (b,):
        raise ValueError("tables must be (B, nb) and cache_len (B,)")
    if t % pb or block_s % pb or block_s < pb:
        raise ValueError(f"T={t} and block_s={block_s} must be whole pages "
                         f"of {pb}")
    if tables.shape[1] < t // pb:
        raise ValueError(f"table width {tables.shape[1]} < {t // pb} pages")
    if r > _MAX_R or d > _MAX_D:
        raise ValueError(f"kernel takes R <= {_MAX_R} and D <= {_MAX_D}, "
                         f"got R={r}, D={d}")
    for x in (q, k_cache, v_cache, tables, cache_len):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")


def paged_decode_attention(q, k_cache, v_cache, tables, cache_len, *,
                           page_block: int, block_s: int, scale=None,
                           window=None) -> torch.Tensor:
    """Fused paged decode.  CPU tensors (or ``kernels.force("plain")``)
    run the plain version; CUDA tensors launch the kernel, whose launch
    count is ``paged_decode_attention.launches``.  Sliding windows are
    not supported by the kernel and raise."""
    if window is not None:
        raise NotImplementedError("paged_decode_attention: sliding windows "
                                  "are not ported (smollm has none)")
    if kernels.use_plain(q):
        return paged_decode_attention_plain(
            q, k_cache, v_cache, tables, cache_len, page_block=page_block,
            block_s=block_s, scale=scale)
    pb = int(page_block)
    _check(q, k_cache, v_cache, tables, cache_len, pb, int(block_s))
    b, g, r, d = q.shape
    t = k_cache.shape[1]
    block_s = min(int(block_s), t)
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if b == 0:
        return out
    fn = _build.load("paged_decode_attention").paged_decode_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            tables.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
            b, t, g, r, d, tables.shape[1], pb, block_s, float(scale),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
