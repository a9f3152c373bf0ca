"""Fused paged flash decode: one new token per pool row, read through
the row's block table with no logical view of the cache materialised.

The CUDA kernel (``csrc/paged_decode_attention.cu``) replaces the JAX
package's ``kernels/paged_decode_attention.py::_paged_decode_kernel``.
What bounds it on the H100 is bytes — the K/V rows of every row's live
prefix — and, at serving sizes, the latency of the loads one CTA walks.
Its design is the split-KV sweep of ``csrc/decode_sweep.cuh``: the grid
is (B, G, ceil(T / split)), each CTA walks ``split`` positions of one
(row, KV group) through the row's block table (each page resolved once
per CTA), stages their K/V rows by cp.async into a ring for all R query
heads of the group and stops at ``cache_len``; the last split of a row
to finish merges the row's partials, in the same launch.  ``block_s``
(whole pages) and ``split`` (whole ``block_s``) are the mapper's plan
(``plan_paged_block``, ``plan_decode_split``), both required.  With ``k_scale``/``v_scale`` the caches hold the int8 pool's
codes and a second instantiation of the kernel
(``paged_decode_attention_int8`` in the same source; it replaces
``_paged_decode_kernel_int8``) stages the codes and dequantises each by
its page's group scale as it scores it; its launches count in
``paged_decode_attention.int8_launches``.

``paged_decode_attention_plain`` is the plain PyTorch version: the JAX
reference's blocked schedule (``block_s`` windows, each gathering only
its own pages — and, for int8 codes, their scales by the same flat
block — through ``paged_flat_indices``, an online softmax across
windows).  The wrapper takes it for CPU tensors and under
``kernels.force("plain")``; for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels
from repro_torch.core.hw import ceil_div
from repro_torch.core.mapper import decode_smem_bytes, decode_splits
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import hw_of, split_buffers
from repro_torch.kernels.paged_gather import paged_flat_indices

__all__ = ["paged_decode_attention", "paged_decode_attention_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_R, _MAX_D = 8, 128
#: C entry point -> its argument types (pointers, ints, scale, dtype,
#: stream)
_ARGTYPES = {
    "paged_decode_attention": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                               + [ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p]),
    "paged_decode_attention_int8": ([ctypes.c_void_p] * 10
                                    + [ctypes.c_int] * 10
                                    + [ctypes.c_float, ctypes.c_int,
                                       ctypes.c_void_p]),
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The C entry point ``name`` with its argument types, set once."""
    fn = getattr(_build.load("paged_decode_attention"), name)
    fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
    return fn


def paged_decode_attention_plain(q, k_cache, v_cache, tables, cache_len, *,
                                 page_block: int, block_s: int, scale=None,
                                 k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain version: q (B, G, R, D); caches (B, T, G, D) on the physical
    grid; tables (B, nb) int (-1 = unmapped); cache_len (B,) int.  The
    sweep covers the windows up to the longest live row (later windows
    are fully masked and change nothing).  With ``k_scale``/``v_scale``
    (B, T / page_block, G) f32 the caches hold int8 codes, dequantised
    per window (``code * scale`` in float32).  Returns (B, G, R, D) in
    q's dtype, accumulated in float32."""
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
    quant = k_scale is not None
    if quant:
        ksf = k_scale.reshape(-1, g)
        vsf = v_scale.reshape(-1, g)
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
        if quant:
            # flat_token // pb == flat block: codes and scales resolve
            # through one layout invariant
            bix = ix // pb
            kb = kb * ksf[bix].reshape(b, block_s, g, 1)
            vb = vb * vsf[bix].reshape(b, block_s, g, 1)
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


def _check(q, k_cache, v_cache, tables, cache_len, pb, block_s,
           k_scale=None, v_scale=None):
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
    if k_scale is None:
        if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
            raise TypeError("q and the caches must share one dtype")
    else:
        # the int8 pool: codes, with f32 scales per (physical page, group)
        if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
            raise TypeError("with scales the caches must hold int8 codes")
        for sc in (k_scale, v_scale):
            if sc is None or sc.dtype != torch.float32:
                raise TypeError("k_scale and v_scale must both be float32")
            if sc.shape != (b, t // pb, g):
                raise ValueError(f"scales {tuple(sc.shape)} are not "
                                 f"(B, T / page, G) = {(b, t // pb, g)}")
            if sc.device != q.device or not sc.is_contiguous():
                raise ValueError("the scales must be contiguous on q's "
                                 "device")
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
    smem = decode_smem_bytes(d, r, page_block=pb,
                             cache_bytes=k_cache.element_size())
    if smem > hw_of(q.device).smem_per_block:
        raise ValueError(f"the sweep stages {smem} B of shared memory, "
                         f"over the block's limit")
    for x in (q, k_cache, v_cache, tables, cache_len):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")


def paged_decode_attention(q, k_cache, v_cache, tables, cache_len, *,
                           page_block: int, block_s: int, split: int,
                           scale=None, window=None, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """Fused paged decode.  CPU tensors (or ``kernels.force("plain")``)
    run the plain version, which ``split`` does not change; CUDA tensors
    launch the kernel on the grid (B, G, ceil(T / split)), ``split`` the
    mapper's width, counted in ``paged_decode_attention.launches`` (int8
    codes with ``k_scale``/``v_scale``:
    ``paged_decode_attention.int8_launches``), the grid in
    ``paged_decode_attention.last_grid``.  Sliding windows are not
    supported by the kernel and raise."""
    if window is not None:
        raise NotImplementedError("paged_decode_attention: sliding windows "
                                  "are not ported (smollm has none)")
    if kernels.use_plain(q):
        return paged_decode_attention_plain(
            q, k_cache, v_cache, tables, cache_len, page_block=page_block,
            block_s=block_s, scale=scale, k_scale=k_scale, v_scale=v_scale)
    pb = int(page_block)
    _check(q, k_cache, v_cache, tables, cache_len, pb, int(block_s),
           k_scale, v_scale)
    b, g, r, d = q.shape
    t = k_cache.shape[1]
    block_s = min(int(block_s), t)
    split = int(split)
    n_split = decode_splits(t, split)
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws, tickets = split_buffers(q, n_split, stream)
    ptrs = (tables.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
            ws.data_ptr(), tickets.data_ptr())
    shape = (b, t, g, r, d, tables.shape[1], pb, block_s, split, n_split,
             float(scale), _DTYPES[q.dtype], stream)
    if k_scale is None:
        rc = _entry("paged_decode_attention")(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *ptrs,
            *shape)
        _build.check(rc, "paged_decode_attention")
        paged_decode_attention.launches += 1
    else:
        rc = _entry("paged_decode_attention_int8")(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), *ptrs, *shape)
        _build.check(rc, "paged_decode_attention_int8")
        paged_decode_attention.int8_launches += 1
    paged_decode_attention.last_grid = (b, g, n_split)
    return out


paged_decode_attention.launches = 0
paged_decode_attention.int8_launches = 0
paged_decode_attention.last_grid = None
