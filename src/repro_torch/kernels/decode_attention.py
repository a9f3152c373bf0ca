"""Contiguous grouped flash decode: one new token per pool row against
the row's contiguous (T, G, D) cache, masked by the row's cache length.

The CUDA kernel (``csrc/decode_attention.cu``) replaces the JAX
package's ``kernels/decode_attention.py::_decode_kernel``, which the JAX
package vmaps over (row, KV group, query head).  What bounds it on the
H100 is bytes — the K/V rows of every row's live prefix — and its design
reads each of those bytes once: one CTA per (row, KV group) stages
``block_s`` positions at a time in shared memory for all R query heads
of the group and stops at ``cache_len``.  It is the read of the engine's
contiguous pool (``paged=False``), of both gather-then-sweep paths
(``fused_decode=False``, after ``kernels.paged_gather``) and of
``kernels.ops.decode_attention``.

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
from repro_torch.core.hw import ceil_div, detect
from repro_torch.core.mapper import CACHE_BLOCK_QUANTUM, decode_smem_bytes
from repro_torch.kernels import _build

__all__ = ["decode_attention", "decode_attention_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_R, _MAX_D = 8, 128
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _smem_limit(device: torch.device) -> int:
    """The block's opt-in shared memory on ``device``, read once."""
    return detect(device).smem_per_block


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
    smem = decode_smem_bytes(block_s, d, r)
    if smem > _smem_limit(q.device):
        raise ValueError(f"block_s={block_s} stages {smem} B of shared "
                         f"memory, over the block's limit")
    for x in (q, k_cache, v_cache, cache_len):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")


def decode_attention(q, k_cache, v_cache, cache_len, *, block_s: int,
                     scale=None) -> torch.Tensor:
    """Contiguous grouped decode.  CPU tensors (or
    ``kernels.force("plain")``) run the plain version; CUDA tensors
    launch the kernel, whose launch count is
    ``decode_attention.launches``."""
    if kernels.use_plain(q):
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      block_s=block_s, scale=scale)
    block_s = int(block_s)
    _check(q, k_cache, v_cache, cache_len, block_s)
    b, g, r, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if b == 0:
        return out
    fn = _build.load("decode_attention").decode_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_len.data_ptr(), out.data_ptr(), b, k_cache.shape[1], g, r,
            d, block_s, float(scale), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
