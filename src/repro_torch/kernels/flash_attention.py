"""Causal flash attention for prefill, in the grouped-query layout.

The CUDA kernel (``csrc/flash_attention.cu``) replaces the JAX package's
``kernels/flash_attention.py::_flash_kernel`` (vmapped per (B, G, R) by
``models/attention.py::pallas_prefill_attention``) and the jnp sweep
``tiled_prefill_attention`` that chunked prefill runs.  ``q_offset`` is a
runtime argument: 0 is whole-prompt prefill; ``start`` over a private
row cache is one prefill chunk.  Tiles ``(block_q, block_k)`` come from
the serving router's plan.

``flash_attention_plain`` is the plain PyTorch version, the schedule of
``tiled_prefill_attention``: query tiles of ``block_q`` rows, key tiles
of ``block_k`` columns, an online softmax across key tiles (key tiles in
a query tile's causal future are skipped — they are fully masked).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import _build

__all__ = ["flash_attention", "flash_attention_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM = 64           # the one head_dim built: smollm-135m's
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def flash_attention_plain(q, k, v, *, block_q: int, block_k: int,
                          q_offset: int = 0, scale=None) -> torch.Tensor:
    """Plain version: q (B, Sq, G, R, D), k/v (B, Sk, G, D); causal mask
    ``k_pos <= q_pos + q_offset``.  Returns (B, Sq, G, R, D) in q's dtype,
    accumulated in float32."""
    b, s, g, r, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    bq, bk = max(1, min(int(block_q), s)), max(1, min(int(block_k), sk))
    qf, kf, vf = q.float() * scale, k.float(), v.float()
    out = torch.empty((b, s, g, r, d), device=q.device)
    neg = float("-inf")
    for q0 in range(0, s, bq):
        qb = qf[:, q0:q0 + bq]
        nq = qb.shape[1]
        q_pos = q0 + torch.arange(nq, device=q.device) + q_offset
        m = torch.full((b, nq, g, r), neg, device=q.device)
        l = torch.zeros((b, nq, g, r), device=q.device)
        acc = torch.zeros((b, nq, g, r, d), device=q.device)
        for k0 in range(0, min(sk, q0 + nq + q_offset), bk):
            kb, vb = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
            sc = torch.einsum("bsgrd,bcgd->bsgrc", qb, kb)
            k_pos = k0 + torch.arange(kb.shape[1], device=q.device)
            ok = k_pos[None, :] <= q_pos[:, None]
            sc = sc.masked_fill(~ok[None, :, None, None, :], neg)
            m_new = torch.maximum(m, sc.amax(-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(torch.isfinite(sc),
                            torch.exp(sc - m_safe[..., None]), 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] \
                + torch.einsum("bsgrc,bcgd->bsgrd", p, vb)
            m = m_new
        out[:, q0:q0 + nq] = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def _check(q, k, v, block_q, block_k, q_offset):
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.dim() != 5 or k.dim() != 4:
        raise ValueError("q must be (B, Sq, G, R, D) and k/v (B, Sk, G, D)")
    b, _, g, _, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (g, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if d != _HEAD_DIM:
        raise ValueError(f"kernel takes head_dim {_HEAD_DIM}, got {d}")
    if not (1 <= block_q <= 128 and block_k >= 1 and q_offset >= 0):
        raise ValueError(f"illegal tiles ({block_q}, {block_k}) or "
                         f"q_offset {q_offset}")
    for x in (q, k, v):
        if x.device != q.device or not x.is_contiguous():
            raise ValueError("q, k and v must be contiguous on one device")


def flash_attention(q, k, v, *, block_q: int, block_k: int,
                    q_offset: int = 0, scale=None, window=None,
                    prefix_len=None) -> torch.Tensor:
    """Causal grouped flash attention.  CPU tensors (or
    ``kernels.force("plain")``) run the plain version; CUDA tensors launch
    the kernel, whose launch count is ``flash_attention.launches``.
    Sliding windows and prefix-LM masks are not supported and raise."""
    if window is not None or prefix_len is not None:
        raise NotImplementedError("flash_attention: window and prefix_len "
                                  "masks are not ported (smollm has neither)")
    q_offset = int(q_offset)
    if kernels.use_plain(q):
        return flash_attention_plain(q, k, v, block_q=block_q,
                                     block_k=block_k, q_offset=q_offset,
                                     scale=scale)
    block_q, block_k = int(block_q), int(block_k)
    _check(q, k, v, block_q, block_k, q_offset)
    b, s, g, r, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.load("flash_attention").flash_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, k.shape[1], g, r, d, block_q, block_k, q_offset,
            float(scale), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
