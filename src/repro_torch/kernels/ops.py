"""Public kernel API of the paper's suite, with the mapping policy.

``flash_attention`` is single-head attention over leading dims, the
JAX package's ``ops.flash_attention``; its tiles come from
``plan_attention_blocks`` and it ignores ``policy`` until the tuner (as
the serving kernels do).  ``decode_attention`` is the suite's entry
point to the contiguous decode kernel the engine's unpaged and
gather-then-sweep paths run; its
``block_s`` comes from ``plan_cache_block`` and its split width from
``plan_decode_split`` under the policy.  ``ssd``
(Mamba-2's chunked scan) takes its chunk from ``chunk=`` or
``models.ssm.plan_ssd_chunk(L, hw)`` and ignores ``policy=``, as the JAX
package's ``ops.ssd`` does.

Each op resolves its launch at call time from the hardware parameters
(``hw`` defaults to ``detect()`` of the inputs' device: the paper's
runtime technique) and the mapping policy, then runs its kernel wrapper:
the hand-written CUDA kernel for CUDA tensors, the plain version for CPU
tensors.  Nothing here moves a tensor between devices.

The policy is ``"naive"``, ``"fixed"`` or ``"auto"`` (the default, Eq.
1); ``policy=`` overrides per call, ``set_default_policy`` for the
process, and ``with ops.policy("naive"): ...`` for a scope::

    >>> import torch
    >>> from repro_torch.kernels import ops
    >>> x = torch.ones(1000)
    >>> ops.vecadd(x, x, policy="fixed")[:3]
    tensor([2., 2., 2.])
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from repro_torch.core import workload
from repro_torch.core.hw import GpuParams, detect
from repro_torch.core.mapper import (MappingPolicy, plan_attention_blocks,
                                     plan_cache_block, plan_decode_split,
                                     plan_gcn, plan_nn, plan_rows,
                                     plan_vector_blocks)
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gcn_agg as _gcn_agg
from repro_torch.kernels import matmul as _matmul
from repro_torch.kernels import nn_search as _nn_search
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import saxpy as _saxpy
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import stencil as _stencil
from repro_torch.kernels import vecadd as _vecadd

__all__ = ["vecadd", "saxpy", "matmul", "rmsnorm", "gaussian_blur",
           "nn_search", "gcn_aggregate", "flash_attention",
           "decode_attention", "ssd",
           "set_default_policy", "policy"]

_DEFAULT_POLICY: MappingPolicy = MappingPolicy.AUTO


def set_default_policy(policy: MappingPolicy | str) -> None:
    global _DEFAULT_POLICY
    _DEFAULT_POLICY = MappingPolicy(policy)


@contextlib.contextmanager
def policy(policy: MappingPolicy | str) -> Iterator[None]:
    """Scoped ``set_default_policy``: ``with ops.policy("naive"): ...``"""
    global _DEFAULT_POLICY
    prev = _DEFAULT_POLICY
    set_default_policy(policy)
    try:
        yield
    finally:
        _DEFAULT_POLICY = prev


def _resolve(policy) -> MappingPolicy:
    return MappingPolicy(policy) if policy is not None else _DEFAULT_POLICY


def _hw(t: torch.Tensor, hw: Optional[GpuParams]) -> GpuParams:
    return hw or detect(t.device)


def vecadd(x, y, *, policy=None, hw: Optional[GpuParams] = None):
    plan = plan_vector_blocks(workload.vecadd(x.numel(), x.element_size()),
                              _hw(x, hw), _resolve(policy))
    return _vecadd.vecadd(x, y, plan=plan)


def saxpy(a, x, y, *, policy=None, hw: Optional[GpuParams] = None):
    plan = plan_vector_blocks(workload.saxpy(x.numel(), x.element_size()),
                              _hw(x, hw), _resolve(policy))
    return _saxpy.saxpy(a, x, y, plan=plan)


def matmul(a, b, *, policy=None, out_dtype=None,
           hw: Optional[GpuParams] = None):
    """``a @ b``, planned for the kernel of the operands' route
    (``kernels.matmul.route``): float32 as three TF32 products on the
    tensor cores ("tf32x3"), bfloat16 of any shape and alignment on the
    tensor cores ("tensor_core")."""
    plan = _matmul.plan_for(a, b, _hw(a, hw), _resolve(policy))
    return _matmul.matmul(a, b, plan=plan, out_dtype=out_dtype)


def rmsnorm(x, gamma, *, eps: float = 1e-6, policy=None,
            hw: Optional[GpuParams] = None):
    """x: (..., d) — leading dims flattened into token rows."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    plan = plan_rows(x2.shape[0], _hw(x, hw), _resolve(policy))
    return _rmsnorm.rmsnorm(x2, gamma, eps=eps, plan=plan).reshape(shape)


def gaussian_blur(img, *, ksize: int = 5, sigma: float = 1.0, policy=None,
                  hw: Optional[GpuParams] = None):
    """img: (h, w) — separable blur, zero "same" padding."""
    plan = _stencil.plan_for(img, ksize, _hw(img, hw), _resolve(policy))
    return _stencil.gaussian_blur(img, ksize=ksize, sigma=sigma, plan=plan)


def nn_search(queries, refs, *, policy=None, hw: Optional[GpuParams] = None):
    """queries (Q, D), refs (R, D) -> (idx int32 (Q,), sq-dist f32 (Q,))."""
    plan = plan_nn(queries.shape[0], refs.shape[0], queries.shape[1],
                   _hw(queries, hw), _resolve(policy),
                   elem_bytes=queries.element_size())
    return _nn_search.nn_search(queries, refs, plan=plan)


def gcn_aggregate(adj_norm, feats, *, policy=None,
                  hw: Optional[GpuParams] = None):
    """adj_norm (N, N) dense normalised adjacency; feats (N, F)."""
    plan = plan_gcn(feats.shape[0], feats.shape[1], _hw(feats, hw),
                    _resolve(policy))
    return _gcn_agg.gcn_agg(adj_norm, feats, plan=plan)


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    policy=None, hw: Optional[GpuParams] = None):
    """q (..., sq, d), k/v (..., skv, d) -> (..., sq, d): attention of
    each leading index's queries over its own keys (the JAX package's
    layout; the leading dims run as the kernel's batch, one query head
    and one KV group each).  Causal queries sit at the end of the keys
    (``q_offset = skv - sq``), as the JAX kernel aligns them; causal
    needs ``sq <= skv``.  ``policy`` is ignored until the tuner (ROADMAP
    queue 1, item 4)."""
    del policy
    sq, d = q.shape[-2:]
    skv = k.shape[-2]
    if causal and sq > skv:
        raise ValueError(f"causal flash_attention needs sq <= skv, got "
                         f"{sq} > {skv}")
    plan = plan_attention_blocks(sq, skv, d, _hw(q, hw))
    out = _flash.flash_attention(
        q.reshape(-1, sq, 1, 1, d).contiguous(),
        k.reshape(-1, skv, 1, d).contiguous(),
        v.reshape(-1, skv, 1, d).contiguous(), block_q=plan.block_q,
        block_k=plan.block_k, q_offset=skv - sq if causal else 0,
        scale=scale, causal=causal)
    return out.reshape(q.shape)


def decode_attention(q, k_cache, v_cache, cache_len=None, *, scale=None,
                     policy=None, hw: Optional[GpuParams] = None):
    """q (..., d), caches (..., S, d), ``cache_len`` broadcastable to the
    leading dims (default S) -> (..., d): single-token attention of each
    query over its own cache, masked past its length (the JAX package's
    layout).  The leading dims run as the kernel's rows, one query head
    and one KV group each; one ``block_s`` and one split width serve
    them all (NAIVE one split a row, FIXED 512 positions, AUTO Eq. 1
    over the resident CTA slots)."""
    lead = q.shape[:-1]
    s, d = k_cache.shape[-2:]
    rows = q.reshape(-1, 1, 1, d).contiguous()
    kc = k_cache.reshape(-1, s, 1, d).contiguous()
    vc = v_cache.reshape(-1, s, 1, d).contiguous()
    if cache_len is None:
        cache_len = s
    clen = torch.broadcast_to(torch.as_tensor(cache_len, dtype=torch.int32,
                                              device=q.device), lead)
    hw, policy = _hw(q, hw), _resolve(policy)
    block = plan_cache_block(s, d, hw, policy)
    split = plan_decode_split(s, rows.shape[0], block, d, hw, policy)
    out = _decode.decode_attention(rows, kc, vc,
                                   clen.reshape(-1).contiguous(),
                                   block_s=block, split=split, scale=scale)
    return out.reshape(q.shape)


def ssd(x, a, b, c, *, chunk=None, policy=None,
        hw: Optional[GpuParams] = None):
    """Mamba-2 SSD: x (L, H, P), a (L, H), b/c (L, G, N) -> (L, H, P).
    ``policy`` is ignored: the chunk is ``chunk`` or planned by
    ``plan_ssd_chunk(L, hw)`` (the mapper's AUTO), then capped at L and
    halved until it divides L.  (On a platform without its kernel the
    JAX ``ops.ssd`` calls ``ref.ssd_chunked(chunk=chunk or 128)`` with no
    halving; this follows its kernel path's rules.)"""
    del policy
    return _ssd.ssd(x, a, b, c, chunk=chunk, hw=_hw(x, hw))
