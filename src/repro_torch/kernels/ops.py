"""Public kernel API of the paper's suite, with the mapping policy.

Each op resolves its launch at call time from the hardware parameters
(``hw`` defaults to ``detect()`` of the inputs' device: the paper's
runtime technique) and the mapping policy, through the tuner's dispatch
(``repro_torch.tuner.dispatch.resolve_plan``), then runs its kernel
wrapper: the hand-written CUDA kernel for CUDA tensors, the plain
version for CPU tensors.  Nothing here moves a tensor between devices.

The policy is ``"naive"``, ``"fixed"``, ``"auto"`` (the default, Eq. 1)
or ``"tuned"``: the Eq. 1 seed refined over the kernel's legaliser and
kept in the process-wide tuning cache (``tuner.get_default_cache``), a
warm hit a dict lookup.  ``policy=`` overrides per call,
``set_default_policy`` for the process, and ``with ops.policy("tuned"):
...`` for a scope.  A TUNED miss refines on the roofline alone unless
``set_default_measure`` (or ``with ops.measuring("live"): ...``) asks
for measured refinement: "cached" re-ranks by recorded times, "live"
times the roofline's top candidates on the inputs' device.

``flash_attention`` is single-head attention over leading dims, the
JAX package's ``ops.flash_attention``.  ``decode_attention`` is the
suite's entry point to the contiguous decode kernel the engine's
unpaged and gather-then-sweep paths run: its ``block_s`` and split
width under the policy.  ``ssd`` (Mamba-2's chunked scan) takes its
chunk from ``chunk=`` or ``models.ssm.plan_ssd_chunk(L, hw)`` and
ignores ``policy=``, as the JAX package's ``ops.ssd`` does (the tuner
registers no SSD).

    >>> import torch
    >>> from repro_torch.kernels import ops
    >>> x = torch.ones(1000)
    >>> ops.vecadd(x, x, policy="fixed")[:3]
    tensor([2., 2., 2.])
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Literal, Optional

import torch

from repro_torch.core.hw import GpuParams, detect
from repro_torch.core.mapper import MappingPolicy
from repro_torch.kernels import ssd as _ssd
from repro_torch.tuner import dispatch as tdispatch
from repro_torch.tuner.dispatch import MEASURE_MODES

__all__ = ["vecadd", "saxpy", "matmul", "rmsnorm", "gaussian_blur",
           "nn_search", "gcn_aggregate", "flash_attention",
           "decode_attention", "ssd",
           "set_default_policy", "policy", "set_default_measure",
           "get_default_measure", "measuring"]

MeasureMode = Literal["off", "cached", "live"]

_DEFAULT_POLICY: MappingPolicy = MappingPolicy.AUTO
_DEFAULT_MEASURE: MeasureMode = "off"


def set_default_policy(policy: MappingPolicy | str) -> None:
    global _DEFAULT_POLICY
    _DEFAULT_POLICY = MappingPolicy(policy)


def set_default_measure(mode: MeasureMode) -> None:
    """Process-wide ``measure=`` mode of TUNED cache misses: "off" the
    roofline, "cached" recorded times, "live" times taken on the device
    and recorded.  A warm hit never measures."""
    global _DEFAULT_MEASURE
    if mode not in MEASURE_MODES:
        raise ValueError(f"measure must be one of {MEASURE_MODES}, "
                         f"got {mode!r}")
    _DEFAULT_MEASURE = mode


def get_default_measure() -> MeasureMode:
    return _DEFAULT_MEASURE


@contextlib.contextmanager
def policy(policy: MappingPolicy | str) -> Iterator[None]:
    """Scoped ``set_default_policy``: ``with ops.policy("tuned"): ...``"""
    global _DEFAULT_POLICY
    prev = _DEFAULT_POLICY
    set_default_policy(policy)
    try:
        yield
    finally:
        _DEFAULT_POLICY = prev


@contextlib.contextmanager
def measuring(mode: MeasureMode) -> Iterator[None]:
    """Scoped ``set_default_measure``: ``with ops.measuring("live"): ...``"""
    global _DEFAULT_MEASURE
    prev = _DEFAULT_MEASURE
    set_default_measure(mode)
    try:
        yield
    finally:
        _DEFAULT_MEASURE = prev


def _resolve(policy) -> MappingPolicy:
    return MappingPolicy(policy) if policy is not None else _DEFAULT_POLICY


def _hw(t: torch.Tensor, hw: Optional[GpuParams]) -> GpuParams:
    return hw or detect(t.device)


def _call(kernel: str, *args, policy, hw, **kwargs):
    """Resolve ``kernel``'s plan for ``args`` under the policy (TUNED
    through the default cache) and run it."""
    return tdispatch.tuned_call(kernel, *args, hw=_hw(args[-1], hw),
                                policy=_resolve(policy),
                                measure=_DEFAULT_MEASURE, **kwargs)


def vecadd(x, y, *, policy=None, hw: Optional[GpuParams] = None):
    return _call("vecadd", x, y, policy=policy, hw=hw)


def saxpy(a, x, y, *, policy=None, hw: Optional[GpuParams] = None):
    return _call("saxpy", a, x, y, policy=policy, hw=hw)


def matmul(a, b, *, policy=None, out_dtype=None,
           hw: Optional[GpuParams] = None):
    """``a @ b``, planned for the kernel of the operands' route
    (``kernels.matmul.route``): float32 as three TF32 products on the
    tensor cores ("tf32x3"), bfloat16 of any shape and alignment on the
    tensor cores ("tensor_core")."""
    return _call("matmul", a, b, policy=policy, hw=hw, out_dtype=out_dtype)


def rmsnorm(x, gamma, *, eps: float = 1e-6, policy=None,
            hw: Optional[GpuParams] = None):
    """x: (..., d) — leading dims flattened into token rows."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    out = _call("rmsnorm", x2, gamma, policy=policy, hw=_hw(x, hw), eps=eps)
    return out.reshape(shape)


def gaussian_blur(img, *, ksize: int = 5, sigma: float = 1.0, policy=None,
                  hw: Optional[GpuParams] = None):
    """img: (h, w) — separable blur, zero "same" padding."""
    return _call("gaussian_blur", img, policy=policy, hw=hw, ksize=ksize,
                 sigma=sigma)


def nn_search(queries, refs, *, policy=None, hw: Optional[GpuParams] = None):
    """queries (Q, D), refs (R, D) -> (idx int32 (Q,), sq-dist f32 (Q,))."""
    return _call("nn_search", queries, refs, policy=policy, hw=hw)


def gcn_aggregate(adj_norm, feats, *, policy=None,
                  hw: Optional[GpuParams] = None):
    """adj_norm (N, N) dense normalised adjacency; feats (N, F)."""
    return _call("gcn_agg", adj_norm, feats, policy=policy, hw=hw)


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    policy=None, hw: Optional[GpuParams] = None):
    """q (..., sq, d), k/v (..., skv, d) -> (..., sq, d): attention of
    each leading index's queries over its own keys (the JAX package's
    layout; the leading dims run as the kernel's batch, one query head
    and one KV group each).  Causal queries sit at the end of the keys
    (``q_offset = skv - sq``), as the JAX kernel aligns them; causal
    needs ``sq <= skv``.  The tiles are the AUTO seed under NAIVE, FIXED
    and AUTO (the flash plan has no policy of its own), the tuner's under
    TUNED."""
    return _call("flash_attention", q, k, v, policy=policy, hw=hw,
                 causal=causal, scale=scale)


def decode_attention(q, k_cache, v_cache, cache_len=None, *, scale=None,
                     policy=None, hw: Optional[GpuParams] = None):
    """q (..., d), caches (..., S, d), ``cache_len`` broadcastable to the
    leading dims (default S) -> (..., d): single-token attention of each
    query over its own cache, masked past its length (the JAX package's
    layout).  The leading dims run as the kernel's rows, one query head
    and one KV group each; one ``block_s`` and one split width serve
    them all (NAIVE one split a row, FIXED 512 positions, AUTO Eq. 1
    over the resident CTA slots, TUNED the tuner's)."""
    lead = q.shape[:-1]
    s, d = k_cache.shape[-2:]
    rows = q.reshape(-1, 1, 1, d).contiguous()
    kc = k_cache.reshape(-1, s, 1, d).contiguous()
    vc = v_cache.reshape(-1, s, 1, d).contiguous()
    if cache_len is None:
        cache_len = s
    clen = torch.broadcast_to(torch.as_tensor(cache_len, dtype=torch.int32,
                                              device=q.device), lead)
    out = _call("decode_attention", rows, kc, vc,
                clen.reshape(-1).contiguous(), policy=policy, hw=hw,
                scale=scale)
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
