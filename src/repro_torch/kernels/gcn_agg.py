"""GCN neighbourhood aggregation ``A_hat (N, N) @ X (N, F)`` over a dense
normalised adjacency, in one pass over ``A_hat``.

The CUDA kernel (``csrc/gcn_agg.cu``) replaces the JAX package's
``kernels/gcn_agg.py::_gcn_kernel``.  Its launch — ``plan.lws`` node rows
per warp, ``block_n = 8 lws`` node rows per CTA, feature tiles over the
grid's second dimension — comes from ``core.mapper.plan_gcn`` under one
of the mapping policies.  The kernel streams each A row once (per
feature tile) in 16-byte vectors between a scalar head and tail, finds
the non-zeros by ballot and gathers their X rows in ascending column
order; it needs no tile-occupancy mask, the JAX wrapper's way to skip
the MXU work of an empty tile.

``gcn_aggregate_plain`` is the plain version: ``A.float() @ X.float()``
rounded once to X's dtype (``ref.gcn_aggregate``).  Skipping the zeros
changes nothing but the work, and a NaN in A reaches its row's sums in
both, where the JAX wrapper skips a tile whose ``sum |a|`` is NaN.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core.mapper import GcnPlan
from repro_torch.kernels import _build
from repro_torch.kernels.vecadd import DTYPES

__all__ = ["gcn_agg", "gcn_aggregate_plain", "occupancy"]

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def gcn_aggregate_plain(adj: torch.Tensor, feats: torch.Tensor
                        ) -> torch.Tensor:
    return (adj.float() @ feats.float()).to(feats.dtype)


def _check(adj, feats, plan: GcnPlan) -> None:
    if feats.dtype not in DTYPES:
        raise TypeError(f"gcn_aggregate takes float32 or bfloat16, got "
                        f"{feats.dtype}")
    if adj.dim() != 2 or feats.dim() != 2 or adj.shape[0] != adj.shape[1] \
            or adj.shape[1] != feats.shape[0]:
        raise ValueError(f"gcn_aggregate takes A (N, N) and X (N, F), got "
                         f"{tuple(adj.shape)} and {tuple(feats.shape)}")
    if adj.dtype != feats.dtype or adj.device != feats.device \
            or not (adj.is_contiguous() and feats.is_contiguous()):
        raise ValueError("gcn_aggregate: A and X must be contiguous, of one "
                         "dtype and device")
    n, f = feats.shape
    if plan.grid[0] * plan.block_n < n or plan.grid[1] * 32 * plan.fpl < f:
        raise ValueError(f"gcn_aggregate: plan {plan} does not cover "
                         f"({n}, {f})")


def gcn_agg(adj: torch.Tensor, feats: torch.Tensor, *,
            plan: GcnPlan) -> torch.Tensor:
    """The op, one launch: CPU tensors (or ``kernels.force("plain")``)
    run the plain version; CUDA tensors launch the kernel, whose launch
    count is ``gcn_agg.launches``."""
    if kernels.use_plain(feats):
        return gcn_aggregate_plain(adj, feats)
    _check(adj, feats, plan)
    n, f = feats.shape
    out = torch.empty_like(feats)
    if out.numel() == 0:
        return out
    fn = _build.load("gcn_agg").gcn_agg
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(adj.data_ptr(), feats.data_ptr(), out.data_ptr(), n, f,
            plan.lws, plan.grid[0], plan.grid[1], plan.fpl,
            DTYPES[feats.dtype],
            torch.cuda.current_stream(feats.device).cuda_stream)
    _build.check(rc, "gcn_agg")
    gcn_agg.launches += 1
    return out


gcn_agg.launches = 0


def occupancy(plan: GcnPlan, dtype: torch.dtype) -> int:
    """Resident CTAs per SM that the CUDA runtime reports for the plan's
    instantiation."""
    fn = _build.load("gcn_agg").gcn_occupancy
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    _build.check(fn(plan.fpl, DTYPES[dtype], ctypes.byref(blocks)),
                 "gcn_occupancy")
    return blocks.value
