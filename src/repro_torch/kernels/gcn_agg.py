"""GCN neighbourhood aggregation ``A_hat (N, N) @ X (N, F)`` over a dense
normalised adjacency, skipping the source tiles that hold no edge.

The CUDA kernel (``csrc/gcn_agg.cu``) replaces the JAX package's
``kernels/gcn_agg.py::_gcn_kernel``.  Its launch — ``plan.lws`` node rows
per warp, a ``block_n = 8 lws`` node block per CTA, ``block_s``-wide
source tiles, feature tiles over the grid's second dimension — comes
from ``core.mapper.plan_gcn`` under one of the mapping policies.
``gcn_aggregate`` is the op: the tile occupancy of ``A_hat`` under the
plan's tiles (``tile_occupancy``, torch ops on the input's device, as
``gcn_aggregate_pallas`` computes it before its kernel), then the kernel.

``gcn_aggregate_plain`` is the plain version: ``A.float() @ X.float()``
rounded once to X's dtype (``ref.gcn_aggregate``); skipping an empty
tile changes nothing but the work.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.core.hw import ceil_div
from repro_torch.core.mapper import GcnPlan
from repro_torch.kernels import _build
from repro_torch.kernels.vecadd import DTYPES

__all__ = ["gcn_aggregate", "gcn_aggregate_plain", "gcn_agg",
           "tile_occupancy", "occupancy"]

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def tile_occupancy(adj: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """``(ceil(n / bm), ceil(m / bk))`` int32 mask: 1 where the adjacency
    tile has any non-zero entry (``max |a| > 0``, which is the JAX
    ``sum |a| > 0``, NaN included).  Reads ``adj`` once in place: the
    column tiles are views, only the small per-row mask is padded."""
    n, m = adj.shape
    full = m // bk
    cols = []
    if full:
        lo, hi = torch.aminmax(adj[:, :full * bk].unflatten(1, (full, bk)),
                               dim=-1)
        cols.append((hi > 0) | (lo < 0))
    if m > full * bk:
        lo, hi = torch.aminmax(adj[:, full * bk:], dim=-1)
        cols.append(((hi > 0) | (lo < 0))[:, None])
    rows = torch.cat(cols, dim=1).to(torch.int32)        # (n, tiles)
    nb = ceil_div(n, bm)
    rows = F.pad(rows, (0, 0, 0, nb * bm - n))
    return rows.view(nb, bm, -1).amax(dim=1).contiguous()


def gcn_aggregate_plain(adj: torch.Tensor, feats: torch.Tensor
                        ) -> torch.Tensor:
    return (adj.float() @ feats.float()).to(feats.dtype)


def _check(adj, feats, occ, plan: GcnPlan) -> None:
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
    want = (ceil_div(n, plan.block_n), ceil_div(n, plan.block_s))
    if occ.shape != want or occ.dtype != torch.int32 \
            or occ.device != adj.device or not occ.is_contiguous():
        raise ValueError(f"gcn_aggregate: occupancy {tuple(occ.shape)} "
                         f"{occ.dtype} does not match the plan's tiles "
                         f"{want}")


def gcn_agg(adj: torch.Tensor, feats: torch.Tensor, occ: torch.Tensor, *,
            plan: GcnPlan) -> torch.Tensor:
    """The kernel over a given occupancy mask.  CPU tensors (or
    ``kernels.force("plain")``) run the plain version; CUDA tensors
    launch the kernel, whose launch count is ``gcn_agg.launches``."""
    if kernels.use_plain(feats):
        return gcn_aggregate_plain(adj, feats)
    _check(adj, feats, occ, plan)
    n, f = feats.shape
    out = torch.empty_like(feats)
    if out.numel() == 0:
        return out
    fn = _build.load("gcn_agg").gcn_agg
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(occ.data_ptr(), adj.data_ptr(), feats.data_ptr(), out.data_ptr(),
            n, f, plan.lws, plan.grid[0], plan.grid[1], plan.block_s,
            plan.fpl, DTYPES[feats.dtype],
            torch.cuda.current_stream(feats.device).cuda_stream)
    _build.check(rc, "gcn_agg")
    gcn_agg.launches += 1
    return out


gcn_agg.launches = 0


def gcn_aggregate(adj: torch.Tensor, feats: torch.Tensor, *,
                  plan: GcnPlan) -> torch.Tensor:
    """The op: occupancy under the plan's tiles, then the kernel."""
    if kernels.use_plain(feats):
        return gcn_aggregate_plain(adj, feats)
    occ = tile_occupancy(adj, plan.block_n, plan.block_s)
    return gcn_agg(adj, feats, occ, plan=plan)


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
