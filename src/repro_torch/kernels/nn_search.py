"""Nearest-neighbour search: queries ``(Q, D)`` against refs ``(R, D)``,
returning the index (int32) and squared L2 distance (float32) of each
query's nearest ref, ties to the lowest index.

The CUDA kernel (``csrc/nn_search.cu``) replaces the JAX package's
``kernels/nn_search.py::_nn_kernel``.  Its launch — ``plan.lws`` queries
per thread, refs swept in ``plan.block_r`` blocks staged in shared
memory — comes from ``core.mapper.plan_nn`` under one of the mapping
policies.

``nn_search_plain`` is the plain version: ``|q|^2 - 2 q.r + |r|^2`` in
float32, then an argmin that keeps the first index (``ref.nn_search``),
over chunks of queries so the distance matrix stays within 2^26
entries.  The kernel sums each dot in another order, so where two refs'
distances differ by less than the rounding of that sum (a near-tie) the
two may pick different indices; ``chip_smoke.py`` counts such rows.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core.mapper import NNPlan, nn_chunk
from repro_torch.kernels import _build
from repro_torch.kernels.vecadd import DTYPES

__all__ = ["nn_search", "nn_search_plain", "occupancy"]

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_PLAIN_CHUNK = 1 << 26          # distance-matrix entries per chunk


def nn_search_plain(queries: torch.Tensor, refs: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    qf, rf = queries.float(), refs.float()
    nq, nr = qf.shape[0], rf.shape[0]
    rn = torch.sum(rf * rf, -1)
    idx = torch.empty(nq, dtype=torch.int32, device=qf.device)
    dist = torch.empty(nq, dtype=torch.float32, device=qf.device)
    step = max(1, _PLAIN_CHUNK // max(nr, 1))
    for i0 in range(0, nq, step):
        q = qf[i0:i0 + step]
        d2 = torch.sum(q * q, -1, keepdim=True) - 2.0 * (q @ rf.T) \
            + rn[None, :]
        m = torch.argmin(d2, -1)
        idx[i0:i0 + step] = m.to(torch.int32)
        dist[i0:i0 + step] = d2.gather(-1, m[:, None])[:, 0]
    return idx, dist


def _check(queries, refs, plan: NNPlan) -> None:
    if queries.dtype not in DTYPES:
        raise TypeError(f"nn_search takes float32 or bfloat16, got "
                        f"{queries.dtype}")
    if queries.dim() != 2 or refs.dim() != 2 \
            or queries.shape[1] != refs.shape[1]:
        raise ValueError(f"nn_search takes queries (Q, D) and refs (R, D), "
                         f"got {tuple(queries.shape)} and "
                         f"{tuple(refs.shape)}")
    if refs.dtype != queries.dtype or refs.device != queries.device \
            or not (queries.is_contiguous() and refs.is_contiguous()):
        raise ValueError("nn_search: queries and refs must be contiguous, "
                         "of one dtype and device")
    if refs.shape[0] == 0 or queries.shape[1] == 0:
        raise ValueError("nn_search needs at least one ref of one dim")
    if plan.chunk != nn_chunk(queries.shape[1]) \
            or plan.grid * plan.threads * plan.lws < queries.shape[0]:
        raise ValueError(f"nn_search: plan {plan} does not cover "
                         f"{tuple(queries.shape)}")


def nn_search(queries: torch.Tensor, refs: torch.Tensor, *,
              plan: NNPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx int32 (Q,), squared distance float32 (Q,)).  CPU tensors (or
    ``kernels.force("plain")``) run the plain version; CUDA tensors
    launch the kernel, whose launch count is ``nn_search.launches``."""
    if kernels.use_plain(queries):
        return nn_search_plain(queries, refs)
    _check(queries, refs, plan)
    nq, d = queries.shape
    idx = torch.empty(nq, dtype=torch.int32, device=queries.device)
    dist = torch.empty(nq, dtype=torch.float32, device=queries.device)
    if nq == 0:
        return idx, dist
    fn = _build.load("nn_search").nn_search
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = fn(queries.data_ptr(), refs.data_ptr(), idx.data_ptr(),
            dist.data_ptr(), nq, refs.shape[0], d, plan.lws, plan.grid,
            plan.block_r, plan.chunk, DTYPES[queries.dtype],
            torch.cuda.current_stream(queries.device).cuda_stream)
    _build.check(rc, "nn_search")
    nn_search.launches += 1
    return idx, dist


nn_search.launches = 0


def occupancy(plan: NNPlan, d: int, dtype: torch.dtype) -> int:
    """Resident CTAs per SM that the CUDA runtime reports for the plan's
    instantiation and shared memory."""
    fn = _build.load("nn_search").nn_occupancy
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    _build.check(fn(plan.chunk, plan.block_r, d, plan.lws, DTYPES[dtype],
                    ctypes.byref(blocks)), "nn_occupancy")
    return blocks.value
