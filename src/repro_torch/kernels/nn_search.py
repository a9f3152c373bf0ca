"""Nearest-neighbour search: queries ``(Q, D)`` against refs ``(R, D)``,
returning the index (int32) and squared L2 distance (float32) of each
query's nearest ref, ties to the lowest index.

The CUDA kernel (``csrc/nn_search.cu``) replaces the JAX package's
``kernels/nn_search.py::_nn_kernel``.  It runs the dots on the tensor
cores, two launches a call:

  * ``prep`` (counted in ``nn_search.prep_launches``): each row's
    ``|x|^2`` in float32 (refs past R, up to the last ref tile's end,
    +inf: a padded ref never wins) and, per ``layout``, the K-major
    sources of the product: for float32 the TF32 big and small halves of
    Q and R (``kernels/matmul.py::tf32_split_plain``'s rounding), K
    padded to ``kp``; for bfloat16 rows that TMA cannot take a padded
    copy; bfloat16 that TMA takes is read where it lies.
  * ``product`` (counted in ``nn_search.launches``): a ``plan.bm`` x
    ``plan.bn`` (query, ref) tile of ``wgmma`` dots a step (3xTF32 for
    float32), ``d^2 = (|q|^2 - 2 q.r) + |r|^2`` and a running argmin in
    registers, never a distance in memory; the grid is (query tiles, ref
    splits), the splits merged by the last CTA of each query tile
    (``core.mapper.plan_nn``).

``nn_search_plain`` is the plain version: ``|q|^2 - 2 q.r + |r|^2`` in
float32, then an argmin that keeps the first index (``ref.nn_search``),
over chunks of queries so the distance matrix stays within 2^26
entries.  ``prep`` and ``product`` on CPU tensors run their own plain
versions: the same workspaces, and the kernel's dots (the three TF32
products summed in float32) with its distance rounding and argmin.  The
kernel sums each dot in another order than ``nn_search_plain``, so where
two refs' distances differ by less than the rounding of that sum (a
near-tie) the two may pick different indices; ``chip_smoke.py`` counts
such rows.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core.hw import round_up
from repro_torch.core.mapper import NNPlan, nn_step_bytes
from repro_torch.kernels import _build
from repro_torch.kernels.matmul import tf32_split_plain
from repro_torch.kernels.vecadd import DTYPES, VECTOR_BYTES

__all__ = ["nn_search", "nn_search_plain", "layout", "prep", "product",
           "occupancy"]

_PREP_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
    + [ctypes.c_void_p]
_PRODUCT_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 \
    + [ctypes.c_void_p]
_MODES = {"norms": 0, "copy": 1, "split": 2}
_PLAIN_CHUNK = 1 << 26          # distance-matrix entries per chunk
#: (device, stream) -> int32 tickets of the split merge, one a query tile,
#: zeroed when allocated (every launch leaves them zero), grown when a
#: launch needs more.  Launches on one stream run in order and share them.
_TICKETS: dict = {}


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


def layout(queries: torch.Tensor, refs: torch.Tensor) -> tuple[str, int]:
    """``(mode, kp)``: what ``prep`` writes for the product, and the K
    columns of the product's sources.  float32: "split", the TF32 halves,
    ``kp`` = D rounded up to 4 (16-byte rows); bfloat16 whose rows (D a
    multiple of 8) and pointers lie on 16 bytes: "norms", the inputs read
    where they lie, ``kp`` = D; other bfloat16: "copy", ``kp`` = D
    rounded up to 8."""
    d, es = queries.shape[1], queries.element_size()
    if queries.dtype == torch.float32:
        return "split", round_up(d, VECTOR_BYTES // es)
    if (d * es) % VECTOR_BYTES == 0 and queries.data_ptr() % VECTOR_BYTES \
            == 0 and refs.data_ptr() % VECTOR_BYTES == 0:
        return "norms", d
    return "copy", round_up(d, VECTOR_BYTES // es)


def _padded(plan: NNPlan, nq: int, nr: int) -> tuple[int, int]:
    """Queries and refs padded to whole query and ref tiles."""
    return round_up(max(nq, 1), plan.bm), round_up(max(nr, 1), plan.bn)


def prep(queries: torch.Tensor, refs: torch.Tensor, plan: NNPlan
         ) -> tuple[torch.Tensor | None, torch.Tensor]:
    """The first launch: ``(ws, norms)``.  ``norms`` (float32) holds
    ``|q|^2`` for the queries padded to whole query tiles (0 past Q),
    then ``|r|^2`` for the refs padded to whole ref tiles (+inf past R).
    ``ws`` is None ("norms"), the bfloat16 copy (2 blocks: Q (Q, kp),
    then R (R, kp), flattened) or the float32 split (Q big, Q small, R
    big, R small, each (rows, kp), flattened), K padded with zeros.
    Counted in ``nn_search.prep_launches``."""
    (nq, d), nr = queries.shape, refs.shape[0]
    mode, kp = layout(queries, refs)
    nq_pad, nr_pad = _padded(plan, nq, nr)
    if kernels.use_plain(queries):
        qf, rf = queries.float(), refs.float()
        norms = torch.zeros(nq_pad + nr_pad, dtype=torch.float32,
                            device=queries.device)
        norms[:nq] = (qf * qf).sum(-1)
        norms[nq_pad:nq_pad + nr] = (rf * rf).sum(-1)
        norms[nq_pad + nr:] = float("inf")
        if mode == "norms":
            return None, norms
        halves = [[t] for t in (queries, refs)] if mode == "copy" else \
            [list(tf32_split_plain(t)) for t in (qf, rf)]
        blocks = []
        for parts in halves:
            for h in parts:
                pad = h.new_zeros((h.shape[0], kp))
                pad[:, :d] = h
                blocks.append(pad.flatten())
        return torch.cat(blocks), norms
    _check(queries, refs, plan)
    norms = torch.empty(nq_pad + nr_pad, dtype=torch.float32,
                        device=queries.device)
    ws = None
    if mode != "norms":
        halves = 2 if mode == "split" else 1
        ws = torch.empty(halves * (nq + nr) * kp, dtype=queries.dtype,
                         device=queries.device)
    fn = _build.load("nn_search").nn_prep
    fn.argtypes, fn.restype = _PREP_ARGTYPES, ctypes.c_int
    rc = fn(queries.data_ptr(), refs.data_ptr(),
            None if ws is None else ws.data_ptr(), norms.data_ptr(), nq, nr,
            d, kp, nq_pad, nr_pad, _MODES[mode], DTYPES[queries.dtype],
            torch.cuda.current_stream(queries.device).cuda_stream)
    _build.check(rc, "nn_prep")
    nn_search.prep_launches += 1
    return ws, norms


def _sources(queries, refs, ws, kp):
    """The product's K-major sources as (rows, kp) views: the inputs
    ("norms"), or the first block of each operand in ``ws`` (Q's and R's
    big halves for the split, each followed by its small half)."""
    nq, nr = queries.shape[0], refs.shape[0]
    if ws is None:
        return queries, refs
    halves = ws.numel() // ((nq + nr) * kp)
    q = ws[:halves * nq * kp].view(halves, nq, kp)
    r = ws[halves * nq * kp:].view(halves, nr, kp)
    return q, r


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _TICKETS[device, stream] = t
    return t


def product(queries: torch.Tensor, refs: torch.Tensor,
            ws: torch.Tensor | None, norms: torch.Tensor, plan: NNPlan
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The second launch: ``(idx, dist)`` from ``prep``'s ``(ws,
    norms)``.  Counted in ``nn_search.launches``."""
    nq, nr = queries.shape[0], refs.shape[0]
    mode, kp = layout(queries, refs)
    nq_pad, _ = _padded(plan, nq, nr)
    q, r = _sources(queries, refs, ws, kp)
    if kernels.use_plain(queries):
        if mode == "split":
            (qb, qs), (rb, rs) = q, r
            s = qs @ rb.T + qb @ rs.T + qb @ rb.T
        else:
            s = q.reshape(nq, kp).float() @ r.reshape(nr, kp).float().T
        d2 = (norms[:nq, None] - 2.0 * s) + norms[nq_pad:nq_pad + nr]
        m = torch.argmin(d2, -1)
        return m.to(torch.int32), d2.gather(-1, m[:, None])[:, 0]
    _check(queries, refs, plan)
    dev = queries.device
    idx = torch.empty(nq, dtype=torch.int32, device=dev)
    dist = torch.empty(nq, dtype=torch.float32, device=dev)
    splits = plan.grid[1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    part_d = part_i = tickets = None
    if splits > 1:
        part_d = torch.empty(splits * nq_pad, dtype=torch.float32, device=dev)
        part_i = torch.empty(splits * nq_pad, dtype=torch.int32, device=dev)
        tickets = _tickets(dev, stream, plan.grid[0])
    fn = _build.load("nn_search").nn_product
    fn.argtypes, fn.restype = _PRODUCT_ARGTYPES, ctypes.c_int

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = fn(q.data_ptr(), r.data_ptr(), norms.data_ptr(), idx.data_ptr(),
            dist.data_ptr(), ptr(part_d), ptr(part_i), ptr(tickets), nq, nr,
            kp, nq_pad, plan.bm // 128, plan.bk * plan.elem_bytes,
            plan.split // plan.bn, splits, plan.stages,
            DTYPES[queries.dtype], stream)
    _build.check(rc, "nn_product")
    nn_search.launches += 1
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
    (nq, d), nr = queries.shape, refs.shape[0]
    if nr == 0 or d == 0:
        raise ValueError("nn_search needs at least one ref of one dim")
    if plan.elem_bytes != queries.element_size() \
            or plan.bk * plan.elem_bytes != nn_step_bytes(d, plan.elem_bytes) \
            or plan.grid[0] * plan.bm < nq \
            or plan.split % plan.bn \
            or not (plan.grid[1] - 1) * plan.split < nr \
            <= plan.grid[1] * plan.split:
        raise ValueError(f"nn_search: plan {plan} does not cover "
                         f"{tuple(queries.shape)} x {nr} refs")


def nn_search(queries: torch.Tensor, refs: torch.Tensor, *,
              plan: NNPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx int32 (Q,), squared distance float32 (Q,)).  CPU tensors (or
    ``kernels.force("plain")``) run the plain version; CUDA tensors
    launch the prep pass and the product (``nn_search.prep_launches``,
    ``nn_search.launches``)."""
    if kernels.use_plain(queries):
        return nn_search_plain(queries, refs)
    _check(queries, refs, plan)
    if queries.shape[0] == 0:
        return (torch.empty(0, dtype=torch.int32, device=queries.device),
                torch.empty(0, dtype=torch.float32, device=queries.device))
    return product(queries, refs, *prep(queries, refs, plan), plan)


nn_search.launches = 0
nn_search.prep_launches = 0


def occupancy(plan: NNPlan) -> int:
    """Resident CTAs per SM that the CUDA runtime reports for the plan's
    instantiation of the product and its shared memory."""
    fn = _build.load("nn_search").nn_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    dtype = 0 if plan.elem_bytes == 4 else 1
    _build.check(fn(plan.bm // 128, plan.bk * plan.elem_bytes, plan.stages,
                    dtype, ctypes.byref(blocks)), "nn_occupancy")
    return blocks.value
