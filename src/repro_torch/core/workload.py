"""Workload descriptors — the software side of Eq. 1.

A kernel is characterised by its global work size ``gws`` (total
iterations) and its per-iteration arithmetic and memory traffic.  The
mapper reads ``gws``; ``chip_smoke.py`` reads the FLOPs for its roofline
bounds; the Vortex trace model (``core.tracesim``) reads the
per-iteration instructions and bytes.  A copy of the paper-suite part of
the JAX package's ``core/workload.py``, with its validation suite
``PAPER_KERNELS`` (the port imports nothing of it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["Workload", "vecadd", "saxpy", "relu", "sgemm", "conv_layer",
           "gaussian_blur", "nearest_neighbor", "gcn_aggregate",
           "dnn_fc_layer", "gcn_layer", "PAPER_KERNELS", "MATH_KERNELS"]


@dataclasses.dataclass(frozen=True)
class Workload:
    """One kernel invocation's software parameters.

    gws              total kernel iterations (paper's global work size)
    flops_per_iter   arithmetic per iteration
    bytes_per_iter   memory traffic per iteration (read + write)
    instrs_per_iter  issued instructions per iteration (trace model)
    dtype_bytes      element width
    dims             optional nd shape whose product is gws
    reduce_dim       inner reduction length (matmul-like kernels), if any
    """

    name: str
    gws: int
    flops_per_iter: float
    bytes_per_iter: float
    instrs_per_iter: float
    dtype_bytes: int = 4
    dims: Optional[tuple[int, ...]] = None
    reduce_dim: Optional[int] = None

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops_per_iter / max(self.bytes_per_iter, 1e-9)

    @property
    def total_flops(self) -> float:
        return self.gws * self.flops_per_iter

    @property
    def total_bytes(self) -> float:
        return self.gws * self.bytes_per_iter


def vecadd(n: int, dtype_bytes: int = 4) -> Workload:
    """c[i] = a[i] + b[i] — the paper's Fig. 1 kernel."""
    return Workload(
        name="vecadd", gws=n, flops_per_iter=1,
        bytes_per_iter=3 * dtype_bytes, instrs_per_iter=8,
        dtype_bytes=dtype_bytes, dims=(n,),
    )


def saxpy(n: int, dtype_bytes: int = 4) -> Workload:
    """y[i] = a*x[i] + y[i]."""
    return Workload(
        name="saxpy", gws=n, flops_per_iter=2,
        bytes_per_iter=3 * dtype_bytes, instrs_per_iter=9,
        dtype_bytes=dtype_bytes, dims=(n,),
    )


def relu(n: int, dtype_bytes: int = 4) -> Workload:
    """DNN activation layer."""
    return Workload(
        name="relu", gws=n, flops_per_iter=1,
        bytes_per_iter=2 * dtype_bytes, instrs_per_iter=6,
        dtype_bytes=dtype_bytes, dims=(n,),
    )


#: operand reuse factor through the per-core data cache for gemm-like
#: kernels (a 16-wide cache block is reused across neighbouring outputs).
_CACHE_REUSE = 16.0


def sgemm(m: int, n: int, k: int, dtype_bytes: int = 4) -> Workload:
    """C[m,n] = A[m,k] @ B[k,n] — one iteration produces one C element.

    Per-iteration traffic is divided by the cache reuse factor (rows and
    columns are shared across neighbouring output elements), which is
    the trace model's view, not the bytes a roofline bound counts.
    """
    return Workload(
        name="sgemm", gws=m * n, flops_per_iter=2.0 * k,
        bytes_per_iter=(2.0 * k / _CACHE_REUSE + 1) * dtype_bytes,
        instrs_per_iter=4.0 * k + 10,
        dtype_bytes=dtype_bytes, dims=(m, n), reduce_dim=k,
    )


def conv_layer(hw_out: int, c_in: int, c_out: int, ksize: int = 3,
               dtype_bytes: int = 4) -> Workload:
    """Direct conv as a DNN layer: one iteration = one output pixel."""
    macs = ksize * ksize * c_in
    return Workload(
        name="conv", gws=hw_out * c_out, flops_per_iter=2.0 * macs,
        bytes_per_iter=(macs / _CACHE_REUSE + 1.0) * dtype_bytes,
        instrs_per_iter=4.0 * macs + 12,
        dtype_bytes=dtype_bytes, dims=(hw_out, c_out), reduce_dim=macs,
    )


def gaussian_blur(h: int, w: int, ksize: int = 5,
                  dtype_bytes: int = 4) -> Workload:
    """2D stencil; the paper notes its atypical trend (halo reuse)."""
    taps = ksize * ksize
    return Workload(
        name="gaussian_blur", gws=h * w, flops_per_iter=2.0 * taps,
        bytes_per_iter=(taps / 2.0 + 1) * dtype_bytes,  # halo reuse factor
        instrs_per_iter=5.0 * taps + 10,
        dtype_bytes=dtype_bytes, dims=(h, w), reduce_dim=taps,
    )


def nearest_neighbor(n_query: int, n_ref: int, dim: int = 4,
                     dtype_bytes: int = 4) -> Workload:
    """Near-neighbour search: one iter = one query scanned over all refs."""
    work = n_ref * dim
    return Workload(
        name="nn_search", gws=n_query, flops_per_iter=3.0 * work,
        bytes_per_iter=(work / _CACHE_REUSE + dim + 1.0) * dtype_bytes,
        instrs_per_iter=6.0 * work + 16,
        dtype_bytes=dtype_bytes, dims=(n_query,), reduce_dim=n_ref,
    )


def gcn_aggregate(n_nodes: int, avg_degree: int, feat: int,
                  dtype_bytes: int = 4) -> Workload:
    """GCN neighbourhood aggregation (Kipf & Welling): irregular gather-sum."""
    work = avg_degree * feat
    return Workload(
        name="gcn_agg", gws=n_nodes, flops_per_iter=2.0 * work,
        bytes_per_iter=(work + feat + avg_degree) * dtype_bytes,
        instrs_per_iter=5.0 * work + 20,
        dtype_bytes=dtype_bytes, dims=(n_nodes,), reduce_dim=avg_degree,
    )


def dnn_fc_layer(batch: int, d_in: int, d_out: int,
                 dtype_bytes: int = 4) -> Workload:
    """Fully connected DNN layer (an sgemm)."""
    w = sgemm(batch, d_out, d_in, dtype_bytes)
    return dataclasses.replace(w, name="fc_layer")


def gcn_layer(n_nodes: int, avg_degree: int, f_in: int, f_out: int,
              dtype_bytes: int = 4) -> Workload:
    """Combined GCN layer: aggregate + transform (the paper's combined
    kernels)."""
    agg = gcn_aggregate(n_nodes, avg_degree, f_in, dtype_bytes)
    xform = sgemm(n_nodes, f_out, f_in, dtype_bytes)
    return Workload(
        name="gcn_layer", gws=n_nodes,
        flops_per_iter=(agg.flops_per_iter
                        + xform.flops_per_iter * f_out / max(f_out, 1)),
        bytes_per_iter=agg.bytes_per_iter + xform.bytes_per_iter,
        instrs_per_iter=agg.instrs_per_iter + xform.instrs_per_iter,
        dtype_bytes=dtype_bytes, dims=(n_nodes,), reduce_dim=avg_degree,
    )


#: the validation suite of the paper's Fig. 2 kernel list: the first six
#: are the "math kernels" of its headline claim, the last four the
#: DNN/GCN layers (the paper flags gaussian_blur, nn_search and gcn_agg as
#: atypical)
PAPER_KERNELS: dict[str, Workload] = {
    "vecadd": vecadd(4096),
    "saxpy": saxpy(4096),
    "relu": relu(8192),
    "sgemm": sgemm(64, 64, 64),
    "conv_layer": conv_layer(28 * 28, 32, 64),
    "fc_layer": dnn_fc_layer(64, 256, 256),
    "gaussian_blur": gaussian_blur(128, 128),
    "nn_search": nearest_neighbor(1024, 256),
    "gcn_agg": gcn_aggregate(2048, 8, 64),
    "gcn_layer": gcn_layer(1024, 8, 64, 64),
}

#: the subset behind the paper's "1.3x / 3.7x" headline numbers
MATH_KERNELS = ("vecadd", "saxpy", "relu", "sgemm", "conv_layer", "fc_layer")
