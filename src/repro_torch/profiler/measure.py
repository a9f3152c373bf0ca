"""Timed runs of kernel plans: the observation side of the tuner's loop.

``measure_value`` runs one ``(kernel, workload, decision value)`` point
on a device and reports robust statistics of its time:

  * **on the card, CUDA events**: the L2 cache (50 MB on an H100) is
    flushed before every repeat and the card spins ~1 ms ahead of the
    launch, as ``chip_smoke.py``'s ``Timer`` does, and each repeat is
    timed by an event pair around the launch; on the CPU,
    ``time.perf_counter`` around the plain version;
  * **median and IQR**, not the mean: one preempted repeat must not move
    the reported cost;
  * **synthetic operands** made from the workload's description with a
    seeded ``torch.Generator``, so a record is reproducible from the
    store alone;
  * **no fallback**: a candidate that fails to build or launch raises;
    it is neither scored infinity nor run as its plain version.

Records keep the JAX package's format (``Measurement.to_record``); the
port has no compiler cost analysis, so ``xla_flops`` and ``xla_bytes``
stay ``None``.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.core.hw import GpuParams, ceil_div

__all__ = [
    "TimingStats",
    "Measurement",
    "time_callable",
    "measure_value",
    "canon_value",
    "value_key",
    "record_key",
    "SynthSpec",
    "SYNTH_REGISTRY",
    "supported_kernels",
]


# --------------------------------------------------------------------------- #
# Decision-value canonicalisation (shared with store and cost)
# --------------------------------------------------------------------------- #


def canon_value(value: Any):
    """Canonical Python form of a decision value: an int or a tuple of
    ints (JSON hands tuples back as lists)."""
    if isinstance(value, (list, tuple)):
        return tuple(int(v) for v in value)
    return int(value)


def value_key(value: Any) -> str:
    """Stable string rendering of a canonical value (store key suffix)."""
    v = canon_value(value)
    if isinstance(v, tuple):
        return "x".join(str(x) for x in v)
    return str(v)


def record_key(hw_key: str, sig_key: str, value: Any) -> str:
    """The identity of a record, used by ``Measurement.key`` and
    ``TraceStore.full_key`` alike."""
    return f"{hw_key}::{sig_key}::{value_key(value)}"


# --------------------------------------------------------------------------- #
# Timing
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class TimingStats:
    """Robust summary of one timed sweep (seconds)."""

    reps: int
    warmup: int
    median_s: float
    iqr_s: float
    mean_s: float
    min_s: float
    max_s: float

    @classmethod
    def from_samples(cls, samples: list[float], warmup: int) -> "TimingStats":
        if not samples:
            raise ValueError("no timing samples")
        n = len(samples)
        med = statistics.median(samples)
        if n >= 4:
            q = statistics.quantiles(samples, n=4)
            iqr = q[2] - q[0]
        else:
            iqr = max(samples) - min(samples)
        return cls(reps=n, warmup=warmup, median_s=med, iqr_s=iqr,
                   mean_s=statistics.fmean(samples),
                   min_s=min(samples), max_s=max(samples))

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TimingStats":
        return cls(reps=int(d["reps"]), warmup=int(d["warmup"]),
                   median_s=float(d["median_s"]), iqr_s=float(d["iqr_s"]),
                   mean_s=float(d["mean_s"]), min_s=float(d["min_s"]),
                   max_s=float(d["max_s"]))


#: bytes written before each timed repeat on the card: more than the
#: H100's 50 MB L2, so every repeat reads its operands from device memory
L2_FLUSH_BYTES = 64 * 1024 * 1024
#: cycles the card spins after the flush (~1 ms), so the host has queued
#: the call before the start event fires and a microsecond kernel is
#: timed without the host's enqueue (``chip_smoke.Timer``'s head start)
HEAD_START_CYCLES = 2_000_000
_FLUSH: dict[torch.device, torch.Tensor] = {}


def time_callable(fn: Callable[[], Any], *, warmup: int = 1, reps: int = 5,
                  device="cuda") -> TimingStats:
    """Time ``fn()`` after ``warmup`` untimed calls.  On a CUDA device each
    repeat is the elapsed time of an event pair around the call, the L2
    flushed and the card given a head start before it; on the CPU the
    wall time of the call."""
    device = torch.device(device)
    for _ in range(max(0, warmup)):
        fn()
    samples = []
    if device.type == "cuda":
        flush = _FLUSH.get(device)
        if flush is None:
            flush = _FLUSH[device] = torch.empty(
                L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
        torch.cuda.synchronize(device)
        for _ in range(max(1, reps)):
            flush.zero_()
            torch.cuda._sleep(HEAD_START_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            fn()
            samples.append(time.perf_counter() - t0)
    return TimingStats.from_samples(samples, warmup=max(0, warmup))


# --------------------------------------------------------------------------- #
# Measurement record
# --------------------------------------------------------------------------- #

#: bump when the record fields change
MEASUREMENT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Measurement:
    """One observed (kernel, workload, hardware, decision value) point.

    ``flops`` and ``hbm_bytes`` are the workload's analytic features;
    ``xla_flops`` and ``xla_bytes`` keep the JAX package's record format
    and stay None here.  ``backend`` is the device type the time was
    taken on ("cuda" or "cpu"); ``interpret`` is always False.
    """

    kernel: str
    hw_key: str
    sig_key: str
    value: Any                       # canonical decision value
    stats: TimingStats
    desc: Optional[dict] = None      # workload description (re-measurable)
    programs: Optional[int] = None   # CTAs launched
    flops: Optional[float] = None    # analytic, whole workload
    hbm_bytes: Optional[float] = None
    xla_flops: Optional[float] = None
    xla_bytes: Optional[float] = None
    backend: str = ""
    interpret: bool = False
    source: str = "live"             # live | fixture
    created: float = 0.0

    @property
    def median_s(self) -> float:
        return self.stats.median_s

    @property
    def per_program_s(self) -> Optional[float]:
        if not self.programs:
            return None
        return self.stats.median_s / self.programs

    @property
    def per_byte_s(self) -> Optional[float]:
        if not self.hbm_bytes:
            return None
        return self.stats.median_s / self.hbm_bytes

    @property
    def key(self) -> str:
        """Store key: hardware :: workload :: decision value."""
        return record_key(self.hw_key, self.sig_key, self.value)

    def to_record(self) -> dict[str, Any]:
        v = canon_value(self.value)
        return {
            "kernel": self.kernel,
            "hw_key": self.hw_key,
            "sig_key": self.sig_key,
            "value": list(v) if isinstance(v, tuple) else v,
            "stats": self.stats.as_dict(),
            "desc": dict(self.desc) if self.desc is not None else None,
            "programs": self.programs,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "xla_flops": self.xla_flops,
            "xla_bytes": self.xla_bytes,
            "backend": self.backend,
            "interpret": self.interpret,
            "source": self.source,
            "created": self.created,
        }

    @classmethod
    def from_record(cls, d: dict) -> "Measurement":
        return cls(
            kernel=d["kernel"], hw_key=d["hw_key"], sig_key=d["sig_key"],
            value=canon_value(d["value"]),
            stats=TimingStats.from_dict(d["stats"]),
            desc=d.get("desc"),
            programs=d.get("programs"),
            flops=d.get("flops"), hbm_bytes=d.get("hbm_bytes"),
            xla_flops=d.get("xla_flops"), xla_bytes=d.get("xla_bytes"),
            backend=d.get("backend", ""),
            interpret=bool(d.get("interpret", False)),
            source=d.get("source", "live"),
            created=float(d.get("created", 0.0)),
        )


# --------------------------------------------------------------------------- #
# Synthetic operands and analytic features per kernel
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class SynthSpec:
    """How to measure one registered kernel without user tensors.

    ``make``     (desc, device, generator) -> (args, kwargs) for
                 ``KernelSpec.run``
    ``programs`` (desc, plan) -> CTAs the plan launches
    ``features`` desc -> (flops, bytes) of the workload
    """

    make: Callable[[dict, torch.device, torch.Generator], tuple[tuple, dict]]
    programs: Callable[[dict, Any], int]
    features: Callable[[dict], tuple[float, float]]


SYNTH_REGISTRY: dict[str, SynthSpec] = {}

#: the GCN synthesiser's graph: Pubmed's 44,324 undirected edges over
#: 19,717 nodes (the Planetoid dataset the GCN workload cites), each edge
#: within a community of 256 consecutive node ids with probability 0.9
GCN_EDGES_PER_NODE = 44324 / 19717
GCN_COMMUNITY, GCN_LOCAL_P = 256, 0.9


def supported_kernels() -> list[str]:
    return sorted(SYNTH_REGISTRY)


def _randn(gen, device, shape, dtype, scale=1.0):
    x = torch.randn(shape, generator=gen, device=device) * scale
    return x.to(getattr(torch, dtype))


def _grid(plan) -> int:
    g = getattr(plan, "grid", 1)
    if isinstance(g, (tuple, list)):
        n = 1
        for d in g:
            n *= int(d)
        return n
    return int(g)


def _populate_synth() -> None:
    def vector(d, dev, gen):
        return (_randn(gen, dev, (d["n"],), d["dtype"]),
                _randn(gen, dev, (d["n"],), d["dtype"])), {}

    def saxpy_make(d, dev, gen):
        (x, y), _ = vector(d, dev, gen)
        return (1.5, x, y), {}

    def vec_feat(flops_per_elem):
        def f(d):
            return flops_per_elem * d["n"], 3.0 * d["n"] * d["dtype_bytes"]
        return f

    SYNTH_REGISTRY["vecadd"] = SynthSpec(vector, lambda d, p: _grid(p),
                                         vec_feat(1.0))
    SYNTH_REGISTRY["saxpy"] = SynthSpec(saxpy_make, lambda d, p: _grid(p),
                                        vec_feat(2.0))

    SYNTH_REGISTRY["matmul"] = SynthSpec(
        make=lambda d, dev, gen: (
            (_randn(gen, dev, (d["m"], d["k"]), d["dtype"], d["k"] ** -0.25),
             _randn(gen, dev, (d["k"], d["n"]), d["dtype"], d["k"] ** -0.25)),
            {}),
        programs=lambda d, p: _grid(p),
        features=lambda d: (
            2.0 * d["m"] * d["n"] * d["k"],
            (d["m"] * d["k"] + d["k"] * d["n"] + d["m"] * d["n"])
            * d["dtype_bytes"]))

    def flash_make(d, dev, gen):
        shape = (d["batch"], d["seq_q"], d["head_dim"])
        kv = (d["batch"], d["seq_kv"], d["head_dim"])
        return ((_randn(gen, dev, shape, d["dtype"], 0.2),
                 _randn(gen, dev, kv, d["dtype"], 0.2),
                 _randn(gen, dev, kv, d["dtype"])), {"causal": d["causal"]})

    SYNTH_REGISTRY["flash_attention"] = SynthSpec(
        make=flash_make,
        programs=lambda d, p: ceil_div(d["seq_q"], p.block_q) * d["batch"],
        features=lambda d: (
            4.0 * d["seq_q"] * d["seq_kv"] * d["head_dim"] * d["batch"]
            * (0.5 if d["causal"] else 1.0),
            2.0 * (d["seq_q"] + d["seq_kv"]) * d["head_dim"]
            * d["dtype_bytes"] * d["batch"]))

    SYNTH_REGISTRY["rmsnorm"] = SynthSpec(
        make=lambda d, dev, gen: (
            (_randn(gen, dev, (d["tokens"], d["d"]), d["dtype"]),
             _randn(gen, dev, (d["d"],), d["dtype"])), {}),
        programs=lambda d, p: _grid(p),
        features=lambda d: (4.0 * d["tokens"] * d["d"],
                            2.0 * d["tokens"] * d["d"] * d["dtype_bytes"]))

    def decode_ops(d, dev, gen):
        """q (rows, 1, R, D) and caches (rows, s, 1, D): one KV group a
        row; an int8 cache holds codes beside positive f32 scales a page,
        read with bf16 queries (the serving pool's)."""
        rows, s, r, hd = d["rows"], d["s"], d["heads_per_group"], d["d"]
        q_dtype = "bfloat16" if d["dtype"] == "int8" else d["dtype"]
        q = _randn(gen, dev, (rows, 1, r, hd), q_dtype, 0.2)
        if d["dtype"] == "int8":
            k, v = (torch.randint(-127, 128, (rows, s, 1, hd), generator=gen,
                                  device=dev, dtype=torch.int8)
                    for _ in range(2))
        else:
            k = _randn(gen, dev, (rows, s, 1, hd), d["dtype"], 0.2)
            v = _randn(gen, dev, (rows, s, 1, hd), d["dtype"])
        clen = torch.full((rows,), s, dtype=torch.int32, device=dev)
        return q, k, v, clen

    def decode_make(d, dev, gen):
        q, k, v, clen = decode_ops(d, dev, gen)
        return (q, k, v, clen), {}

    def paged_make(d, dev, gen):
        q, k, v, clen = decode_ops(d, dev, gen)
        rows, pb = d["rows"], d["page_block"]
        per_row = d["s"] // pb
        # every physical page once, in a seeded order: the indirection
        # must scatter, or the paged read measures a contiguous one
        perm = torch.randperm(rows * per_row, generator=gen, device=dev)
        tables = torch.full((rows, d["max_blocks_per_row"]), -1,
                            dtype=torch.int32, device=dev)
        tables[:, :per_row] = perm.view(rows, per_row).to(torch.int32)
        kw = {"page_block": pb}
        if d["dtype"] == "int8":
            kw.update(k_scale=torch.rand((rows, per_row, 1), generator=gen,
                                         device=dev) * 0.01 + 1e-3,
                      v_scale=torch.rand((rows, per_row, 1), generator=gen,
                                         device=dev) * 0.01 + 1e-3)
        return (q, k, v, tables, clen), kw

    def decode_programs(d, p):
        return d["rows"] * ceil_div(d["s"], p[1])

    def decode_feat(d):
        return (4.0 * d["rows"] * d["heads_per_group"] * d["s"] * d["d"],
                2.0 * d["rows"] * d["s"] * d["d"] * d["dtype_bytes"])

    SYNTH_REGISTRY["decode_attention"] = SynthSpec(decode_make,
                                                   decode_programs,
                                                   decode_feat)
    SYNTH_REGISTRY["paged_decode"] = SynthSpec(paged_make, decode_programs,
                                               decode_feat)

    def blur_make(d, dev, gen):
        h, w = d["h"], d["w"]
        if d["aligned"]:
            img = _randn(gen, dev, (h, w), d["dtype"])
        else:                           # one element past a 16-byte boundary
            img = _randn(gen, dev, (h * w + 1,), d["dtype"])[1:].view(h, w)
        return (img,), {"ksize": d["ksize"]}

    SYNTH_REGISTRY["gaussian_blur"] = SynthSpec(
        make=blur_make,
        programs=lambda d, p: 2 * _grid(p),             # two passes
        features=lambda d: (4.0 * d["ksize"] * d["h"] * d["w"],
                            4.0 * d["h"] * d["w"] * d["dtype_bytes"]))

    def gcn_make(d, dev, gen):
        # a graph of Pubmed's density and a Planetoid graph's locality:
        # GCN_EDGES_PER_NODE undirected edges a node (5.5 neighbours with
        # the self-loop), each within a community of GCN_COMMUNITY
        # consecutive ids with probability GCN_LOCAL_P, else anywhere;
        # symmetric, row-normalised
        n = d["n"]
        edges = max(1, round(n * GCN_EDGES_PER_NODE))

        def randint(hi):
            return torch.randint(0, hi, (edges,), generator=gen, device=dev)

        src = randint(n)
        local = (src // GCN_COMMUNITY * GCN_COMMUNITY
                 + randint(GCN_COMMUNITY)).clamp(max=n - 1)
        near = torch.rand(edges, generator=gen, device=dev) < GCN_LOCAL_P
        dst = torch.where(near, local, randint(n))
        adj = torch.zeros((n, n), device=dev)
        adj[src, dst] = 1.0
        adj[dst, src] = 1.0
        adj.fill_diagonal_(1.0)
        adj /= adj.sum(1, keepdim=True)
        dtype = getattr(torch, d["dtype"])
        return (adj.to(dtype), _randn(gen, dev, (n, d["f"]), d["dtype"])), {}

    SYNTH_REGISTRY["gcn_agg"] = SynthSpec(
        make=gcn_make, programs=lambda d, p: _grid(p),
        features=lambda d: (2.0 * d["n"] * d["n"] * d["f"],
                            (d["n"] + 2.0 * d["f"]) * d["n"]
                            * d["dtype_bytes"]))

    SYNTH_REGISTRY["nn_search"] = SynthSpec(
        make=lambda d, dev, gen: (
            (_randn(gen, dev, (d["nq"], d["d"]), d["dtype"]),
             _randn(gen, dev, (d["nr"], d["d"]), d["dtype"])), {}),
        programs=lambda d, p: _grid(p),
        features=lambda d: (3.0 * d["nq"] * d["nr"] * d["d"],
                            (d["nq"] + d["nr"]) * d["d"] * d["dtype_bytes"]))


_populate_synth()


# --------------------------------------------------------------------------- #
# The harness
# --------------------------------------------------------------------------- #


def measure_value(
    kernel: str,
    desc: dict,
    value: Any,
    hw: GpuParams,
    *,
    device="cuda",
    warmup: int = 1,
    reps: int = 5,
    seed: int = 0,
) -> Measurement:
    """Time one decision value of one workload on ``device``.

    Builds the plan with the kernel's ``plan_from_value``, makes the
    operands from ``desc`` (``seed``), and times the kernel's run at
    that plan with ``time_callable``.  A kernel with no synthesiser
    raises ``ValueError``; a plan that fails to build or launch raises
    whatever the wrapper raises.
    """
    from repro_torch.tuner.dispatch import KERNEL_REGISTRY
    from repro_torch.tuner.signature import hardware_key

    device = torch.device(device)
    spec = KERNEL_REGISTRY[kernel]
    synth = SYNTH_REGISTRY.get(kernel)
    if synth is None:
        raise ValueError(f"kernel {kernel!r} has no input synthesiser")

    value = canon_value(value)
    plan = spec.plan_from_value(desc, hw, value)
    gen = torch.Generator(device=device).manual_seed(seed)
    args, kwargs = synth.make(desc, device, gen)

    def fn():
        return spec.run(plan, hw, *args, **kwargs)

    stats = time_callable(fn, warmup=warmup, reps=reps, device=device)
    flops, byts = synth.features(desc)
    sig = spec.sig(desc, "tuned")
    return Measurement(
        kernel=kernel, hw_key=hardware_key(hw), sig_key=sig.key,
        value=value, stats=stats, desc=dict(desc),
        programs=int(synth.programs(desc, plan)),
        flops=float(flops), hbm_bytes=float(byts),
        backend=device.type, interpret=False, source="live",
        created=time.time(),
    )
