"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to account.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  env      torch/CUDA/nvcc versions, the card's name and power limit, the
           GpuParams ``detect()`` read and Eq. 1's ``hp``;
  build    nvcc seconds for every kernel in ``src/repro_torch/csrc``
           (all compiled in parallel) and, per source, each kernel
           entry function's registers and spills and the compiler's
           warnings from ptxas;
  kernels  each serving kernel against its plain PyTorch version on the
           same inputs at smollm-135m's serving shapes (8 rows, a pool of
           1024, the ragged lengths of ``decode_case`` and, for the three
           decode kernels, a single live row of 1024, each with its plan:
           ``block_s``, the split W and the grid the wrapper launched
           (``last_grid``; its CTAs asserted above B x G at the ragged
           shape), and the ragged case timed at each width of
           ``SPLIT_SWEEP``; flash at a 512
           prompt causal and non-causal, a 64-row chunk at q_offset 448,
           and a 512 prompt at qwen3-8b's heads, head_dim 128, bf16
           only), in float32 (atol
           = rtol = 2e-5: summation order only) and bfloat16 (atol = rtol
           = 1.6e-2: two bf16 ulps near 1); the two gathers bit for bit;
           the int8 decode and dequant gather over int8 codes with random
           positive scales; with CUDA-event times (median of 25 runs
           after warm-up, L2 flushed before each; the decode kernels and
           the gathers with the head start) of the kernel, the plain
           version and, where one exists, one PyTorch library call
           computing the same function (SDPA for flash and the contiguous
           decode, ``index_select`` for the gather), beside the roofline
           bound, and the host's time to enqueue one call (``host_ms``);
           and a ``decode_shapes`` line: the three decode kernels against
           plain at ``DECODE_SHAPES`` (odd head_dims, R 8, pages of 8 and
           32, 128 splits of one row, one split of 512), each fp launch
           just after the same kernel left NaN in every SM's shared
           memory, the merge tickets back at 0 after; the two gathers
           also at ``GATHER_LARGE`` (8, 4096, 8, 128), every page mapped,
           and at one page (1, 16, 3, 64), the launch's floor, each with
           the plan that launched (item width, gws, lws, grid); and a
           ``gather_shapes`` line: both gathers bit for bit against plain
           at ``GATHER_SHAPES`` (pages 1, 8, 32; D 6, 32, 100; G 1, 8;
           B 1; nb 1; -1 and repeated ids; tables wider than nb) with the
           cache at its buffer's start and at ``GATHER_OFFSETS`` past
           it, every item width of each launched by the wrappers' own
           plans, and at ``GATHER_WIDE`` (2.15 GB of int8 codes: the
           64-bit index path);
  suite    the paper's kernel suite through ``repro_torch.kernels.ops``
           (vecadd, saxpy, matmul, rmsnorm, gaussian_blur, nn_search,
           gcn_aggregate) and Mamba-2's ``ssd`` under each mapping policy
           (naive, fixed, auto, and tuned at ``TUNED_CASES``, each
           registered kernel's largest case; for ssd the chunk
           ``plan_ssd_chunk(L, hw, policy)``) at the cases of
           ``SUITE_CASES``: each op driven once per policy with its
           launch counts reset just before and read just after (all
           twelve counts must be above 0; the matmul's routes count
           apart: every f32 case must launch the split pass and the
           3xTF32 product once each, every bf16 case, odd shapes and
           pointers included, the tensor-core kernel once, and nothing
           else; nn_search's prep pass and product count apart too;
           each gcn_aggregate and each ssd call launches once, and
           nothing else);
           then per case and policy the plan (for matmul its
           route, its counts, the bytes of each operand's copies (16:
           TMA) and the host's time to enqueue a call; for f32 the split
           pass held bit for bit against its plain version, the split
           and the product timed apart, and the route's and
           ``torch.matmul``'s max error against an f64 product; for
           vecadd and saxpy the 16-byte vectors a thread takes (0:
           scalars); for rmsnorm the row path; for nn_search the tiles,
           the split and the grid, the prep pass and the product timed
           apart, what the prep pass writes (``layout``), and the
           bound of the CUDA-core kernel it replaced beside its own; for
           ssd the grids one call launched (held against the plan's),
           the workspace, its three steps' device times from a
           torch.profiler trace that must hold them once a call and no
           other kernel, and the CUDA-core kernel's bound beside its
           own; for gcn_aggregate the device kernels of ten calls by
           torch.profiler: one ``gcn_kernel`` a call and nothing else),
           the launches of the case's own drive, the resident CTAs per SM
           that the CUDA runtime reports beside the plan's full-residency
           assumption, the error against the plain version
           (``SUITE_TOL``; for nn_search ``NN_DIST_TOL`` and the
           near-ties counted; for ssd ``TOL`` of the output's largest
           magnitude),
           CUDA-event times of the op, its plain version and one PyTorch
           call computing the same function (none for nn_search and ssd), and
           the roofline bound; for the blur each pass held bit for bit
           and timed apart, with the route the wrapper takes; then the
           vecadd sweep (float32, n = 2^12 ... 2^26, the three policies),
           the split pass held bit for bit against its plain version
           on infinities, NaN, the largest floats, subnormals and ties,
           and the bf16 kernel's copy loader against TMA
           (``tc_loader_check``): at every tile the same operands 2, 4
           and 8 bytes off a 16-byte boundary (A, B, both) bit for bit
           equal to TMA's product, and odd K and N against the plain
           version; and nn_search's ties across its ref splits
           (``nn_split_ties``: exact copies of a ref at the end of split
           0, the start of split 1 and the end of the last split, and two
           refs at equal distance from a query in split 0 and the last
           split: the lower index, as the plain version);
  tuner    the tuner (``repro_torch.tuner``) from a fresh cache and trace
           store in a temporary directory: every ``KERNEL_TABLE`` row of
           the serving router (decode, flash, paged decode) at every
           bucket of smollm-135m's pool (8 slots, up to 1024, pages of
           16), fp32 and int8 pools, and every suite kernel the tuner
           registers at its largest case (``TUNED_CASES``), each resolved
           cold: AUTO's seed, TUNED's pick, the probes, both plans' times
           at the largest bucket or case (``Timer``) and TUNED's output
           against the plain version; a second router on the same cache
           file (0 probes: a gate) and each suite kernel's warm hit (0
           probes); then ``measure="live"`` on ``live_cases`` (the blur,
           vecadd 2^26, a Pubmed-sized GCN, the paged decode's split),
           timing the roofline's top candidates with CUDA events into the
           store, and ``measure="cached"`` replaying them into another
           cache: 0 live measurements and the same picks (gates); the
           seed, the roofline's pick and the live pick then timed by
           ``Timer`` on the same operands, beside the live records;
  engine   ``ServeEngine("smollm-135m", reduced=False)`` serving 12 seeded
           requests in bf16 on each path of ``ENGINE_RUNS``: the default
           (fused paged decode) with chunked and with whole-prompt
           prefill, then ``paged=False``, ``fused_decode=False``,
           ``kv_dtype="int8"`` and int8 with ``fused_decode=False``
           (chunked); then ``ServeEngine("mamba2-1.3b", reduced=False)``
           on the mix's first 4 requests, chunked and whole-prompt
           (``MAMBA_RUNS``), every engine on its default policy, TUNED;
           each run prints the decode plans that ran (``block_s`` and
           split per pool length) and each bucket's TUNED plan beside
           AUTO's (``tuned_beside_auto``); the kernels' launch
           counts are reset just
           before each run and read just after: the path's own kernels
           must be above 0, every other kernel 0 (the ssm path runs none:
           its prefill is the plain ``ssd_chunked``, as the reference's
           is jnp);
  retune   smollm-135m at full width, default chunked path, TUNED, the
           engine phase's params, the mix's first ``RETUNE_REQUESTS``
           requests, each run in a private tuning cache: untraced, traced
           (``obs.Tracer``: the same launches, plans and streams, a
           gate), and traced with the retune controller inline
           (``RETUNE_CONFIG``), handed ``gated_candidate`` of the bucket's
           pair after decode tick ``RETUNE_PROPOSE_AT``: one trial must
           conclude, a ``decode_tick`` span and row 1's launches (one a
           layer) must run the candidate, the streams must equal the
           untraced run's, an adoption must read back through a fresh
           router, and the trace must survive ``write_trace`` /
           ``load_trace`` (gates); then W 64 (``w64_candidate``),
           reported only; prints the decisions, the drift rows and each
           run's wall time a tick;
  profile  smollm's chunked path, fp and int8 pools, on the mix's first 4
           requests, and mamba2's chunked path on its first request
           (``PROFILE_RUNS``), unprofiled (wall time) and under
           torch.profiler (device time by kernel from the raw device
           events, busy time, idle share; no check: a reading);
  parity   the same engine in float32 on each path (chunked), once on the
           kernels and once under ``kernels.force("plain")``: identical
           token streams, first decode-step logits within atol 1e-3;
  timing   seconds per phase.

The run keeps its own tuning cache and trace store in a temporary
directory.  Then the card's name and power limit as nvidia-smi prints
them, the kernel summary as one JSON line (each row the tuner registers
with ``tuned_ms`` beside AUTO's ``ms``; a suite row's ``launches``
counts NAIVE, FIXED and AUTO over every case, and ``tuned_launches``
TUNED's at its cases), and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
exits non-zero and prints no result.  It needs one CUDA device and exits
non-zero without one.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
SLOW_S, SLOW_RUNS = 0.1, 5
TOL = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}


def emit(phase: str, **payload) -> None:
    print(json.dumps({"phase": phase, **payload}, sort_keys=True), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """CUDA-event timing: the median of ``runs`` launches after warm-up,
    with the 50 MB L2 flushed before each (the serving loop finds each
    layer's K/V cold)."""

    def __init__(self, device):
        self.scratch = torch.empty(64 * 1024 * 1024, dtype=torch.uint8,
                                   device=device)

    def ms(self, fn, runs: int = 25, warmup: int = 3,
           head_start: bool = False) -> float:
        """``head_start`` spins the card ~1 ms after the flush, so the
        host has enqueued ``fn``'s launch before the start event fires
        and a microsecond kernel is timed without the host's overhead
        (0.1 ms was too short on the card's shared host: identical plans
        timed up to 40x apart).  A call that takes over 100 ms on its
        first warm-up is timed over 5 runs (``last_runs`` says how many
        were taken)."""
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() - t0 > SLOW_S:      # one call over 100 ms
            runs, warmup = min(runs, SLOW_RUNS), 1
        for _ in range(warmup - 1):
            fn()
        torch.cuda.synchronize()
        self.last_runs = runs
        times = []
        for _ in range(runs):
            self.scratch.zero_()
            if head_start:
                torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def host_ms(fn, calls: int = 20) -> float:
    """Host time to enqueue one call (the wrapper's checks, allocation
    and launch), averaged over ``calls`` calls issued back to back; the
    device runs them behind."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e3


def check_close(got, want, dtype, what: str) -> float:
    err = float((got.float() - want.float()).abs().max())
    tol = TOL[dtype]
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version, max abs err {err} (tol {tol})")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{what}: non-finite output")
    return err


# --------------------------------------------------------------------------- #
# kernels
# --------------------------------------------------------------------------- #


#: the decode tick's cache lengths: ragged (1 included), and a single
#: live row of 1024 (the others retired at 0)
RAGGED = (1, 17, 128, 300, 512, 700, 1000, 1024)
ONE_ROW = (1024, 0, 0, 0, 0, 0, 0, 0)


def decode_case(cfg, plan_block, device, dtype, split=None, lens=RAGGED):
    """The decode tick's shapes at full width: 8 slots, a 1024-long pool,
    cache lengths ``lens`` over permuted pages, -1 tails; ``split`` the
    sweep's planned width."""
    rng = np.random.default_rng(SEED)
    b, t, pb = 8, 1024, 16
    g, r, d = cfg.num_kv_heads, cfg.heads_per_group, cfg.head_dim
    clen = np.array(lens, np.int32)
    tw = t // pb
    perm = list(rng.permutation(b * tw))
    tables = np.full((b, tw), -1, np.int32)
    for i in range(b):
        for j in range(-(-int(clen[i]) // pb)):
            tables[i, j] = perm.pop()
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(device=device,
                                                    dtype=dtype)

    return dict(q=rand(b, g, r, d), k_cache=rand(b, t, g, d),
                v_cache=rand(b, t, g, d),
                tables=torch.from_numpy(tables).to(device),
                cache_len=torch.from_numpy(clen).to(device),
                page_block=pb, block_s=plan_block, split=split)


def flash_case(cfg, sq, sk, q_offset, tiles, device, dtype, causal=True,
               heads=None):
    """``heads`` (G, R, D) overrides the config's (a head_dim it does not
    have)."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + sq)
    g, r, d = heads or (cfg.num_kv_heads, cfg.heads_per_group, cfg.head_dim)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(device=device,
                                                    dtype=dtype)

    return dict(q=rand(1, sq, g, r, d), k=rand(1, sk, g, d),
                v=rand(1, sk, g, d), block_q=tiles[0], block_k=tiles[1],
                q_offset=q_offset, causal=causal)


def decode_bound(case, hw):
    """The live prefix's K/V read once (for int8 codes: one byte a value,
    plus the live pages' scales), q read and the output written once."""
    q, k = case["q"], case["k_cache"]
    b, g, r, d = q.shape
    es = q.element_size()
    clen = case["cache_len"].clamp(max=k.shape[1])
    n = int(clen.sum())
    nbytes = 2 * n * g * d * k.element_size() + 2 * q.numel() * es + b * 4
    if "tables" in case:
        nbytes += case["tables"].numel() * 4
    if case.get("k_scale") is not None:
        pages = int((clen + case["page_block"] - 1).div(
            case["page_block"], rounding_mode="floor").sum())
        nbytes += 2 * pages * g * 4
    flops = 4 * n * g * r * d
    return bound(nbytes, flops, q.dtype, hw)


def gather_bound(case, hw):
    """Every page of the table read once and the view written once (the
    int8 gather also reads each page's scales)."""
    cache, out_es = case["cache"], case["out_bytes"]
    nbytes = cache.numel() * (cache.element_size() + out_es) \
        + case["tables"].numel() * 4
    if "scale" in case:
        nbytes += case["scale"].numel() * 4
    return bound(nbytes, 0, torch.float32, hw)


def int8_pool(case, gen):
    """The case's caches as int8 codes with random positive per-(page,
    group) scales."""
    k, pb = case["k_cache"], case["page_block"]
    b, t, g, d = k.shape
    dev = k.device

    def codes():
        return torch.randint(-127, 128, (b, t, g, d), generator=gen,
                             dtype=torch.int8).to(dev)

    def scales():
        return (torch.rand((b, t // pb, g), generator=gen) * 0.05
                + 1e-3).to(dev)

    return dict(case, k_cache=codes(), v_cache=codes(), k_scale=scales(),
                v_scale=scales())


def contiguous_case(cfg, block_s, device, dtype, split=None, lens=RAGGED):
    """The decode tick's shapes on the contiguous pool (and on a gathered
    view): decode_case's rows, lengths and caches, no tables."""
    c = decode_case(cfg, block_s, device, dtype, split, lens)
    return dict(q=c["q"], k_cache=c["k_cache"], v_cache=c["v_cache"],
                cache_len=c["cache_len"], block_s=block_s, split=split)


def gather_case(cfg, device, dtype, quant):
    """One cache of decode_case's pool and its tables (the int8 gather:
    codes and scales, out in ``dtype``)."""
    c = decode_case(cfg, 16, device, dtype)
    if quant:
        c = int8_pool(c, torch.Generator().manual_seed(SEED + 3))
        return dict(cache=c["k_cache"], scale=c["k_scale"],
                    tables=c["tables"], block_size=16, out_dtype=dtype,
                    out_bytes=torch.empty((), dtype=dtype).element_size())
    return dict(cache=c["k_cache"], tables=c["tables"], block_size=16,
                out_bytes=c["k_cache"].element_size())


#: the gathers' large case: qwen3-8b's KV heads (8 groups of 128) over
#: 8 rows of 4,096, every page mapped: 67 MB a cache in bf16
GATHER_LARGE = (8, 4096, 8, 128)


def pool_gather_case(shape, device, dtype, quant, seed):
    """A cache of ``shape`` (B, T, G, D), pages of 16 all mapped through a
    permuted table, made on the card (the int8 gather: codes and scales,
    out in ``dtype``)."""
    b, t, g, d = shape
    pb = 16
    rng = np.random.default_rng(seed)
    tables = torch.from_numpy(rng.permutation(b * (t // pb)).astype(
        np.int32).reshape(b, t // pb)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if quant:
        return dict(
            cache=torch.randint(-127, 128, shape, generator=gen,
                                device=device, dtype=torch.int8),
            scale=torch.rand((b, t // pb, g), generator=gen,
                             device=device) * 0.05 + 1e-3,
            tables=tables, block_size=pb, out_dtype=dtype,
            out_bytes=torch.empty((), dtype=dtype).element_size())
    return dict(cache=torch.randn(shape, generator=gen, device=device)
                .to(dtype), tables=tables, block_size=pb,
                out_bytes=torch.empty((), dtype=dtype).element_size())


def flash_bound(case, hw):
    q, k = case["q"], case["k"]
    b, sq, g, r, d = q.shape
    sk, off = k.shape[1], case["q_offset"]
    pairs = sum(min(sk, i + off + 1) for i in range(sq)) \
        if case["causal"] else sq * sk
    es = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * es
    flops = 4 * pairs * b * g * r * d
    return bound(nbytes, flops, q.dtype, hw)


def bound(nbytes, flops, dtype, hw):
    t_bytes = nbytes / hw.mem_bw * 1e3
    t_ops = flops / hw.peak_flops(dtype) * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_call(case):
    """One PyTorch call computing the flash kernel's function: SDPA over
    the KV heads repeated to H, with the causal offset as a mask.  Timed
    as a yardstick only; the port never calls it."""
    import torch.nn.functional as F

    q, k, v, off = case["q"], case["k"], case["v"], case["q_offset"]
    b, sq, g, r, d = q.shape
    sk = k.shape[1]
    qh = q.reshape(b, sq, g * r, d).transpose(1, 2)
    kh = k.repeat_interleave(r, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(r, dim=2).transpose(1, 2)
    if not case["causal"]:
        return lambda: F.scaled_dot_product_attention(qh, kh, vh)
    if off == 0 and sq == sk:
        return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                      is_causal=True)
    mask = (torch.arange(sk, device=q.device)[None, :]
            <= torch.arange(sq, device=q.device)[:, None] + off)
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)


def sdpa_decode_call(case):
    """One PyTorch call computing the contiguous decode's function: SDPA
    with GQA over the (B, G, T, D) caches and a boolean cache_len mask.
    Timed as a yardstick only; the port never calls it."""
    import torch.nn.functional as F

    q, k, v, clen = (case["q"], case["k_cache"], case["v_cache"],
                     case["cache_len"])
    b, g, r, d = q.shape
    t = k.shape[1]
    qh = q.reshape(b, g * r, 1, d)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(t, device=q.device)[None, :]
            < clen[:, None].long())[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                  enable_gqa=True)


def index_select_call(case):
    """One PyTorch call computing the gather: ``index_select`` of the
    flattened pool at precomputed flat positions (a yardstick only)."""
    from repro_torch.kernels.paged_gather import paged_flat_indices

    cache, tables, pb = case["cache"], case["tables"], case["block_size"]
    b, t = cache.shape[:2]
    idx = paged_flat_indices(tables[:, :t // pb], b, t, pb).reshape(-1)
    flat = cache.reshape(b * t, *cache.shape[2:])
    return lambda: flat.index_select(0, idx).view(cache.shape)


#: split widths each decode kernel is timed at, beside AUTO's
SPLIT_SWEEP = (16, 32, 64, 128, 256, 512, 1024)

#: shapes the decode wrappers take beyond the serving one: (B, T, G, R,
#: D, page, block_s, split, cache lengths).  Many splits with an empty
#: row and one past T; R 8 at D 128; D 6 (one value a copy, rows padded
#: to 8); D 100 (bf16 rows of 200 B: one value a copy; f32 16-byte);
#: D 96 with a first chunk of 3 positions (at D 96 and 100 a lane group
#: is 32 lanes over 128 values, so lanes 24/25-31 hold no column);
#: 128 splits of one row merged; one split of 512 (32 chunks through the
#: 4-stage ring); pages of 8 and 32 and a split planned by AUTO (None)
DECODE_SHAPES = (
    (3, 80, 2, 2, 16, 16, 16, 16, (0, 17, 85)),
    (2, 96, 1, 8, 128, 32, 32, 64, (96, 33)),
    (4, 48, 3, 1, 6, 8, 16, 16, (1, 48, 20, 0)),
    (2, 128, 2, 5, 100, 16, 32, None, (128, 77)),
    (2, 64, 1, 3, 96, 16, 16, 16, (3, 35)),
    (1, 2048, 1, 3, 64, 16, 16, 16, (2000,)),
    (2, 512, 3, 3, 64, 16, 16, 512, (512, 300)),
)


#: shapes the gather wrappers take beyond the serving one: (B, T, G, D,
#: page).  Pages of 1, 8 and 32; D 6 (bf16 rows of 12 bytes: 4-byte
#: copies at page 1, and the dequant gather's scalar route), D 100 (its
#: char4 route) and D 32 (8 codes behind a bf16 store, 4 behind an f32
#: one); G 1 and 8; B 1; nb 1.  Every table holds -1 entries, repeated
#: ids and 2 columns past nb (``gather_tables``); every case runs with
#: the cache at the start of its buffer and at each offset of
#: ``GATHER_OFFSETS`` past it (bytes: a contiguous slice of a larger
#: buffer), so the wrappers' own plans launch copy items of 16, 8, 4, 2
#: and 1 bytes and dequant items of each of ``DEQUANT_WIDTHS``
GATHER_SHAPES = (
    (2, 8, 1, 6, 1),
    (3, 64, 8, 100, 8),
    (1, 96, 8, 32, 32),
    (4, 32, 1, 6, 32),
)
GATHER_OFFSETS = {torch.float32: (0, 4), torch.bfloat16: (0, 2),
                  torch.int8: (0, 1, 2, 4)}
#: an int8 cache of 2.15 GB (B, T, G, D), pages of 16, one byte past 16:
#: items of one byte or one code, more of them than 32-bit item math
#: covers, so both gathers launch their 64-bit index path
GATHER_WIDE = (8, 16384, 16, 1025)


def gather_tables(rng, b, nb):
    """(B, nb + 2) ids drawn with repeats from the pool's B nb pages and
    -1; the first entry -1, the last used one a repeat of the second."""
    tables = rng.integers(-1, b * nb, size=(b, nb + 2)).astype(np.int32)
    used = tables[:, :nb].reshape(-1)
    used[0], used[1] = -1, rng.integers(b * nb)
    used[-1] = used[1]
    tables[:, :nb] = used.reshape(b, nb)
    return tables


def gather_row(name, dtype, out, shape, off, plan):
    """The ``gather_shapes`` line's record of one case and its plan."""
    return dict(kernel=name, dtype=str(dtype).split(".")[1],
                out=str(out or dtype).split(".")[1],
                shape=dict(zip(("B", "T", "G", "D", "page"), shape)),
                offset_bytes=off, width=plan.width, lws=plan.lws,
                grid=plan.grid)


def check_gather(name, call, what):
    """Run ``call`` on the kernel and on the plain version: bit for bit,
    or raise."""
    from repro_torch import kernels

    got = call()
    with kernels.force("plain"):
        want = call()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{name} {what}: not bit-exact against the "
                             f"plain version")


def gather_shapes_check(device):
    """Both gathers against their plain versions, bit for bit, at
    ``GATHER_SHAPES`` x ``GATHER_OFFSETS``: the copy of float32, bfloat16
    and int8 caches under the wrapper's plan, the dequant gather of the
    int8 codes into float32 and bfloat16 under the wrapper's plan and at
    each narrower legal item width; the wrappers' own plans must have
    launched every item width of each (``GATHER_WIDTHS``, and
    ``DEQUANT_WIDTHS`` of each output).  Then both at ``GATHER_WIDE``,
    whose plans must take the 64-bit path."""
    from repro_torch.core.hw import detect
    from repro_torch.core.mapper import (DEQUANT_WIDTHS, GATHER_THREADS,
                                         GATHER_WIDTHS, plan_gather)
    from repro_torch.kernels.paged_gather import (paged_dequant_gather,
                                                  paged_gather)

    hw = detect(device)
    outs = (torch.float32, torch.bfloat16)
    rows, widths = [], {k: set() for k in [None, *outs]}
    for b, t, g, d, pb in GATHER_SHAPES:
        nb, n = t // pb, b * t * g * d
        tab = torch.from_numpy(gather_tables(
            np.random.default_rng(SEED + t + d), b, nb)).to(device)
        gen = torch.Generator().manual_seed(SEED + d)
        scale = (torch.rand((b, nb, g), generator=gen) * 0.05
                 + 1e-3).to(device)
        for dtype, offsets in GATHER_OFFSETS.items():
            es = torch.empty((), dtype=dtype).element_size()
            for off in offsets:
                if dtype == torch.int8:
                    buf = torch.randint(-127, 128, (n + off,), generator=gen,
                                        dtype=dtype)
                else:
                    buf = torch.randn(n + off // es, generator=gen).to(dtype)
                cache = buf.to(device)[off // es:].view(b, t, g, d)
                calls = [("paged_gather", None, None, paged_gather,
                          lambda: paged_gather(cache, tab, pb))]
                for out in outs if dtype == torch.int8 else ():
                    # the wrapper's own plan (the widest legal width),
                    # then each narrower legal width
                    legal = [w for w in DEQUANT_WIDTHS[out.itemsize]
                             if d % w == 0 and off % w == 0]
                    for plan in [None] + [plan_gather(n, w, hw)
                                          for w in legal[1:]]:
                        calls.append((
                            "paged_dequant_gather", out, plan,
                            paged_dequant_gather,
                            lambda out=out, plan=plan: paged_dequant_gather(
                                cache, scale, tab, pb, out_dtype=out,
                                plan=plan)))
                for name, out, plan, fn, call in calls:
                    check_gather(name, call, (
                        f"{dtype} -> {out or dtype} at B {b} T {t} G {g} "
                        f"D {d} page {pb}, cache {off} bytes past its "
                        f"buffer"))
                    if plan is None:
                        widths[out].add(fn.last_plan.width)
                    rows.append(gather_row(name, dtype, out,
                                           (b, t, g, d, pb), off,
                                           fn.last_plan))
    for out, want in ((None, GATHER_WIDTHS),
                      *((o, DEQUANT_WIDTHS[o.itemsize]) for o in outs)):
        if widths[out] != set(want):
            raise AssertionError(f"gathers into {out}: the wrappers' plans "
                                 f"launched items of {sorted(widths[out])}, "
                                 f"not {want}")
    b, t, g, d = GATHER_WIDE
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    buf = torch.randint(-127, 128, (b * t * g * d + 1,), generator=gen,
                        device=device, dtype=torch.int8)
    cache = buf[1:].view(b, t, g, d)
    tab = torch.from_numpy(gather_tables(np.random.default_rng(SEED + 7), b,
                                         t // 16)).to(device)
    scale = torch.rand((b, t // 16, g), generator=gen, device=device) \
        * 0.05 + 1e-3
    for name, fn, call in (
            ("paged_gather", paged_gather,
             lambda: paged_gather(cache, tab, 16)),
            ("paged_dequant_gather", paged_dequant_gather,
             lambda: paged_dequant_gather(cache, scale, tab, 16,
                                          out_dtype=torch.bfloat16))):
        check_gather(name, call, f"int8 at {GATHER_WIDE}, 1 byte past 16")
        plan = fn.last_plan
        if plan.grid * GATHER_THREADS * plan.lws < 2 ** 31:
            raise AssertionError(f"{name} at {GATHER_WIDE}: {plan} is "
                                 f"inside the 32-bit item math")
        rows.append(gather_row(name, torch.int8, None if name ==
                               "paged_gather" else torch.bfloat16,
                               (b, t, g, d, 16), 1, plan))
    del buf, cache
    torch.cuda.empty_cache()
    return rows


def poison_decode_smem(call, g, r, d, pb, dtype, device):
    """Leave NaN in the shared memory of every SM that ``call``'s
    kernel (a decode wrapper with the fp caches' signature of
    ``paged_decode_attention``) lays out at (G, R, D, page, dtype): the
    same kernel over NaN caches, 1,024 rows of 128 positions, one split
    each (more CTAs than an H100 holds resident, each through the whole
    ring).  A later launch of that kernel that read a staged row past
    its end would then read NaN and fail its check."""
    b, t = 1024, 128
    nan = torch.full((b, t, g, d), float("nan"), dtype=dtype, device=device)
    q = torch.ones((b, g, r, d), dtype=dtype, device=device)
    tables = torch.arange(b * (t // pb), dtype=torch.int32,
                          device=device).reshape(b, t // pb)
    clen = torch.full((b,), t, dtype=torch.int32, device=device)
    call(q, nan, nan, tables, clen, page_block=pb, block_s=t, split=t)


def decode_shapes_check(device, hw):
    """Each decode kernel (contiguous, paged, paged int8) against its
    plain version at ``DECODE_SHAPES`` in float32 and bfloat16, each fp
    launch right after ``poison_decode_smem``; then the merge tickets
    must all be back at 0."""
    from repro_torch import kernels
    from repro_torch.core.mapper import plan_decode_split
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention

    def contiguous(q, k, v, tables, clen, *, page_block, **kw):
        return da.decode_attention(q, k, v, clen, **kw)

    rows = []
    for b, t, g, r, d, pb, bs, w, lens in DECODE_SHAPES:
        if w is None:
            w = plan_decode_split(t, b * g, bs, d, hw, heads_per_group=r,
                                  page_block=pb)
        rng = np.random.default_rng(SEED + t + d)
        nb = t // pb
        perm = list(rng.permutation(b * nb))
        tables = np.full((b, nb + 1), -1, np.int32)
        for i in range(b):
            for j in range(-(-min(lens[i], t) // pb)):
                tables[i, j] = perm.pop()
        clen = torch.tensor(lens, dtype=torch.int32, device=device)
        tab = torch.from_numpy(tables).to(device)
        gen = torch.Generator().manual_seed(SEED + d)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=gen).to(device, dtype)
                       for shape in ((b, g, r, d), (b, t, g, d),
                                     (b, t, g, d)))
            codes = [torch.randint(-127, 128, (b, t, g, d), generator=gen,
                                   dtype=torch.int8).to(device)
                     for _ in range(2)]
            scales = [(torch.rand((b, nb, g), generator=gen) * 0.05
                       + 1e-3).to(device) for _ in range(2)]
            calls = {
                "decode_attention": (contiguous, lambda: da.decode_attention(
                    q, k, v, clen, block_s=max(16, bs), split=max(16, w))),
                "paged_decode_attention": (
                    paged_decode_attention, lambda: paged_decode_attention(
                        q, k, v, tab, clen, page_block=pb, block_s=bs,
                        split=w)),
                "paged_decode_attention_int8": (
                    None, lambda: paged_decode_attention(
                        q, *codes, tab, clen, page_block=pb, block_s=bs,
                        split=w, k_scale=scales[0], v_scale=scales[1])),
            }
            for name, (fp, call) in calls.items():
                if fp is not None:   # int8 codes are finite whatever they hold
                    poison_decode_smem(fp, g, r, d, pb, dtype, device)
                got = call()
                with kernels.force("plain"):
                    want = call()
                torch.cuda.synchronize()
                rows.append(dict(
                    kernel=name, dtype=str(dtype).split(".")[1],
                    shape=dict(B=b, T=t, G=g, R=r, D=d, page=pb, block_s=bs,
                               split=w, lens=list(lens)),
                    max_abs_err=check_close(
                        got, want, dtype,
                        f"{name} {dtype} at B {b} T {t} G {g} R {r} D {d}")))
    for tickets, _ in da._SCRATCH.values():
        if int(tickets.abs().sum()) != 0:
            raise AssertionError("a decode launch left a merge ticket set")
    return rows


def kernels_phase(cfg, hw, timer, device):
    from repro_torch import kernels
    from repro_torch.core.mapper import (plan_attention_blocks,
                                         plan_cache_block, plan_decode_split,
                                         plan_paged_block)
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.kernels.paged_gather import (paged_dequant_gather,
                                                  paged_gather)

    g, r, d = cfg.num_kv_heads, cfg.heads_per_group, cfg.head_dim
    block_s = plan_paged_block(1024, d, 16, hw, heads_per_group=r)
    cache_block = plan_cache_block(1024, d, hw, heads_per_group=r)
    # the split width W: Eq. 1 over the resident CTA slots (AUTO)
    split = plan_decode_split(1024, 8 * g, block_s, d, hw,
                              heads_per_group=r, page_block=16)
    cache_split = plan_decode_split(1024, 8 * g, cache_block, d, hw,
                                    heads_per_group=r)
    p512 = plan_attention_blocks(512, 512, cfg.head_dim, hw)
    tiles = (p512.block_q, p512.block_k)
    p128 = plan_attention_blocks(512, 512, 128, hw)
    tiles128 = (p128.block_q, p128.block_k)
    results = {}

    def measure(name, fn, case, bound_fn, library, exact=False,
                head_start=False, dtypes=(torch.float32, torch.bfloat16)):
        """Kernel vs plain in each of ``dtypes`` (``exact``: bit for bit),
        then bf16 times (``head_start`` for microsecond kernels, see
        ``Timer.ms``); ``case(dtype)`` builds the inputs, its ``*_bytes``
        keys are bookkeeping, not arguments."""
        entry = {"max_abs_err": {}}
        for dtype in dtypes:
            c = dict(case(dtype))
            args = {k: x for k, x in c.items() if not k.endswith("_bytes")}
            got = fn(**args)
            with kernels.force("plain"):
                want = fn(**args)
            torch.cuda.synchronize()
            key = str(dtype).split(".")[1]
            if exact:
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} {dtype}: the kernel is not "
                                         f"bit-exact against its plain "
                                         f"version")
                entry["max_abs_err"][key] = 0.0
            else:
                entry["max_abs_err"][key] = check_close(got, want, dtype,
                                                        f"{name} {dtype}")
        c = case(torch.bfloat16)               # the serving dtype
        args = {k: x for k, x in c.items() if not k.endswith("_bytes")}
        entry["kernel_ms"] = timer.ms(lambda: fn(**args),
                                      head_start=head_start)
        entry["host_ms"] = host_ms(lambda: fn(**args))

        def plain():
            with kernels.force("plain"):
                fn(**args)
        entry["plain_ms"] = timer.ms(plain, head_start=head_start)
        entry["library_ms"] = (timer.ms(library(c), head_start=head_start)
                               if library else None)
        entry["bound_ms"], entry["bound_by"] = bound_fn(c, hw)
        return entry

    def decode_entries(name, fn, case, plan_block, w, library, what):
        """The serving shape (ragged lengths) and a single live row of
        1024, each with its plan: block_s, the split W and the grid the
        wrapper launched (``fn.last_grid``, B x G x n_split)."""
        out = []
        for label, lens in (("ragged lengths", RAGGED),
                            ("a single live row of 1024", ONE_ROW)):
            fn.last_grid = None
            entry = measure(name, fn, lambda dt, lens=lens: case(dt, lens),
                            decode_bound, library, head_start=True)
            grid = fn.last_grid
            out.append(dict(shape=f"slots 8, {what}, {label}",
                            plan=dict(block_s=plan_block, split=w,
                                      grid=list(grid),
                                      ctas=math.prod(grid)),
                            **entry))
        if out[0]["plan"]["ctas"] <= 8 * g:
            raise AssertionError(f"{name}: AUTO's split launched "
                                 f"{out[0]['plan']['grid']}, not more than "
                                 f"B x G = {8 * g} CTAs")
        # the same call at other split widths (bf16, ragged): NAIVE's one
        # split is 1024, FIXED's 512
        args = {k: x for k, x in case(torch.bfloat16, RAGGED).items()
                if not k.endswith("_bytes")}
        out[0]["split_sweep_ms"] = {
            width: timer.ms(lambda: fn(**dict(args, split=width)),
                            head_start=True)
            for width in SPLIT_SWEEP}
        return out

    results["paged_decode_attention"] = decode_entries(
        "paged_decode_attention", paged_decode_attention,
        lambda dt, lens: decode_case(cfg, block_s, device, dt, split, lens),
        block_s, split, None, "pool 1024")
    chunk_tiles = plan_attention_blocks(64, 512, cfg.head_dim, hw)
    results["flash_attention"] = [
        dict(shape=f"prompt 512, q_offset 0, tiles {tiles}",
             **measure("flash_attention", flash_attention,
                       lambda dt: flash_case(cfg, 512, 512, 0, tiles,
                                             device, dt),
                       flash_bound, sdpa_call)),
        dict(shape="chunk 64 at q_offset 448 over a 512 cache, tiles "
                   f"{(chunk_tiles.block_q, chunk_tiles.block_k)}",
             **measure("flash_attention", flash_attention,
                       lambda dt: flash_case(
                           cfg, 64, 512, 448,
                           (chunk_tiles.block_q, chunk_tiles.block_k),
                           device, dt),
                       flash_bound, sdpa_call)),
        dict(shape=f"prompt 512, non-causal, tiles {tiles}",
             **measure("flash_attention", flash_attention,
                       lambda dt: flash_case(cfg, 512, 512, 0, tiles, device,
                                             dt, causal=False),
                       flash_bound, sdpa_call)),
        # qwen3-8b's attention heads (8 KV groups x 4, head_dim 128); the
        # f32 kernel is built for head_dim 64 only, so bf16 alone
        dict(shape=f"prompt 512, G 8, R 4, head_dim 128, tiles {tiles128}",
             **measure("flash_attention", flash_attention,
                       lambda dt: flash_case(cfg, 512, 512, 0, tiles128,
                                             device, dt, heads=(8, 4, 128)),
                       flash_bound, sdpa_call, dtypes=(torch.bfloat16,))),
    ]
    results["paged_decode_attention_int8"] = decode_entries(
        "paged_decode_attention_int8", paged_decode_attention,
        lambda dt, lens: int8_pool(
            decode_case(cfg, block_s, device, dt, split, lens),
            torch.Generator().manual_seed(SEED + 2)),
        block_s, split, None, "pool 1024, int8 codes, q/out in the dtype")
    results["decode_attention"] = decode_entries(
        "decode_attention", decode_attention,
        lambda dt, lens: contiguous_case(cfg, cache_block, device, dt,
                                         cache_split, lens),
        cache_block, cache_split, sdpa_decode_call, "contiguous rows of 1024")
    emit("decode_shapes", cases=decode_shapes_check(device, hw))

    def gather_entries(name, fn, quant, library):
        """The serving shape, the large case and one page (the launch's
        floor), each with the plan that launched the bf16 timing."""
        out = []
        for label, case in (
                ("one cache of the pool (8, 1024, 3, 64), page 16",
                 lambda dt: gather_case(cfg, device, dt, quant)),
                (f"{GATHER_LARGE}, page 16, every page mapped",
                 lambda dt: pool_gather_case(GATHER_LARGE, device, dt,
                                             quant, SEED + 4)),
                ("one page (1, 16, 3, 64)",
                 lambda dt: pool_gather_case((1, 16, g, d), device, dt,
                                             quant, SEED + 5))):
            entry = measure(name, fn, case, gather_bound, library,
                            exact=True, head_start=True)
            out.append(dict(shape=("int8 codes " if quant else "") + label,
                            plan=dataclasses.asdict(fn.last_plan),
                            **entry))
        return out

    results["paged_gather"] = gather_entries(
        "paged_gather", paged_gather, False, index_select_call)
    results["paged_dequant_gather"] = gather_entries(
        "paged_dequant_gather", paged_dequant_gather, True, None)
    emit("gather_shapes", cases=gather_shapes_check(device))
    return results


# --------------------------------------------------------------------------- #
# suite
# --------------------------------------------------------------------------- #

POLICIES = ("naive", "fixed", "auto")
F32, BF16 = torch.float32, torch.bfloat16
# GCN graphs with the sizes of the Planetoid datasets: (nodes, features,
# undirected edges), Cora and Pubmed.
CORA = (2708, 1433, 5278)
PUBMED = (19717, 500, 44324)
COMMUNITY, LOCAL_P = 256, 0.9
RMS_MISALIGNED = (64, 1000)      # rmsnorm x 2 bytes past a 16-byte boundary
MM_MISALIGNED = (8, 576, 576)    # matmul A 2 bytes past a 16-byte boundary
BLUR_MISALIGNED = (2160, 3840, 5)  # bf16 4K frame 2 bytes past 16 bytes
# SSD (L, H, P, G, N): one mamba2-1.3b layer over a 2,048-token prompt
# (d_inner 4096 = 64 heads of 64, one group, state 128), and a ragged L
# of 1,200 that no policy's chunk divides (the wrapper halves to 16)
MAMBA2_LAYER = (2048, 64, 64, 1, 128)
SSD_RAGGED = (1200, 64, 64, 1, 128)
BLUR_SIGMA = 1.0
# (op, shape, dtype): vectors under, at (hp, filled in at run time) and
# over hp; smollm-135m's decode-row MLP projection (m, n, k) = (8 slots,
# d_ff, d_model) and its decode rows (8, d_model); the paper's sgemm
# size and a long-prompt norm; a bf16 projection of 1532 columns (N not a
# multiple of 8: TMA cannot take B, the kernel copies it).
# The atypical kernels: the blur (h, w, ksize) of 256^2 (under hp) and of
# a 16-megapixel frame (62x hp) with halo 2 and 3; nn_search (nq, nr, d) of SIFT-style 128-dim descriptors
# (gws under hp) and at the workload's default 4 dims (gws ~1.9x hp);
# GCN aggregation (nodes, features, edges) at Cora's and Pubmed's sizes.
# Mamba-2's SSD at one mamba2-1.3b layer (f32 and bf16) and a ragged L.
# nn_search also at (1000, 3001, 36), which no tile divides, whose bf16
# rows (72 bytes) are not whole 16-byte vectors (the prep pass copies
# them for TMA), with 12 to 24 ref splits.
# Then an f32 product of odd sizes (130, 70, 300) (the 3xTF32 route pads
# it), and rmsnorm rows of 999 (not whole 16-byte vectors) and rows whose
# x starts 2 bytes past a 16-byte boundary (``RMS_MISALIGNED``): the
# scalar path.  Then bf16 products TMA cannot take, each operand copied
# by the kernel: (130, 70, 300) (K and N not multiples of 8: A in 8-byte
# copies, B in 4), (130, 1001, 257) (K and N odd: both in 2-byte copies)
# and smollm's decode-row output projection (8, 576, 576) with A 2 bytes
# past a 16-byte boundary (``MM_MISALIGNED``: A in 2-byte copies, B by
# TMA); and the sgemm size with N 4 or 1 short of 4096 (B in 8- or
# 2-byte copies at the large tiles).  Then the blur's scalar route: f32
# (3000, 4001, 5), whose rows of 16,004 bytes are not whole 16-byte
# vectors, and a bf16 4K frame whose rows are whole vectors but whose
# image starts 2 bytes past a 16-byte boundary (``BLUR_MISALIGNED``).
SUITE_CASES = (
    [(op, (n,), F32) for op in ("vecadd", "saxpy")
     for n in (1 << 16, "hp", 1 << 26)]
    + [(op, (1 << 26,), BF16) for op in ("vecadd", "saxpy")]
    + [("matmul", s, dt) for s in ((8, 1536, 576), (4096, 4096, 4096))
       for dt in (F32, BF16)]
    + [("matmul", (8, 1532, 576), BF16)]
    + [("rmsnorm", s, dt) for s in ((8, 576), (16384, 4096))
       for dt in (F32, BF16)]
    + [("gaussian_blur", (256, 256, 5), F32)]
    + [("gaussian_blur", (4096, 4096, 5), dt) for dt in (F32, BF16)]
    + [("gaussian_blur", (4096, 4096, 7), F32)]
    + [("nn_search", (4096, 65536, 128), dt) for dt in (F32, BF16)]
    + [("nn_search", (524288, 4096, 4), F32)]
    + [("gcn_aggregate", CORA, F32)]
    + [("gcn_aggregate", PUBMED, dt) for dt in (F32, BF16)]
    + [("ssd", MAMBA2_LAYER, dt) for dt in (F32, BF16)]
    + [("ssd", SSD_RAGGED, F32)]
    # last, so the seeded inputs of every case above stay as they were
    + [("matmul", (130, 70, 300), F32)]
    + [("rmsnorm", s, BF16) for s in ((37, 999), RMS_MISALIGNED)]
    + [("matmul", s, BF16) for s in ((130, 70, 300), (130, 1001, 257),
                                     MM_MISALIGNED, (4096, 4092, 4096),
                                     (4096, 4095, 4096))]
    + [("nn_search", (1000, 3001, 36), dt) for dt in (F32, BF16)]
    + [("gaussian_blur", (3000, 4001, 5), F32),
       ("gaussian_blur", BLUR_MISALIGNED, BF16)])
#: the suite's largest case of each kernel the tuner registers, run under
#: TUNED as a fourth policy (the ssd is not registered: its chunk is
#: Eq. 1's under every policy)
TUNED_CASES = (("vecadd", (1 << 26,), F32),
               ("saxpy", (1 << 26,), F32),
               ("matmul", (4096, 4096, 4096), F32),
               ("matmul", (4096, 4096, 4096), BF16),
               ("rmsnorm", (16384, 4096), BF16),
               ("gaussian_blur", (4096, 4096, 5), F32),
               ("nn_search", (4096, 65536, 128), F32),
               ("gcn_aggregate", PUBMED, F32))
#: suite op -> the tuner's kernel name
TUNER_KERNEL = {"vecadd": "vecadd", "saxpy": "saxpy", "matmul": "matmul",
                "rmsnorm": "rmsnorm", "gaussian_blur": "gaussian_blur",
                "nn_search": "nn_search", "gcn_aggregate": "gcn_agg"}
# (atol, rtol) of each kernel against its plain version: the CPU tests'
# tolerances against JAX (tests/test_torch_suite.py,
# tests/test_torch_suite_atypical.py); vecadd and saxpy round where
# their plain versions round and are held bitwise.  matmul's inputs are
# scaled by k^-1/4 so its
# outputs are O(1) and float32 sums over k = 4096 stay within 1e-4 (the
# 3xTF32 route keeps ~21 bits of each operand; one TF32 product would
# not: tests/test_torch_tf32x3.py).  The
# blur passes repeat their plain versions' roundings and are held bit for
# bit, on both routes; the aggregation sums each row in another order.
SUITE_TOL = {
    ("vecadd", F32): (0.0, 0.0),
    ("vecadd", BF16): (0.0, 0.0),
    ("saxpy", F32): (0.0, 0.0),
    ("saxpy", BF16): (0.0, 0.0),
    ("rmsnorm", F32): (1e-5, 1e-5),
    ("rmsnorm", BF16): (0.0, 8e-3),
    ("matmul", F32): (1e-4, 1e-4),
    ("matmul", BF16): (1.6e-2, 1.6e-2),
    ("gaussian_blur", F32): (0.0, 0.0),
    ("gaussian_blur", BF16): (0.0, 0.0),
    ("gcn_aggregate", F32): (1e-5, 1e-5),
    ("gcn_aggregate", BF16): (1e-5, 8e-3),
}
# nn_search's dist: within NN_DIST_TOL x (max |q|^2 + max |r|^2) of the
# plain version (the cancellation in |q|^2 - 2 q.r + |r|^2 leaves an
# error of the norms' size, not the distance's); idx equal except where
# the plain version's distance at the kernel's index is within that
# tolerance of its minimum (a near-tie: counted and printed).
NN_DIST_TOL = 2.0 ** -18
# nn_split_ties's shapes: 3 query tiles and 24 to 63 ref splits; d 36
# (bf16 copied by the prep pass) and 128 (bf16 read by TMA in place)
NN_TIE_SHAPES = ((300, 3001, 36), (300, 4000, 128))
SAXPY_A = 1.7
SWEEP_EXPONENTS = range(12, 27)      # vecadd sweep: n = 2^12 ... 2^26
RMS_EPS = 1e-6


def planetoid_like(n, f, edges, dtype, gen, device):
    """A synthetic graph of a Planetoid dataset's size: each undirected
    edge falls within one community of 256 consecutive node ids with
    probability 0.9, otherwise anywhere; made symmetric, with
    self-loops, row-normalised as tests/test_kernels.py does."""
    def randint(hi, size):
        return torch.randint(0, hi, (size,), generator=gen, device=device)

    src = randint(n, edges)
    local = (src // COMMUNITY * COMMUNITY + randint(COMMUNITY, edges)) \
        .clamp(max=n - 1)
    near = torch.rand(edges, generator=gen, device=device) < LOCAL_P
    dst = torch.where(near, local, randint(n, edges))
    a = torch.zeros(n, n, device=device)
    a[src, dst] = 1.0
    a[dst, src] = 1.0
    a.fill_diagonal_(1.0)
    a /= a.sum(1, keepdim=True).clamp(min=1.0)
    x = torch.randn(n, f, generator=gen, device=device)
    return a.to(dtype), x.to(dtype)


def suite_inputs(cases, device):
    """Seeded inputs for every case, made on the card; vecadd and saxpy
    of one shape and dtype share their vectors."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    made = {}

    def randn(*shape, dtype, scale=1.0):
        x = torch.randn(shape, generator=gen, device=device) * scale
        return x.to(dtype)

    for op, shape, dtype in cases:
        key = ("vec" if op in ("vecadd", "saxpy") else op, shape, dtype)
        if key in made:
            continue
        if op in ("vecadd", "saxpy"):
            made[key] = (randn(*shape, dtype=dtype),
                         randn(*shape, dtype=dtype))
        elif op == "matmul":
            m, n, k = shape
            if shape == MM_MISALIGNED:          # one bf16 past the start
                a = randn(m * k + 1, dtype=dtype,
                          scale=k ** -0.25)[1:].view(m, k)
            else:
                a = randn(m, k, dtype=dtype, scale=k ** -0.25)
            made[key] = (a, randn(k, n, dtype=dtype, scale=k ** -0.25))
        elif op == "gaussian_blur" and shape == BLUR_MISALIGNED:
            h, w, k = shape                     # one bf16 past the start
            made[key] = (randn(h * w + 1, dtype=dtype)[1:].view(h, w), k)
        elif op == "gaussian_blur":
            made[key] = (randn(*shape[:2], dtype=dtype), shape[2])
        elif op == "nn_search":
            nq, nr, d = shape
            made[key] = (randn(nq, d, dtype=dtype), randn(nr, d, dtype=dtype))
        elif op == "gcn_aggregate":
            n, f, edges = shape
            made[key] = planetoid_like(n, f, edges, dtype, gen, device)
        elif op == "ssd":            # tests/test_kernels.py's scaling
            length, h, p, g, n = shape
            made[key] = (randn(length, h, p, dtype=dtype, scale=0.5),
                         -randn(length, h, dtype=F32).abs() * 0.1,
                         randn(length, g, n, dtype=dtype, scale=0.3),
                         randn(length, g, n, dtype=dtype, scale=0.3))
        elif shape == RMS_MISALIGNED:           # one bf16 past the start
            t, d = shape
            x = randn(t * d + 1, dtype=dtype)[1:].view(t, d)
            made[key] = (x, randn(d, dtype=dtype))
        else:
            made[key] = (randn(*shape, dtype=dtype),
                         randn(shape[1], dtype=dtype))
    return lambda op, shape, dtype: made[
        ("vec" if op in ("vecadd", "saxpy") else op, shape, dtype)]


def suite_call(op, ins, policy):
    """The user's call: ``repro_torch.kernels.ops.<op>`` under ``policy``."""
    from repro_torch.kernels import ops

    if op == "vecadd":
        return lambda: ops.vecadd(*ins, policy=policy)
    if op == "saxpy":
        return lambda: ops.saxpy(SAXPY_A, *ins, policy=policy)
    if op == "matmul":
        return lambda: ops.matmul(*ins, policy=policy)
    if op == "gaussian_blur":
        img, k = ins
        return lambda: ops.gaussian_blur(img, ksize=k, sigma=BLUR_SIGMA,
                                         policy=policy)
    if op == "nn_search":
        return lambda: ops.nn_search(*ins, policy=policy)
    if op == "gcn_aggregate":
        return lambda: ops.gcn_aggregate(*ins, policy=policy)
    if op == "ssd":
        from repro_torch.core.hw import detect
        from repro_torch.models.ssm import plan_ssd_chunk

        chunk = plan_ssd_chunk(ins[0].shape[0], detect(ins[0].device), policy)
        return lambda: ops.ssd(*ins, chunk=chunk, policy=policy)
    return lambda: ops.rmsnorm(*ins, eps=RMS_EPS, policy=policy)


def blur_conv(img, taps_2d):
    """One ``F.conv2d`` with ``padding="same"`` over the image."""
    import torch.nn.functional as F

    w = taps_2d.to(device=img.device, dtype=img.dtype)[None, None]
    return lambda: F.conv2d(img[None, None], w, padding="same")


def suite_library(op, ins):
    """One PyTorch call computing the op's function, or None where no
    single call does: a yardstick only; the port never calls it."""
    import torch.nn.functional as F

    from repro_torch.kernels.stencil import gaussian_kernel_1d

    if op == "vecadd":
        return lambda: torch.add(*ins)
    if op == "saxpy":
        x, y = ins
        return lambda: torch.add(y, x, alpha=SAXPY_A)
    if op == "matmul" or op == "gcn_aggregate":
        return lambda: torch.matmul(*ins)
    if op == "gaussian_blur":
        img, k = ins
        taps = gaussian_kernel_1d(k, BLUR_SIGMA)
        return blur_conv(img, torch.outer(taps, taps))
    if op in ("nn_search", "ssd"):
        return None
    x, g = ins
    return lambda: F.rms_norm(x, (x.shape[1],), g, RMS_EPS)


@dataclasses.dataclass(frozen=True)
class SsdPlan:
    """What ``ops.ssd`` runs under a policy: the planned chunk, the chunk
    after the wrapper's halving, and its three launches (``grids`` of
    ``threads``-thread CTAs and shared memory by step, the f32
    workspace)."""

    chunk: int
    legal_chunk: int
    grids: dict
    threads: int
    smem_bytes: dict
    workspace_bytes: int


def tuner_args(op, ins):
    """The arguments ``ops.<op>`` hands the tuner's kernel for ``ins``."""
    if op == "saxpy":
        return (SAXPY_A, *ins), {}
    if op == "gaussian_blur":
        return (ins[0],), {"ksize": ins[1]}
    return tuple(ins), {}


def suite_plan(op, shape, dtype, policy, hw, ins):
    """The plan ``ops`` launches for the inputs under ``policy``: the
    tuner's ``plan_for`` (under TUNED from the run's cache), or the SSD's
    chunk plan (the tuner registers no SSD)."""
    if op == "ssd":
        from repro_torch.kernels import ssd
        from repro_torch.models.ssm import plan_ssd_chunk

        length, h, p, _, n = shape
        chunk = plan_ssd_chunk(length, hw, policy)
        legal = ssd.legal_chunk(length, chunk)
        geo = ssd.launch_geometry(length, h, n, p, legal)
        return SsdPlan(chunk, legal, geo.grids, geo.threads, geo.smem_bytes,
                       geo.workspace_bytes)
    from repro_torch.tuner.dispatch import plan_for

    args, kw = tuner_args(op, ins)
    return plan_for(TUNER_KERNEL[op], *args, hw=hw, policy=policy, **kw)[0]


def suite_bound(op, shape, dtype, hw, ins):
    """Each input read once, each output written once, over 3.35 TB/s;
    the operations these inputs need over the dtype's peak."""
    from repro_torch.core import workload

    es = torch.empty((), dtype=dtype).element_size()
    if op in ("vecadd", "saxpy"):
        w = getattr(workload, op)(shape[0], es)
        return bound(w.total_bytes, w.total_flops, dtype, hw)
    if op == "matmul":
        m, n, k = shape
        w = workload.sgemm(m, n, k, es)
        nbytes = (m * k + k * n + m * n) * es
        if dtype == F32:             # 3xTF32: three TF32 products each
            t_bytes = nbytes / hw.mem_bw * 1e3
            t_ops = 3 * w.total_flops / hw.peak_flops_tf32 * 1e3
            return (max(t_bytes, t_ops),
                    "bytes" if t_bytes >= t_ops else "operations")
        return bound(nbytes, w.total_flops, dtype, hw)
    if op == "gaussian_blur":        # two passes, each 2 h w elements
        h, w, k = shape
        return bound(2 * 2 * h * w * es, 2 * 2 * k * h * w, dtype, hw)
    if op == "nn_search":
        return nn_bounds(shape, dtype, hw)[:2]
    if op == "gcn_aggregate":        # A read once
        n, f, _ = shape
        nnz = int(torch.count_nonzero(ins[0]))
        return bound((n * n + 2 * n * f) * es, 2 * nnz * f, dtype, hw)
    if op == "ssd":
        return ssd_bound(shape, dtype, hw)[:2]
    t, d = shape
    return bound((2 * t * d + d) * es, 4 * t * d, dtype, hw)


def nn_bounds(shape, dtype, hw):
    """(ms, by, CUDA-core ms) of nn_search.  The least time is the
    longest of the bytes (queries and refs read once, idx and dist
    written once), the dots on the tensor cores (float32 as three TF32
    products, 3 x 2 nq nr d at the TF32 rate; bf16 2 nq nr d at its
    rate) and the epilogue's 3 nq nr f32 operations on the CUDA cores.
    The third number is the bound of the CUDA-core kernel this row had
    before: (2 d + 3) nq nr operations at the dtype's peak
    (``bound``)."""
    nq, nr, d = shape
    es = torch.empty((), dtype=dtype).element_size()
    nbytes = (nq + nr) * d * es + 8 * nq
    t_bytes = nbytes / hw.mem_bw * 1e3
    t_dot = (3 * 2 * nq * nr * d / hw.peak_flops_tf32 if dtype == F32
             else 2 * nq * nr * d / hw.peak_flops(dtype)) * 1e3
    t_epi = 3 * nq * nr / hw.peak_flops(F32) * 1e3
    t = max(t_bytes, t_dot, t_epi)
    old, _ = bound(nbytes, 2 * nq * nr * d + 3 * nq * nr, dtype, hw)
    return t, "bytes" if t == t_bytes else "operations", old


def ssd_bound(shape, dtype, hw):
    """(ms, by, CUDA-core ms) of the SSD.  x read and y written in the
    dtype, a (f32) read, b and c read.  Operations: the least count over
    the chunks the wrapper takes, so the bound does not follow the plan.
    At chunk c the function needs, a step and a head, the causal half of
    the scores and their product with x (s <= t only: (c + 1)(N + P))
    and the state products (4NP); the least is at c = 1, the recurrence:
    L H (2(N + P) + 4NP).  The score product C_t . B_s (2N of these) has
    both operands in the inputs' dtype; every other product has an f32
    operand (a decay or the state).  On the tensor cores an f32-operand
    product is three TF32 products at the TF32 rate, and so is the score
    product in f32; in bf16 the score product runs at the bf16 rate, and
    every other product has one operand that is a bf16 input, exact in
    TF32, so it is two TF32 products (csrc/ssd.cu's ``warp_mma``).
    The least time is the longest of those and the bytes.  The third
    number is the bound of the CUDA-core kernel this row had before:
    every f32-operand product at the f32 CUDA-core rate, the bf16 score
    product beside it at the bf16 rate."""
    length, h, p, g, n = shape
    es = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * length * h * p * es + length * h * 4 + 2 * length * g * n * es
    f32_flops = length * h * (2 * p + 4 * n * p)
    score_flops = length * h * 2 * n
    t_bytes = nbytes / hw.mem_bw * 1e3
    if dtype == torch.float32:
        t_ops = 3 * (f32_flops + score_flops) / hw.peak_flops_tf32 * 1e3
    else:
        t_ops = max(2 * f32_flops / hw.peak_flops_tf32,
                    score_flops / hw.peak_flops(dtype)) * 1e3
    f32_rate = hw.peak_flops(torch.float32)
    if dtype == torch.float32:
        t_old = (f32_flops + score_flops) / f32_rate * 1e3
    else:
        t_old = max(f32_flops / f32_rate,
                    score_flops / hw.peak_flops(dtype)) * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            max(t_bytes, t_old))


def suite_occupancy(op, plan, dtype, shape, ins):
    from repro_torch.kernels import (gcn_agg, matmul, nn_search, rmsnorm,
                                     saxpy, ssd, stencil, vecadd)

    if op == "matmul":
        return matmul.occupancy(plan, *ins)
    if op == "gaussian_blur":
        return {p: stencil.occupancy(p, plan, dtype) for p in ("rows", "cols")}
    if op == "nn_search":
        return nn_search.occupancy(plan)
    if op == "gcn_aggregate":
        return gcn_agg.occupancy(plan, dtype)
    if op == "ssd":
        return ssd.occupancy(plan.legal_chunk, dtype)
    if op == "rmsnorm":
        return rmsnorm.occupancy(*ins)
    if op == "vecadd":
        return vecadd.occupancy(dtype, vecadd.vector_steps(plan, *ins) > 0)
    return saxpy.occupancy(dtype, vecadd.vector_steps(plan, *ins) > 0)


def nn_compare(got, want, ins):
    """(max abs dist error, near-tie rows, dist tolerance); raises when
    an index differs outside a near-tie or a distance is out of
    tolerance."""
    q, r = (t.float() for t in ins)
    (gi, gd), (wi, wd) = got, want
    tol = NN_DIST_TOL * float((q * q).sum(-1).max() + (r * r).sum(-1).max())
    rows = (gi != wi).nonzero()[:, 0]
    if rows.numel():
        qq, rr = q[rows], r[gi[rows].long()]
        at = (qq * qq).sum(-1) - 2.0 * (qq * rr).sum(-1) + (rr * rr).sum(-1)
        if ((at - wd[rows]).abs() > tol).any():
            raise AssertionError("nn_search: an index differs from the "
                                 "plain version's outside a near-tie")
    gap = (gd - wd).abs()
    err = float(gap.max())
    if not torch.isfinite(gd).all() or err > 2 * tol \
            or float(torch.where(gi == wi, gap, 0.0).max()) > tol:
        raise AssertionError(f"nn_search: dist differs by {err} (tol {tol})")
    return err, int(rows.numel()), tol


def blur_passes(ins, plan, timer):
    """Each pass of the blur against its plain version on the same input
    (the column pass on the kernel's intermediate), bit for bit, and each
    timed; the route the wrapper takes for the image."""
    from repro_torch.kernels import stencil as st

    img, k = ins
    taps = st.gaussian_kernel_1d(k, BLUR_SIGMA)
    mid = st.stencil_rows(img, taps, plan=plan)
    out = st.stencil_cols(mid, taps, plan=plan)
    errs = {}
    for name, got, want in (("rows", mid, st.stencil_rows_plain(img, taps)),
                            ("cols", out, st.stencil_cols_plain(mid, taps))):
        atol, rtol = SUITE_TOL["gaussian_blur", img.dtype]
        errs[name] = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), atol=atol,
                              rtol=rtol):
            raise AssertionError(f"stencil_{name} disagrees with its plain "
                                 f"version by {errs[name]}")
    ms = {"rows": timer.ms(lambda: st.stencil_rows(img, taps, plan=plan),
                           head_start=True),
          "cols": timer.ms(lambda: st.stencil_cols(mid, taps, plan=plan),
                           head_start=True)}
    return dict(route=st.route(img, plan), pass_max_abs_err=errs,
                pass_ms=ms, passes_ms=ms["rows"] + ms["cols"])


def blur_pass_yardsticks(ins, timer):
    """Per pass, once per case: the plain version's time and one
    ``F.conv2d`` with a 1 x k or k x 1 kernel."""
    from repro_torch.kernels import stencil as st

    img, k = ins
    taps = st.gaussian_kernel_1d(k, BLUR_SIGMA)
    mid = st.stencil_rows_plain(img, taps)
    return dict(
        pass_plain_ms={
            "rows": timer.ms(lambda: st.stencil_rows_plain(img, taps),
                             head_start=True),
            "cols": timer.ms(lambda: st.stencil_cols_plain(mid, taps),
                             head_start=True)},
        pass_library_ms={
            "rows": timer.ms(blur_conv(img, taps[None, :]), head_start=True),
            "cols": timer.ms(blur_conv(mid, taps[:, None]),
                             head_start=True)})


def matmul_route_launches(dtype):
    """The launches one ``ops.matmul`` call must make: the split pass and
    the 3xTF32 product for float32; the tensor-core kernel for bfloat16,
    whatever the shape or alignment."""
    if dtype == F32:
        return {"matmul_split": 1, "matmul_tf32x3": 1}
    return {"matmul_tc": 1}


def tf32x3_parts(ins, plan, timer):
    """The 3xTF32 route's two launches apart: the split pass held bit for
    bit against its plain version and timed, the product timed; and the
    route's and ``torch.matmul``'s (TF32 off) max error against an f64
    product of the same inputs."""
    from repro_torch import kernels
    from repro_torch.kernels import matmul as mm

    a, b = ins
    n = b.shape[1]
    ws = mm.tf32_split(a, b, plan)
    with kernels.force("plain"):
        want = mm.tf32_split(a, b, plan)
    for got, ref, what in zip(ws, want, ("A", "B")):
        if not torch.equal(got, ref):
            raise AssertionError(f"tf32x3_split: {what}'s workspaces differ "
                                 f"from the plain split")
    del want
    ref = a.double() @ b.double()
    err = float((mm.tf32_product(*ws, n, plan).double() - ref).abs().max())
    lib_err = float((torch.matmul(a, b).double() - ref).abs().max())
    del ref
    return dict(
        f64_max_abs_err=err, library_f64_max_abs_err=lib_err,
        split_ms=timer.ms(lambda: mm.tf32_split(a, b, plan), head_start=True),
        product_ms=timer.ms(lambda: mm.tf32_product(*ws, n, plan),
                            head_start=True))


def tf32x3_split_edges(hw, device):
    """The split pass held bit for bit against its plain version on the
    values a random operand seldom holds: infinities, NaN, the largest
    floats (one within half a TF32 step of FLT_MAX, which rounding would
    take to infinity), subnormals and ties of the TF32 rounding."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.tuner.dispatch import plan_for

    top = float(np.finfo(np.float32).max)
    ties = (np.float32(1.0).view(np.uint32)
            | np.array([0x1000, 0x0FFF, 0x1001, 0x1FFF], np.uint32)
            ).view(np.float32)
    edge = np.concatenate([
        np.float32([np.inf, -np.inf, np.nan, top, -top, 3.4027e38, 1e-45,
                    -1e-45, 1e-40, 0.0, -0.0]), ties, -ties])
    rng = np.random.default_rng(0)
    a = rng.standard_normal((9, 40)).astype(np.float32)
    b = rng.standard_normal((40, 13)).astype(np.float32)
    a.flat[:edge.size], b.flat[-edge.size:] = edge, edge
    a, b = (torch.from_numpy(t).to(device) for t in (a, b))
    plan = plan_for("matmul", a, b, hw=hw, policy="auto")[0]
    got = mm.tf32_split(a, b, plan)
    want = mm.tf32_split(a.cpu(), b.cpu(), plan)
    for g, w, what in zip(got, want, ("A", "B")):
        if not torch.equal(g.cpu().view(torch.int32), w.view(torch.int32)):
            raise AssertionError(f"tf32x3_split: {what}'s workspaces differ "
                                 f"from the plain split on edge values")
    return int(2 * edge.size)


# tc_loader_check's operands: M 40 plans BM 64 and M 130 BM 128 (a
# second row tile of 2 rows); N and K multiples of 8 that TMA takes, with
# a ragged last column tile at BN 256 and a K tail of 8; N and K one
# less are both odd
LOADER_SHAPES = ((40, 264, 328), (130, 264, 328))


def tc_loader_check(hw, device):
    """The bf16 kernel's copy loader held against TMA's at every tile (BN
    8 ... 256, BM 64 and 128): the same operands, once where TMA takes
    them and once 1, 2 or 4 elements past a 16-byte boundary (A, B or
    both: 2-, 4- or 8-byte copies), must give the same bits, since the
    copies must write TMA's swizzled layout.  Then N and K odd (2-byte
    copies of both, the odd-N epilogue) against the plain version within
    ``SUITE_TOL``, in bf16 and f32 out.  These launches come after the
    suite's counts were read."""
    from repro_torch import kernels
    from repro_torch.core.mapper import matmul_plan_for_blocks
    from repro_torch.kernels import matmul as mm

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    atol, rtol = SUITE_TOL["matmul", BF16]

    def off(t, e):                        # t's values, e elements past
        flat = torch.empty(t.numel() + e, dtype=t.dtype, device=device)
        flat[e:] = t.flatten()
        return flat[e:].view(t.shape)

    bitwise = odd = 0
    odd_err = 0.0
    for m, n, k in LOADER_SHAPES:
        a = (torch.randn(m, k, generator=gen, device=device)
             * k ** -0.25).to(BF16)
        b = (torch.randn(k, n, generator=gen, device=device)
             * k ** -0.25).to(BF16)
        n_odd, k_odd = n - 1, k - 1
        a_odd = a[:, :k_odd].contiguous()
        b_odd = b[:k_odd, :n_odd].contiguous()
        for lws in (4, 8, 16, 32, 64, 128):
            plan = matmul_plan_for_blocks(m, n, k, hw, lws,
                                          kernel="tensor_core")
            want = mm.matmul(a, b, plan=plan)
            for e in (1, 2, 4):
                for a2, b2 in ((off(a, e), b), (a, off(b, e)),
                               (off(a, e), off(b, e))):
                    widths = mm.loader_bytes(a2, b2)
                    if widths == (16, 16) or 2 * e not in widths:
                        raise AssertionError(f"tc_loader_check: loaders "
                                             f"{widths} at offset {e}")
                    if not torch.equal(mm.matmul(a2, b2, plan=plan), want):
                        raise AssertionError(
                            f"tc_loader_check: ({m}, {n}, {k}) {plan.bm}x"
                            f"{plan.bn}, loaders {widths}: the copy "
                            f"loader's product differs from TMA's")
                    bitwise += 1
            oplan = matmul_plan_for_blocks(m, n_odd, k_odd, hw, lws,
                                           kernel="tensor_core")
            for out in (BF16, F32):
                got = mm.matmul(a_odd, b_odd, plan=oplan, out_dtype=out)
                with kernels.force("plain"):
                    ref = mm.matmul(a_odd, b_odd, plan=oplan, out_dtype=out)
                err = float((got.float() - ref.float()).abs().max())
                if not torch.allclose(got.float(), ref.float(), atol=atol,
                                      rtol=rtol):
                    raise AssertionError(
                        f"tc_loader_check: ({m}, {n_odd}, {k_odd}) "
                        f"{oplan.bm}x{oplan.bn} {out}: max abs err {err}")
                odd_err = max(odd_err, err)
                odd += 1
    torch.cuda.synchronize()
    return dict(bitwise_cases=bitwise, odd_cases=odd,
                odd_max_abs_err=odd_err, atol=atol, rtol=rtol)


def nn_parts(ins, plan, timer):
    """nn_search's two launches apart: what the prep pass writes for the
    product (``layout``: the TF32 split, a bf16 copy, or the norms
    alone), the prep pass and the product each timed."""
    from repro_torch.kernels import nn_search as nn

    q, r = ins
    ws, norms = nn.prep(q, r, plan)
    return dict(
        layout=nn.layout(q, r)[0],
        prep_ms=timer.ms(lambda: nn.prep(q, r, plan), head_start=True),
        product_ms=timer.ms(lambda: nn.product(q, r, ws, norms, plan),
                            head_start=True))


def nn_split_ties(hw, device):
    """Ties across nn_search's ref splits, in float32 and bf16 under each
    policy at ``NN_TIE_SHAPES`` (every plan at least 3 splits of W refs):
    a ref copied exactly to the end of split 0 (W - 1), the start of
    split 1 (W) and the last ref, with query 0 a small step from it;
    refs +e0 at W - 2 and -e0 at the last but one, with the last query
    at the origin (both distances exactly 1).  The kernel must return W
    - 1 and W - 2, the lower index of each tie.  Returns the cases
    checked and how many of them the plain version (cuBLAS's dots, then
    ``argmin``) answered the same.  These launches come after the
    suite's counts were read."""
    from repro_torch import kernels
    from repro_torch.core.mapper import plan_nn
    from repro_torch.kernels import ops

    rng = np.random.default_rng(SEED + 2)
    checked = plain_agrees = 0
    for nq, nr, d in NN_TIE_SHAPES:
        base = rng.standard_normal((nr, d)).astype(np.float32) + 8.0
        queries = rng.standard_normal((nq, d)).astype(np.float32) + 8.0
        for dtype in (F32, BF16):
            es = torch.empty((), dtype=dtype).element_size()
            for policy in POLICIES:
                plan = plan_nn(nq, nr, d, hw, policy, elem_bytes=es)
                w = plan.split
                if plan.grid[1] < 3:
                    raise AssertionError(f"nn_split_ties: {plan} has fewer "
                                         f"than 3 splits")
                refs, qs = base.copy(), queries.copy()
                refs[[w, nr - 1]] = refs[w - 1]
                qs[0] = refs[w - 1] + 1e-3
                refs[[w - 2, nr - 2]] = 0.0
                refs[w - 2, 0], refs[nr - 2, 0] = 1.0, -1.0
                qs[-1] = 0.0
                q, r = (torch.from_numpy(t).to(device=device, dtype=dtype)
                        for t in (qs, refs))
                idx, _ = ops.nn_search(q, r, policy=policy)
                with kernels.force("plain"):
                    want, _ = ops.nn_search(q, r, policy=policy)
                got = [int(idx[0]), int(idx[-1])]
                if got != [w - 1, w - 2]:
                    raise AssertionError(
                        f"nn_split_ties: ({nq}, {nr}, {d}) {dtype} {policy} "
                        f"(W {w}, {plan.grid[1]} splits): kernel {got}, "
                        f"expected {[w - 1, w - 2]}")
                checked += 1
                plain_agrees += [int(want[0]), int(want[-1])] == got
    torch.cuda.synchronize()
    return dict(cases=checked, plain_agrees=plain_agrees)


#: calls of an op in one profiler trace (``traced_kernels``), and the
#: idle seconds at each end of the trace
TRACE_CALLS, TRACE_PAD_S = 10, 0.1


def traced_kernels(call, per_call: int, tries: int = 3):
    """``device_kernels`` of one torch.profiler trace of ``TRACE_CALLS``
    calls of ``call``, each launching ``per_call`` kernels: what ran on
    the card, which the launch counters cannot see (a torch op doing a
    kernel's work).  The profiler keeps only the device events inside
    its window and has come back short of them (five of ten, or none of
    one), so the trace is padded with ``TRACE_PAD_S`` of idle at each
    end, a trace with fewer events than launches is taken again, and
    after ``tries`` such traces this raises; more events raise at once."""
    from torch.profiler import ProfilerActivity, profile

    want = TRACE_CALLS * per_call
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_PAD_S)
            for _ in range(TRACE_CALLS):
                call()
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
        rows = device_kernels(prof)
        got = sum(n for _, _, n in rows)
        if got > want:
            raise AssertionError(f"{TRACE_CALLS} calls ran {rows}, over "
                                 f"{per_call} kernels a call")
        if got == want:
            return rows
    raise AssertionError(f"{tries} profiler traces held fewer than the "
                         f"{want} kernels launched, the last {rows}")


def gcn_device_kernels(call):
    """The device kernels of ``TRACE_CALLS`` calls of the op, by name:
    one launch of ``gcn_kernel`` a call and nothing else, no torch pass
    over A."""
    names = [(k, n) for k, _, n in traced_kernels(call, 1)]
    if len(names) != 1 or "gcn_kernel" not in names[0][0] \
            or names[0][1] != TRACE_CALLS:
        raise AssertionError(f"gcn_aggregate ran {names} in {TRACE_CALLS} "
                             f"calls, not one launch of gcn_kernel a call")
    return {k[:80]: n for k, n in names}


def ssd_parts(ins, plan):
    """The grids one call launched (held against the plan's), and each
    of its three steps' device time, the mean over ``TRACE_CALLS``
    back-to-back calls in one profiler trace (the L2 not flushed: the
    workspace alone outgrows it).  The trace must hold each step once a
    call and no other kernel: no torch op does a step's work."""
    from repro_torch.kernels import ssd

    def call():
        ssd.ssd(*ins, chunk=plan.legal_chunk)

    rows = traced_kernels(call, len(ssd.STEPS))
    if ssd.ssd.last_grids != plan.grids:
        raise AssertionError(f"ssd launched {ssd.ssd.last_grids}, not the "
                             f"plan's {plan.grids}")
    step_ms = {}
    for name, ms, n in rows:
        step = re.search(r"::ssd_(states|pass|outputs)[<(]", name)
        if step is None or n != TRACE_CALLS:
            raise AssertionError(f"ssd ran {[(k, n) for k, _, n in rows]}, "
                                 f"not its three steps once a call")
        step_ms[step.group(1)] = ms / n
    if sorted(step_ms) != sorted(ssd.STEPS):
        raise AssertionError(f"ssd ran the steps {sorted(step_ms)}")
    return dict(launched_grids={k: list(v) for k, v in
                                ssd.ssd.last_grids.items()},
                step_ms=step_ms, steps_sum_ms=sum(step_ms.values()))


SUITE_REPLACES = {"vecadd": "src/repro/kernels/vecadd.py:20",
                  "saxpy": "src/repro/kernels/saxpy.py:15",
                  "matmul_tc": "src/repro/kernels/matmul.py:24",
                  "matmul_tf32x3": "src/repro/kernels/matmul.py:24",
                  "rmsnorm": "src/repro/kernels/rmsnorm.py:19",
                  "stencil_rows": "src/repro/kernels/stencil.py:40",
                  "stencil_cols": "src/repro/kernels/stencil.py:59",
                  "nn_search": "src/repro/kernels/nn_search.py:39",
                  "gcn_agg": "src/repro/kernels/gcn_agg.py:38",
                  "ssd": "src/repro/kernels/ssd.py:29"}


def suite_phase(hw, timer, device):
    """The paper's kernel suite on the card under the three policies."""
    from repro_torch import kernels
    from repro_torch.kernels import (gcn_agg, matmul, nn_search, rmsnorm,
                                     saxpy, ssd, stencil, vecadd)

    # kernel name -> (wrapper, attribute of its launch count); the two
    # matmul routes count apart, the 3xTF32 route's split and product
    # too, and nn_search's prep pass and product
    counters = {"vecadd": (vecadd.vecadd, "launches"),
                "saxpy": (saxpy.saxpy, "launches"),
                "matmul_tc": (matmul.matmul, "tc_launches"),
                "matmul_split": (matmul.matmul, "split_launches"),
                "matmul_tf32x3": (matmul.matmul, "tf32_launches"),
                "rmsnorm": (rmsnorm.rmsnorm, "launches"),
                "stencil_rows": (stencil.stencil_rows, "launches"),
                "stencil_cols": (stencil.stencil_cols, "launches"),
                "nn_search": (nn_search.nn_search, "launches"),
                "nn_search_prep": (nn_search.nn_search, "prep_launches"),
                "gcn_agg": (gcn_agg.gcn_agg, "launches"),
                "ssd": (ssd.ssd, "launches")}
    # the launches of one call of these ops, and nothing else
    one_call = {"gcn_aggregate": {"gcn_agg": 1}, "ssd": {"ssd": 1}}
    cases = [(op, (hw.hp(),) if shape == ("hp",) else shape, dtype)
             for op, shape, dtype in SUITE_CASES]
    inputs = suite_inputs(cases, device)
    t0 = time.perf_counter()

    # the main path: every op under every policy, counts read per policy
    # (and per case: the launches of the case's own call)
    outs, launches, case_launches = {}, {}, {}

    def counts():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    tuned_cases = [c for c in cases if c in TUNED_CASES]
    for policy in POLICIES + ("tuned",):
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        for case in (tuned_cases if policy == "tuned" else cases):
            before = counts()
            outs[case, policy] = suite_call(case[0], inputs(*case), policy)()
            case_launches[case, policy] = {
                k: n - before[k] for k, n in counts().items()
                if n != before[k]}
            want = one_call.get(case[0])
            if case[0] == "matmul":
                want = matmul_route_launches(case[2])
            if want is not None:
                if case_launches[case, policy] != want:
                    raise AssertionError(
                        f"suite: {case[0]} {case[1]} {case[2]} {policy} "
                        f"launched {case_launches[case, policy]}, not "
                        f"{want}")
        torch.cuda.synchronize()
        launches[policy] = counts()
        for k, n in launches[policy].items():
            if n <= 0 and (policy != "tuned" or k != "ssd"):
                raise AssertionError(f"suite: {k} was never launched under "
                                     f"policy {policy}")
    emit("suite_launches", **launches)

    results = {}
    for case in cases:
        op, shape, dtype = case
        ins = inputs(*case)
        dt = str(dtype).split(".")[1]
        library = suite_library(op, ins)
        library_ms = timer.ms(library, head_start=True) if library else None
        bound_ms, bound_by = suite_bound(op, shape, dtype, hw, ins)
        per_case = blur_pass_yardsticks(ins, timer) \
            if op == "gaussian_blur" else {}
        for policy in POLICIES + (("tuned",) if case in TUNED_CASES
                                  else ()):
            plan = suite_plan(op, shape, dtype, policy, hw, ins)
            call = suite_call(op, ins, policy)
            with kernels.force("plain"):
                want = call()
            got = outs.pop((case, policy))
            extra = dict(per_case)
            if op == "nn_search":
                err, extra["idx_near_ties"], extra["dist_atol"] = \
                    nn_compare(got, want, ins)
                atol = rtol = None
            else:
                # ssd: TOL of the output's largest magnitude (the chunk's
                # exponent sums reorder against the plain version's)
                atol, rtol = SUITE_TOL[op, dtype] if op != "ssd" else (
                    TOL[dtype] * float(want.float().abs().max()), 0.0)
                err = float((got.float() - want.float()).abs().max())
                ok = torch.allclose(got.float(), want.float(), atol=atol,
                                    rtol=rtol)
                if not ok or not torch.isfinite(got.float()).all():
                    raise AssertionError(
                        f"suite {op} {shape} {dt} {policy}: kernel disagrees "
                        f"with its plain version, max abs err {err} (atol "
                        f"{atol}, rtol {rtol})")
            del got, want
            if op == "gaussian_blur":
                extra.update(blur_passes(ins, plan, timer))
            elif op == "gcn_aggregate":
                extra["device_kernels"] = gcn_device_kernels(call)
            elif op == "ssd":
                extra.update(ssd_parts(ins, plan))
                extra["bound_cuda_core_ms"] = ssd_bound(shape, dtype, hw)[2]
            elif op == "matmul":
                launched = case_launches[case, policy]
                extra.update(route=plan.kernel,
                             loader_bytes=matmul.loader_bytes(*ins),
                             matmul_tc_launches=launched.get("matmul_tc", 0),
                             split_launches=launched.get("matmul_split", 0),
                             tf32_launches=launched.get("matmul_tf32x3", 0),
                             host_ms=host_ms(call))
                if plan.kernel == "tf32x3":
                    extra.update(tf32x3_parts(ins, plan, timer))
            elif op == "rmsnorm":
                from repro_torch.kernels.rmsnorm import row_path
                extra["row_path"] = row_path(*ins)
            elif op in ("vecadd", "saxpy"):
                extra["vector_steps"] = vecadd.vector_steps(plan, *ins)
            elif op == "nn_search":
                extra.update(nn_parts(ins, plan, timer))
                extra["bound_cuda_core_ms"] = nn_bounds(shape, dtype, hw)[2]

            def plain():
                with kernels.force("plain"):
                    call()
            entry = dict(
                op=op, shape=list(shape), dtype=dt, policy=policy,
                plan={k: (v.value if hasattr(v, "value") else v)
                      for k, v in dataclasses.asdict(plan).items()},
                resident_ctas_per_sm=suite_occupancy(op, plan, dtype, shape,
                                                     ins),
                assumed_ctas_per_sm=hw.warps_per_sm * hw.warp_size
                // plan.threads,
                max_abs_err=err, atol=atol, rtol=rtol,
                launches=case_launches[case, policy],
                kernel_ms=timer.ms(call, head_start=True),
                kernel_runs=timer.last_runs,
                plain_ms=timer.ms(plain, head_start=True),
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                **extra)
            emit("suite", **entry)
            results[op, shape, dt, policy] = entry

    x, y = inputs("vecadd", (1 << SWEEP_EXPONENTS[-1],), F32)
    sweep = {}
    for e in SWEEP_EXPONENTS:
        n = 1 << e
        xs, ys = x[:n], y[:n]
        sweep[n] = {p: timer.ms(suite_call("vecadd", (xs, ys), p),
                                head_start=True) for p in POLICIES}
    emit("suite_sweep", op="vecadd", dtype="float32",
         kernel_ms={str(n): v for n, v in sweep.items()})
    emit("tf32x3_split_edges", values=tf32x3_split_edges(hw, device))
    emit("matmul_tc_loaders", **tc_loader_check(hw, device))
    emit("nn_split_ties", **nn_split_ties(hw, device))
    emit("suite_done", seconds=time.perf_counter() - t0)
    # the kernels line's launches: NAIVE, FIXED and AUTO over every case;
    # TUNED's at its cases apart
    total = {k: sum(launches[p][k] for p in POLICIES) for k in counters}
    return results, total, launches["tuned"]


# --------------------------------------------------------------------------- #
# tuner
# --------------------------------------------------------------------------- #

#: the serving router's geometry: smollm-135m's pool (8 slots, buckets up
#: to 1024, pages of 16) on both pool dtypes; the kernels are timed at
#: the largest bucket
TUNER_SLOTS, TUNER_MAX_LEN, TUNER_PAGE = 8, 1024, 16
#: the suite kernels the tuner phase resolves, at their largest case
TUNER_SUITE = TUNED_CASES
#: live measurement settings: warm-up calls and timed repeats a value,
#: ``Timer.ms``'s, so a live record and the Timer's reading of one plan
#: are taken alike
LIVE_OPTS = {"warmup": 3, "reps": 25}


def live_cases():
    """The four cases where a plan other than AUTO's is known to be
    faster on the card: label -> (tuner kernel, workload description).
    The blur's passes (one plan), vecadd at 2^26, GCN on a Pubmed-sized
    graph (all float32), and the paged decode's split width at the
    serving bucket (bf16, 8 slots x 3 KV heads of 3 queries)."""
    from repro_torch.configs import get_config

    cfg = get_config("smollm-135m")
    return {
        "blur": ("gaussian_blur", dict(h=4096, w=4096, ksize=5,
                                       dtype="float32", dtype_bytes=4,
                                       aligned=True)),
        "vecadd": ("vecadd", dict(n=1 << 26, dtype="float32",
                                  dtype_bytes=4)),
        "gcn_pubmed": ("gcn_agg", dict(n=PUBMED[0], f=PUBMED[1],
                                       block_s=256, dtype="float32",
                                       dtype_bytes=4)),
        "decode_split": ("paged_decode", dict(
            s=TUNER_MAX_LEN, d=cfg.head_dim,
            rows=TUNER_SLOTS * cfg.num_kv_heads,
            heads_per_group=cfg.heads_per_group, dtype=cfg.dtype,
            dtype_bytes=2, page_block=TUNER_PAGE,
            max_blocks_per_row=TUNER_MAX_LEN // TUNER_PAGE)),
    }


def held_to_plain(got, want, what):
    """Max abs error of a kernel's output against its plain version's,
    raising outside the output dtype's ``TOL``."""
    return check_close(got, want, got.dtype, what)


def time_values(kernel, desc, values, hw, timer, device):
    """CUDA-event times of ``kernel`` at each decision value on operands
    made from ``desc`` (``profiler.measure``'s synthesiser), and the last
    value's output held against its plain version."""
    from repro_torch import kernels
    from repro_torch.profiler.measure import SYNTH_REGISTRY
    from repro_torch.tuner import KERNEL_REGISTRY

    spec = KERNEL_REGISTRY[kernel]
    gen = torch.Generator(device=device).manual_seed(SEED)
    args, kw = SYNTH_REGISTRY[kernel].make(desc, device, gen)
    out = {}
    for label, value in values.items():
        plan = spec.plan_from_value(desc, hw, value)
        out[f"{label}_ms"] = timer.ms(lambda: spec.run(plan, hw, *args,
                                                       **kw),
                                      head_start=True)
    got = spec.run(plan, hw, *args, **kw)
    with kernels.force("plain"):
        want = spec.run(plan, hw, *args, **kw)
    out["max_abs_err"] = held_to_plain(got, want, f"tuner {kernel} at "
                                       f"{label}")
    return out


def tuner_phase(hw, timer, device):
    """The tuner on the card, from a fresh cache and trace store in a
    temporary directory: every ``KERNEL_TABLE`` row at every serving
    bucket and every suite kernel at its largest case resolved cold
    (AUTO's seed beside TUNED's pick, the probes, the card time of both
    and TUNED's output against plain); a second router on the same cache
    file (0 probes, a gate); measured refinement, ``measure="live"`` on
    the four cases of ``live_cases``, then ``measure="cached"`` replaying
    them from the store (0 live measurements and the same picks, gates).
    Returns the times at the serving bucket and the suite's cases."""
    from repro_torch.configs import get_config
    from repro_torch.core.mapper import MappingPolicy
    from repro_torch.profiler import TraceStore, value_key
    from repro_torch.serve.buckets import (KERNEL_TABLE, BucketRouter,
                                           BucketSpec)
    from repro_torch.tuner import (KERNEL_REGISTRY, TuningCache,
                                   hardware_key, resolve_plan)

    tmp = tempfile.mkdtemp(prefix="tuner_phase_")
    try:
        t0 = time.perf_counter()
        cfg = get_config("smollm-135m")
        spec = BucketSpec(max_len=TUNER_MAX_LEN, min_len=32)
        cache_path = f"{tmp}/tuning_cache.json"
        serving = {}
        for kv in ("fp32", "int8"):
            def router(policy, cache=None, _kv=kv):
                return BucketRouter(cfg, spec, slots=TUNER_SLOTS, hw=hw,
                                    policy=policy, cache=cache,
                                    page_block=TUNER_PAGE, kv_dtype=_kv,
                                    device=device)
            tuned = router("tuned", TuningCache(cache_path))
            auto = router("auto")
            for n in spec.lattice():
                b = tuned.bucket(n)
                tp, ap = tuned.resolve(b), auto.resolve(b)
                for row in KERNEL_TABLE:
                    info = getattr(tp, row.info)
                    pick = tuple(getattr(tp, f) for f in row.fields)
                    seed = tuple(getattr(ap, f) for f in row.fields)
                    if row.kernel == "flash_attention":
                        pick, seed = pick[0], seed[0]
                    entry = dict(kv_dtype=kv, bucket=n, kernel=row.kernel,
                                 seed=list(seed), tuned=list(pick),
                                 source=info.source, probes=info.probes)
                    # the contiguous sweep takes no int8 cache (the int8
                    # gather path sweeps its dequantised view)
                    if n == TUNER_MAX_LEN and not (
                            kv == "int8" and row.kernel != "paged_decode"):
                        entry.update(time_values(
                            row.kernel, tuned.row_desc(row, b),
                            {"seed": seed, "tuned": pick}, hw, timer,
                            device))
                        serving[kv, row.kernel] = entry
                    emit("tuner", **entry)
            if tuned.stats.probes <= 0:
                raise AssertionError(f"tuner: the cold router ({kv}) made "
                                     f"no probe")
        # a second router on the same cache file: every bucket a hit
        for kv in ("fp32", "int8"):
            warm = BucketRouter(cfg, spec, slots=TUNER_SLOTS, hw=hw,
                                cache=TuningCache(cache_path),
                                page_block=TUNER_PAGE, kv_dtype=kv,
                                device=device)
            for n in spec.lattice():
                warm.resolve(warm.bucket(n))
            emit("tuner_warm", kv_dtype=kv, **dataclasses.asdict(warm.stats))
            if warm.stats.probes != 0 or warm.stats.cache_hits <= 0:
                raise AssertionError(f"tuner: a router on a warm cache "
                                     f"file probed: {warm.stats}")

        # the suite's kernels at their largest case, on the suite's inputs
        inputs = suite_inputs(TUNER_SUITE, device)
        suite = {}
        suite_cache = TuningCache(f"{tmp}/suite_cache.json")
        for op, shape, dtype in TUNER_SUITE:
            kernel = TUNER_KERNEL[op]
            ks = KERNEL_REGISTRY[kernel]
            ins = inputs(op, shape, dtype)
            args, kw = tuner_args(op, ins)
            desc = ks.describe(*args, **kw)
            plan, info = resolve_plan(kernel, hw, "tuned", desc, suite_cache)
            seed = ks.plan_value(ks.seed_plan(desc, hw, MappingPolicy.TUNED))
            entry = dict(op=op, shape=list(shape),
                         dtype=str(dtype).split(".")[1], kernel=kernel,
                         seed=seed, tuned=ks.plan_value(plan),
                         source=info.source, probes=info.probes,
                         model_seed_ms=info.seed_cost * 1e3,
                         model_tuned_ms=info.cost * 1e3)
            for label, pol in (("seed", "auto"), ("tuned", "tuned")):
                entry[f"{label}_ms"] = timer.ms(
                    suite_call(op, ins, pol), head_start=True)
            from repro_torch import kernels
            got = suite_call(op, ins, "tuned")()
            with kernels.force("plain"):
                want = suite_call(op, ins, "tuned")()
            if op == "nn_search":
                entry["max_abs_err"] = nn_compare(got, want, ins)[0]
            else:
                atol, rtol = SUITE_TOL[op, dtype]
                if not torch.allclose(got.float(), want.float(), atol=atol,
                                      rtol=rtol):
                    raise AssertionError(f"tuner: {op} at TUNED's plan "
                                         f"disagrees with plain")
                entry["max_abs_err"] = float(
                    (got.float() - want.float()).abs().max())
            del got, want
            again, ainfo = resolve_plan(kernel, hw, "tuned", desc,
                                        suite_cache)
            if ainfo.source != "cache" or ainfo.probes != 0:
                raise AssertionError(f"tuner: {kernel}'s warm hit probed")
            emit("tuner_suite", **entry)
            suite[op, shape, entry["dtype"]] = entry
        del inputs

        # measured refinement: live, then replayed from the store
        store = TraceStore(f"{tmp}/traces.jsonl")
        live_cache = TuningCache(f"{tmp}/live_cache.json")
        replay_cache = TuningCache(f"{tmp}/replay_cache.json")
        opts = {"device": device, **LIVE_OPTS}
        live = {}
        for label, (kernel, desc) in live_cases().items():
            ks = KERNEL_REGISTRY[kernel]
            seed = ks.plan_value(ks.seed_plan(desc, hw, MappingPolicy.TUNED))
            roof, _ = resolve_plan(kernel, hw, "tuned", desc,
                                   TuningCache(path=None))
            plan, info = resolve_plan(kernel, hw, "tuned", desc, live_cache,
                                      measure="live", store=store,
                                      measure_opts=opts)
            rplan, rinfo = resolve_plan(kernel, hw, "tuned", desc,
                                        replay_cache, measure="cached",
                                        store=store,
                                        measure_opts={"device": device})
            recorded = {value_key(m.value): m.median_s * 1e3
                        for m in store.lookup(hardware_key(hw),
                                              ks.sig(desc, "tuned").key)}
            entry = dict(case=label, kernel=kernel, seed=seed,
                         roofline=ks.plan_value(roof),
                         live=ks.plan_value(plan), live_source=info.source,
                         live_measurements=info.measured,
                         replayed=ks.plan_value(rplan),
                         replay_source=rinfo.source,
                         replay_measurements=rinfo.measured,
                         recorded_ms=recorded)
            # the Timer's reading of the seed, the roofline's pick and the
            # live pick on the same operands, beside the live records
            entry["timer"] = time_values(
                kernel, desc, {"seed": seed, "roofline": entry["roofline"],
                               "live": entry["live"]}, hw, timer, device)
            emit("tuner_live", **entry)
            if info.measured <= 0 or info.source != "measured":
                raise AssertionError(f"tuner: live {label} measured "
                                     f"nothing")
            if rinfo.measured != 0 or rinfo.source != "measured" \
                    or entry["replayed"] != entry["live"]:
                raise AssertionError(f"tuner: the cached replay of {label} "
                                     f"measured or picked otherwise: {entry}")
            live[label] = entry
        emit("tuner_done", seconds=time.perf_counter() - t0,
             store_records=len(store))
        return serving, suite, live
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------- #
# engine
# --------------------------------------------------------------------------- #


def requests(n, lo, hi, max_new, vocab, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=n)
    return [(rng.integers(1, vocab, size=int(m)).tolist(), max_new)
            for m in lens]


def serve(engine, reqs):
    submitted = [engine.submit(p, max_new_tokens=m) for p, m in reqs]
    torch.cuda.synchronize()
    report = engine.run()
    torch.cuda.synchronize()
    outs = [report.outputs.get(r.rid) for r in submitted]
    vocab = engine.cfg.vocab_size
    for (p, m), out in zip(reqs, outs):
        if out is None or len(out) != len(p) + m or out[:len(p)] != p \
                or not all(0 <= t < vocab for t in out):
            raise AssertionError("a request came back incomplete or with "
                                 "tokens outside the vocabulary")
    return report, outs


#: engine runs: label -> (engine options, prefill chunk, the kernels the
#: path must launch); every other kernel of the serving paths must be
#: launched 0 times in that run
ENGINE_RUNS = {
    "chunked": ({}, "auto", {"paged_decode_attention", "flash_attention"}),
    "whole_prompt": ({}, None, {"paged_decode_attention",
                                "flash_attention"}),
    "contiguous": (dict(paged=False), "auto",
                   {"decode_attention", "flash_attention"}),
    "gather": (dict(fused_decode=False), "auto",
               {"paged_gather", "decode_attention", "flash_attention"}),
    "int8": (dict(kv_dtype="int8"), "auto",
             {"paged_decode_attention_int8", "flash_attention"}),
    "int8_gather": (dict(kv_dtype="int8", fused_decode=False), "auto",
                    {"paged_dequant_gather", "decode_attention",
                     "flash_attention"}),
}


#: mamba2-1.3b runs on the mix's first requests: label -> prefill chunk.
#: The ssm path launches no kernel of the port (its prefill is the plain
#: ``ssd_chunked``, as the reference's is jnp), so every count stays 0
MAMBA_RUNS = {"mamba2": "auto", "mamba2_whole": None}
#: requests of the mix the mamba2 runs serve: on all 12 (3,262 prompt
#: tokens; the chunked prefill is a 48-layer decode step a prompt
#: token) the two runs took 238 s and the smoke 772 s; the first 4 hold
#: 1,389 prompt tokens
MAMBA_REQUESTS = 4


def launch_counters():
    """kernel name -> (wrapper, attribute) of its launch count: the six
    serving kernels and the ssd, which no engine path may launch."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_gather as pg
    from repro_torch.kernels import ssd

    return {"paged_decode_attention": (pda.paged_decode_attention,
                                       "launches"),
            "paged_decode_attention_int8": (pda.paged_decode_attention,
                                            "int8_launches"),
            "flash_attention": (fa.flash_attention, "launches"),
            "decode_attention": (da.decode_attention, "launches"),
            "paged_gather": (pg.paged_gather, "launches"),
            "paged_dequant_gather": (pg.paged_dequant_gather, "launches"),
            "ssd": (ssd.ssd, "launches")}


def tuned_beside_auto(eng):
    """Each bucket's plan as the engine's router resolved it (TUNED by
    default) beside the AUTO seed for the same bucket, and each prompt
    bucket's flash tiles likewise."""
    from repro_torch.serve.buckets import BucketRouter

    r = eng.router
    auto = BucketRouter(eng.cfg, r.spec, slots=r.slots, hw=r.hw,
                        policy="auto", page_block=r.page_block,
                        kv_dtype=r.kv_spec.name, device=r.device)
    fields = ("decode_block", "decode_split", "paged_decode_block",
              "paged_decode_split", "prefill_blocks")
    out = {"buckets": {}, "prefill_tiles": {}}
    for plan in r.plans:
        seed = auto.resolve(plan.bucket)
        out["buckets"][plan.bucket.kv_len] = {
            "tuned": {f: getattr(plan, f) for f in fields},
            "auto": {f: getattr(seed, f) for f in fields}}
    for pb, tiles in r.prefill_plans.items():
        out["prefill_tiles"][pb] = {"tuned": list(tiles),
                                    "auto": list(auto.prefill_tiles(pb))}
    return out


def engine_run(label, eng, reqs, opts, expected):
    """Serve ``reqs`` with the counts reset just before and read just
    after; the path's own kernels must be above 0, every other 0."""
    counters = launch_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    report, _ = serve(eng, reqs)
    wall = time.perf_counter() - t0
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    s = report.summary
    run = dict(
        arch=eng.cfg.name, options=opts, completed=s.n_completed,
        output_tokens=s.output_tokens, tokens_per_s=s.tokens_per_s,
        wall_s=wall, ttft_p50_ms=s.ttft_p50_s * 1e3,
        decode_tick_p50_ms=s.decode_tick_p50_s * 1e3,
        decode_ticks=s.decode_steps, prefill_s=s.prefill_s,
        decode_s=s.decode_s,
        paged_decode_block=report.paged_decode_blocks,
        decode_block=report.decode_blocks,
        paged_decode_split=report.paged_decode_splits,
        decode_split=report.decode_splits,
        prefill_tiles={k: list(v) for k, v in report.prefill_tiles.items()},
        launches=launches, policy=eng.router.policy.value,
        router_stats=report.router_stats, plans=tuned_beside_auto(eng))
    emit("engine", run=label, **run)
    if s.n_completed != len(reqs):
        raise AssertionError(f"{label}: {s.n_completed}/{len(reqs)} "
                             f"completed")
    for k, n in launches.items():
        if k in expected and n <= 0:
            raise AssertionError(f"{label}: {k} was never launched on its "
                                 f"path")
        if k not in expected and n != 0:
            raise AssertionError(f"{label}: {k} launched {n} times on a "
                                 f"path that must not use it")
    return run


def engine_phase(device):
    """Returns the runs, the params of each arch (for the profile) and
    the requests."""
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeEngine

    vocab = get_config("smollm-135m").vocab_size
    reqs = requests(12, 16, 600, 32, vocab, SEED)
    runs = {}
    params = {"smollm-135m": None, "mamba2-1.3b": None}
    for label, (opts, chunk, expected) in ENGINE_RUNS.items():
        eng = ServeEngine("smollm-135m", reduced=False, slots=8,
                          max_len=1024, prefill_chunk=chunk,
                          params=params["smollm-135m"], seed=SEED,
                          device=device, **opts)
        params["smollm-135m"] = eng.params
        runs[label] = engine_run(label, eng, reqs, opts, expected)
    # the same token lists (drawn below smollm's vocabulary, so inside
    # mamba2's 50,280)
    for label, chunk in MAMBA_RUNS.items():
        eng = ServeEngine("mamba2-1.3b", reduced=False, slots=8,
                          max_len=1024, prefill_chunk=chunk,
                          params=params["mamba2-1.3b"], seed=SEED,
                          device=device)
        params["mamba2-1.3b"] = eng.params
        runs[label] = engine_run(label, eng, reqs[:MAMBA_REQUESTS],
                                 {"prefill_chunk": chunk}, set())
    return runs, params, reqs


# --------------------------------------------------------------------------- #
# retune
# --------------------------------------------------------------------------- #

#: the retune phase's controller: the incumbent's median from 2 ticks, a
#: trial of 2 measured ticks after 1 warm-up tick (the candidate's first
#: launch), 4 ticks of cooldown after the verdict; no drift scan
#: (``propose`` drives the trial, as tests/test_retune.py does)
RETUNE_CONFIG = dict(mode="inline", min_samples=2, trial_ticks=2,
                     warmup_ticks=1, cooldown_ticks=4, interval_ticks=10_000)
#: the mix's requests the phase serves, and the decode tick after which
#: the candidate is proposed
RETUNE_REQUESTS = 4
RETUNE_PROPOSE_AT = 4


def gated_candidate(bs, w):
    """The trial's candidate beside the incumbent (block_s, W): (W, W)
    keeps the split, and on the card the sweep's arithmetic depends on W
    alone (``block_s`` is checked, not used: csrc/decode_sweep.cuh), so
    the retuned run's bf16 streams must equal the untraced run's bit for
    bit; (block_s, 2 block_s) where the split is one block already."""
    return (w, w) if w != bs else (bs, 2 * bs)


def w64_candidate(bs, w):
    """W 64, the split ``measure="live"`` picks at the 1024 bucket on the
    H100 (PERF.md §6): it reorders the sweep's f32 sums, so its streams
    are reported, not gated."""
    return (bs, 64) if w != 64 else (bs, 128)


def retune_run(label, eng, reqs, candidate=None):
    """Serve ``reqs`` with the launch counts reset just before and read
    just after, each decode step's plan and row 1's launches recorded;
    with ``candidate`` (a function of the incumbent pair) the retune
    controller is handed it after decode tick ``RETUNE_PROPOSE_AT``."""
    from repro_torch.kernels import paged_decode_attention as pda

    counters = launch_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    steps, proposed = [], {}
    step = eng.model.decode_step

    def spy(*a, **kw):
        n0 = pda.paged_decode_attention.launches
        out = step(*a, **kw)
        steps.append(((kw.get("paged_decode_block"),
                       kw.get("paged_decode_split")),
                      pda.paged_decode_attention.launches - n0))
        return out

    eng.model.decode_step = spy
    if candidate is not None:
        tick = eng._decode_tick

        def hooked():
            tick()
            if len(steps) == RETUNE_PROPOSE_AT:
                kv = eng.pool.kv_len
                plan = eng.router.resolve(eng.router.bucket(kv))
                inc = (plan.paged_decode_block, plan.paged_decode_split)
                proposed.update(kv=kv, incumbent=inc, value=candidate(*inc))
                eng.retune.propose(kv, "paged_decode", proposed["value"])

        eng._decode_tick = hooked
    t0 = time.perf_counter()
    report, streams = serve(eng, reqs)
    wall = time.perf_counter() - t0
    s = report.summary
    return dict(
        label=label, wall_s=wall, decode_ticks=s.decode_steps,
        decode_tick_p50_ms=s.decode_tick_p50_s * 1e3,
        decode_tick_mean_ms=s.decode_s / max(1, s.decode_steps) * 1e3,
        tokens_per_s=s.tokens_per_s,
        launches={k: getattr(fn, attr) for k, (fn, attr) in counters.items()},
        paged_decode_block=report.paged_decode_blocks,
        paged_decode_split=report.paged_decode_splits,
        prefill_tiles={k: list(v) for k, v in report.prefill_tiles.items()},
        router_stats=report.router_stats, retune=report.retune,
        proposed=proposed), streams, steps


def trace_round_trip(tracer, tmp):
    """The trace through ``write_trace``/``load_trace`` in both forms:
    the JSONL log gives back every span, counter, gauge and the meta;
    Perfetto's form every span name (counters come back as samples)."""
    from repro_torch.obs import load_trace, write_trace

    def spans(tr):
        return [(r.name, r.sid, r.parent, r.t0, r.dur) for r in tr.spans()]

    out = {}
    for suffix in (".jsonl", ".json"):
        back = load_trace(write_trace(tracer, f"{tmp}/retune{suffix}"))
        if suffix == ".jsonl":
            ok = (spans(back) == spans(tracer)
                  and back.counters() == tracer.counters()
                  and back.gauges() == tracer.gauges()
                  and back.meta == tracer.meta)
        else:
            ok = (sorted(r.name for r in back.spans())
                  == sorted(r.name for r in tracer.spans())
                  and back.meta == tracer.meta)
        if not ok:
            raise AssertionError(f"retune: the trace did not survive "
                                 f"write_trace/load_trace as {suffix}")
        out[suffix] = len(back.spans())
    return out


def retune_phase(device, params, reqs, tmp):
    """smollm-135m at full width on the default chunked path under TUNED,
    the engine phase's params, the mix's first ``RETUNE_REQUESTS``
    requests: untraced, traced, and traced with the retune controller
    (``RETUNE_CONFIG``) handed ``gated_candidate`` after tick
    ``RETUNE_PROPOSE_AT``; then with ``w64_candidate``, reported only.
    The first three engines share a private tuning cache, the last has
    one of its own, so an adoption reaches no other run or phase."""
    from repro_torch.configs import get_config
    from repro_torch.obs import Tracer, drift_report
    from repro_torch.serve import BucketRouter, ServeEngine
    from repro_torch.serve.retune import RetuneConfig
    from repro_torch.tuner import TuningCache

    reqs = reqs[:RETUNE_REQUESTS]
    cache = TuningCache(path=None)
    layers = get_config("smollm-135m").num_layers

    def engine(tuning_cache=cache, **kw):
        return ServeEngine("smollm-135m", reduced=False, slots=8,
                           max_len=1024, prefill_chunk="auto",
                           params=params["smollm-135m"], seed=SEED,
                           device=device, tuning_cache=tuning_cache, **kw)

    plain, want, _ = retune_run("untraced", engine(), reqs)
    traced_eng = engine(tracer=Tracer())
    traced, got, _ = retune_run("traced", traced_eng, reqs)
    same_plans = all(traced[k] == plain[k] for k in (
        "launches", "paged_decode_block", "paged_decode_split",
        "prefill_tiles"))
    traced["streams_equal_untraced"] = got == want
    eng = engine(tracer=Tracer(), retune=RetuneConfig(**RETUNE_CONFIG))
    run, got, steps = retune_run("retune", eng, reqs, gated_candidate)
    run["streams_equal_untraced"] = got == want
    cand = run["proposed"]["value"]
    decisions = eng.retune.decisions
    spans = eng.obs.spans()
    ran = sorted({(s.attrs["paged_decode_block"],
                   s.attrs["paged_decode_split"])
                  for s in spans if s.name == "decode_tick"})
    cand_launches = [n for plan, n in steps if plan == cand]
    drift = drift_report(spans, eng.obs.meta, eng.router.hw)
    read_back = None
    if decisions and decisions[0].adopted:
        # the adoption is in the private cache: a fresh router reads it
        fresh = BucketRouter(eng.cfg, eng.spec, slots=8, hw=eng.hw,
                             cache=cache, device=device)
        p = fresh.resolve(fresh.bucket(run["proposed"]["kv"]))
        read_back = [p.paged_decode_block, p.paged_decode_split]
    w64_eng = engine(TuningCache(path=None), tracer=Tracer(),
                     retune=RetuneConfig(**RETUNE_CONFIG))
    w64, w64_streams, _ = retune_run("retune_w64", w64_eng, reqs,
                                     w64_candidate)
    w64["streams_equal_untraced"] = w64_streams == want
    emit("retune", runs=[plain, traced, run, w64], candidate=list(cand),
         incumbent=list(run["proposed"]["incumbent"]),
         bucket=run["proposed"]["kv"],
         decisions=[dataclasses.asdict(d) for d in decisions],
         w64_decisions=[dataclasses.asdict(d)
                        for d in w64_eng.retune.decisions],
         decode_tick_pairs=[list(p) for p in ran],
         candidate_ticks=len(cand_launches),
         candidate_launches_per_tick=sorted(set(cand_launches)),
         adopted_read_back=read_back,
         traced_launches_as_untraced=same_plans,
         trace_round_trip=trace_round_trip(eng.obs, tmp),
         counters=eng.obs.counters(),
         drift_median_ratio=drift.median_ratio,
         drift=[dataclasses.asdict(r) for r in drift.rows],
         drift_candidates=len(drift.candidates(
             RetuneConfig().drift_threshold)))
    if len(decisions) != 1 or eng.retune.stats.trials != 1:
        raise AssertionError(f"retune: {eng.retune.stats.trials} trials and "
                             f"{len(decisions)} decisions, not one")
    if tuple(cand) not in ran:
        raise AssertionError(f"retune: no decode_tick span ran {cand}")
    if not cand_launches or min(cand_launches) != layers:
        raise AssertionError(f"retune: row 1 launched {cand_launches} times "
                             f"a tick at {cand}, not {layers}")
    if not run["streams_equal_untraced"]:
        raise AssertionError("retune: the retuned streams differ from the "
                             "untraced run's")
    if not (same_plans and traced["streams_equal_untraced"]):
        raise AssertionError("retune: the traced run launched other kernels "
                             "or plans, or served other streams, than the "
                             "untraced run")
    if read_back is not None and read_back != list(cand):
        raise AssertionError(f"retune: a fresh router read {read_back}, not "
                             f"the adopted {cand}")


#: profiled runs: label -> (arch, engine options, requests of the mix).
#: mamba2 is cut to the mix's first request: on its 4 (1,389 prompt
#: tokens, ~4.1M device kernels, each prompt token a 48-layer decode
#: step) the phase took 329 s and the smoke 694 s
PROFILE_RUNS = {"chunked": ("smollm-135m", {}, 4),
                "int8": ("smollm-135m", dict(kv_dtype="int8"), 4),
                "mamba2": ("mamba2-1.3b", {}, 1)}


def device_kernels(prof):
    """(name, device ms, count) per kernel name, largest first, summed
    from the profiler's raw device events (``key_averages`` takes ~150
    us an event to build, minutes for the mamba2 trace; on device
    activities self time is the duration)."""
    from torch.autograd import DeviceType

    agg = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        ms, n = agg.get(e.name(), (0.0, 0))
        agg[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return sorted(((k, ms, n) for k, (ms, n) in agg.items() if ms > 0),
                  key=lambda r: -r[1])


def profile_phase(device, params, reqs):
    """Where the device time of the chunked path goes (smollm with the fp
    and the int8 pool, and mamba2): the first requests of the mix served
    once unprofiled (wall time) and once under torch.profiler tracing
    the device only, device time summed per kernel name."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServeEngine

    mix = reqs
    for label, (arch, opts, n_reqs) in PROFILE_RUNS.items():
        reqs = mix[:n_reqs]

        def engine():
            return ServeEngine(arch, reduced=False, slots=8, max_len=1024,
                               params=params[arch], seed=SEED,
                               device=device, **opts)

        eng = engine()
        t0 = time.perf_counter()
        report, _ = serve(eng, reqs)
        wall = time.perf_counter() - t0
        eng = engine()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            serve(eng, reqs)
        rows = device_kernels(prof)
        busy_ms = sum(r[1] for r in rows)
        emit("profile", run=label, arch=arch, options=opts,
             requests=len(reqs), wall_s=wall, device_busy_ms=busy_ms,
             idle_share=1.0 - busy_ms / 1e3 / wall,
             decode_ticks=report.summary.decode_steps,
             decode_tick_p50_ms=report.summary.decode_tick_p50_s * 1e3,
             kernel_launches=sum(n for _, _, n in rows),
             top=[{"kernel": k[:80], "ms": ms, "count": n,
                   "share": ms / busy_ms if busy_ms else 0.0}
                  for k, ms, n in rows[:12]])


def parity_phase(device):
    """Full width in float32, for the default path and each of the other
    decode paths: kernels vs plain on the same requests."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config("smollm-135m"), dtype="float32")
    reqs = requests(6, 16, 200, 16, cfg.vocab_size, SEED + 1)
    params = None
    for label, (opts, _, _) in ENGINE_RUNS.items():
        if label == "whole_prompt":
            continue
        streams, first = {}, {}
        for mode in ("kernel", "plain"):
            eng = ServeEngine(cfg, slots=8, max_len=1024, params=params,
                              seed=SEED, device=device, **opts)
            params = eng.params
            step = eng.model.decode_step

            def spy(*a, _step=step, _mode=mode, **kw):
                out = _step(*a, **kw)
                first.setdefault(_mode, out[0].detach().clone())
                return out

            eng.model.decode_step = spy
            t0 = time.perf_counter()
            with kernels.force(mode):
                _, streams[mode] = serve(eng, reqs)
            if mode == "plain":
                plain_s = time.perf_counter() - t0
        same = streams["kernel"] == streams["plain"]
        err = float((first["kernel"] - first["plain"]).abs().max())
        emit("parity", run=label, options=opts,
             token_streams_identical=same,
             first_decode_logits_max_abs_err=err, plain_wall_s=plain_s,
             tokens=sum(len(s) for s in streams["kernel"]))
        if not same:
            raise AssertionError(f"{label}: fp32 token streams differ "
                                 f"between the kernels and their plain "
                                 f"versions")
        if err > 1e-3:
            raise AssertionError(f"{label}: first decode-step logits "
                                 f"differ by {err}")


# --------------------------------------------------------------------------- #

#: serving kernel -> (its source in csrc/, the TPU kernel it replaces, the
#: engine run whose launches it reports)
SERVING_KERNELS = {
    "paged_decode_attention": (
        "paged_decode_attention",
        "src/repro/kernels/paged_decode_attention.py:221", "chunked"),
    "flash_attention": ("flash_attention",
                        "src/repro/kernels/flash_attention.py:31", "chunked"),
    "paged_decode_attention_int8": (
        "paged_decode_attention",
        "src/repro/kernels/paged_decode_attention.py:230", "int8"),
    "decode_attention": ("decode_attention",
                         "src/repro/kernels/decode_attention.py:41",
                         "contiguous"),
    "paged_gather": ("paged_gather", "src/repro/kernels/paged_gather.py:81",
                     "gather"),
    "paged_dequant_gather": ("paged_gather",
                             "src/repro/kernels/paged_gather.py:168",
                             "int8_gather"),
}


#: serving kernel -> its (pool dtype, tuner kernel) in the tuner phase
SERVING_TUNER = {"paged_decode_attention": ("fp32", "paged_decode"),
                 "flash_attention": ("fp32", "flash_attention"),
                 "paged_decode_attention_int8": ("int8", "paged_decode"),
                 "decode_attention": ("fp32", "decode_attention")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.hw import detect
    from repro_torch.kernels import _build

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = nvidia_smi()
    hw = detect(device)
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], nvcc=nvcc.strip().splitlines()[-1],
         nvidia_smi=smi, gpu_params=dataclasses.asdict(hw), hp=hw.hp(),
         build_dir=str(_build.build_dir()))

    t0 = time.perf_counter()
    secs = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0, per_source=secs,
         ptxas={n: [ln for ln in _build.ptxas_report(n).splitlines()
                    if "entry function" in ln or "registers" in ln
                    or "spill" in ln or "arning" in ln]
                for n in _build.SOURCES})

    cfg = get_config("smollm-135m")
    # float32 products in full float32 (the plain versions' einsums)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = Timer(device)
    # the run's own tuning cache and trace store: no run replays another
    # run's decisions (the checkout's default files stay untouched)
    from repro_torch.profiler import TraceStore, set_default_store
    from repro_torch.tuner import TuningCache, set_default_cache

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    set_default_cache(TuningCache(f"{tmp}/tuning_cache.json"))
    set_default_store(TraceStore(f"{tmp}/traces.jsonl"))
    phase_s = {}

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    try:
        kres = timed("kernels", kernels_phase, cfg, hw, timer, device)
        emit("kernels", card=smi, results=kres)
        sres, suite_launches, tuned_launches = timed(
            "suite", suite_phase, hw, timer, device)
        serving, _, _ = timed("tuner", tuner_phase, hw, timer, device)
        runs, params, reqs = timed("engine", engine_phase, device)
        timed("retune", retune_phase, device, params, reqs, tmp)
        timed("profile", profile_phase, device, params, reqs)
        timed("parity", parity_phase, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("timing", seconds=phase_s)

    summary = []
    for name, cases in kres.items():
        main_case = cases[0]
        src, replaces, run = SERVING_KERNELS[name]
        summary.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}.cu",
            "replaces": replaces,
            "launches": runs[run]["launches"][name],
            "max_abs_err": main_case["max_abs_err"]["bfloat16"],
            "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "shape": main_case["shape"]})
        tuned = serving.get(SERVING_TUNER.get(name))
        if tuned is not None:
            # the tuner phase: AUTO's seed and TUNED's pick at the largest
            # serving bucket, every row at full length
            summary[-1].update(seed_plan=tuned["seed"],
                               tuned_plan=tuned["tuned"],
                               seed_ms=tuned["seed_ms"],
                               tuned_ms=tuned["tuned_ms"])
        if name in ("paged_gather", "paged_dequant_gather"):
            # the large case and one page (the launch's floor)
            large, page = cases[1], cases[2]
            summary[-1].update(
                plan=main_case["plan"], large_shape=large["shape"],
                large_ms=large["kernel_ms"], large_plain_ms=large["plain_ms"],
                large_bound_ms=large["bound_ms"],
                large_library_ms=large["library_ms"], large_plan=large["plan"],
                one_page_ms=page["kernel_ms"])
    # the suite's row per kernel: AUTO (the default policy) at its
    # largest case
    for name, op, shape, dt in (
            ("vecadd", "vecadd", (1 << 26,), "float32"),
            ("saxpy", "saxpy", (1 << 26,), "float32"),
            ("matmul_tc", "matmul", (8, 1532, 576), "bfloat16"),
            ("matmul_tc", "matmul", (4096, 4096, 4096), "bfloat16"),
            ("matmul_tf32x3", "matmul", (4096, 4096, 4096), "float32"),
            ("rmsnorm", "rmsnorm", (16384, 4096), "bfloat16"),
            ("stencil_rows", "gaussian_blur", (4096, 4096, 5), "float32"),
            ("stencil_cols", "gaussian_blur", (4096, 4096, 5), "float32"),
            ("nn_search", "nn_search", (4096, 65536, 128), "float32"),
            ("gcn_agg", "gcn_aggregate", PUBMED, "float32"),
            ("ssd", "ssd", MAMBA2_LAYER, "float32")):
        e = sres[op, shape, dt, "auto"]
        row = {"max_abs_err": e["max_abs_err"], "ms": e["kernel_ms"],
               "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
               "bound_by": e["bound_by"], "library_ms": e["library_ms"],
               "shape": f"{dt} {list(shape)}, policy auto"}
        if name.startswith("stencil_"):
            p = name.split("_")[1]           # one pass: half the op's bytes
            row.update(max_abs_err=e["pass_max_abs_err"][p],
                       ms=e["pass_ms"][p], plain_ms=e["pass_plain_ms"][p],
                       library_ms=e["pass_library_ms"][p],
                       bound_ms=e["bound_ms"] / 2)
            row["shape"] += f", {p} pass"
            # the plan's tile and residency ("route" is the contract's);
            # the same pass at AUTO in bf16 and at ksize 7
            row.update(blur_route=e["route"], grid=e["plan"]["grid"],
                       rows=e["plan"]["rows"], tile_w=e["plan"]["tile_w"],
                       resident_ctas_per_sm=e["resident_ctas_per_sm"][p])
            for key, other, odt in (("bf16", (4096, 4096, 5), "bfloat16"),
                                    ("k7", (4096, 4096, 7), "float32")):
                o = sres[op, other, odt, "auto"]
                row[f"{key}_ms"] = o["pass_ms"][p]
                row[f"{key}_bound_ms"] = o["bound_ms"] / 2
        elif name == "gcn_agg":
            row["shape"] += ", the op: one launch"
        elif name == "ssd":                # ms: the op's three launches
            row["shape"] += f", chunk {e['plan']['legal_chunk']}"
            row.update(step_ms=e["step_ms"], grids=e["launched_grids"],
                       workspace_bytes=e["plan"]["workspace_bytes"],
                       bound_cuda_core_ms=e["bound_cuda_core_ms"])
        elif name.startswith("matmul"):
            row["shape"] += f", {e['route']} route"
            row["loader_bytes"] = e["loader_bytes"]
            if name == "matmul_tf32x3":        # ms: the split + the product
                row.update(split_ms=e["split_ms"], product_ms=e["product_ms"],
                           split_launches=suite_launches["matmul_split"],
                           f64_max_abs_err=e["f64_max_abs_err"],
                           library_f64_max_abs_err=e[
                               "library_f64_max_abs_err"])
        elif name == "rmsnorm":
            row["shape"] += f", {e['row_path']} path"
        elif name == "nn_search":          # ms: the prep pass + the product
            row.update(prep_ms=e["prep_ms"], product_ms=e["product_ms"],
                       prep_launches=suite_launches["nn_search_prep"],
                       bound_cuda_core_ms=e["bound_cuda_core_ms"],
                       grid=e["plan"]["grid"])
        t = sres.get((op, shape, dt, "tuned"))
        if t is not None:            # TUNED beside AUTO at the same case
            row.update(tuned_ms=t["kernel_ms"], tuned_plan=t["plan"],
                       tuned_launches=tuned_launches[name])
            if name.startswith("stencil_"):
                row["tuned_ms"] = t["pass_ms"][name.split("_")[1]]
        src = "stencil" if name.startswith("stencil_") else name
        summary.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{src}.cu",
                        "replaces": SUITE_REPLACES[name],
                        "launches": suite_launches[name], **row})
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
