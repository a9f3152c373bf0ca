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
           a 32-row chunk at q_offset 203 over a 256 cache (a radix
           resume: the first query tile straddles the diagonal off the
           16-row grid), and a 512 prompt at qwen3-8b's heads, head_dim
           128, bf16), in float32 (atol
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
           64-bit index path); then the variants the dense phase's
           models take (``add_variants``): flash in f32 at head_dim 128
           (qwen3-8b's G 8, R 4: a 512 prompt and a 64-row chunk at
           q_offset 385) and 32, and in bf16 at head_dim 192
           (nemotron-4-340b's G 8, R 12: the prompt and the chunk) and
           128 (deepseek-moe-16b's G 16, R 1, also in f32, and
           qwen3-moe-235b-a22b's G 4, R 16); the three decode kernels at
           R 12 / D 192, R 16 / D 256 (runs of 4 heads a CTA), R 1 / D 128
           (G 16) and R 16 / D 128 (G 4); both gathers at D 192 and at
           the moe models' KV heads; ``DECODE_SHAPES`` also holds those
           four geometries and zamba2-7b's (G 32, R 1, D 112);
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
           (chunked); then mamba2-1.3b at its published width cut to
           ``MAMBA_LAYERS`` layers (``engine_config``) on the mix's
           first 4 requests, chunked and whole-prompt
           (``MAMBA_RUNS``), every engine on its default policy, TUNED;
           each run prints the decode plans that ran (``block_s`` and
           split per pool length) and each bucket's TUNED plan beside
           AUTO's (``tuned_beside_auto``); the kernels' launch
           counts are reset just
           before each run and read just after: the path's own kernels
           must be above 0, every other kernel 0 (the ssm path runs none:
           its prefill is the plain ``ssd_chunked``, as the reference's
           is jnp);
  dense    qwen3-8b at full width (36 layers, qk-norm, untied; weights
           drawn on the card): in float32 with the radix on, 2 slots, a
           4-request sharing mix, the kernels against
           ``kernels.force("plain")``: identical streams, first
           decode-step logits within 1e-3, the preamble's 384 tokens hit,
           flash (f32, head_dim 128) and the paged decode launched and no
           other kernel, nothing launched by the plain run; in bf16,
           chunked and whole-prompt on the mix's first ``DENSE_REQUESTS``
           requests with the engine phase's gates, and the chunked run
           under torch.profiler (``dense_profile``: busy time, idle
           share); then nemotron-4-340b at its published width cut to
           ``NEMOTRON_LAYERS`` layers (R 12, head_dim 192), bf16, on each
           path of ``NEMOTRON_RUNS`` (default, int8, gather): the path's
           kernels launched and no other, the streams equal to a
           ``force("plain")`` run's (``dense_plain``);
  moe      deepseek-moe-16b at full width (64 routed experts top-6, 2
           shared, G 16 / R 1 / D 128, untied; weights drawn on the
           card): in float32 cut to ``MOE_FP32_LAYERS`` layers, 8 slots,
           the mix's first ``MOE_REQUESTS`` requests, the kernels against
           ``kernels.force("plain")`` (``kernel_plain``, as the dense
           phase's qwen3-8b): identical streams, first decode-step logits
           within 1e-3, flash (f32, D 128) and the paged decode launched
           and no other kernel, nothing by plain, and the (token, layer)
           top-k sets that differ between the two runs with plain's
           smallest gap between the k-th and (k+1)-th probability
           (``RouteSpy``, ``route_diff``); in bf16 at full depth (28
           layers) chunked and whole-prompt with ``engine_run``'s gates
           and the chunked run under torch.profiler (``bf16_runs``,
           ``moe_profile``), then the chunked run's streams
           teacher-forced, untimed (``teacher_run``: fed through
           ``TeacherForce`` to a kernel run and a plain run; each step's
           logits within the model's ``TEACHER_TOL`` and the greedy
           picks equal wherever plain's top-2 margin exceeds it; plain
           launches nothing; a third run with a planted fault, the last
           layer's decode reading the wrong KV group (``WrongGroup``),
           must leave the bound); then qwen3-moe-235b-a22b at full width
           (128 experts top-8, G 4 / R 16 / D 128, qk-norm) cut to
           ``QWEN3_MOE_LAYERS`` layers on each path of
           ``QWEN3_MOE_RUNS`` (default, int8, gather, int8 gather), each
           teacher-forced (the default path with the planted fault); the
           teacher-forced kernel runs print the routing counts (calls,
           routed tokens, dropped slots; the timed runs carry no spy)
           and every run the decode tick's bound (``tick_bound``: every
           weight but the token embedding read once, the dense expert
           buffers multiply every expert);
  hybrid   zamba2-7b (81 Mamba-2 layers padded to 14 groups of 6, each
           led by one shared attention block, 32 heads over 32 KV heads
           at head_dim 112, a GELU MLP, tied; weights drawn on the card):
           first its kernel rows (``hybrid_kernel_rows``, a
           ``hybrid_kernels`` line): flash in f32 and bf16 at G 32, R 1,
           D 112 (a 512 prompt, causal), rows 1, 3 and 4 at G 32 / R 1 /
           D 112 over ``decode_case``'s ragged lengths, rows 5 and 6 at
           (8, 1024, 32, 112), each against its plain version and timed
           beside SDPA where one call computes it and its bound; then in
           float32 cut to ``HYBRID_CUT_LAYERS`` (9: two groups, the
           second with 3 active and 3 padded layers, the shape of the
           published 81) on each path of ``HYBRID_FP32_RUNS`` (chunked,
           whole-prompt, int8, gather, int8 with the gather), the
           kernels against ``kernels.force("plain")`` (``kernel_plain``:
           identical streams, first decode-step logits within 1e-3, the
           path's kernels launched and no other: the chunked paths'
           prompt steps run the contiguous decode, row 4, and no flash),
           then in bf16 on each run of ``HYBRID_BF16_RUNS`` (chunked at 9
           layers, whole-prompt at all 81) with ``engine_run``'s gates
           and the tick's bound (``hybrid_tick_bound``), each
           teacher-forced against plain with the planted fault at the
           last group's shared block (``teacher_run``, ``TEACHER_TOL``;
           ``hybrid_teacher`` lines), on ``HYBRID_REQUESTS`` seeded
           prompts of 16-160 tokens with ``HYBRID_NEW`` new tokens each;
  encdec   whisper-medium (24 encoder and 24 decoder layers, 16 heads
           over 16 KV heads at head_dim 64, a GELU MLP, tied, vocab
           51865, 1,500 stub frames; weights drawn on the card): first
           its kernel rows (``encdec_kernel_rows``, an ``encdec_kernels``
           line): flash at G 16, R 1, D 64 causal at a 512 prompt,
           non-causal 1,500 x 1,500 (the encoder) and 64 x 1,500 (the
           prefill's cross-attention), row 4 over a full
           1,500-position cross cache at 8 rows (``cross_case``), rows 1,
           3 and 4 over ``decode_case``'s ragged lengths, rows 5 and 6 at
           (8, 1024, 16, 64), each against its plain version in f32 and
           bf16 and timed beside SDPA where one call computes it and its
           bound; then in float32 cut to ``ENCDEC_FP32_LAYERS`` encoder
           and decoder layers on each path of ``ENCDEC_FP32_RUNS`` (the
           default options, whole-prompt since encdec cannot chunk;
           contiguous, gather, int8, int8 with the gather), the kernels
           against ``kernels.force("plain")`` (``kernel_plain``: identical
           streams, first decode-step logits within 1e-3, nothing by
           plain) with every kernel at its exact count
           (``encdec_launches``: flash 3 call sites a request, a launch
           a layer each; one row-4 cross read a layer a tick on every
           path, beside the path's self-attention reads), and two rows of
           one prompt with distinct seeded frames (``encdec_frames``:
           kernels against plain and each row against its own batch-1
           run within 1e-3, the rows apart); then in bf16 at full depth
           on the default options with ``engine_run``'s gates, the exact
           counts and the tick's bound (``encdec_tick_bound``), the tied
           unembedding at vocab 51865 (``unembed_check``), teacher-forced
           against plain with the planted fault at the last layer's
           cross read (``WrongGroup`` on ``decode_attention``;
           ``TEACHER_TOL``), on ``ENCDEC_REQUESTS`` seeded prompts of
           16-160 tokens with ``ENCDEC_NEW`` new tokens each;
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
  prefix   radix prefix sharing: smollm-135m at full width, TUNED, chunk
           "auto", ``max_len`` 1024, 2 slots, on ``prefix_mix`` (8
           requests behind one 200-token system prompt, 16 new tokens
           each, then two chat turns on retired requests' prompts and a
           regenerate of one: ``PREFIX_ORDER``), cold and shared
           (``prefix_cache``) on the default, ``int8``, ``gather`` and
           ``int8_gather`` paths (``PREFIX_RUNS``), each with its path's
           launch gates; every shared run must hit at least 6 times for
           6 x 192 tokens, take fewer prefill chunks than cold, run a
           decode tick whose block tables hold one physical id in two
           live rows, and launch flash at a ``q_offset`` off the 16 grid
           (``PrefixSpies``); then the shared default path at
           ``tight_blocks`` from a 512 lattice floor (evictions, hits,
           every request done) and ``admission="gang"`` with the radix
           off on the mix's first ``PREFIX_GANG_REQUESTS`` (every request
           done, its streams printed); prints TTFT
           p50 and p95 cold and shared, the prefill chunks and the hit
           rate (``prefix_summary``);
  profile  smollm's chunked path, fp and int8 pools, on the mix's first 4
           requests, and mamba2's chunked path (``MAMBA_LAYERS``
           layers) on its first request
           (``PROFILE_RUNS``), unprofiled (wall time) and under
           torch.profiler (device time by kernel from the raw device
           events, busy time, idle share; no check: a reading);
  parity   the same engine in float32 on each path (chunked), once on
           the kernels and once under ``kernels.force("plain")``
           (``kernel_plain``): identical token streams, first decode-step
           logits within atol 1e-3, the path's kernels launched and no
           other, nothing by plain;
           then ``prefix`` (the radix at the prefix phase's tight budget)
           and ``prefix_int8`` (the radix on the int8 pool) at 2 slots on
           a 4-request sharing mix, the same gates, and the kernel run's
           streams equal to the radix-off run's (a gate for ``prefix``);
  timing   seconds per phase.

The run keeps its own tuning cache and trace store in a temporary
directory.  Then the card's name and power limit as nvidia-smi prints
them, the kernel summary as one JSON line (each row the tuner registers
with ``tuned_ms`` beside AUTO's ``ms``; a suite row's ``launches``
counts NAIVE, FIXED and AUTO over every case, and ``tuned_launches``
TUNED's at its cases; a serving row's ``prefix_launches`` counts the
prefix phase's runs; ``variants`` the added variants, each with the
launches of the dense, moe, hybrid or encdec run that takes it), and as the
last line
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
exits non-zero and prints no result.  It needs one CUDA device and exits
non-zero without one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
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


def decode_case(cfg, plan_block, device, dtype, split=None, lens=RAGGED,
                heads=None):
    """The decode tick's shapes at full width: 8 slots, a 1024-long pool,
    cache lengths ``lens`` over permuted pages, -1 tails; ``split`` the
    sweep's planned width; ``heads`` (G, R, D) overrides the config's."""
    rng = np.random.default_rng(SEED)
    b, t, pb = 8, 1024, 16
    g, r, d = heads or (cfg.num_kv_heads, cfg.heads_per_group, cfg.head_dim)
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


def contiguous_case(cfg, block_s, device, dtype, split=None, lens=RAGGED,
                    heads=None):
    """The decode tick's shapes on the contiguous pool (and on a gathered
    view): decode_case's rows, lengths and caches, no tables."""
    c = decode_case(cfg, block_s, device, dtype, split, lens, heads)
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
#: 4-stage ring); pages of 8 and 32 and a split planned by AUTO (None);
#: the wide groups: R 12 at D 192 (nemotron-4-340b; three runs of 4 heads
#: a group, lanes 24-31 idle) and R 16 at D 256 (four runs of 4); the
#: moe models' G 16, R 1 and G 4, R 16 (two runs of 8) at D 128; zamba2-7b's
#: G 32, R 1 at D 112 (28 lane groups of 4 values, lanes 28-31 idle)
DECODE_SHAPES = (
    (3, 80, 2, 2, 16, 16, 16, 16, (0, 17, 85)),
    (2, 96, 1, 8, 128, 32, 32, 64, (96, 33)),
    (4, 48, 3, 1, 6, 8, 16, 16, (1, 48, 20, 0)),
    (2, 128, 2, 5, 100, 16, 32, None, (128, 77)),
    (2, 64, 1, 3, 96, 16, 16, 16, (3, 35)),
    (1, 2048, 1, 3, 64, 16, 16, 16, (2000,)),
    (2, 512, 3, 3, 64, 16, 16, 512, (512, 300)),
    (2, 128, 2, 12, 192, 16, 32, None, (128, 77)),
    (2, 96, 1, 16, 256, 32, 32, 64, (96, 33)),
    (2, 80, 16, 1, 128, 16, 16, None, (80, 41)),
    (2, 96, 4, 16, 128, 32, 32, 64, (96, 33)),
    (2, 80, 32, 1, 112, 16, 16, None, (80, 41)),
)

#: the head geometries (G, R, D) of the kernels phase's variants:
#: qwen3-8b's, nemotron-4-340b's, the decode sweep's widest, the
#: reduced configs' and the two moe models'
QWEN3_HEADS = (8, 4, 128)
NEMOTRON_HEADS = (8, 12, 192)
WIDEST_HEADS = (8, 16, 256)
REDUCED_HEADS = (2, 2, 32)
#: the moe phase's models: deepseek-moe-16b (full multi-head attention)
#: and qwen3-moe-235b-a22b
DEEPSEEK_HEADS = (16, 1, 128)
QWEN3_MOE_HEADS = (4, 16, 128)


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


def measure_kernel(hw, timer, name, fn, case, bound_fn, library,
                   exact=False, head_start=False,
                   dtypes=(torch.float32, torch.bfloat16)):
    """Kernel vs plain in each of ``dtypes`` (``exact``: bit for bit),
    then times in bf16, or in the one dtype a variant takes
    (``head_start`` for microsecond kernels, see ``Timer.ms``);
    ``case(dtype)`` builds the inputs, its ``*_bytes`` keys are
    bookkeeping, not arguments."""
    from repro_torch import kernels

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
    timed = torch.bfloat16 if torch.bfloat16 in dtypes else dtypes[0]
    entry["timed_dtype"] = str(timed).split(".")[1]
    c = case(timed)                        # the serving dtype
    args = {k: x for k, x in c.items() if not k.endswith("_bytes")}
    entry["kernel_ms"] = timer.ms(lambda: fn(**args), head_start=head_start)
    entry["host_ms"] = host_ms(lambda: fn(**args))

    def plain():
        with kernels.force("plain"):
            fn(**args)
    entry["plain_ms"] = timer.ms(plain, head_start=head_start)
    entry["library_ms"] = (timer.ms(library(c), head_start=head_start)
                           if library else None)
    entry["bound_ms"], entry["bound_by"] = bound_fn(c, hw)
    return entry


def flash_variant(measure, cfg, hw, device, label, heads, sq, sk, off,
                  dtype, run):
    """Flash at ``heads`` (G, R, D): ``sq`` queries at ``q_offset`` ``off``
    over ``sk`` keys, AUTO's tiles, held and timed in ``dtype``; ``run``
    names the engine run whose launches the case reports."""
    from repro_torch.core.mapper import plan_attention_blocks
    from repro_torch.kernels.flash_attention import flash_attention

    p = plan_attention_blocks(sq, sk, heads[2], hw)
    tiles = (p.block_q, p.block_k)
    entry = measure("flash_attention", flash_attention,
                    lambda dt: flash_case(cfg, sq, sk, off, tiles, device,
                                          dt, heads=heads),
                    flash_bound, sdpa_call, dtypes=(dtype,))
    return dict(shape=f"{label}: G {heads[0]}, R {heads[1]}, head_dim "
                      f"{heads[2]}, {sq} queries at q_offset {off} over "
                      f"{sk} keys, tiles {tiles}",
                variant=label, run=run, **entry)


def decode_variant(measure, timer, cfg, hw, device, name, fn, heads, quant,
                   contiguous, run, sweep=False):
    """A decode kernel (row 1, row 3 with ``quant``, row 4 with
    ``contiguous``) at ``heads`` (G, R, D) over ``decode_case``'s ragged
    lengths, 8 slots, a pool of 1024, with AUTO's plan and the grid it
    launched; ``sweep`` also times it at each width of ``SPLIT_SWEEP``."""
    from repro_torch.core.mapper import (decode_head_chunks,
                                         plan_cache_block, plan_decode_split,
                                         plan_paged_block)

    g, r, d = heads
    if contiguous:
        bs = plan_cache_block(1024, d, hw, heads_per_group=r)
    else:
        bs = plan_paged_block(1024, d, 16, hw, heads_per_group=r)
    w = plan_decode_split(1024, 8 * g, bs, d, hw, heads_per_group=r,
                          page_block=None if contiguous else 16)

    def case(dt):
        if contiguous:
            return contiguous_case(cfg, bs, device, dt, w, heads=heads)
        c = decode_case(cfg, bs, device, dt, w, heads=heads)
        return int8_pool(c, torch.Generator().manual_seed(SEED + 2)) \
            if quant else c

    fn.last_grid = None
    entry = measure(name, fn, case, decode_bound,
                    sdpa_decode_call if contiguous else None,
                    head_start=True)
    grid = fn.last_grid
    label = f"R {r} D {d}"
    if sweep:                    # the same call at other split widths
        args = {k: x for k, x in case(BF16).items()
                if not k.endswith("_bytes")}
        entry["split_sweep_ms"] = {
            width: timer.ms(lambda: fn(**dict(args, split=width)),
                            head_start=True)
            for width in SPLIT_SWEEP}
    return dict(shape=f"{label}: slots 8, G {g}, pool 1024, ragged "
                      f"lengths", variant=label, run=run,
                plan=dict(block_s=bs, split=w, grid=list(grid),
                          ctas=math.prod(grid),
                          head_runs=decode_head_chunks(d, r)),
                **entry)


def gather_variant(measure, device, name, fn, quant, heads, run):
    """A gather (row 5, row 6 with ``quant``) of one (8, 1024, G, D)
    cache, pages of 16, every page mapped, bit for bit, with the plan
    that launched."""
    g, _, d = heads
    shape = (8, 1024, g, d)
    entry = measure(name, fn,
                    lambda dt: pool_gather_case(shape, device, dt, quant,
                                                SEED + 6),
                    gather_bound, None, exact=True, head_start=True)
    return dict(shape=f"G {g}, D {d}: {shape}, page 16, every page mapped",
                variant=f"G {g} D {d}", run=run,
                plan=dataclasses.asdict(fn.last_plan), **entry)


def add_variants(results, cfg, hw, device, timer, measure):
    """The variants the dense and moe phases' models take, appended to
    each serving kernel's cases (after the serving shape, which stays
    first): flash in f32 at head_dim 128 (qwen3-8b's heads, a 512 prompt
    and a 64-row chunk at an odd q_offset; deepseek-moe-16b's G 16, R 1)
    and 32 (the reduced configs'), and in bf16 at head_dim 192
    (nemotron-4-340b's G 8, R 12; the prompt and the chunk) and 128
    (deepseek-moe-16b's R 1, qwen3-moe-235b-a22b's G 4, R 16); the three
    decode kernels at R 12 / D 192, R 16 / D 256, R 1 / D 128 (G 16) and
    R 16 / D 128 (G 4) over ``decode_case``'s ragged lengths (nemotron's
    also timed at each width of ``SPLIT_SWEEP``); the gathers at D 192
    and at the two moe models' KV heads.  Each case names the dense or
    moe run whose launches it reports (``run``; None: no run takes
    it).  zamba2-7b's variants are the hybrid phase's
    (``hybrid_kernel_rows``)."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.kernels.paged_gather import (paged_dequant_gather,
                                                  paged_gather)

    def flash(*args):
        return flash_variant(measure, cfg, hw, device, *args)

    results["flash_attention"] += [
        flash("f32 D 128", QWEN3_HEADS, 512, 512, 0, F32, "qwen3_fp32"),
        flash("f32 D 128 chunk", QWEN3_HEADS, 64, 512, 385, F32,
              "qwen3_fp32"),
        flash("f32 D 32", REDUCED_HEADS, 512, 512, 0, F32, None),
        flash("bf16 D 192", NEMOTRON_HEADS, 512, 512, 0, BF16, "nemotron"),
        flash("bf16 D 192 chunk", NEMOTRON_HEADS, 64, 512, 385, BF16,
              "nemotron"),
        flash("bf16 D 128 R 1", DEEPSEEK_HEADS, 512, 512, 0, BF16,
              "deepseek_chunked"),
        flash("f32 D 128 R 1", DEEPSEEK_HEADS, 512, 512, 0, F32,
              "deepseek_fp32"),
        flash("bf16 D 128 R 16", QWEN3_MOE_HEADS, 512, 512, 0, BF16,
              "qwen3_moe")]

    # kernel, wrapper, int8 pool, contiguous, the run of each geometry:
    # nemotron's, the widest, deepseek-moe's and qwen3-moe's
    for name, fn, quant, contiguous, runs in (
            ("paged_decode_attention", paged_decode_attention, False, False,
             ("nemotron", None, "deepseek_chunked", "qwen3_moe")),
            ("paged_decode_attention_int8", paged_decode_attention, True,
             False, ("nemotron_int8", None, None, "qwen3_moe_int8")),
            ("decode_attention", decode_attention, False, True,
             ("nemotron_gather", None, None, "qwen3_moe_gather"))):
        results[name] += [
            decode_variant(measure, timer, cfg, hw, device, name, fn, heads,
                           quant, contiguous, run,
                           sweep=heads is NEMOTRON_HEADS)
            for heads, run in zip((NEMOTRON_HEADS, WIDEST_HEADS,
                                   DEEPSEEK_HEADS, QWEN3_MOE_HEADS), runs)]
    for name, fn, quant, runs in (
            ("paged_gather", paged_gather, False,
             ("nemotron_gather", None, "qwen3_moe_gather")),
            ("paged_dequant_gather", paged_dequant_gather, True,
             (None, None, "qwen3_moe_int8_gather"))):
        for heads, run in zip((NEMOTRON_HEADS, DEEPSEEK_HEADS,
                               QWEN3_MOE_HEADS), runs):
            results[name].append(gather_variant(measure, device, name, fn,
                                                quant, heads, run))


def kernels_phase(cfg, hw, timer, device):
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

    def measure(*args, **kw):
        return measure_kernel(hw, timer, *args, **kw)

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
    resume_tiles = plan_attention_blocks(32, 256, cfg.head_dim, hw)
    resume_tiles = (resume_tiles.block_q, resume_tiles.block_k)
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
        # a radix-resumed chunk: its first query tile straddles the causal
        # diagonal at an offset off the 16-row grid
        dict(shape=f"chunk 32 at q_offset 203 over a 256 cache, tiles "
                   f"{resume_tiles}",
             **measure("flash_attention", flash_attention,
                       lambda dt: flash_case(cfg, 32, 256, 203, resume_tiles,
                                             device, dt),
                       flash_bound, sdpa_call)),
        dict(shape=f"prompt 512, non-causal, tiles {tiles}",
             **measure("flash_attention", flash_attention,
                       lambda dt: flash_case(cfg, 512, 512, 0, tiles, device,
                                             dt, causal=False),
                       flash_bound, sdpa_call)),
        # qwen3-8b's attention heads (8 KV groups x 4, head_dim 128) in
        # bf16; its f32 kernel is held among the variants (add_variants)
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
    add_variants(results, cfg, hw, device, timer, measure)
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
#: mamba2-1.3b's depth in the engine and profile phases: its published
#: width, 12 of its 48 layers.  With all 48 the mamba2 runs of the two
#: phases took ~355 s of a 1,067 s smoke (the chunked prefill is a
#: decode step a prompt token, ~59 launches a layer); at 24 the smoke
#: would sit near 950 s on a slow host.  Their gates (completion, no
#: kernel launched) do not depend on the depth
MAMBA_LAYERS = 12


def engine_config(arch):
    """The engine and profile phases' config of ``arch``: smollm-135m at
    its published width and depth, mamba2-1.3b at its published width cut
    to ``MAMBA_LAYERS`` layers."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch == "mamba2-1.3b":
        cfg = dataclasses.replace(cfg, num_layers=MAMBA_LAYERS)
    return cfg


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


def engine_run(label, eng, reqs, opts, expected, phase="engine",
               extra=None):
    """Serve ``reqs`` with the counts reset just before and read just
    after; the path's own kernels must be above 0, every other 0.
    Prints the run on a ``phase`` line with the readings ``extra()``
    returns after the run; returns the run's dict and the requests'
    outputs."""
    counters = launch_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    report, outs = serve(eng, reqs)
    wall = time.perf_counter() - t0
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    s = report.summary
    run = dict(
        arch=eng.cfg.name, options=opts, completed=s.n_completed,
        output_tokens=s.output_tokens, tokens_per_s=s.tokens_per_s,
        wall_s=wall, ttft_p50_ms=s.ttft_p50_s * 1e3,
        ttft_p95_ms=s.ttft_p95_s * 1e3,
        decode_tick_p50_ms=s.decode_tick_p50_s * 1e3,
        decode_ticks=s.decode_steps, prefill_s=s.prefill_s,
        decode_s=s.decode_s,
        paged_decode_block=report.paged_decode_blocks,
        decode_block=report.decode_blocks,
        paged_decode_split=report.paged_decode_splits,
        decode_split=report.decode_splits,
        prefill_tiles={k: list(v) for k, v in report.prefill_tiles.items()},
        launches=launches, policy=eng.router.policy.value,
        router_stats=report.router_stats, plans=tuned_beside_auto(eng),
        radix=report.radix, pool_growths=report.pool_growths,
        **(extra() if extra is not None else {}))
    emit(phase, run=label, **run)
    if s.n_completed != len(reqs):
        raise AssertionError(f"{label}: {s.n_completed}/{len(reqs)} "
                             f"completed")
    check_launches(label, launches, expected)
    return run, outs


def check_launches(label, launches, expected):
    """The path's own kernels launched, every other kernel not."""
    for k, n in launches.items():
        if k in expected and n <= 0:
            raise AssertionError(f"{label}: {k} was never launched on its "
                                 f"path")
        if k not in expected and n != 0:
            raise AssertionError(f"{label}: {k} launched {n} times on a "
                                 f"path that must not use it")


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
        runs[label], _ = engine_run(label, eng, reqs, opts, expected)
    # the same token lists (drawn below smollm's vocabulary, so inside
    # mamba2's 50,280)
    for label, chunk in MAMBA_RUNS.items():
        eng = ServeEngine(engine_config("mamba2-1.3b"), slots=8,
                          max_len=1024, prefill_chunk=chunk,
                          params=params["mamba2-1.3b"], seed=SEED,
                          device=device)
        params["mamba2-1.3b"] = eng.params
        runs[label], _ = engine_run(label, eng, reqs[:MAMBA_REQUESTS],
                                    {"prefill_chunk": chunk}, set())
    return runs, params, reqs


# --------------------------------------------------------------------------- #
# dense: qwen3-8b and nemotron-4-340b at full width
# --------------------------------------------------------------------------- #

#: qwen3-8b's bf16 runs serve the engine mix's first requests (1,389
#: prompt tokens)
DENSE_REQUESTS = 4
#: nemotron-4-340b at its published width with its depth cut to 2 layers
#: (340 B parameters do not fit one card; two layers and the two
#: 256,000 x 18,432 embedding tables hold 16.4 B, ~33 GB in bf16), on the
#: mix's first prompts with a few new tokens each
NEMOTRON_LAYERS = 2
NEMOTRON_REQUESTS = 3
NEMOTRON_NEW = 8
#: nemotron's runs: label -> the ``ENGINE_RUNS`` path; each held against
#: a ``force("plain")`` run on the same requests
NEMOTRON_RUNS = {"nemotron": "chunked", "nemotron_int8": "int8",
                 "nemotron_gather": "gather"}


def free_cuda():
    """Return the freed model's memory to the card before the next one
    (engines hold reference cycles, so collect them first)."""
    gc.collect()
    torch.cuda.empty_cache()


def draw_weights(cfg, device):
    """The model's seeded weights, drawn on the card
    (``Model.init``: a CUDA generator, per tensor in flat pieces), and
    the seconds the draw took."""
    from repro_torch.models import build_model

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = build_model(cfg, device=device).init(SEED)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


#: vocab columns of the unembedding held against a float32 product, and
#: the tolerance (bf16 products are exact in float32; only the order of
#: the float32 sums differs)
UNEMBED_CHECK_COLS = 4096
UNEMBED_TOL = 1e-3


def unembed_check(label, params, device):
    """The unembedding at a decode step's 8 rows (``layers.unembed``:
    one product of the bf16 inputs with a float32 output): its logits
    over the first ``UNEMBED_CHECK_COLS`` columns against a float32
    product of the same inputs, the memory it takes beyond its logits
    (a float32 copy of the table would show here), and its time beside
    the bound of reading the table once."""
    from repro_torch.core.hw import detect
    from repro_torch.models.layers import unembed

    emb = params["embed"]
    w = emb["unembed"] if "unembed" in emb else emb["tok"].t()
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn(8, w.shape[0], generator=gen, device=device).to(w.dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    out = unembed(emb, x)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(device) - base \
        - out.numel() * out.element_size()
    want = x.float() @ w[:, :UNEMBED_CHECK_COLS].float()
    err = float((out[:, :UNEMBED_CHECK_COLS] - want).abs().max())
    ms = Timer(device).ms(lambda: unembed(emb, x))
    table = w.numel() * w.element_size()
    entry = dict(run=label, shape=[8, *w.shape], dtype=str(w.dtype),
                 out_dtype=str(out.dtype), ms=ms,
                 bound_ms=table / detect(device).mem_bw * 1e3,
                 bound_by="bytes", max_abs_err=err, tol=UNEMBED_TOL,
                 extra_bytes=extra, table_bytes=table)
    emit("dense_unembed", **entry)
    if out.dtype != torch.float32 or err > UNEMBED_TOL:
        raise AssertionError(f"{label} unembed: {out.dtype}, {err}")
    if extra > table // 4:
        raise AssertionError(f"{label} unembed took {extra} bytes beyond "
                             f"its logits: a copy of the table")
    return entry


def keep_first_logits(eng, sink, key):
    """Wraps ``eng``'s decode step: the first tick's logits kept in
    ``sink[key]``; returns ``eng``."""
    step = eng.model.decode_step

    def spy(*a, **kw):
        out = step(*a, **kw)
        sink.setdefault(key, out[0].detach().clone())
        return out

    eng.model.decode_step = spy
    return eng


def kernel_plain(engine, reqs, watch=None):
    """``engine()`` (float32) served on ``reqs`` twice: on the kernels and
    under ``kernels.force("plain")``, the counts reset just before each
    serve and read just after.  ``watch(mode, eng)``, if given, installs
    a run's spies and returns the context its serve runs in.  Returns the
    reading (identical streams, the first decode-step logits' largest
    difference, each run's launches and wall time, the tokens) and each
    mode's (report, streams, first decode-step logits)."""
    from repro_torch import kernels

    counters = launch_counters()
    streams, first, launches, wall, reports = {}, {}, {}, {}, {}
    for mode in ("kernel", "plain"):
        eng = keep_first_logits(engine(), first, mode)
        ctx = watch(mode, eng) if watch else contextlib.nullcontext()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        t0 = time.perf_counter()
        with kernels.force(mode), ctx:
            reports[mode], streams[mode] = serve(eng, reqs)
        wall[mode] = time.perf_counter() - t0
        launches[mode] = {k: getattr(fn, attr)
                          for k, (fn, attr) in counters.items()}
    reading = dict(
        token_streams_identical=streams["kernel"] == streams["plain"],
        first_decode_logits_max_abs_err=float(
            (first["kernel"] - first["plain"]).abs().max()),
        launches=launches["kernel"], plain_launches=launches["plain"],
        wall_s=wall, tokens=sum(len(s) for s in streams["kernel"]))
    return reading, {m: (reports[m], streams[m], first[m]) for m in reports}


def check_kernel_plain(label, reading, expected):
    """``kernel_plain``'s gates: identical token streams, first
    decode-step logits within 1e-3, the path's kernels launched and no
    other, nothing launched by plain."""
    if not reading["token_streams_identical"]:
        raise AssertionError(f"{label}: fp32 token streams differ between "
                             f"the kernels and their plain versions")
    err = reading["first_decode_logits_max_abs_err"]
    if err > 1e-3:
        raise AssertionError(f"{label}: first decode-step logits differ "
                             f"by {err}")
    check_launches(label, reading["launches"], expected)
    check_launches(f"{label} plain", reading["plain_launches"], set())


def bf16_runs(name, cfg, params, reqs, device, phase, extra):
    """``cfg`` served on ``reqs`` chunked and whole-prompt with
    ``engine_run``'s gates (runs ``{name}_chunked`` and
    ``{name}_whole_prompt``, ``extra`` on their lines), then the chunked
    run again under torch.profiler: device busy time and idle share
    against the unprofiled run's wall time (run ``{name}_profile``, a
    ``{phase}_profile`` line).  Returns the runs and the chunked run's
    outputs."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServeEngine

    def engine(label):
        opts, chunk, _ = ENGINE_RUNS[label]
        return ServeEngine(cfg, slots=8, max_len=1024, prefill_chunk=chunk,
                           params=params, seed=SEED, device=device, **opts)

    runs, outs = {}, {}
    for label in ("chunked", "whole_prompt"):
        opts, _, expected = ENGINE_RUNS[label]
        runs[f"{name}_{label}"], outs[label] = engine_run(
            f"{name}_{label}", engine(label), reqs, opts, expected,
            phase=phase, extra=lambda: extra)
    eng = engine("chunked")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve(eng, reqs)
    rows = device_kernels(prof)
    busy_ms = sum(r[1] for r in rows)
    unprofiled = runs[f"{name}_chunked"]["wall_s"]
    runs[f"{name}_profile"] = dict(
        requests=len(reqs), wall_s=unprofiled, device_busy_ms=busy_ms,
        idle_share=1.0 - busy_ms / 1e3 / unprofiled,
        kernel_launches=sum(n for _, _, n in rows),
        top=[{"kernel": k[:80], "ms": ms, "count": n,
              "share": ms / busy_ms if busy_ms else 0.0}
             for k, ms, n in rows[:12]])
    emit(f"{phase}_profile", run=f"{name}_chunked",
         **runs[f"{name}_profile"])
    return runs, outs["chunked"]


def dense_phase(device, reqs):
    """qwen3-8b at full width (36 layers): in float32 with the radix on,
    the kernels against ``kernels.force("plain")`` on a 4-request sharing
    mix (requests 3 and 4 resume behind the 200-token preamble;
    ``kernel_plain``): identical streams, first decode-step logits within
    1e-3, the radix hit, flash (f32, head_dim 128) and the paged decode
    launched, nothing launched by the plain run; then in bf16 chunked and
    whole-prompt on the engine mix's first ``DENSE_REQUESTS`` requests
    (``engine_run``'s gates), the chunked run again under torch.profiler
    (``bf16_runs``).  nemotron-4-340b at full width, 2 layers, bf16, on
    each path of ``NEMOTRON_RUNS`` (R 12, head_dim 192): the path's
    kernels launched and no other, and the streams equal a
    ``force("plain")`` run's.  Each bf16 model's unembedding is checked
    and timed at a decode step (``unembed_check``).  Each model is freed
    before the next."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeEngine

    runs = {}
    qwen3 = get_config("qwen3-8b")
    f32 = dataclasses.replace(qwen3, dtype="float32")
    params, init_s = draw_weights(f32, device)
    mix = prefix_mix(f32.vocab_size, n=4, new=8, order=(0, 1, 2, 3),
                     seed=SEED + 1)
    reading, out = kernel_plain(
        lambda: ServeEngine(f32, slots=PREFIX_SLOTS, max_len=1024,
                            params=params, seed=SEED, device=device,
                            prefix_cache=True), mix)
    radix = {mode: report.radix for mode, (report, _, _) in out.items()}
    runs["qwen3_fp32"] = dict(
        arch=f32.name, dtype="float32", layers=f32.num_layers,
        init_s=init_s, radix=radix["kernel"], **reading)
    emit("dense", run="qwen3_fp32", **runs["qwen3_fp32"])
    check_kernel_plain("qwen3-8b fp32", reading, ENGINE_RUNS["chunked"][2])
    for mode, rx in radix.items():
        if rx is None or rx["hit_tokens"] < 2 * (PREFIX_PREAMBLE // 16 * 16):
            raise AssertionError(f"qwen3-8b fp32 {mode}: requests 3 and 4 "
                                 f"did not share the preamble: {rx}")
    del params, out
    free_cuda()

    params, init_s = draw_weights(qwen3, device)
    unembed_check("qwen3_bf16", params, device)
    new, _ = bf16_runs("qwen3", qwen3, params, reqs[:DENSE_REQUESTS],
                       device, "dense", {"init_s": init_s})
    runs.update(new)
    del params
    free_cuda()

    nemotron = dataclasses.replace(get_config("nemotron-4-340b"),
                                   num_layers=NEMOTRON_LAYERS)
    params, init_s = draw_weights(nemotron, device)
    unembed_check("nemotron_bf16", params, device)
    nreqs = [(p, NEMOTRON_NEW) for p, _ in reqs[:NEMOTRON_REQUESTS]]
    for label, path in NEMOTRON_RUNS.items():
        opts, chunk, expected = ENGINE_RUNS[path]

        def engine():
            return ServeEngine(nemotron, slots=8, max_len=1024,
                               prefill_chunk=chunk, params=params,
                               seed=SEED, device=device, **opts)

        runs[label], outs = engine_run(
            label, engine(), nreqs, opts, expected, phase="dense",
            extra=lambda: {"init_s": init_s, "layers": NEMOTRON_LAYERS})
        with kernels.force("plain"):
            _, plain = serve(engine(), nreqs)
        same = outs == plain
        runs[label]["streams_equal_plain"] = same
        emit("dense_plain", run=label, streams_equal_plain=same,
             kernel_streams=[o[-NEMOTRON_NEW:] for o in outs],
             plain_streams=[o[-NEMOTRON_NEW:] for o in plain])
        if not same:
            raise AssertionError(f"{label}: bf16 token streams differ "
                                 f"between the kernels and their plain "
                                 f"versions")
    del params
    free_cuda()
    return runs


# --------------------------------------------------------------------------- #
# moe: deepseek-moe-16b at full width, qwen3-moe-235b-a22b's layers
# --------------------------------------------------------------------------- #

#: the engine mix's first requests each moe run serves (1,389 prompt
#: tokens)
MOE_REQUESTS = 4
#: deepseek-moe-16b's float32 check at its published width, depth cut
#: from 28 layers to 4 (~11 GB; all 28 in float32 would be ~67.6 GB)
MOE_FP32_LAYERS = 4
#: qwen3-moe-235b-a22b at its published width, depth cut from 94 layers
#: to 4 (~2.49 B parameters a layer: 4 layers and the two embedding
#: tables hold ~11.2 B, ~22 GB in bf16), a few new tokens a request
QWEN3_MOE_LAYERS = 4
QWEN3_MOE_NEW = 8
#: new tokens a request in deepseek-moe-16b's teacher-forced runs
MOE_TEACHER_NEW = 8
#: qwen3-moe's runs: label -> the ``ENGINE_RUNS`` path
QWEN3_MOE_RUNS = {"qwen3_moe": "chunked", "qwen3_moe_int8": "int8",
                  "qwen3_moe_gather": "gather",
                  "qwen3_moe_int8_gather": "int8_gather"}
#: the teacher-forced check's bound on a step's logits, kernels against
#: plain in bf16, a model each, between the kernels' rounding and a
#: planted fault (``WrongGroup``), both read on an H100: deepseek's 28
#: layers 0.358 sound, 1.107 with the fault; qwen3-moe's 4 layers
#: 0.117-0.152 sound on its four paths, 6.10 with the fault; zamba2-7b's
#: 9 layers chunked 0.109 sound, 1.965 with the fault at its last group's
#: shared block, its 81 layers whole-prompt 0.257 and 0.744;
#: whisper-medium's 24 + 24 layers 0.038 sound, 0.477 with the fault at
#: its last layer's cross read
TEACHER_TOL = {"deepseek-moe-16b": 0.6, "qwen3-moe-235b-a22b": 0.3,
               "zamba2-7b": 0.45, "whisper-medium": 0.15}


class RouteSpy:
    """While installed, wraps ``models.moe.route``: a run's routing
    counts (calls, routed tokens, dropped slots; device tensors read once
    at the end) and, with ``keep_sets``, each call's top-k expert sets
    (ids sorted) and its smallest gap between the k-th and (k+1)-th
    probability, tagged prefill or decode (``attach`` marks the engine's
    decode steps)."""

    def __init__(self, keep_sets=False):
        self.keep_sets = keep_sets
        self.calls = self.tokens = 0
        self.dropped = []
        self.sets, self.gaps = [], []
        self.phase = "prefill"

    def attach(self, eng):
        step = eng.model.decode_step

        def decode(*a, **kw):
            self.phase = "decode"
            try:
                return step(*a, **kw)
            finally:
                self.phase = "prefill"

        eng.model.decode_step = decode
        return eng

    def __enter__(self):
        from repro_torch.models import moe

        self._moe, self._route = moe, moe.route

        def route(x, router, e, k, c):
            out = self._route(x, router, e, k, c)
            keep, probs, eidx = out[1][3], out[3], out[4]
            self.calls += 1
            self.tokens += x.shape[0]
            self.dropped.append((~keep).sum())
            if self.keep_sets:
                top = probs.topk(k + 1, dim=-1).values
                self.sets.append((self.phase, eidx.sort(-1).values))
                self.gaps.append((self.phase,
                                  (top[:, k - 1] - top[:, k]).min()))
            return out

        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route

    def counts(self):
        return dict(route_calls=self.calls, routed_tokens=self.tokens,
                    dropped_slots=int(sum(int(d) for d in self.dropped)))


def route_diff(kernel, plain):
    """(token, layer) top-k sets that differ between two runs' calls of
    one schedule, per phase, and plain's smallest k-th to (k+1)-th
    probability gap, per phase."""
    if len(kernel.sets) != len(plain.sets):
        raise AssertionError("the two runs routed a different number of "
                             "calls")
    out = {}
    for phase in ("prefill", "decode"):
        pairs = [(a, b) for (pa, a), (_, b) in zip(kernel.sets, plain.sets)
                 if pa == phase]
        gaps = [g for p, g in plain.gaps if p == phase]
        out[phase] = dict(
            sets=sum(a.shape[0] for a, _ in pairs),
            sets_differ=int(sum(int((a != b).any(-1).sum())
                                for a, b in pairs)),
            min_gap=float(torch.stack(gaps).min()) if gaps else None)
    return out


class TeacherForce:
    """Records the logits an engine takes each request's tokens from
    (the last prompt position at prefill, each live row at a decode
    tick), keyed by (prompt, step); with ``force`` (prompt -> the stream
    to feed) it writes a one-hot of the stream's token over those logits
    once recorded, so the engine feeds that stream whatever its own
    logits say."""

    def __init__(self, eng, force=None):
        self.logits = {}
        m = eng.model
        prefill, chunk, step = m.prefill, m.prefill_chunk, m.decode_step

        def take(prompt, j, row):
            self.logits[prompt, j] = row.float().clone()
            if force is not None:
                row.zero_()
                row[force[prompt][len(prompt) + j]] = 1.0

        def prefill_spy(params, toks, pb, **kw):
            logits, cache = prefill(params, toks, pb, **kw)
            plen = int(kw["last_pos"][0]) + 1
            take(tuple(toks[0, :plen].tolist()), 0, logits[0, -1])
            return logits, cache

        def chunk_spy(params, cache, toks, n, **kw):
            task = eng._chunk_tasks[0]
            last = task.done + n >= len(task.toks)
            logits, cache = chunk(params, cache, toks, n, **kw)
            if last:
                take(tuple(task.req.prompt), 0, logits[0, n - 1])
            return logits, cache

        def step_spy(*a, **kw):
            logits, cache = step(*a, **kw)
            for slot, req in eng.scheduler.live_by_slot().items():
                if not req.done and req.rid not in eng._prefilling:
                    take(tuple(req.prompt), len(req.generated),
                         logits[slot, 0])
            return logits, cache

        m.prefill, m.prefill_chunk, m.decode_step = (prefill_spy, chunk_spy,
                                                     step_spy)


def teacher_reading(kernel, plain, tol):
    """Each step's logits, kernels against plain on the same tokens (two
    ``TeacherForce`` records): the largest and median difference, the
    greedy picks that differ, and those where plain's top-2 margin
    exceeds ``tol``."""
    if set(kernel.logits) != set(plain.logits):
        raise AssertionError("the teacher-forced runs recorded different "
                             "steps")
    keys = list(plain.logits)
    kl = torch.stack([kernel.logits[k] for k in keys])
    pl = torch.stack([plain.logits[k] for k in keys])
    err = (kl - pl).abs().amax(-1).cpu()
    top2 = pl.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu()
    differ = (kl.argmax(-1) != pl.argmax(-1)).cpu()
    return dict(steps=len(keys), max_abs_err=float(err.max()),
                p50_abs_err=float(err.median()), tol=tol,
                logit_std=float(pl.std()),
                argmax_differ=int(differ.sum()),
                argmax_differ_above_tol=int((differ & (margin > tol)).sum()),
                min_margin=float(margin.min()),
                steps_above_tol_margin=int((margin > tol).sum()))


def attention_calls(cfg):
    """The decode attention calls of one tick: a call a layer, or for the
    hybrid family one a group (its shared block)."""
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import n_groups

        return n_groups(cfg)
    return cfg.num_layers


class WrongGroup:
    """While installed, one attention call's decode read takes the wrong
    KV group: at call ``layer`` of every tick's ``layers`` calls of the
    wrapper ``fn`` as ``models.attention`` names it (the fused paged
    decode by default, one call a layer or, for the hybrid, its shared
    block's once a group, ``attention_calls``; whisper's cross read, the
    contiguous decode once a layer) the queries are rolled one group
    along before the kernel and its output rolled back, so group g
    attends over group g - 1's keys and values.  A planted fault the
    teacher-forced bound must see (``faulted``: the calls it changed)."""

    def __init__(self, layers, layer, fn="paged_decode_attention"):
        self.layers, self.layer, self.name = layers, layer, fn
        self.calls = self.faulted = 0

    def __enter__(self):
        from repro_torch.models import attention

        self._mod, self._fn = attention, getattr(attention, self.name)

        def decode(q, *a, **kw):
            i, self.calls = self.calls, self.calls + 1
            if i % self.layers != self.layer:
                return self._fn(q, *a, **kw)
            self.faulted += 1
            return self._fn(q.roll(1, 1), *a, **kw).roll(-1, 1)

        setattr(attention, self.name, decode)
        return self

    def __exit__(self, *exc):
        setattr(self._mod, self.name, self._fn)


def teacher_run(label, engine, reqs, outs, tol, fault=False, phase="moe"):
    """The teacher-forced check, untimed: ``engine()`` on the kernels and
    under ``kernels.force("plain")``, both fed ``outs`` (the timed run's
    outputs for ``reqs``' prompts), each step's logits recorded
    (``TeacherForce``), for a moe model the kernel run's routing counts
    (``RouteSpy``); with ``fault``, a third run on the kernels with the
    tick's last attention call reading the wrong KV group
    (``WrongGroup``; ``fault`` may instead be a function of the config
    that returns the ``WrongGroup`` to plant).  Gates: plain launches nothing; every step's logits
    within ``tol`` of plain's and the greedy picks equal wherever plain's
    top-2 margin exceeds ``tol``; the fault's logits more than ``tol``
    from plain's.  Prints a ``{phase}_teacher`` line; returns its
    reading."""
    from repro_torch import kernels

    force = {tuple(p): o for (p, _), o in zip(reqs, outs)}
    counters = launch_counters()
    spy, recs, planted = None, {}, None
    for mode in ("kernel", "plain", "fault")[:3 if fault else 2]:
        eng = engine()
        recs[mode] = TeacherForce(eng, force)
        if mode == "kernel" and eng.cfg.family == "moe":
            spy = RouteSpy()
        if mode == "fault" and callable(fault):
            planted = fault(eng.cfg)
        elif mode == "fault":
            calls = attention_calls(eng.cfg)
            planted = WrongGroup(calls, calls - 1)
        ctx = {"kernel": spy, "fault": planted}.get(mode)
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        with kernels.force("plain" if mode == "plain" else "kernel"), \
                ctx or contextlib.nullcontext():
            serve(eng, reqs)
        if mode == "plain":
            check_launches(f"{label} plain",
                           {k: getattr(fn, attr)
                            for k, (fn, attr) in counters.items()}, set())
    reading = teacher_reading(recs["kernel"], recs["plain"], tol)
    reading["routing"] = spy.counts() if spy is not None else None
    if fault:
        f = teacher_reading(recs["fault"], recs["plain"], tol)
        reading["fault"] = dict(layer=planted.layer,
                                faulted_calls=planted.faulted,
                                max_abs_err=f["max_abs_err"],
                                p50_abs_err=f["p50_abs_err"],
                                argmax_differ=f["argmax_differ"])
    emit(f"{phase}_teacher", run=label, **reading)
    if reading["max_abs_err"] > tol or reading["argmax_differ_above_tol"]:
        raise AssertionError(f"{label}: teacher-forced logits {reading}")
    f = reading.get("fault")
    if f is not None and (not f["faulted_calls"]
                          or f["max_abs_err"] <= tol):
        raise AssertionError(f"{label}: the bound {tol} does not see the "
                             f"planted fault {f}")
    return reading


def tree_bytes(tree):
    """Bytes of every tensor in a nested dict of tensors."""
    return sum(tree_bytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in tree.values())


def tick_bound(params, hw):
    """Bytes a decode tick must read, every weight but the token
    embedding (its rows are gathered): the dense (E, C, d) buffers
    multiply every expert, so every expert's weights; and the time at
    the card's memory rate."""
    tok = params["embed"]["tok"]
    total = tree_bytes(params) - tok.numel() * tok.element_size()
    experts = tree_bytes({k: v for k, v in params["blocks"]["moe"].items()
                          if k != "shared"})
    return dict(tick_bytes=total, expert_bytes=experts,
                tick_bound_ms=total / hw.mem_bw * 1e3)


def moe_phase(device, reqs, hw):
    """deepseek-moe-16b at full width: in float32 cut to
    ``MOE_FP32_LAYERS`` layers, kernels against ``force("plain")``
    (``kernel_plain``: identical streams, first decode-step logits within
    1e-3, flash and row 1 launched, nothing by plain; the top-k sets that
    differ and plain's smallest top-k gap printed); in bf16 at full depth
    chunked and whole-prompt with ``engine_run``'s gates and the chunked
    run under torch.profiler (``bf16_runs``), then the chunked run's
    streams teacher-forced on ``MOE_TEACHER_NEW`` new tokens a request
    (``teacher_run``, with the planted fault); then qwen3-moe-235b-a22b
    at full width cut to ``QWEN3_MOE_LAYERS`` layers on each path of
    ``QWEN3_MOE_RUNS``, each teacher-forced (the default path with the
    planted fault).  The timed runs carry no spy: the routing counts come
    from the teacher-forced kernel runs.  Every run prints the tick's
    bound (every weight read once); each model is freed before the
    next."""
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeEngine

    runs = {}
    mreqs = reqs[:MOE_REQUESTS]
    if len({tuple(p) for p, _ in mreqs}) != len(mreqs):
        raise AssertionError("the teacher-forced runs key steps by prompt")
    deepseek = get_config("deepseek-moe-16b")
    f32 = dataclasses.replace(deepseek, dtype="float32",
                              num_layers=MOE_FP32_LAYERS)
    params, init_s = draw_weights(f32, device)
    recs, spies = {}, {}

    def watch(mode, eng):
        recs[mode] = TeacherForce(eng)
        spies[mode] = RouteSpy(keep_sets=True)
        spies[mode].attach(eng)
        return spies[mode]

    reading, _ = kernel_plain(
        lambda: ServeEngine(f32, slots=8, max_len=1024, params=params,
                            seed=SEED, device=device), mreqs, watch)
    same = reading["token_streams_identical"]
    # every step (prefill's last position and each decode step)
    all_err = max(float((recs["kernel"].logits[k] - v).abs().max())
                  for k, v in recs["plain"].logits.items()) if same else None
    runs["deepseek_fp32"] = dict(
        arch=f32.name, dtype="float32", layers=f32.num_layers,
        init_s=init_s, **reading, all_steps_logits_max_abs_err=all_err,
        routing=spies["kernel"].counts(),
        routing_differ=route_diff(spies["kernel"], spies["plain"])
        if same else None, **tick_bound(params, hw))
    emit("moe", run="deepseek_fp32", **runs["deepseek_fp32"])
    check_kernel_plain("deepseek-moe-16b fp32", reading,
                       ENGINE_RUNS["chunked"][2])
    del params, recs, spies
    free_cuda()

    params, init_s = draw_weights(deepseek, device)
    unembed_check("deepseek_bf16", params, device)
    bound = tick_bound(params, hw)
    new, outs = bf16_runs("deepseek", deepseek, params, mreqs, device, "moe",
                          {"init_s": init_s, **bound})
    runs.update(new)
    # a few new tokens a request: plain's decode at full depth takes
    # ~1.7 s a tick
    runs["deepseek_teacher"] = teacher_run(
        "deepseek_teacher", lambda: ServeEngine(
            deepseek, slots=8, max_len=1024, params=params, seed=SEED,
            device=device), [(p, MOE_TEACHER_NEW) for p, _ in mreqs], outs,
        TEACHER_TOL[deepseek.name], fault=True)
    del params
    free_cuda()

    qwen3_moe = dataclasses.replace(get_config("qwen3-moe-235b-a22b"),
                                    num_layers=QWEN3_MOE_LAYERS)
    params, init_s = draw_weights(qwen3_moe, device)
    unembed_check("qwen3_moe_bf16", params, device)
    bound = tick_bound(params, hw)
    qreqs = [(p, QWEN3_MOE_NEW) for p, _ in mreqs]
    for label, path in QWEN3_MOE_RUNS.items():
        opts, chunk, expected = ENGINE_RUNS[path]

        def engine():
            return ServeEngine(qwen3_moe, slots=8, max_len=1024,
                               prefill_chunk=chunk, params=params,
                               seed=SEED, device=device, **opts)

        runs[label], outs = engine_run(
            label, engine(), qreqs, opts, expected, phase="moe",
            extra=lambda: {"init_s": init_s, "layers": QWEN3_MOE_LAYERS,
                           **bound})
        runs[label]["teacher"] = teacher_run(
            label, engine, qreqs, outs, TEACHER_TOL[qwen3_moe.name],
            fault=path == "chunked")
    del params
    free_cuda()
    return runs


# --------------------------------------------------------------------------- #
# hybrid: zamba2-7b at full width
# --------------------------------------------------------------------------- #

#: zamba2-7b's attention heads: 32 KV heads of one query head each, head_dim
#: 112 (the shared block's; its K/V slot is one a group)
ZAMBA2_HEADS = (32, 1, 112)
#: the float32 runs' and the timed chunked run's depth: two groups of 6,
#: the second with 3 active and 3 padded layers, the shape of the
#: published 81 (13 full groups and one of 3 plus 3 padded); 1.2 B
#: parameters, 4.9 GB in float32
HYBRID_CUT_LAYERS = 9
#: the phase's requests: seeded prompts of 16-160 tokens, 8 new tokens
#: each.  A chunked prompt token is a decode step through every layer
#: (the exact recurrence), so the engine mix's first 4 requests (1,389
#: prompt tokens) would make each of the phase's eight chunked runs
#: several times longer
HYBRID_REQUESTS = 4
HYBRID_PROMPT = (16, 160)
HYBRID_NEW = 8
#: the float32 runs, kernels against ``force("plain")``: label -> (the
#: ``ENGINE_RUNS`` path, the kernels it must launch).  Chunked prefill
#: scans the decode step over the prompt, its attention through the
#: contiguous decode (row 4) over the row cache: every chunked path
#: launches ``decode_attention`` and no flash; whole-prompt prefill
#: launches flash
HYBRID_FP32_RUNS = {
    "zamba2_fp32": ("chunked", {"paged_decode_attention",
                                "decode_attention"}),
    "zamba2_fp32_whole": ("whole_prompt", {"paged_decode_attention",
                                           "flash_attention"}),
    "zamba2_fp32_int8": ("int8", {"paged_decode_attention_int8",
                                  "decode_attention"}),
    "zamba2_fp32_gather": ("gather", {"paged_gather", "decode_attention"}),
    "zamba2_fp32_int8_gather": ("int8_gather", {"paged_dequant_gather",
                                                "decode_attention"}),
}
#: the bf16 runs, timed, then teacher-forced against plain with the
#: planted fault: label -> (layers, the ``ENGINE_RUNS`` path, the kernels
#: it must launch); whole-prompt prefill at all 81 layers (13.7 GB) is
#: one forward a prompt
HYBRID_BF16_RUNS = {
    "zamba2_chunked": (HYBRID_CUT_LAYERS, "chunked",
                       {"paged_decode_attention", "decode_attention"}),
    "zamba2_whole_prompt": (81, "whole_prompt",
                            {"paged_decode_attention", "flash_attention"}),
}


def hybrid_kernel_rows(cfg, hw, device, timer):
    """The serving kernels at zamba2-7b's heads (G 32, R 1, D 112), each
    against its plain version and timed beside its bound (and SDPA where
    one call computes the same function): flash in f32 and bf16 (a 512
    prompt, causal), rows 1, 3 and 4 over ``decode_case``'s ragged
    lengths (8 slots, a pool of 1024), rows 5 and 6 over (8, 1024, 32,
    112).  Each case names the hybrid run whose launches it reports."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.kernels.paged_gather import (paged_dequant_gather,
                                                  paged_gather)

    def measure(*args, **kw):
        return measure_kernel(hw, timer, *args, **kw)

    rows = {name: [] for name in SERVING_KERNELS}
    rows["flash_attention"] = [
        flash_variant(measure, cfg, hw, device, "f32 D 112", ZAMBA2_HEADS,
                      512, 512, 0, F32, "zamba2_fp32_whole"),
        flash_variant(measure, cfg, hw, device, "bf16 D 112", ZAMBA2_HEADS,
                      512, 512, 0, BF16, "zamba2_whole_prompt")]
    for name, fn, quant, contiguous, run in (
            ("paged_decode_attention", paged_decode_attention, False, False,
             "zamba2_chunked"),
            ("paged_decode_attention_int8", paged_decode_attention, True,
             False, "zamba2_fp32_int8"),
            ("decode_attention", decode_attention, False, True,
             "zamba2_chunked")):
        rows[name].append(decode_variant(measure, timer, cfg, hw, device,
                                         name, fn, ZAMBA2_HEADS, quant,
                                         contiguous, run))
    for name, fn, quant, run in (
            ("paged_gather", paged_gather, False, "zamba2_fp32_gather"),
            ("paged_dequant_gather", paged_dequant_gather, True,
             "zamba2_fp32_int8_gather")):
        rows[name].append(gather_variant(measure, device, name, fn, quant,
                                         ZAMBA2_HEADS, run))
    return rows


def hybrid_tick_bound(params, cfg, hw):
    """Bytes a decode tick must read: every weight it uses once (the tied
    token table once, by the unembedding; the shared block once, though
    it runs once a group; no padded layer's), and the time at the card's
    memory rate."""
    from repro_torch.models.hybrid import padded_layers

    blocks = tree_bytes(params["blocks"])
    total = tree_bytes(params) - blocks \
        + blocks * cfg.num_layers // padded_layers(cfg)
    return dict(tick_bytes=total, tick_bound_ms=total / hw.mem_bw * 1e3)


def hybrid_phase(device, hw, timer, cfg):
    """zamba2-7b at full width: its kernel rows (``hybrid_kernel_rows``);
    in float32 cut to ``HYBRID_CUT_LAYERS`` layers on each path of
    ``HYBRID_FP32_RUNS``, kernels against ``force("plain")``
    (``kernel_plain``: identical streams, first decode-step logits within
    1e-3, the path's kernels launched and no other, nothing by plain);
    in bf16 on each run of ``HYBRID_BF16_RUNS`` (chunked at 9 layers,
    whole-prompt at 81) with ``engine_run``'s gates, each teacher-forced
    against plain with the planted fault (``teacher_run``).  Returns the
    runs and the kernel rows; each model is freed before the next."""
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeEngine

    rows = hybrid_kernel_rows(cfg, hw, device, timer)
    emit("hybrid_kernels", card=nvidia_smi(), results=rows)
    zamba = get_config("zamba2-7b")
    hreqs = requests(HYBRID_REQUESTS, *HYBRID_PROMPT, HYBRID_NEW,
                     zamba.vocab_size, SEED + 3)
    if len({tuple(p) for p, _ in hreqs}) != len(hreqs):
        raise AssertionError("the teacher-forced runs key steps by prompt")
    runs = {}
    f32 = dataclasses.replace(zamba, dtype="float32",
                              num_layers=HYBRID_CUT_LAYERS)
    params, init_s = draw_weights(f32, device)
    for label, (path, expected) in HYBRID_FP32_RUNS.items():
        opts, chunk, _ = ENGINE_RUNS[path]
        reading, _ = kernel_plain(
            lambda: ServeEngine(f32, slots=8, max_len=1024,
                                prefill_chunk=chunk, params=params,
                                seed=SEED, device=device, **opts), hreqs)
        runs[label] = dict(arch=f32.name, dtype="float32", path=path,
                           layers=f32.num_layers, init_s=init_s, **reading)
        emit("hybrid", run=label, **runs[label])
        check_kernel_plain(label, reading, expected)
    del params
    free_cuda()

    for label, (layers, path, expected) in HYBRID_BF16_RUNS.items():
        bcfg = dataclasses.replace(zamba, num_layers=layers)
        params, init_s = draw_weights(bcfg, device)
        bound = hybrid_tick_bound(params, bcfg, hw)
        opts, chunk, _ = ENGINE_RUNS[path]

        def engine():
            return ServeEngine(bcfg, slots=8, max_len=1024,
                               prefill_chunk=chunk, params=params,
                               seed=SEED, device=device, **opts)

        runs[label], outs = engine_run(
            label, engine(), hreqs, opts, expected, phase="hybrid",
            extra=lambda: {"init_s": init_s, "layers": layers, **bound})
        runs[label]["teacher"] = teacher_run(
            label, engine, hreqs, outs, TEACHER_TOL[zamba.name], fault=True,
            phase="hybrid")
        del params
        free_cuda()
    return runs, rows


# --------------------------------------------------------------------------- #
# encdec: whisper-medium at full width
# --------------------------------------------------------------------------- #

#: whisper-medium's attention heads: 16 KV heads of one query head each,
#: head_dim 64 (the decoder's self-attention, the encoder's and the
#: cross-attention's alike)
WHISPER_HEADS = (16, 1, 64)
#: the stub frames a request's encoder takes: the cross cache's length
WHISPER_FRAMES = 1500
#: the float32 runs' depth: 4 encoder and 4 decoder layers of the 24 each
#: (0.18 B parameters with the embedding, 0.7 GB in float32).  The plain
#: runs' cross read sweeps 1,500 positions in 16-position windows of torch
#: ops (94 a layer a tick), and their encoder 1,500 x 1,500 in tiles, so
#: depth is what the plain runs pay for
ENCDEC_FP32_LAYERS = 4
#: the phase's requests: seeded prompts of 16-160 tokens, 8 new tokens
#: each.  The plain runs pay most of the phase's time, a request's
#: encoder (~0.3 s a layer for plain flash at 1,500 x 1,500) and its
#: ticks (~57 ms a layer for the plain cross read at 8 slots), read on
#: an H100 80GB HBM3 at 700 W: with 4 requests the phase took ~120 s
ENCDEC_REQUESTS = 3
ENCDEC_PROMPT = (16, 160)
ENCDEC_NEW = 8
#: the float32 runs, kernels against ``force("plain")``: label -> the
#: ``ENGINE_RUNS`` path ("chunked" is the engine's default options, chunk
#: "auto", which encdec serves whole: it cannot chunk)
ENCDEC_FP32_RUNS = {"whisper_fp32": "chunked",
                    "whisper_fp32_contiguous": "contiguous",
                    "whisper_fp32_gather": "gather",
                    "whisper_fp32_int8": "int8",
                    "whisper_fp32_int8_gather": "int8_gather"}
#: a decode tick's launches a decoder layer on each path: the
#: self-attention's read (the fused paged sweep, or a gather of K and V
#: then the contiguous sweep, or the contiguous sweep over the slot rows)
#: and the cross read, one ``decode_attention`` a layer on every path
ENCDEC_DECODE_READS = {
    "chunked": {"paged_decode_attention": 1, "decode_attention": 1},
    "contiguous": {"decode_attention": 2},
    "gather": {"paged_gather": 2, "decode_attention": 2},
    "int8": {"paged_decode_attention_int8": 1, "decode_attention": 1},
    "int8_gather": {"paged_dequant_gather": 2, "decode_attention": 2}}


def encdec_launches(cfg, path, requests, ticks):
    """The exact launches of one whisper run: flash at three call sites a
    request, a launch a layer each (the encoder's self-attention, the
    prefill's cross-attention, the decoder's self-attention), the path's
    decode reads a layer a tick (``ENCDEC_DECODE_READS``), every other
    kernel none."""
    out = {"flash_attention": requests * (cfg.encoder_layers
                                          + 2 * cfg.num_layers)}
    for k, n in ENCDEC_DECODE_READS[path].items():
        out[k] = n * cfg.num_layers * ticks
    return out


def check_exact_launches(label, launches, expected):
    """Each kernel launched exactly its ``expected`` count (0 if absent)."""
    for k, n in launches.items():
        if n != expected.get(k, 0):
            raise AssertionError(f"{label}: {k} launched {n} times, "
                                 f"expected {expected.get(k, 0)}")


def cross_case(device, dtype, hw):
    """Row 4 over a full cross cache: 8 rows of 1,500 positions at
    whisper's heads, every ``cache_len`` 1500 (the sweep stops inside its
    last ``block_s`` window), at the plan the model's cross read takes
    (``models.encdec.cross_decode_plan``)."""
    from repro_torch.models.encdec import cross_decode_plan

    b, t = 8, WHISPER_FRAMES
    g, r, d = WHISPER_HEADS
    bs, w = cross_decode_plan(t, b * g, d, r, hw)
    gen = torch.Generator(device=device).manual_seed(SEED + 7)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    return dict(q=rand(b, g, r, d), k_cache=rand(b, t, g, d),
                v_cache=rand(b, t, g, d),
                cache_len=torch.full((b,), t, dtype=torch.int32,
                                     device=device), block_s=bs, split=w)


def encdec_kernel_rows(cfg, hw, device, timer):
    """The serving kernels at whisper-medium's heads (G 16, R 1, D 64),
    each against its plain version in f32 and bf16 and timed in bf16
    beside its bound (and SDPA where one call computes it): flash causal
    at a 512 prompt, non-causal 1,500 x 1,500 (the encoder) and 64 x
    1,500 (the prefill's
    cross-attention); row 4 over a full 1,500-position cross cache at 8
    rows (``cross_case``); rows 1, 3 and 4 over ``decode_case``'s ragged
    lengths; rows 5 and 6 over (8, 1024, 16, 64).  Each case names the
    encdec run whose launches it reports."""
    from repro_torch.core.mapper import plan_attention_blocks
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.kernels.paged_gather import (paged_dequant_gather,
                                                  paged_gather)

    def measure(*args, **kw):
        return measure_kernel(hw, timer, *args, **kw)

    g, r, d = WHISPER_HEADS
    rows = {name: [] for name in SERVING_KERNELS}
    for label, sq, sk, causal, dtypes, run in (
            ("prompt 512", 512, 512, True, (F32, BF16), "whisper_bf16"),
            ("encoder 1500", WHISPER_FRAMES, WHISPER_FRAMES, False,
             (F32, BF16), "whisper_bf16"),
            ("cross 64 x 1500", 64, WHISPER_FRAMES, False, (F32, BF16),
             "whisper_bf16")):
        p = plan_attention_blocks(sq, sk, d, hw)
        tiles = (p.block_q, p.block_k)
        entry = measure("flash_attention", flash_attention,
                        lambda dt: flash_case(cfg, sq, sk, 0, tiles, device,
                                              dt, causal=causal,
                                              heads=WHISPER_HEADS),
                        flash_bound, sdpa_call, dtypes=dtypes)
        rows["flash_attention"].append(dict(
            shape=f"whisper {label}: G {g}, R {r}, head_dim {d}, {sq} "
                  f"queries over {sk} keys, "
                  f"{'causal' if causal else 'non-causal'}, tiles {tiles}",
            variant=f"whisper {label}", run=run, **entry))
    entry = measure("decode_attention", decode_attention,
                    lambda dt: cross_case(device, dt, hw), decode_bound,
                    sdpa_decode_call, head_start=True)
    c = cross_case(device, BF16, hw)
    rows["decode_attention"].append(dict(
        shape=f"whisper cross: 8 rows, G {g}, R {r}, D {d}, "
              f"{WHISPER_FRAMES} positions each, every row full",
        variant="whisper cross 1500", run="whisper_bf16",
        plan=dict(block_s=c["block_s"], split=c["split"],
                  grid=list(decode_attention.last_grid)), **entry))
    for name, fn, quant, contiguous, run in (
            ("paged_decode_attention", paged_decode_attention, False, False,
             "whisper_bf16"),
            ("paged_decode_attention_int8", paged_decode_attention, True,
             False, "whisper_fp32_int8"),
            ("decode_attention", decode_attention, False, True,
             "whisper_fp32_contiguous")):
        rows[name].append(decode_variant(measure, timer, cfg, hw, device,
                                         name, fn, WHISPER_HEADS, quant,
                                         contiguous, run))
    for name, fn, quant, run in (
            ("paged_gather", paged_gather, False, "whisper_fp32_gather"),
            ("paged_dequant_gather", paged_dequant_gather, True,
             "whisper_fp32_int8_gather")):
        rows[name].append(gather_variant(measure, device, name, fn, quant,
                                         WHISPER_HEADS, run))
    return rows


def distinct_frames_check(cfg, params, device, hw):
    """The model with distinct seeded frames for two rows of one prompt
    (float32): one batch-2 prefill and 3 decode steps from its row cache
    (the contiguous reads, a vector ``pos``, the same seeded tokens fed
    to every run) on the kernels, against ``force("plain")`` and against
    each row's own batch-1 run on the kernels.  The engine's frames are
    zeros, so every request's cross K/V are equal there and a slot
    mix-up in ck/cv cannot show in its streams; here the rows differ
    only by their frames.  Gates: every step's logits within 1e-3 of
    plain and of the row's own run; the two rows' logits apart."""
    from repro_torch import kernels
    from repro_torch.core.mapper import plan_attention_blocks
    from repro_torch.models import build_model

    model = build_model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    frames = torch.randn((2, cfg.encoder_tokens, cfg.d_model), generator=gen,
                         device=device)
    rng = np.random.default_rng(SEED + 8)
    prompt = rng.integers(1, cfg.vocab_size, size=64)
    feed = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(3, 1))).to(
        device)
    p = plan_attention_blocks(64, 64, cfg.head_dim, hw)
    counters = launch_counters()

    def run(rows, mode):
        b = len(rows)
        toks = torch.from_numpy(np.tile(prompt, (b, 1))).to(device)
        with kernels.force(mode):
            logits, cache = model.prefill(params, toks, 128,
                                          prefill_tiles=(p.block_q,
                                                         p.block_k),
                                          frames=frames[rows])
            cache["pos"] = torch.full((b,), 64, dtype=torch.int32,
                                      device=device)
            out = [logits[:, -1]]
            for i in range(feed.shape[0]):
                logits, cache = model.decode_step(params, cache,
                                                  feed[i].expand(b, 1))
                out.append(logits[:, 0])
        return torch.stack(out, 1), cache

    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    both, cache = run([0, 1], "kernel")
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    plain, _ = run([0, 1], "plain")
    alone = torch.cat([run([i], "kernel")[0] for i in (0, 1)])
    reading = dict(
        layers=cfg.num_layers, steps=both.shape[1],
        plain_max_abs_err=float((both - plain).abs().max()),
        alone_max_abs_err=float((both - alone).abs().max()),
        rows_apart=float((both[0] - both[1]).abs().max()),
        cross_rows_apart=float((cache["ck"][:, 0]
                                - cache["ck"][:, 1]).abs().max()),
        launches=launches)
    emit("encdec_frames", **reading)
    if reading["plain_max_abs_err"] > 1e-3 \
            or reading["alone_max_abs_err"] > 1e-3:
        raise AssertionError(f"distinct frames: {reading}")
    if reading["rows_apart"] < 1e-2 or reading["cross_rows_apart"] == 0:
        raise AssertionError(f"distinct frames gave equal rows: {reading}")
    return reading


def encdec_tick_bound(params, cfg, reqs, hw):
    """Bytes a decode tick must read: every decoder weight it uses once
    (the tied token table once, by the unembedding; not the encoder's,
    nor the cross-attention's K and V projections, whose outputs are
    cached), and the live rows' cross K/V (every request live, 1,500
    positions a layer) and self K/V (each at its prompt plus half its
    new tokens, the run's mean); and the time at the card's memory
    rate.  The kernels read every slot's cross cache, dead slots'
    too."""
    dec = params["dec_blocks"]
    weights = tree_bytes(dec) - tree_bytes(
        {k: dec["cross"][k] for k in ("wk", "wv")}) \
        + tree_bytes(params["embed"]) + tree_bytes({"f": params["ln_f"]})
    es = params["ln_f"].element_size()
    kv_row = cfg.num_layers * max(cfg.num_kv_heads, 1) * cfg.head_dim * 2 \
        * es
    cross = len(reqs) * cfg.encoder_tokens * kv_row
    self_kv = int(sum(len(p) + m / 2 for p, m in reqs) * kv_row)
    total = weights + cross + self_kv
    return dict(tick_bytes=total, weight_bytes=weights, cross_bytes=cross,
                self_kv_bytes=self_kv, tick_bound_ms=total / hw.mem_bw * 1e3)


def encdec_phase(device, hw, timer, cfg):
    """whisper-medium at full width: its kernel rows
    (``encdec_kernel_rows``); in float32 cut to ``ENCDEC_FP32_LAYERS``
    encoder and decoder layers on each path of ``ENCDEC_FP32_RUNS``,
    kernels against ``force("plain")`` (``kernel_plain``: identical
    streams, first decode-step logits within 1e-3, each kernel at its
    exact count, ``encdec_launches``, nothing by plain), and the
    distinct-frames check (``distinct_frames_check``); in bf16 at full
    depth on the engine's default options with ``engine_run``'s gates,
    the exact counts and the tick's bound (``encdec_tick_bound``), its
    unembedding (``unembed_check``), then teacher-forced against plain
    with the planted fault at the last layer's cross read (``teacher_run``,
    ``TEACHER_TOL``), on ``ENCDEC_REQUESTS`` seeded prompts of 16-160
    tokens with ``ENCDEC_NEW`` new tokens each.  Returns the runs and the
    kernel rows; each model is freed before the next."""
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeEngine

    rows = encdec_kernel_rows(cfg, hw, device, timer)
    emit("encdec_kernels", card=nvidia_smi(), results=rows)
    whisper = get_config("whisper-medium")
    ereqs = requests(ENCDEC_REQUESTS, *ENCDEC_PROMPT, ENCDEC_NEW,
                     whisper.vocab_size, SEED + 4)
    if len({tuple(p) for p, _ in ereqs}) != len(ereqs):
        raise AssertionError("the teacher-forced runs key steps by prompt")
    runs = {}
    f32 = dataclasses.replace(whisper, dtype="float32",
                              num_layers=ENCDEC_FP32_LAYERS,
                              encoder_layers=ENCDEC_FP32_LAYERS)
    params, init_s = draw_weights(f32, device)
    for label, path in ENCDEC_FP32_RUNS.items():
        opts, chunk, _ = ENGINE_RUNS[path]
        reading, modes = kernel_plain(
            lambda: ServeEngine(f32, slots=8, max_len=1024,
                                prefill_chunk=chunk, params=params,
                                seed=SEED, device=device, **opts), ereqs)
        ticks = modes["kernel"][0].summary.decode_steps
        expected = encdec_launches(f32, path, len(ereqs), ticks)
        runs[label] = dict(arch=f32.name, dtype="float32", path=path,
                           layers=f32.num_layers, init_s=init_s,
                           decode_ticks=ticks, expected_launches=expected,
                           **reading)
        emit("encdec", run=label, **runs[label])
        check_kernel_plain(label, reading, set(expected))
        check_exact_launches(label, reading["launches"], expected)
    runs["whisper_frames"] = distinct_frames_check(f32, params, device, hw)
    del params
    free_cuda()

    params, init_s = draw_weights(whisper, device)
    unembed_check("whisper_bf16", params, device)
    bound = encdec_tick_bound(params, whisper, ereqs, hw)
    opts, chunk, _ = ENGINE_RUNS["chunked"]

    def engine():
        return ServeEngine(whisper, slots=8, max_len=1024,
                           prefill_chunk=chunk, params=params, seed=SEED,
                           device=device, **opts)

    keys = {"flash_attention", *ENCDEC_DECODE_READS["chunked"]}
    run, outs = engine_run("whisper_bf16", engine(), ereqs, opts, keys,
                           phase="encdec",
                           extra=lambda: {"init_s": init_s, **bound})
    check_exact_launches("whisper_bf16", run["launches"], encdec_launches(
        whisper, "chunked", len(ereqs), run["decode_ticks"]))
    last = whisper.num_layers - 1
    run["teacher"] = teacher_run(
        "whisper_bf16", engine, ereqs, outs, TEACHER_TOL[whisper.name],
        fault=lambda c: WrongGroup(c.num_layers, last, "decode_attention"),
        phase="encdec")
    runs["whisper_bf16"] = run
    del params
    free_cuda()
    return runs, rows


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

# --------------------------------------------------------------------------- #
# prefix
# --------------------------------------------------------------------------- #

#: the prefix phase's mix: a 200-token system prompt (12 full blocks of
#: 16 and an 8-token tail) in front of ``PREFIX_SHARERS`` requests with
#: private suffixes of ``PREFIX_SUFFIX`` tokens, each ``PREFIX_NEW`` new
#: tokens; then chat turns (``("turn", i)``: request i's prompt plus
#: ``PREFIX_TURN`` new tokens) and a regenerate (``("repeat", i)``:
#: request i's prompt again), each placed at least three positions after
#: its donor, so that with 2 slots the donor has retired (and its prompt's
#: tail block is indexed) before the turn reaches the head of the queue
PREFIX_PREAMBLE = 200
PREFIX_SHARERS = 8
PREFIX_SUFFIX = ("uniform", 8, 64)
PREFIX_NEW = 16
PREFIX_TURN = 24
PREFIX_ORDER = (0, 1, 2, 3, 4, 5, ("turn", 0), 6, ("turn", 1), 7,
                ("repeat", 2))
PREFIX_SLOTS = 2
#: the cold and shared runs: label -> the ``ENGINE_RUNS`` path
PREFIX_RUNS = {"default": "chunked", "int8": "int8", "gather": "gather",
               "int8_gather": "int8_gather"}
#: the tight run's lattice: from 512, so that its block budget is not
#: topped up by growth (the pool gains the grid's new blocks at each step)
PREFIX_TIGHT_MIN_LEN = 512
#: the gang run serves the mix's first requests (two batches of two): on
#: all 11 the phase took 102 s on an H100, over its 90 s target
PREFIX_GANG_REQUESTS = 4


def prefix_mix(vocab, n=PREFIX_SHARERS, new=PREFIX_NEW, order=PREFIX_ORDER,
               seed=SEED):
    """(prompt, new tokens) per request, through the port's own
    ``synthesize`` (``TrafficConfig.shared_prefix``)."""
    from repro_torch.serve import TrafficConfig, synthesize

    base = [r.prompt for r in synthesize(TrafficConfig(
        n_requests=n, mode="closed", prompt_dist=PREFIX_SUFFIX,
        output_dist=("fixed", new, 0), vocab=vocab, seed=seed,
        shared_prefix=(PREFIX_PREAMBLE, 1.0)))]
    rng = np.random.default_rng(seed)
    out = []
    for item in order:
        if isinstance(item, int):
            out.append((base[item], new))
        elif item[0] == "turn":
            out.append((base[item[1]]
                        + rng.integers(1, vocab, size=PREFIX_TURN).tolist(),
                        new))
        else:
            out.append((list(base[item[1]]), new))
    return out


def tight_blocks(reqs, block_size=16):
    """The least block budget that seats the two longest requests at
    once over the shared preamble's full blocks: below what the radix
    indexes over the mix, so admission must evict."""
    lease = max(-(-(len(p) + m) // block_size) for p, m in reqs)
    return PREFIX_SLOTS * lease - PREFIX_PREAMBLE // block_size


class PrefixSpies:
    """What the prefix runs must show the kernels were given: the flash
    launches' ``q_offset`` (a spy on the model's call of the wrapper), the
    decode ticks whose block tables hold one physical id in two live rows
    (a spy on ``decode_step``'s argument) and the prefill chunks (a spy
    on ``prefill_chunk``).  ``watch`` attaches the engine spies; the
    flash spy holds from ``__enter__`` to ``__exit__``."""

    def __enter__(self):
        from repro_torch.models import transformer

        self.module, self.flash = transformer, transformer.flash_attention

        def flash(*a, **kw):
            self.offsets.append(int(kw.get("q_offset", 0)))
            return self.flash(*a, **kw)
        transformer.flash_attention = flash
        self.offsets, self.aliased, self.ticks, self.chunks = [], 0, 0, 0
        return self

    def __exit__(self, *exc):
        self.module.flash_attention = self.flash

    def watch(self, eng):
        self.offsets.clear()
        self.aliased = self.ticks = self.chunks = 0
        step, chunk = eng.model.decode_step, eng.model.prefill_chunk

        def decode_step(*a, **kw):
            tables = kw.get("page_tables")
            if tables is not None:
                t = tables.cpu().numpy()
                rows = [set(r[r >= 0].tolist()) for r in t]
                seen, shared = set(), False
                for r in rows:
                    shared |= bool(seen & r)
                    seen |= r
                self.aliased += shared
            self.ticks += 1
            return step(*a, **kw)

        def prefill_chunk(*a, **kw):
            self.chunks += 1
            return chunk(*a, **kw)
        eng.model.decode_step = decode_step
        eng.model.prefill_chunk = prefill_chunk

    def readings(self):
        return {"prefill_chunks": self.chunks, "aliased_ticks": self.aliased,
                "flash_q_offsets_off_16": sorted(
                    {o for o in self.offsets if o % 16})}


def prefix_phase(device, params):
    """smollm-135m at full width, TUNED, chunk "auto", ``max_len`` 1024,
    ``PREFIX_SLOTS`` slots, on ``prefix_mix``: cold (``prefix_cache=
    False``) and shared on each path of ``PREFIX_RUNS``, then the shared
    default path at ``tight_blocks`` (from a 512 lattice floor) and the
    default path under ``admission="gang"``, radix off, on the mix's
    first ``PREFIX_GANG_REQUESTS`` requests.  Gates: on every
    shared run at least 6 hits and 6 x 192 hit tokens, fewer prefill
    chunks than cold, a decode tick with aliased tables, a flash launch
    at a ``q_offset`` off the 16 grid and the path's kernels as
    ``engine_run`` checks them; on the tight run evictions, hits and
    every request completed; on the gang run every request completed."""
    from repro_torch.configs import get_config
    from repro_torch.serve import BucketSpec, ServeEngine

    reqs = prefix_mix(get_config("smollm-135m").vocab_size)
    tight = tight_blocks(reqs)
    emit("prefix_mix", requests=len(reqs),
         prompt_lens=[len(p) for p, _ in reqs], preamble=PREFIX_PREAMBLE,
         order=[list(o) if isinstance(o, tuple) else o
                for o in PREFIX_ORDER], tight_blocks=tight)

    def engine(**kw):
        return ServeEngine("smollm-135m", reduced=False, slots=PREFIX_SLOTS,
                           max_len=1024, prefill_chunk="auto", params=params,
                           seed=SEED, device=device, **kw)

    runs, summary = {}, {}
    with PrefixSpies() as spies:
        for label, path in PREFIX_RUNS.items():
            opts, _, expected = ENGINE_RUNS[path]
            for shared in (False, True):
                name = f"{label}_{'shared' if shared else 'cold'}"
                eng = engine(prefix_cache=shared, **opts)
                spies.watch(eng)
                runs[name], _ = engine_run(
                    name, eng, reqs, dict(opts, prefix_cache=shared),
                    expected, phase="prefix", extra=spies.readings)
            cold, hot = runs[f"{label}_cold"], runs[f"{label}_shared"]
            rx = hot["radix"]
            summary[label] = dict(
                ttft_p50_ms=[cold["ttft_p50_ms"], hot["ttft_p50_ms"]],
                ttft_p95_ms=[cold["ttft_p95_ms"], hot["ttft_p95_ms"]],
                prefill_chunks=[cold["prefill_chunks"],
                                hot["prefill_chunks"]],
                hit_rate=rx["hit_rate"], hits=rx["hits"],
                hit_tokens=rx["hit_tokens"])
            if rx["hits"] < 6 or rx["hit_tokens"] < 6 * 192:
                raise AssertionError(f"prefix {label}: {rx['hits']} hits, "
                                     f"{rx['hit_tokens']} hit tokens")
            if hot["prefill_chunks"] >= cold["prefill_chunks"]:
                raise AssertionError(
                    f"prefix {label}: {hot['prefill_chunks']} prefill "
                    f"chunks shared, {cold['prefill_chunks']} cold")
            if not hot["aliased_ticks"]:
                raise AssertionError(f"prefix {label}: no decode tick with "
                                     f"a physical block in two live rows")
            if not hot["flash_q_offsets_off_16"]:
                raise AssertionError(f"prefix {label}: no flash launch at a "
                                     f"q_offset off the 16 grid")
        opts, _, expected = ENGINE_RUNS["chunked"]
        eng = engine(prefix_cache=True, total_blocks=tight,
                     spec=BucketSpec(max_len=1024,
                                     min_len=PREFIX_TIGHT_MIN_LEN))
        spies.watch(eng)
        runs["tight"], _ = engine_run(
            "tight", eng, reqs, dict(prefix_cache=True, total_blocks=tight,
                                     min_len=PREFIX_TIGHT_MIN_LEN),
            expected, phase="prefix", extra=spies.readings)
        rx = runs["tight"]["radix"]
        summary["tight"] = dict(total_blocks=tight, **rx)
        if rx["evicted_blocks"] <= 0 or rx["hits"] <= 0:
            raise AssertionError(f"prefix tight: {rx}: the budget of {tight} "
                                 f"blocks did not make the radix evict")
    gang = reqs[:PREFIX_GANG_REQUESTS]
    eng = engine(admission="gang")
    runs["gang"], outs = engine_run("gang", eng, gang, dict(admission="gang"),
                                    expected, phase="prefix")
    emit("prefix_gang", streams=[o[len(p):] for (p, _), o in zip(gang, outs)])
    emit("prefix_summary", **summary)
    return runs


# --------------------------------------------------------------------------- #
# profile
# --------------------------------------------------------------------------- #

#: profiled runs: label -> (arch, engine options, requests of the mix).
#: mamba2 is cut to the mix's first request (and ``MAMBA_LAYERS``
#: layers): on its 4 (1,389 prompt tokens, ~4.1M device kernels, each
#: prompt token a 48-layer decode step) the phase took 329 s and the
#: smoke 694 s
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
            return ServeEngine(engine_config(arch), slots=8, max_len=1024,
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
    decode paths: kernels vs plain on the same requests
    (``kernel_plain``)."""
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config("smollm-135m"), dtype="float32")
    reqs = requests(6, 16, 200, 16, cfg.vocab_size, SEED + 1)
    params, _ = draw_weights(cfg, device)
    for label, (opts, _, expected) in ENGINE_RUNS.items():
        if label == "whole_prompt":
            continue
        reading, _ = kernel_plain(
            lambda: ServeEngine(cfg, slots=8, max_len=1024, params=params,
                                seed=SEED, device=device, **opts), reqs)
        emit("parity", run=label, options=opts, **reading)
        check_kernel_plain(label, reading, expected)
    parity_prefix(cfg, params, device)


def parity_prefix(cfg, params, device):
    """The radix on, fp32 at full width, ``PREFIX_SLOTS`` slots, on a
    4-request sharing mix with 8 new tokens (requests 3 and 4 hit):
    ``prefix`` at the prefix phase's tight budget, ``prefix_int8`` on the
    int8 pool.  Kernel vs plain (``kernel_plain``): identical streams,
    first decode logits within 1e-3, the path's kernels; and the kernel
    run's streams equal to the same engine's with the radix off (a gate
    on the fp32 pool, a reading on int8)."""
    from repro_torch.serve import BucketSpec, ServeEngine

    reqs = prefix_mix(cfg.vocab_size, n=4, new=8, order=(0, 1, 2, 3),
                      seed=SEED + 1)
    tight = tight_blocks(prefix_mix(cfg.vocab_size))
    labels = {"prefix": ("chunked", dict(total_blocks=tight, spec=BucketSpec(
                  max_len=1024, min_len=PREFIX_TIGHT_MIN_LEN))),
              "prefix_int8": ("int8", dict(kv_dtype="int8"))}
    for label, (path, opts) in labels.items():
        def engine(shared=True):
            return ServeEngine(cfg, slots=PREFIX_SLOTS, max_len=1024,
                               params=params, seed=SEED, device=device,
                               prefix_cache=shared, **opts)

        first = {}
        _, cold = serve(keep_first_logits(engine(False), first, "cold"),
                        reqs)
        reading, out = kernel_plain(engine, reqs)
        report, shared, first["kernel"] = out["kernel"]
        radix = report.radix
        emit("parity", run=label, options={k: str(v) for k, v in
                                           opts.items()},
             shared_equals_cold=shared == cold,
             cold_first_decode_logits_max_abs_err=float(
                 (first["kernel"] - first["cold"]).abs().max()),
             radix=radix, **reading)
        check_kernel_plain(label, reading, ENGINE_RUNS[path][2])
        if radix["hit_tokens"] < 2 * 192:
            raise AssertionError(f"{label}: requests 3 and 4 did not share "
                                 f"the preamble: {radix}")
        if label == "prefix" and shared != cold:
            raise AssertionError(f"{label}: the radix changed the fp32 "
                                 f"token streams")


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
        dense = timed("dense", dense_phase, device, reqs)
        moe = timed("moe", moe_phase, device, reqs, hw)
        hybrid, hybrid_rows = timed("hybrid", hybrid_phase, device, hw,
                                    timer, cfg)
        encdec, encdec_rows = timed("encdec", encdec_phase, device, hw,
                                    timer, cfg)
        timed("retune", retune_phase, device, params, reqs, tmp)
        prefix_runs = timed("prefix", prefix_phase, device,
                            params["smollm-135m"])
        timed("profile", profile_phase, device, params, reqs)
        timed("parity", parity_phase, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("timing", seconds=phase_s)

    for rows in (hybrid_rows, encdec_rows):
        for name, cases in rows.items():
            kres[name] += cases
    summary = []
    for name, cases in kres.items():
        main_case = cases[0]
        src, replaces, run = SERVING_KERNELS[name]
        summary.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}.cu",
            "replaces": replaces,
            "launches": runs[run]["launches"][name],
            # the prefix phase's cold, shared, tight and gang runs
            "prefix_launches": sum(r["launches"][name]
                                   for r in prefix_runs.values()),
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
        # the dense, moe, hybrid and encdec phases' variants: each case's
        # numbers and the launches of the run that takes it (0: none does)
        summary[-1]["variants"] = [{
            "variant": c["variant"], "shape": c["shape"],
            "dtype": c["timed_dtype"], "max_abs_err": c["max_abs_err"],
            "ms": c["kernel_ms"], "plain_ms": c["plain_ms"],
            "library_ms": c["library_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "plan": c.get("plan"),
            "split_sweep_ms": c.get("split_sweep_ms"),
            "run": c["run"],
            "launches": ({**dense, **moe, **hybrid, **encdec}[c["run"]][
                "launches"][name] if c["run"] else 0)}
            for c in cases if "variant" in c]
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
