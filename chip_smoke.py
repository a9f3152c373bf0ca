"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to account.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  env      torch/CUDA/nvcc versions, the card's name and power limit, the
           GpuParams ``detect()`` read and Eq. 1's ``hp``;
  build    nvcc seconds for every kernel in ``src/repro_torch/csrc``
           (all compiled in parallel) and each one's ptxas report;
  kernels  each kernel against its plain PyTorch version on the same
           inputs at smollm-135m's serving shapes, in float32 (atol = rtol
           = 2e-5: summation order only) and bfloat16 (atol = rtol =
           1.6e-2: two bf16 ulps near 1), with CUDA-event times (median of
           25 runs after warm-up, L2 flushed before each) of the kernel,
           the plain version and, where one exists, one PyTorch library
           call computing the same function, beside the roofline bound;
  engine   ``ServeEngine("smollm-135m", reduced=False)`` serving 12 seeded
           requests in bf16, once with chunked prefill (the default) and
           once with whole-prompt prefill; each kernel's launch count is
           reset just before each run and must be above 0 just after;
  profile  the chunked path on the mix's first 4 requests, unprofiled
           (wall time) and under torch.profiler (device time by kernel,
           busy time, idle share; no check: a reading);
  parity   the same engine in float32, once on the kernels and once under
           ``kernels.force("plain")``: identical token streams, first
           decode-step logits within atol 1e-3.

Then the card's name and power limit as nvidia-smi prints them, the
kernel summary as one JSON line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
exits non-zero and prints no result.  It needs one CUDA device and exits
non-zero without one.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 0
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

    def ms(self, fn, runs: int = 25, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            self.scratch.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


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


def decode_case(cfg, plan_block, device, dtype):
    """The decode tick's shapes at full width: 8 slots, a 1024-long pool,
    ragged cache lengths (1 included) over permuted pages, -1 tails."""
    rng = np.random.default_rng(SEED)
    b, t, pb = 8, 1024, 16
    g, r, d = cfg.num_kv_heads, cfg.heads_per_group, cfg.head_dim
    clen = np.array([1, 17, 128, 300, 512, 700, 1000, 1024], np.int32)
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
                page_block=pb, block_s=plan_block)


def flash_case(cfg, sq, sk, q_offset, tiles, device, dtype):
    gen = torch.Generator(device="cpu").manual_seed(SEED + sq)
    g, r, d = cfg.num_kv_heads, cfg.heads_per_group, cfg.head_dim

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(device=device,
                                                    dtype=dtype)

    return dict(q=rand(1, sq, g, r, d), k=rand(1, sk, g, d),
                v=rand(1, sk, g, d), block_q=tiles[0], block_k=tiles[1],
                q_offset=q_offset)


def decode_bound(case, hw):
    q, k = case["q"], case["k_cache"]
    b, g, r, d = q.shape
    es = q.element_size()
    n = int(case["cache_len"].clamp(max=k.shape[1]).sum())
    nbytes = (2 * n * g * d * es + 2 * q.numel() * es
              + case["tables"].numel() * 4 + b * 4)
    flops = 4 * n * g * r * d
    return bound(nbytes, flops, q.dtype, hw)


def flash_bound(case, hw):
    q, k = case["q"], case["k"]
    b, sq, g, r, d = q.shape
    sk, off = k.shape[1], case["q_offset"]
    pairs = sum(min(sk, i + off + 1) for i in range(sq))
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
    if off == 0 and sq == sk:
        return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                      is_causal=True)
    mask = (torch.arange(sk, device=q.device)[None, :]
            <= torch.arange(sq, device=q.device)[:, None] + off)
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)


def kernels_phase(cfg, hw, timer, device):
    from repro_torch import kernels
    from repro_torch.core.mapper import plan_attention_blocks, plan_paged_block
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention

    block_s = plan_paged_block(1024, cfg.head_dim, 16, hw,
                               heads_per_group=cfg.heads_per_group)
    p512 = plan_attention_blocks(512, 512, cfg.head_dim, hw)
    tiles = (p512.block_q, p512.block_k)
    results = {}

    def measure(name, fn, case, bound_fn, library):
        entry = {"max_abs_err": {}}
        for dtype in (torch.float32, torch.bfloat16):
            c = dict(case(dtype))
            got = fn(**c)
            with kernels.force("plain"):
                want = fn(**c)
            torch.cuda.synchronize()
            entry["max_abs_err"][str(dtype).split(".")[1]] = check_close(
                got, want, dtype, f"{name} {dtype}")
        c = case(torch.bfloat16)               # the serving dtype
        entry["kernel_ms"] = timer.ms(lambda: fn(**c))

        def plain():
            with kernels.force("plain"):
                fn(**c)
        entry["plain_ms"] = timer.ms(plain)
        entry["library_ms"] = timer.ms(library(c)) if library else None
        entry["bound_ms"], entry["bound_by"] = bound_fn(c, hw)
        return entry

    results["paged_decode_attention"] = [dict(
        shape=f"slots 8, pool 1024, block_s {block_s}",
        **measure("paged_decode_attention", paged_decode_attention,
                  lambda dt: decode_case(cfg, block_s, device, dt),
                  decode_bound, None))]
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
    ]
    return results


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


def engine_phase(device):
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.serve import ServeEngine

    counters = {"paged_decode_attention": pda.paged_decode_attention,
                "flash_attention": fa.flash_attention}
    vocab = get_config("smollm-135m").vocab_size
    reqs = requests(12, 16, 600, 32, vocab, SEED)
    runs = {}
    params = None
    for label, chunk in (("chunked", "auto"), ("whole_prompt", None)):
        eng = ServeEngine("smollm-135m", reduced=False, slots=8,
                          max_len=1024, prefill_chunk=chunk, params=params,
                          seed=SEED, device=device)
        params = eng.params
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        report, _ = serve(eng, reqs)
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        s = report.summary
        runs[label] = dict(
            completed=s.n_completed, output_tokens=s.output_tokens,
            tokens_per_s=s.tokens_per_s, wall_s=wall,
            ttft_p50_ms=s.ttft_p50_s * 1e3,
            decode_tick_p50_ms=s.decode_tick_p50_s * 1e3,
            decode_ticks=s.decode_steps, prefill_s=s.prefill_s,
            decode_s=s.decode_s,
            paged_decode_block=report.paged_decode_blocks,
            prefill_tiles={k: list(v) for k, v in
                           report.prefill_tiles.items()},
            launches=launches)
        emit("engine", run=label, **runs[label])
        if s.n_completed != len(reqs):
            raise AssertionError(f"{label}: {s.n_completed}/{len(reqs)} "
                                 f"completed")
        for k, n in launches.items():
            if n <= 0:
                raise AssertionError(f"{label}: {k} was never launched on "
                                     f"the main path")
    return runs, params, reqs


def profile_phase(device, params, reqs):
    """Where the device time of the chunked path goes: the first requests
    of the mix served once unprofiled (wall time) and once under
    torch.profiler tracing the device only (a full trace of the whole mix
    takes minutes to parse), self device time summed per kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServeEngine

    def engine():
        return ServeEngine("smollm-135m", reduced=False, slots=8,
                           max_len=1024, params=params, seed=SEED,
                           device=device)

    reqs = reqs[:4]
    eng = engine()
    t0 = time.perf_counter()
    serve(eng, reqs)
    wall = time.perf_counter() - t0
    eng = engine()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve(eng, reqs)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    emit("profile", requests=len(reqs), wall_s=wall, device_busy_ms=busy_ms,
         idle_share=1.0 - busy_ms / 1e3 / wall,
         top=[{"kernel": k[:80], "ms": ms, "count": n,
               "share": ms / busy_ms if busy_ms else 0.0}
              for k, ms, n in rows[:10]])


def parity_phase(device):
    """Full width in float32: kernels vs plain on the same requests."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config("smollm-135m"), dtype="float32")
    reqs = requests(6, 16, 200, 16, cfg.vocab_size, SEED + 1)
    streams, first = {}, {}
    params = None
    for mode in ("kernel", "plain"):
        eng = ServeEngine(cfg, slots=8, max_len=1024, params=params,
                          seed=SEED, device=device)
        params = eng.params
        step = eng.model.decode_step

        def spy(*a, _step=step, _mode=mode, **kw):
            out = _step(*a, **kw)
            first.setdefault(_mode, out[0].detach().clone())
            return out

        eng.model.decode_step = spy
        with kernels.force(mode):
            _, streams[mode] = serve(eng, reqs)
    same = streams["kernel"] == streams["plain"]
    err = float((first["kernel"] - first["plain"]).abs().max())
    emit("parity", token_streams_identical=same,
         first_decode_logits_max_abs_err=err,
         tokens=sum(len(s) for s in streams["kernel"]))
    if not same:
        raise AssertionError("fp32 token streams differ between the "
                             "kernels and their plain versions")
    if err > 1e-3:
        raise AssertionError(f"first decode-step logits differ by {err}")


# --------------------------------------------------------------------------- #


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
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], nvcc=nvcc.strip().splitlines()[-1],
         nvidia_smi=smi, gpu_params=dataclasses.asdict(hw), hp=hw.hp(),
         build_dir=str(_build.build_dir()))

    t0 = time.perf_counter()
    secs = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0, per_source=secs,
         ptxas={n: [ln for ln in _build.ptxas_report(n).splitlines()
                    if "registers" in ln or "spill" in ln]
                for n in _build.SOURCES})

    cfg = get_config("smollm-135m")
    # float32 products in full float32 (the plain versions' einsums)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = Timer(device)
    kres = kernels_phase(cfg, hw, timer, device)
    emit("kernels", card=smi, results=kres)
    runs, params, reqs = engine_phase(device)
    profile_phase(device, params, reqs)
    del params
    parity_phase(device)

    replaces = {
        "paged_decode_attention":
            "src/repro/kernels/paged_decode_attention.py:221",
        "flash_attention": "src/repro/kernels/flash_attention.py:31"}
    summary = []
    for name, cases in kres.items():
        main_case = cases[0]
        summary.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": runs["chunked"]["launches"][name],
            "max_abs_err": main_case["max_abs_err"]["bfloat16"],
            "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "shape": main_case["shape"]})
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
