"""Serving CLI — synthetic Poisson traffic through the port's engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --full \\
        --requests 12 --slots 8 --max-len 1024 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b --full

``--arch`` takes any registered config (``repro_torch.configs``:
smollm-135m, qwen3-8b, nemotron-4-340b, deepseek-moe-16b,
qwen3-moe-235b-a22b, mamba2-1.3b, zamba2-7b, whisper-medium).

Runs on the CUDA device by default and raises without one;
``--device cpu`` runs the kernels' plain versions (reduced width is the
default; ``--full`` serves the published width).  ``--policy`` (default
tuned) plans the buckets' kernels; ``--measure`` (default cached) says
how a TUNED cache miss is judged: "cached" by times recorded in the
profiler's store (none yet: the roofline's pick), "live" by CUDA-event
times taken now and recorded, "off" by the roofline alone.
``--trace PATH`` writes the run's trace (``.json``: Perfetto's form, else
the JSONL log; ``tools/trace_view_torch.py`` reads either) and
``--retune inline|background`` runs the live retune loop.
``--prefix-cache`` turns on radix prefix sharing and ``--shared-prefix
N`` gives 90% of the requests one common N-token preamble (the traffic
it exists for); ``--bucket-mode`` picks the length lattice.  Prints the
run's summary (with the radix line when sharing engaged), writes it to
``--metrics-json PATH`` when asked and, as its last line, prints it as
JSON.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.mapper import MappingPolicy
from repro_torch.obs import Tracer, write_trace
from repro_torch.serve import BucketSpec, ServeEngine, TrafficConfig, drive
from repro_torch.serve.buckets import BUCKET_MODES
from repro_torch.serve.retune import RETUNE_MODES
from repro_torch.tuner import MEASURE_MODES


def parse_chunk(value: str):
    """``--prefill-chunk`` value: "auto", "none" (whole prompts) or N."""
    if value == "none":
        return None
    return value if value == "auto" else int(value)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="open-loop Poisson arrivals per second")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--mode", choices=("open", "closed"), default="open")
    ap.add_argument("--no-paged", action="store_true",
                    help="serve from contiguous cache rows instead of the "
                         "paged pool (contiguous decode kernel)")
    ap.add_argument("--kv-dtype", choices=("fp32", "int8"), default="fp32",
                    help="KV pool storage: fp32 keeps the model's dtype, "
                         "int8 stores symmetric per-(block, head) codes + "
                         "scales, dequantised inside the decode read; "
                         "requires the paged pool")
    ap.add_argument("--bucket-mode", choices=BUCKET_MODES, default="pow2",
                    help="the length lattice (the paged pool needs a "
                         "finite one: 'exact' only with --no-paged)")
    ap.add_argument("--prefill-chunk", metavar="N|auto|none", default="auto",
                    help="prefill in N-token chunks between decode ticks; "
                         "'auto' uses the bucket's flash block_q, 'none' "
                         "prefills whole prompts")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix sharing: requests whose prompts "
                         "share a leading token run map the same physical "
                         "KV blocks and resume prefill mid-prompt; engages "
                         "on the paged, chunked dense path, a no-op "
                         "elsewhere (moe, ssm, hybrid and encdec included)")
    ap.add_argument("--shared-prefix", type=int, metavar="N", default=0,
                    help="give 90%% of the requests one common N-token "
                         "preamble (0: independent prompts)")
    ap.add_argument("--policy", default="tuned",
                    choices=[p.value for p in MappingPolicy],
                    help="how the router plans each bucket's kernels")
    ap.add_argument("--measure", choices=MEASURE_MODES, default="cached",
                    help="a TUNED cache miss: cached replays recorded "
                         "times, live times the candidates on the device, "
                         "off is the roofline alone")
    ap.add_argument("--retune", choices=RETUNE_MODES, default="off",
                    help="live retuning: drift-flagged buckets are "
                         "re-resolved over the serving-fed trace store and "
                         "trialled on real decode ticks, a slower "
                         "candidate never adopted; 'inline' re-resolves "
                         "between ticks, 'background' on a worker thread")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write the run's trace here (.json: Perfetto's "
                         "form, else versioned JSONL)")
    ap.add_argument("--metrics-json", metavar="PATH", default=None,
                    help="write the run's summary here as JSON")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the traffic and the random weights")
    ap.add_argument("--full", action="store_true",
                    help="serve the published width (default: reduced)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    vocab = (cfg if args.full else cfg.reduced()).vocab_size
    # the paged pool needs whole-block rows (block_size=16)
    max_len = -(-args.max_len // 16) * 16
    rng = np.random.default_rng(args.seed)
    hi = max(8, max_len - args.max_new - 1)
    traffic = TrafficConfig(
        n_requests=args.requests, rate=args.rate, mode=args.mode,
        prompt_dist=("uniform", 4, min(hi, 48)),
        output_dist=("uniform", 2, args.max_new),
        concurrency=args.slots, vocab=vocab,
        seed=int(rng.integers(1 << 30)),
        shared_prefix=((args.shared_prefix, 0.9)
                       if args.shared_prefix else None))
    engine = ServeEngine(
        args.arch, slots=args.slots, max_len=max_len,
        reduced=not args.full, paged=not args.no_paged,
        spec=BucketSpec(max_len=max_len, mode=args.bucket_mode),
        kv_dtype=args.kv_dtype, prefix_cache=args.prefix_cache,
        prefill_chunk=parse_chunk(args.prefill_chunk), seed=args.seed,
        policy=args.policy, measure=args.measure, device=args.device,
        tracer=Tracer() if args.trace else None, retune=args.retune,
        verbose=True)
    report = drive(engine, traffic)
    s = report.summary
    print(f"[serve] ttft p50/p95 {s.ttft_p50_s * 1e3:.1f}/"
          f"{s.ttft_p95_s * 1e3:.1f} ms, tpot p50 {s.tpot_p50_s * 1e3:.2f} ms, "
          f"{s.tokens_per_s:.1f} tok/s, util {s.utilization:.2f}, "
          f"pool growths {report.pool_growths}, router {report.router_stats}")
    if report.retune is not None:
        st = report.retune["stats"]
        print(f"[serve] retune: scans={st['scans']} trials={st['trials']} "
              f"adopted={st['adopted']} rejected={st['rejected']}")
    if report.radix is not None:
        rx = report.radix
        print(f"[serve] radix: hit rate {rx['hit_rate']:.2f} "
              f"({rx['hits']}/{rx['lookups']}), "
              f"{rx['hit_tokens']} prompt tokens reused, "
              f"{rx['evicted_blocks']} blocks evicted")
    if args.trace:
        path = write_trace(engine.obs, args.trace)
        print(f"[serve] trace ({len(engine.obs.spans())} spans) -> {path}")
    payload = {"summary": s.as_dict(), "router_stats": report.router_stats,
               "pool_growths": report.pool_growths,
               "n_rejected": len(report.rejected), "retune": report.retune,
               "radix": report.radix}
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        print(f"[serve] metrics -> {args.metrics_json}")
    print(json.dumps(payload, sort_keys=True))
    return payload


if __name__ == "__main__":
    main()
