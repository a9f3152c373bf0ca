"""Serving CLI — synthetic Poisson traffic through the port's engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --full \\
        --requests 12 --slots 8 --max-len 1024 --max-new 32

Runs on the CUDA device by default and raises without one;
``--device cpu`` runs the kernels' plain versions (reduced width is the
default; ``--full`` serves the published width).  ``--policy`` (default
tuned) plans the buckets' kernels; ``--measure`` (default cached) says
how a TUNED cache miss is judged: "cached" by times recorded in the
profiler's store (none yet: the roofline's pick), "live" by CUDA-event
times taken now and recorded, "off" by the roofline alone.
``--trace PATH`` writes the run's trace (``.json``: Perfetto's form, else
the JSONL log; ``tools/trace_view_torch.py`` reads either) and
``--retune inline|background`` runs the live retune loop.  Prints the
run's summary and, as its last line, the summary as JSON.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.mapper import MappingPolicy
from repro_torch.obs import Tracer, write_trace
from repro_torch.serve import ServeEngine, TrafficConfig, drive
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
    ap.add_argument("--prefill-chunk", metavar="N|auto|none", default="auto",
                    help="prefill in N-token chunks between decode ticks; "
                         "'auto' uses the bucket's flash block_q, 'none' "
                         "prefills whole prompts")
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
        seed=int(rng.integers(1 << 30)))
    engine = ServeEngine(
        args.arch, slots=args.slots, max_len=max_len,
        reduced=not args.full, paged=not args.no_paged,
        kv_dtype=args.kv_dtype,
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
    if args.trace:
        path = write_trace(engine.obs, args.trace)
        print(f"[serve] trace ({len(engine.obs.spans())} spans) -> {path}")
    payload = {"summary": s.as_dict(), "router_stats": report.router_stats,
               "pool_growths": report.pool_growths,
               "n_rejected": len(report.rejected), "retune": report.retune}
    print(json.dumps(payload, sort_keys=True))
    return payload


if __name__ == "__main__":
    main()
