"""The smoke's kernels phase alone, for one checkout, on one GPU.

    python3 tools/kernels_ab.py [--root DIR] [--out PATH]

Loads ``DIR/chip_smoke.py`` (default: this checkout) with ``DIR/src`` first
on the path, builds that checkout's kernels into its own
``build/repro_torch/``, sets the card up as the smoke's ``main`` does
(float32 products without TF32, a tuning cache and trace store of the
run's own) and runs its ``kernels_phase``: every serving kernel held
against its plain version and timed with CUDA events.  Then it times, with
the checkout's own helpers, cases that phase does not time and that both
a change and its parent take (``EXTRA_DECODE``, the f32 flash at
smollm-135m's head_dim 64).  Prints one JSON line, and writes it to PATH
if given: the root, the card's name and power limit, ptxas's register and
spill lines for the attention kernels, the phase's results and the extra
cases.

To compare a change with its parent on one card, unpack the parent into
``build/`` (git-ignored, and a directory pytest never collects: a tree
under another directory puts a second copy of every test file into the
checkout's test run) and run both in one call, parent first and last:

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 tools/kernels_ab.py --root $r; done
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import shutil
import sys
import tempfile

import torch

ATTENTION_SOURCES = ("flash_attention", "decode_attention",
                     "paged_decode_attention")
#: (G, R, D) of the paged decode's extra cases: 8 heads a CTA at 4 values
#: a lane, the sweep's widest register arrays
EXTRA_DECODE = ((3, 8, 64), (8, 8, 128))


def extra_cases(smoke, hw, timer, device) -> list:
    """Each case against its plain version (largest |difference|) and
    its CUDA-event time: flash in float32 at smollm-135m's heads (a 512
    prompt, a 64-row chunk at ``q_offset`` 448), and the paged decode,
    bf16 and int8, at each ``EXTRA_DECODE`` geometry over the smoke's
    ragged lengths at AUTO's plan."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.mapper import (plan_attention_blocks,
                                         plan_decode_split, plan_paged_block)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention

    cfg = get_config("smollm-135m")
    out = []

    def run(label, fn, case):
        args = {k: x for k, x in case.items() if not k.endswith("_bytes")}
        got = fn(**args)
        with kernels.force("plain"):
            want = fn(**args)
        err = float((got.float() - want.float()).abs().max())
        out.append(dict(case=label, max_abs_err=err,
                        ms=timer.ms(lambda: fn(**args), head_start=True)))

    for sq, off in ((512, 0), (64, 448)):
        p = plan_attention_blocks(sq, 512, cfg.head_dim, hw)
        run(f"flash f32 D 64: {sq} queries at q_offset {off}, tiles "
            f"({p.block_q}, {p.block_k})", flash_attention,
            smoke.flash_case(cfg, sq, 512, off, (p.block_q, p.block_k),
                             device, torch.float32))
    for g, r, d in EXTRA_DECODE:
        c = dataclasses.replace(cfg, num_kv_heads=g, num_heads=g * r,
                                head_dim=d)
        bs = plan_paged_block(1024, d, 16, hw, heads_per_group=r)
        w = plan_decode_split(1024, 8 * g, bs, d, hw, heads_per_group=r,
                              page_block=16)
        for quant in (False, True):
            case = smoke.decode_case(c, bs, device, torch.bfloat16, w)
            if quant:
                case = smoke.int8_pool(
                    case, torch.Generator().manual_seed(smoke.SEED + 2))
            run(f"paged decode {'int8' if quant else 'bf16'} G {g} R {r} "
                f"D {d}, block_s {bs}, W {w}", paged_decode_attention, case)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(
        pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke      # its dataclasses look it up
    spec.loader.exec_module(smoke)

    from repro_torch.configs import get_config
    from repro_torch.core.hw import detect
    from repro_torch.kernels import _build
    from repro_torch.profiler import TraceStore, set_default_store
    from repro_torch.tuner import TuningCache, set_default_cache

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    hw = detect(device)
    build_s = _build.build_all()
    ptxas = {n: [ln.strip() for ln in _build.ptxas_report(n).splitlines()
                 if "entry function" in ln or "spill" in ln
                 or "registers" in ln]
             for n in ATTENTION_SOURCES}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="kernels_ab_")
    try:
        set_default_cache(TuningCache(f"{tmp}/tuning_cache.json"))
        set_default_store(TraceStore(f"{tmp}/traces.jsonl"))
        timer = smoke.Timer(device)
        results = smoke.kernels_phase(get_config("smollm-135m"), hw, timer,
                                      device)
        extra = extra_cases(smoke, hw, timer, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = json.dumps({"root": str(root), "card": smoke.nvidia_smi(),
                       "build_s": build_s, "ptxas": ptxas,
                       "results": results, "extra": extra},
                      sort_keys=True, default=str)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
