"""Probe: how far a bf16 stream's kernel run is from its plain run.

    python3 tools/dense_stream_probe.py [--layers N] [--new N]

Serves nemotron-4-340b at its published width, cut to ``--layers``
layers (default 2, as the smoke's ``dense`` phase), in bf16 with the
smoke's seeded weights and its first 3 requests of the engine mix, on
the default and the int8 paths: once with ``kernels.force("plain")``,
then with the kernels, with flash alone run plain, with the decode
kernels alone run plain, and with all three run plain through the same
patches (the control, which must match the plain run exactly).  For each
run it records every decode step's logits and compares them with the
plain run's tick by tick, up to the first tick whose greedy picks differ.
Prints one JSON line a run: whether the token streams are equal, the
largest |logit difference| of each compared tick, the plain run's
smallest top-2 margin of each tick, and at the first divergence the
plain run's margin between the two picks.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

REQUESTS = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--new", type=int, default=8,
                    help="new tokens a request")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dense_stream_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import attention, transformer
    from repro_torch.serve import ServeEngine
    from repro_torch.tuner import TuningCache, set_default_cache

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="dense_stream_probe_")
    cfg = dataclasses.replace(get_config("nemotron-4-340b"),
                              num_layers=args.layers)
    params, _ = smoke.draw_weights(cfg, device)
    mix = smoke.requests(12, 16, 600, 32,
                         get_config("smollm-135m").vocab_size, smoke.SEED)
    reqs = [(p, args.new) for p, _ in mix[:REQUESTS]]
    sites = {(attention, "flash_attention"), (transformer, "flash_attention"),
             (attention, "paged_decode_attention"),
             (attention, "decode_attention")}
    orig = {site: getattr(*site) for site in sites}

    def plain_of(fn):
        def call(*a, **kw):
            with kernels.force("plain"):
                return fn(*a, **kw)
        return call

    def run(mode, opts, plain_names=()):
        for (mod, name), fn in orig.items():
            setattr(mod, name, plain_of(fn) if name in plain_names else fn)
        set_default_cache(TuningCache(f"{tmp}/cache_{run.n}.json"))
        run.n += 1
        eng = ServeEngine(cfg, slots=8, max_len=1024, params=params,
                          seed=smoke.SEED, device=device, **opts)
        step, logits = eng.model.decode_step, []

        def spy(*a, **kw):
            out = step(*a, **kw)
            logits.append(out[0].detach().float().reshape(
                -1, out[0].shape[-1]).clone())
            return out

        eng.model.decode_step = spy
        with kernels.force(mode):
            _, outs = smoke.serve(eng, reqs)
        return outs, logits
    run.n = 0

    card = smoke.nvidia_smi()
    for path, opts in (("default", {}), ("int8", {"kv_dtype": "int8"})):
        plain_outs, plain_logits = run("plain", opts)
        for label, names in (
                ("kernels", ()), ("flash plain", ("flash_attention",)),
                ("decode plain", ("paged_decode_attention",
                                  "decode_attention")),
                ("all plain by patch", ("flash_attention",
                                        "paged_decode_attention",
                                        "decode_attention"))):
            outs, logits = run("kernel", opts, names)
            line = dict(card=card, layers=args.layers, path=path, run=label,
                        streams_equal=outs == plain_outs,
                        max_abs_logit_diff=[], min_plain_margin=[])
            for tick, (a, b) in enumerate(zip(logits, plain_logits)):
                if a.shape != b.shape:
                    break
                top = b.topk(2, dim=-1).values
                line["max_abs_logit_diff"].append(
                    float((a - b).abs().max()))
                line["min_plain_margin"].append(
                    float((top[:, 0] - top[:, 1]).min()))
                pick, plain_pick = a.argmax(-1), b.argmax(-1)
                if not torch.equal(pick, plain_pick):
                    r = int((pick != plain_pick).nonzero()[0, 0])
                    line["first_divergence"] = dict(
                        tick=tick, row=r, plain_margin=float(
                            b[r, plain_pick[r]] - b[r, pick[r]]))
                    break
            print(json.dumps(line), flush=True)
    for (mod, name), fn in orig.items():
        setattr(mod, name, fn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
