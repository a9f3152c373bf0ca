"""Probe: the blur's two passes on one GPU, this tree's against another's.

    python3 tools/stencil_probe.py [OTHER_TREE]

Builds ``csrc/stencil.cu``, holds each pass bit for bit against its
plain version under every policy at the cases of ``CASES`` (the blur
cases of ``chip_smoke.py``: 256^2, 4096^2 f32 and bf16 at ksize 5, f32 at
ksize 7, and the two scalar-route cases: f32 (3000, 4001), whose rows
are not whole 16-byte vectors, and a bf16 4K frame starting 2 bytes past
a 16-byte boundary), and times each pass at the cases and policies of
``TIMED`` with ``chip_smoke.Timer`` (CUDA events, L2 flushed, the head
start), beside one ``F.conv2d`` a pass and a ``copy_`` of the image
(one read and one write of each pixel), with the plan (route, rows a
thread, strip width, grid) and the residency the CUDA runtime reports.

With OTHER_TREE (a checkout of another commit, e.g. unpacked from ``git
archive`` into a git-ignored directory), the two trees run in turns,
other / this / this / other, each in a process of its own that imports
that tree's ``repro_torch`` and builds into that tree's build directory.
Prints ptxas's lines for this tree's blur kernels, one JSON line a run,
then the card's name and power limit; exits 1 if a pass disagreed with
its plain version.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
POLICIES = ("naive", "fixed", "auto")
# (h, w, ksize), dtype, bytes past a 16-byte boundary
CASES = [((256, 256, 5), "float32", 0), ((4096, 4096, 5), "float32", 0),
         ((4096, 4096, 5), "bfloat16", 0), ((4096, 4096, 7), "float32", 0),
         ((3000, 4001, 5), "float32", 0), ((2160, 3840, 5), "bfloat16", 2)]
TIMED = {((4096, 4096, 5), "float32", 0): POLICIES,
         ((4096, 4096, 5), "bfloat16", 0): ("fixed", "auto"),
         ((4096, 4096, 7), "float32", 0): ("fixed", "auto"),
         ((3000, 4001, 5), "float32", 0): ("auto",),
         ((2160, 3840, 5), "bfloat16", 2): ("auto",)}
SEED = 0


def image(shape, dtype, off, gen, device):
    h, w, _ = shape
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    x = torch.randn(h * w + off // es, generator=gen, device=device)
    return x.to(dt)[off // es:].view(h, w)


def blur_plan(st, img, k, hw, policy):
    """The plan ``ops.gaussian_blur`` takes for ``img`` in the tree
    loaded: the tuner's ``plan_for`` where the tree has a tuner, else the
    wrapper's ``plan_for``, else ``plan_stencil`` of the shape."""
    try:
        from repro_torch.tuner.dispatch import plan_for
    except ImportError:
        if hasattr(st, "plan_for"):
            return st.plan_for(img, k, hw, policy)
        from repro_torch.core.mapper import plan_stencil
        return plan_stencil(img.shape[0], img.shape[1], k, hw, policy)
    return plan_for("gaussian_blur", img, ksize=k, hw=hw, policy=policy)[0]


def run_tree(tree: pathlib.Path) -> dict:
    """One tree's checks and times (run in a process of its own)."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.core.hw import detect
    from repro_torch.kernels import _build
    from repro_torch.kernels import stencil as st

    device = torch.device("cuda", 0)
    hw = detect(device)
    timer = cs.Timer(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    _build.load("stencil")
    result = {"tree": str(tree), "cases": []}
    if tree == ROOT:
        result["ptxas"] = [ln for ln in _build.ptxas_report("stencil")
                           .splitlines() if "entry function" in ln
                           or "registers" in ln or "spill" in ln]
    for case in CASES:
        shape, dtype, off = case
        img = image(shape, dtype, off, gen, device)
        k = shape[2]
        taps = st.gaussian_kernel_1d(k, 1.0)
        want_mid = st.stencil_rows_plain(img, taps)
        want_out = st.stencil_cols_plain(want_mid, taps)
        for policy in POLICIES:
            plan = blur_plan(st, img, k, hw, policy)
            mid = st.stencil_rows(img, taps, plan=plan)
            out = st.stencil_cols(want_mid, taps, plan=plan)
            torch.cuda.synchronize()
            entry = {
                "shape": list(shape), "dtype": dtype, "off": off,
                "policy": policy,
                "plan": {f: getattr(plan, f) for f in (
                    "route", "vec", "lws", "rows", "tile_w", "grid",
                    "smem_bytes") if hasattr(plan, f)},
                "bitwise": {"rows": bool(torch.equal(mid, want_mid)),
                            "cols": bool(torch.equal(out, want_out))},
                "max_abs_err": {
                    "rows": float((mid.float() - want_mid.float()).abs()
                                  .max()),
                    "cols": float((out.float() - want_out.float()).abs()
                                  .max())},
                "resident_ctas_per_sm": {
                    p: st.occupancy(p, plan, img.dtype)
                    for p in ("rows", "cols")}}
            if policy in TIMED.get(case, ()):
                entry["ms"] = {
                    "rows": timer.ms(lambda: st.stencil_rows(
                        img, taps, plan=plan), head_start=True),
                    "cols": timer.ms(lambda: st.stencil_cols(
                        want_mid, taps, plan=plan), head_start=True)}
            result["cases"].append(entry)
        if case in TIMED:
            # a plain copy of the image: what one read and one write of
            # each pixel take on this card, the passes' floor in practice
            buf = torch.empty_like(img)
            result["cases"][-1]["copy_ms"] = timer.ms(
                lambda: buf.copy_(img), head_start=True)
            w = taps.to(device=device, dtype=img.dtype)
            result["cases"][-1]["conv2d_ms"] = {
                "rows": timer.ms(lambda: F.conv2d(
                    img[None, None], w[None, None, None, :],
                    padding="same"), head_start=True),
                "cols": timer.ms(lambda: F.conv2d(
                    want_mid[None, None], w[None, None, :, None],
                    padding="same"), head_start=True)}
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("stencil_probe: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--tree"]:
        print(json.dumps(run_tree(pathlib.Path(sys.argv[2]).resolve())))
        return 0
    other = pathlib.Path(sys.argv[1]).resolve() if sys.argv[1:] else None
    trees = [other, ROOT, ROOT, other] if other else [ROOT]
    ok = True
    for tree in trees:
        proc = subprocess.run([sys.executable, __file__, "--tree", str(tree)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        for line in res.pop("ptxas", []):
            print(line)
        ok &= all(all(c["bitwise"].values()) for c in res["cases"])
        print(json.dumps(res))
    import chip_smoke as cs

    print(cs.nvidia_smi())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
