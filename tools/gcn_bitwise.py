"""Hold this tree's ``gcn_aggregate`` kernel bit for bit against another
tree's on one CUDA card.

    python3 tools/gcn_bitwise.py OTHER_ROOT

OTHER_ROOT is the root of another checkout of this repository (for
example a parent commit unpacked with ``git archive`` into the
git-ignored ``out/``).  For each graph of ``chip_smoke.py``'s suite
(Cora- and Pubmed-sized, ``planetoid_like`` from the smoke's seed, f32
and bf16 as its ``SUITE_CASES``) and each mapping policy, the script
runs ``repro_torch.kernels.ops.gcn_aggregate`` from this tree and, in a
child process with ``OTHER_ROOT/src`` first on its path, from the other
tree, on the same inputs made anew from the seed, and compares the
SHA-256 of the outputs' bytes.  It prints one JSON line per case and
policy and a last line ``{"bitwise": true | false}``, and exits 1
where any output differs, 2 without a card.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
POLICIES = ("naive", "fixed", "auto")


def hashes(src: str) -> dict:
    """SHA-256 of each case's output under each policy, with ``src``
    first on the path (the tree whose ``repro_torch`` runs)."""
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.kernels import ops

    device = torch.device("cuda", 0)
    out = {}
    for op, shape, dtype in smoke.SUITE_CASES:
        if op != "gcn_aggregate":
            continue
        gen = torch.Generator(device=device).manual_seed(smoke.SEED)
        adj, x = smoke.planetoid_like(*shape, dtype, gen, device)
        for policy in POLICIES:
            y = ops.gcn_aggregate(adj, x, policy=policy)
            torch.cuda.synchronize()
            raw = y.contiguous().view(torch.uint8).cpu().numpy().tobytes()
            key = f"{list(shape)} {str(dtype).split('.')[1]} {policy}"
            out[key] = hashlib.sha256(raw).hexdigest()
        del adj, x
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("gcn_bitwise: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--hashes"]:
        print(json.dumps(hashes(sys.argv[2])))
        return 0
    other = pathlib.Path(sys.argv[1]).resolve()
    child = subprocess.run(
        [sys.executable, __file__, "--hashes", str(other / "src")],
        capture_output=True, text=True, check=True, timeout=900)
    theirs = json.loads(child.stdout.strip().splitlines()[-1])
    ours = hashes(str(ROOT / "src"))
    same = True
    for key, h in ours.items():
        equal = theirs.get(key) == h
        same &= equal
        print(json.dumps({"case": key, "bitwise": equal, "sha256": h,
                          "other_sha256": theirs.get(key)}))
    same &= set(theirs) == set(ours)
    print(json.dumps({"bitwise": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
