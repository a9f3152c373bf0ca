"""Probe: the block-table copy against TMA bulk copies on one GPU.

    python3 tools/gather_probe.py

The copy (``repro_torch.kernels.paged_gather``) runs under Eq. 1's plan
and at ``lws`` of ``KERNEL_LWS`` (its legaliser's candidates).  The
probe's bulk kernel (``BULK_SRC`` below, built with ``_build``'s
``nvcc`` and flags into the port's build directory) gives each CTA
``ppc`` consecutive logical pages: one thread reads their table entries,
issues one ``cp.async.bulk`` global -> shared copy a page, all
completing on one ``mbarrier``, then one ``cp.async.bulk`` shared ->
global copy a page, and waits until they have read shared memory.
Pages must be whole 16-byte vectors on 16-byte pointers.

At the serving shape (one cache of smollm-135m's pool, (8, 1024, 3, 64))
and the large case ((8, 4096, 8, 128)), both from ``chip_smoke.py``, it
holds every route bit for bit against the plain version, then times each
with ``chip_smoke.Timer`` (CUDA events, L2 flushed, the host's enqueue
outside the events) in ``ROUNDS`` rounds, the routes in turns, forwards
and backwards.  Prints one JSON line a case (each route's readings and
median), then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

PPC = (1, 2, 3, 4)
KERNEL_LWS = (1, 4)
ROUNDS = 4

BULK_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "tma_wgmma.cuh"

using namespace tma_wgmma;

__global__ void bulk_gather(const unsigned char* cache, const int* tables,
                            unsigned char* out, int B, int nb, int tw,
                            int page_bytes, int pages, int ppc) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x != 0) return;
  const int p0 = blockIdx.x * ppc;
  const int n = min(ppc, pages - p0);
  mbar_init(&bar, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  mbar_expect_tx(&bar, n * page_bytes);
  for (int k = 0; k < n; ++k) {
    const int p = p0 + k, b = p / nb, j = p % nb;
    const int pid = max(tables[b * tw + j], 0);
    const size_t src = ((size_t)(pid % B) * nb + pid / B) * page_bytes;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(smem + k * page_bytes)),
        "l"(cache + src), "r"(page_bytes), "r"(smem_u32(&bar))
        : "memory");
  }
  mbar_wait(&bar, 0);
  for (int k = 0; k < n; ++k)
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            out + (size_t)(p0 + k) * page_bytes),
        "r"(smem_u32(smem + k * page_bytes)), "r"(page_bytes)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

extern "C" int bulk_gather_launch(const void* cache, const void* tables,
                                  void* out, int B, int nb, int tw,
                                  int page_bytes, int ppc, void* stream) {
  const int pages = B * nb, smem = ppc * page_bytes;
  if (page_bytes % 16 || ppc < 1 || smem > 227 * 1024 ||
      (reinterpret_cast<uintptr_t>(cache) | reinterpret_cast<uintptr_t>(out))
          % 16)
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(bulk_gather,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  bulk_gather<<<(pages + ppc - 1) / ppc, 32, smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(cache),
      static_cast<const int*>(tables), static_cast<unsigned char*>(out), B,
      nb, tw, page_bytes, pages, ppc);
  return (int)cudaGetLastError();
}
"""


def build():
    from repro_torch.kernels import _build

    out_dir = _build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(BULK_SRC.encode()).hexdigest()[:16]
    so = out_dir / f"gather_probe-{digest}.so"
    if not so.exists():
        src = out_dir / f"gather_probe-{digest}.cu"
        src.write_text(BULK_SRC)
        subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS,
                        "-I", str(_build.CSRC), "-o", str(so), str(src)],
                       check=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.bulk_gather_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.hw import detect
    from repro_torch.core.mapper import gather_plan_for_block
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_gather import paged_gather

    device = torch.device("cuda", 0)
    bulk = build()
    timer = cs.Timer(device)
    hw = detect(device)
    cfg = get_config("smollm-135m")

    def report(label, case, calls, plain):
        """Hold each call bit for bit against ``plain`` under
        ``kernels.force("plain")``, time them in turns, print a line."""
        with kernels.force("plain"):
            want = plain()
        for name, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"{label}: {name} is not exact"
        ms = {name: [] for name in calls}
        for r in range(ROUNDS):
            for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                ms[name].append(timer.ms(calls[name], head_start=True))
        print(json.dumps(dict(
            case=label, shape=list(case["cache"].shape),
            bound_ms=cs.gather_bound(case, hw)[0], ms=ms,
            median_ms={k: statistics.median(v) for k, v in ms.items()})),
            flush=True)

    cases = {"serving": cs.gather_case(cfg, device, torch.bfloat16, False),
             "large": cs.pool_gather_case(cs.GATHER_LARGE, device,
                                          torch.bfloat16, False,
                                          cs.SEED + 4)}
    stream = torch.cuda.current_stream(device).cuda_stream
    for label, c in cases.items():
        cache, tables, pb = c["cache"], c["tables"], c["block_size"]
        b, t = cache.shape[:2]
        page_bytes = pb * cache[0, 0].numel() * cache.element_size()
        out = torch.empty_like(cache)

        def bulk_call(ppc):
            _build.check(bulk(cache.data_ptr(), tables.data_ptr(),
                              out.data_ptr(), b, t // pb, tables.shape[1],
                              page_bytes, ppc, stream), "bulk_gather")
            return out

        # the port's kernel under Eq. 1's plan, then at other lws of its
        # legaliser (the tuner's candidates)
        size = cache.numel() * cache.element_size()
        calls = {"kernel": lambda: paged_gather(cache, tables, pb)}
        calls.update({f"kernel_lws{lws}": lambda lws=lws: paged_gather(
            cache, tables, pb, plan=gather_plan_for_block(size, 16, hw, lws))
                      for lws in KERNEL_LWS})
        calls.update({f"bulk_ppc{ppc}": lambda ppc=ppc: bulk_call(ppc)
                      for ppc in PPC})
        report(f"copy, {label}", c, calls,
               lambda: paged_gather(cache, tables, pb))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
