"""The port's tuner (``repro_torch.tuner``) against the JAX package's, on
the CPU: ``refine_discrete`` gives the same result, the signatures give
the same keys, the cache and the dispatch keep the reference's rules
(disk round trip, version, corruption, LRU, concurrent writers, zero
probes on a warm hit, non-TUNED policies bypassing the cache, a TUNED
cost never above the seed's), every TUNED plan is legal for the port's
kernels, and each registered op under TUNED matches the JAX op under
TUNED (Pallas in interpret mode) within the tolerances the port's suite
tests state: vecadd and the blur bitwise or 1e-6, saxpy 1e-6, rmsnorm
and gcn 1e-5, matmul 1e-4 (float32 sums over k <= 600), flash and decode
1e-5, nn_search the same indices and distances within 1e-5.

Every test uses a memory-only cache (``TuningCache(path=None)``) or one
under ``tmp_path``, for both packages, never the default files.
"""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.autotune import refine_discrete as jax_refine_discrete
from repro.kernels import ops as jax_ops
from repro.tuner import KERNEL_REGISTRY as JAX_REGISTRY
from repro.tuner import TuningCache as JaxTuningCache
from repro.tuner import set_default_cache as jax_set_default_cache
from repro.tuner import workload_signature as jax_signature

from repro_torch.core.autotune import refine_discrete
from repro_torch.core.hw import GPU_REGISTRY
from repro_torch.core.mapper import MappingPolicy
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import check_split
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.tuner import (KERNEL_REGISTRY, SCHEMA_VERSION, KernelSpec,
                               TuningCache, WorkloadSignature, hardware_key,
                               register_kernel, resolve_plan,
                               set_default_cache, tuned_call,
                               workload_signature)
from repro_torch.tuner.dispatch import COST_DIGEST, cache_hw_key

H100 = GPU_REGISTRY["h100_sxm"]
CPU = GPU_REGISTRY["cpu"]


@pytest.fixture(autouse=True)
def _memory_caches():
    """Both packages' process-wide caches in memory for every test."""
    set_default_cache(TuningCache(path=None))
    jax_set_default_cache(JaxTuningCache(path=None))
    yield
    set_default_cache(None)
    jax_set_default_cache(None)


# --------------------------------------------------------------------------- #
# refine_discrete: the same result as the reference
# --------------------------------------------------------------------------- #


def _bowl(centre, width):
    return lambda v: float((v - centre) ** 2) / width + 1.0


REFINE_CASES = {
    "default_candidates": (64, _bowl(130, 7.0), None, 16),
    "given_candidates": (10, _bowl(3, 2.0), [1, 2, 3, 4, 8, 10, 16], 16),
    "budget_cut": (10, _bowl(30, 1.0), [1, 2, 4, 8, 16, 20, 30, 40], 4),
    "seed_wins": (5, _bowl(5, 1.0), [1, 5, 7, 9], 16),
    "ties_keep_first": (8, lambda v: 1.0 if v in (2, 4) else 3.0,
                        [1, 2, 4, 16], 16),
    "pairs": ((16, 48), lambda v: abs(v[1] - 100) + v[0] / 8,
              [(16, 32), (16, 96), (32, 96), (16, 192)], 16),
    "infinite": (4, lambda v: float("inf") if v > 8 else 1.0 / v,
                 [1, 2, 8, 16, 32], 16),
}


@pytest.mark.parametrize("case", list(REFINE_CASES))
def test_refine_discrete_equals_the_reference(case):
    seed, cost, cands, probes = REFINE_CASES[case]
    got = refine_discrete(seed, cost, candidates=cands, max_probes=probes)
    want = jax_refine_discrete(seed, cost, candidates=cands,
                               max_probes=probes)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.ranked() == want.ranked()
    assert got.improvement == want.improvement


# --------------------------------------------------------------------------- #
# Signatures: the reference's keys
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("form", ["torch", "numpy", "tuple"])
def test_signature_key_equals_the_reference_in_every_form(form):
    """Tensors, arrays or shape tuples; torch, numpy or string dtypes
    (bfloat16 included, which ``np.dtype`` alone does not know); extras
    in any order."""
    t = torch.zeros(128, 64, dtype=torch.bfloat16)
    a = {"torch": t, "numpy": np.zeros((128, 64), np.float32),
         "tuple": (128, 64)}[form]
    dt = {"torch": torch.bfloat16, "numpy": t, "tuple": "bfloat16"}[form]
    got = workload_signature("k", shapes=[a, 32], dtypes=[dt, torch.int32],
                             policy=MappingPolicy.TUNED, win=128, causal=True)
    want = jax_signature("k", shapes=[(128, 64), (32,)],
                         dtypes=[jnp.bfloat16, np.int32], policy="tuned",
                         causal=True, win=128)
    assert got.key == want.key
    back = WorkloadSignature.from_dict(json.loads(json.dumps(got.as_dict())))
    assert back == got and back.key == got.key


def _operands(kernel, dtype):
    """Torch operands of each registered kernel, and the numpy (or jnp,
    for bfloat16) arrays the reference describes."""
    rng = np.random.default_rng(0)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def pair(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x).to(dtype), jnp.asarray(x, jdt)

    if kernel in ("vecadd", "saxpy"):
        (x, jx), (y, jy) = pair(5000), pair(5000)
        pre = (1.5,) if kernel == "saxpy" else ()
        return (*pre, x, y), (*pre, jx, jy), {}
    if kernel == "matmul":
        (a, ja), (b, jb) = pair(64, 96), pair(96, 80)
        return (a, b), (ja, jb), {}
    if kernel == "rmsnorm":
        (x, jx), (g, jg) = pair(37, 256), pair(256)
        return (x, g), (jx, jg), {}
    if kernel == "gcn_agg":
        (a, ja), (f, jf) = pair(96, 96), pair(96, 64)
        return (a, f), (ja, jf), {}
    if kernel == "nn_search":
        (q, jq), (r, jr) = pair(60, 16), pair(200, 16)
        return (q, r), (jq, jr), {}
    raise AssertionError(kernel)


#: the kernels whose workload description is the reference's
SAME_DESC = ["vecadd", "saxpy", "matmul", "rmsnorm", "gcn_agg", "nn_search"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", SAME_DESC)
def test_registered_signatures_equal_the_reference(kernel, dtype):
    args, jargs, kw = _operands(kernel, dtype)
    spec, jspec = KERNEL_REGISTRY[kernel], JAX_REGISTRY[kernel]
    for policy in ("tuned", "auto"):
        got = spec.sig(spec.describe(*args, **kw), policy).key
        want = jspec.sig(jspec.describe(*jargs, **kw), policy).key
        assert got == want


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention",
                                    "paged_decode", "gaussian_blur"])
def test_port_extras_render_as_the_reference_renders_them(kernel):
    """Where the port's plan depends on more than the reference's
    description (flash: its batch of heads; decode: rows and heads a
    group; the blur: whether the image starts on 16 bytes), the port's
    key is the reference's ``workload_signature`` of the same shapes,
    dtypes and extras."""
    spec = KERNEL_REGISTRY[kernel]
    if kernel == "flash_attention":
        q = torch.zeros(9, 100, 64)
        desc = spec.describe(q, q, q, causal=True)
        want = jax_signature(kernel, shapes=[(100, 64), (100, 64)],
                             dtypes=["float32"], causal=True, batch=9)
    elif kernel == "gaussian_blur":
        img = torch.zeros(64, 128, dtype=torch.bfloat16)
        desc = spec.describe(img, ksize=7)
        want = jax_signature(kernel, shapes=[(64, 128)],
                             dtypes=[jnp.bfloat16], ksize=7, aligned=True)
    else:
        q = torch.zeros(8, 3, 3, 64)
        kc = torch.zeros(8, 1024, 3, 64)
        clen = torch.ones(8, dtype=torch.int32)
        extras = dict(rows=24, heads_per_group=3)
        if kernel == "paged_decode":
            tables = torch.zeros(8, 64, dtype=torch.int32)
            desc = spec.describe(q, kc, kc, tables, clen, page_block=16)
            extras.update(page_block=16, max_blocks_per_row=64)
        else:
            desc = spec.describe(q, kc, kc, clen)
        want = jax_signature(kernel, shapes=[(1024, 64)],
                             dtypes=["float32"], **extras)
    assert spec.sig(desc, "tuned").key == want.key


def test_hardware_key_covers_every_field():
    assert hardware_key(CPU) != hardware_key(H100)
    assert hardware_key(H100) != hardware_key(
        dataclasses.replace(H100, wave_s=2 * H100.wave_s))
    assert hardware_key(H100) == hardware_key(GPU_REGISTRY["h100_sxm"])
    assert all(f"{f.name}=" in hardware_key(H100)
               for f in dataclasses.fields(H100))


def test_registry_holds_the_references_kernels_but_the_mesh():
    assert set(KERNEL_REGISTRY) == set(JAX_REGISTRY) - {"mesh_microbatch"}


# --------------------------------------------------------------------------- #
# Cache
# --------------------------------------------------------------------------- #


def _sig(n=4096) -> WorkloadSignature:
    return workload_signature("vecadd", shapes=[(n,)], dtypes=["float32"])


def test_cache_roundtrip_through_disk(tmp_path):
    path = str(tmp_path / "cache.json")
    TuningCache(path).put(hardware_key(CPU), _sig(), {"value": 2048},
                          cost=1e-5, probes=7)
    entry = TuningCache(path).get(hardware_key(CPU), _sig())
    assert entry["plan"] == {"value": 2048}
    assert entry["cost"] == pytest.approx(1e-5) and entry["probes"] == 7


def test_cache_file_reads_in_both_packages(tmp_path):
    """One file format: the reference's cache reads the port's file."""
    path = str(tmp_path / "cache.json")
    TuningCache(path).put("hw", _sig(), {"value": 8})
    assert JaxTuningCache(path).get("hw", _sig().key)["plan"] == {"value": 8}


def test_cache_version_mismatch_discards_file(tmp_path):
    path = str(tmp_path / "cache.json")
    TuningCache(path).put(hardware_key(CPU), _sig(), {"value": 2048})
    blob = json.load(open(path))
    blob["version"] = SCHEMA_VERSION + 1
    json.dump(blob, open(path, "w"))
    assert len(TuningCache(path)) == 0


def test_cache_corrupt_file_is_ignored(tmp_path):
    path = str(tmp_path / "cache.json")
    open(path, "w").write("{not json")
    c = TuningCache(path)
    assert len(c) == 0
    c.put(hardware_key(CPU), _sig(), {"value": 1024})
    assert TuningCache(path).get(hardware_key(CPU), _sig()) is not None


def test_cache_stats_and_lru_eviction():
    c = TuningCache(path=None, capacity=2)
    hk = hardware_key(CPU)
    assert c.get(hk, _sig(1)) is None
    c.put(hk, _sig(1), {"value": 1})
    c.put(hk, _sig(2), {"value": 2})
    assert c.get(hk, _sig(1)) is not None     # refreshes 1: 2 is the LRU
    c.put(hk, _sig(3), {"value": 3})          # evicts 2
    assert c.get(hk, _sig(2)) is None
    assert c.get(hk, _sig(1)) is not None
    s = c.stats
    assert (s.hits, s.misses, s.puts, s.evictions) == (2, 2, 3, 1)
    assert 0 < s.hit_rate < 1


def test_cache_concurrent_writers_merge(tmp_path):
    path = str(tmp_path / "cache.json")
    hk = hardware_key(CPU)

    def writer(i):
        TuningCache(path).put(hk, _sig(1000 + i), {"value": i})

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    merged = TuningCache(path)
    assert all(merged.get(hk, _sig(1000 + i)) is not None for i in range(8))


def test_default_paths_lie_in_the_checkout(monkeypatch, tmp_path):
    from repro_torch.kernels._build import build_dir
    from repro_torch.profiler.store import default_store_path
    from repro_torch.tuner.cache import default_cache_path

    monkeypatch.delenv("REPRO_TORCH_TUNER_CACHE", raising=False)
    monkeypatch.delenv("REPRO_TORCH_TRACE_STORE", raising=False)
    assert default_cache_path() == str(build_dir() / "tuning_cache.json")
    assert default_store_path() == str(build_dir() / "traces.jsonl")
    monkeypatch.setenv("REPRO_TORCH_TUNER_CACHE", str(tmp_path / "c.json"))
    assert default_cache_path() == str(tmp_path / "c.json")


# --------------------------------------------------------------------------- #
# Dispatch under TUNED
# --------------------------------------------------------------------------- #

VEC = {"n": 100_000, "dtype": "float32", "dtype_bytes": 4}


def test_tuned_warm_hit_spends_zero_probes():
    cache = TuningCache(path=None)
    x = torch.arange(5001, dtype=torch.float32)
    out = tuned_call("vecadd", x, 2 * x, hw=CPU, cache=cache)
    assert torch.equal(out, 3 * x)
    cold = (cache.stats.misses, cache.stats.refine_probes)
    assert cold[0] == 1 and cold[1] > 0
    out = tuned_call("vecadd", x, 2 * x, hw=CPU, cache=cache)
    assert torch.equal(out, 3 * x)
    assert cache.stats.hits == 1 and cache.stats.misses == cold[0]
    assert cache.stats.refine_probes == cold[1]


def test_tuned_plan_matches_across_caches_of_one_file(tmp_path):
    path = str(tmp_path / "cache.json")
    p1, i1 = resolve_plan("vecadd", CPU, "tuned", VEC, TuningCache(path))
    p2, i2 = resolve_plan("vecadd", CPU, "tuned", VEC, TuningCache(path))
    assert (i1.source, i2.source, i2.probes) == ("refined", "cache", 0)
    assert p1 == p2


def test_tuned_resolves_distinct_plans_per_hardware():
    cache = TuningCache(path=None)
    _, i1 = resolve_plan("vecadd", CPU, "tuned", VEC, cache)
    _, i2 = resolve_plan("vecadd", H100, "tuned", VEC, cache)
    assert i1.source == i2.source == "refined" and len(cache) == 2


def test_non_tuned_policies_bypass_the_cache():
    cache = TuningCache(path=None)
    x = torch.arange(2048, dtype=torch.float32)
    for pol in ("naive", "fixed", "auto"):
        out = tuned_call("vecadd", x, x, hw=CPU, policy=pol, cache=cache)
        assert torch.equal(out, 2 * x)
    assert len(cache) == 0 and cache.stats.hits == cache.stats.misses == 0


def test_a_cache_of_another_cost_model_is_not_replayed():
    """An entry is keyed by the cost models' digest beside the card: one
    written under another digest (or none, as before a change to a
    model) misses, and the tuner decides anew."""
    cache = TuningCache(path=None)
    sig = KERNEL_REGISTRY["vecadd"].sig(VEC, MappingPolicy.TUNED)
    assert cache_hw_key(CPU) == f"{hardware_key(CPU)}|cost={COST_DIGEST}"
    for stale in (hardware_key(CPU), f"{hardware_key(CPU)}|cost=0"):
        cache.put(stale, sig, {"value": 1})
    _, info = resolve_plan("vecadd", CPU, "tuned", VEC, cache)
    assert info.source == "refined" and info.probes > 0
    assert cache.get(cache_hw_key(CPU), sig) is not None and len(cache) == 3
    _, again = resolve_plan("vecadd", CPU, "tuned", VEC, cache)
    assert again.source == "cache" and again.probes == 0


#: a workload of each registered kernel (the serving shapes of
#: smollm-135m for flash and decode)
DESCS = {
    "vecadd": VEC,
    "saxpy": {"n": 1 << 26, "dtype": "bfloat16", "dtype_bytes": 2},
    "matmul": {"m": 4096, "n": 4096, "k": 4096, "dtype": "bfloat16",
               "dtype_bytes": 2},
    "matmul-f32": {"m": 8, "n": 1536, "k": 576, "dtype": "float32",
                   "dtype_bytes": 4},
    "flash_attention": {"seq_q": 1024, "seq_kv": 1024, "head_dim": 64,
                        "dtype": "bfloat16", "dtype_bytes": 2,
                        "causal": True, "batch": 9},
    "flash_attention-f32": {"seq_q": 40, "seq_kv": 72, "head_dim": 64,
                  "dtype": "float32", "dtype_bytes": 4, "causal": False,
                  "batch": 4},
    "rmsnorm": {"tokens": 16384, "d": 4096, "dtype": "bfloat16",
                "dtype_bytes": 2},
    "decode_attention": {"s": 1024, "d": 64, "rows": 24,
                         "heads_per_group": 3, "dtype": "bfloat16",
                         "dtype_bytes": 2},
    "paged_decode": {"s": 1024, "d": 64, "rows": 24, "heads_per_group": 3,
                     "dtype": "int8", "dtype_bytes": 1, "page_block": 16,
                     "max_blocks_per_row": 64},
    "gaussian_blur": {"h": 3000, "w": 4001, "ksize": 5, "dtype": "float32",
                      "dtype_bytes": 4, "aligned": True},
    "gcn_agg": {"n": 19717, "f": 500, "block_s": 256, "dtype": "float32",
                "dtype_bytes": 4},
    "nn_search": {"nq": 4096, "nr": 65536, "d": 128, "block_r": 512,
                  "dtype": "float32", "dtype_bytes": 4},
}


def _kernel(case):
    return case.split("-")[0]


def _legal(kernel, desc, plan, hw):
    """The plan is a fixed point of its kernel's legaliser, and passes the
    kernel's own rules."""
    spec = KERNEL_REGISTRY[kernel]
    assert spec.plan_from_value(desc, hw, spec.plan_value(plan)) == plan
    if kernel in ("decode_attention", "paged_decode"):
        bs, w = plan
        q = desc.get("page_block", 16)
        assert bs % q == 0 and w % bs == 0
        check_split(desc["s"], bs, w)
    elif kernel == "flash_attention":
        assert plan.block_q % 16 == 0 and plan.block_k % 16 == 0
        assert 32 <= plan.block_q <= 128 and plan.smem_bytes \
            <= hw.smem_per_block
        assert desc["head_dim"] in HEAD_DIMS[getattr(torch, desc["dtype"])]
    elif kernel == "matmul":
        assert plan.smem_bytes <= hw.smem_per_block
        assert plan.kernel == ("tf32x3" if desc["dtype"] == "float32"
                               else "tensor_core")
    elif kernel in ("vecadd", "saxpy"):        # a thread an item
        assert plan.grid * plan.threads * plan.lws >= desc["n"]
    elif kernel == "rmsnorm":                  # a warp a row
        assert plan.grid * plan.threads // 32 * plan.lws >= desc["tokens"]
    elif kernel == "gcn_agg":
        assert plan.grid[0] * plan.block_n >= desc["n"]
    elif kernel == "gaussian_blur":
        assert plan.smem_bytes <= hw.smem_per_block
    elif kernel == "nn_search":
        assert plan.smem_bytes <= hw.smem_per_block
        assert plan.grid[1] * plan.split >= desc["nr"]


@pytest.mark.parametrize("hw", [H100, CPU], ids=["h100", "cpu"])
@pytest.mark.parametrize("case", list(DESCS))
def test_tuned_plans_are_legal_and_never_cost_more_than_the_seed(case, hw):
    kernel, desc = _kernel(case), DESCS[case]
    plan, info = resolve_plan(kernel, hw, "tuned", desc,
                              TuningCache(path=None))
    assert info.source == "refined" and info.probes >= 1
    assert info.cost <= info.seed_cost
    _legal(kernel, desc, plan, hw)


def test_ops_layer_routes_tuned_through_the_default_cache():
    cache = TuningCache(path=None)
    set_default_cache(cache)
    with ops.policy("tuned"):
        x = torch.arange(4096, dtype=torch.float32)
        ops.vecadd(x, x, hw=CPU)
        assert cache.stats.misses == 1
        ops.vecadd(x, x, hw=CPU)
        assert cache.stats.hits == 1


def test_ops_context_managers_restore_state():
    assert ops._DEFAULT_POLICY is MappingPolicy.AUTO
    with ops.policy("tuned"), ops.measuring("cached"):
        assert ops._DEFAULT_POLICY is MappingPolicy.TUNED
        assert ops.get_default_measure() == "cached"
    assert ops._DEFAULT_POLICY is MappingPolicy.AUTO
    with pytest.raises(RuntimeError):
        with ops.policy("naive"), ops.measuring("live"):
            raise RuntimeError("boom")
    assert ops._DEFAULT_POLICY is MappingPolicy.AUTO
    assert ops.get_default_measure() == "off"
    with pytest.raises(ValueError):
        ops.set_default_measure("sometimes")


# --------------------------------------------------------------------------- #
# Each registered op under TUNED against the JAX op under TUNED
# --------------------------------------------------------------------------- #


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _both(kernel, rng):
    """(port call, JAX call, (atol, rtol)) on one seeded float32 input."""
    def arr(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    t, j = torch.from_numpy, jnp.asarray
    if kernel in ("vecadd", "saxpy"):
        x, y = arr(3000), arr(3000)
        if kernel == "vecadd":
            return (lambda: ops.vecadd(t(x), t(y)),
                    lambda: jax_ops.vecadd(j(x), j(y)), (0.0, 0.0))
        return (lambda: ops.saxpy(1.7, t(x), t(y)),
                lambda: jax_ops.saxpy(jnp.float32(1.7), j(x), j(y)),
                (1e-6, 1e-6))
    if kernel == "matmul":
        a, b = arr(130, 96), arr(96, 70)
        return (lambda: ops.matmul(t(a), t(b)),
                lambda: jax_ops.matmul(j(a), j(b)), (1e-4, 1e-4))
    if kernel == "rmsnorm":
        x, g = arr(37, 256), arr(256)
        return (lambda: ops.rmsnorm(t(x), t(g)),
                lambda: jax_ops.rmsnorm(j(x), j(g)), (1e-5, 1e-5))
    if kernel == "gaussian_blur":
        img = arr(64, 128)
        return (lambda: ops.gaussian_blur(t(img)),
                lambda: jax_ops.gaussian_blur(j(img)), (1e-6, 1e-6))
    if kernel == "gcn_agg":
        adj = (rng.random((96, 96)) < 0.1).astype(np.float32)
        adj /= np.maximum(adj.sum(1, keepdims=True), 1.0)
        f = arr(96, 64)
        return (lambda: ops.gcn_aggregate(t(adj), t(f)),
                lambda: jax_ops.gcn_aggregate(j(adj), j(f)), (1e-5, 1e-5))
    if kernel == "nn_search":
        q, r = arr(60, 16), arr(200, 16)
        return (lambda: ops.nn_search(t(q), t(r)),
                lambda: jax_ops.nn_search(j(q), j(r)), (1e-5, 1e-5))
    if kernel == "flash_attention":
        q, k, v = arr(2, 40, 64, scale=0.5), arr(2, 72, 64, scale=0.5), \
            arr(2, 72, 64)
        return (lambda: ops.flash_attention(t(q), t(k), t(v)),
                lambda: jax_ops.flash_attention(j(q), j(k), j(v)),
                (1e-5, 1e-5))
    if kernel == "decode_attention":
        q, k, v = arr(3, 64, scale=0.5), arr(3, 300, 64, scale=0.5), \
            arr(3, 300, 64)
        clen = np.array([300, 17, 200], np.int32)
        return (lambda: ops.decode_attention(t(q), t(k), t(v), t(clen)),
                lambda: jax_ops.decode_attention(j(q), j(k), j(v), j(clen)),
                (1e-5, 1e-5))
    raise AssertionError(kernel)


#: the ops of the registered kernels (paged_decode has no op: the engine
#: tests below hold it under TUNED)
OPS = ["vecadd", "saxpy", "matmul", "rmsnorm", "gaussian_blur", "gcn_agg",
       "nn_search", "flash_attention", "decode_attention"]


@pytest.mark.parametrize("kernel", OPS)
def test_op_under_tuned_matches_the_jax_op_under_tuned(kernel):
    port, ref, (atol, rtol) = _both(kernel, np.random.default_rng(3))
    cache = TuningCache(path=None)
    set_default_cache(cache)
    with ops.policy("tuned"):
        got = port()
    assert cache.stats.misses == 1 and cache.stats.refine_probes >= 1
    with jax_ops.force("interpret"), jax_ops.policy("tuned"):
        want = ref()
    if kernel == "nn_search":
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        got, want = got[1], want[1]
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)
