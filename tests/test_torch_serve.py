"""The port's serving engine against the JAX engine, on the CPU.

Both engines serve the same requests with the same weights (the JAX
params converted through ``params_from_jax``) at reduced width in
float32: two slots for five requests (slots recycle mid-decode) and one
long prompt that steps the pool up a length bucket (growth).  Token
streams must be identical, once with whole-prompt prefill and once with
an integer chunk width both engines share.  The port's management layer
(allocator, pool, scheduler, lattice) is also held to the reference's
invariants under seeded random traffic.
"""

import dataclasses
import random

import numpy as np
import pytest

import jax

from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro.tuner import TuningCache

from repro_torch.configs import get_config
from repro_torch.profiler import TraceStore, set_default_store
from repro_torch.serve import (BlockAllocator, BucketRouter, BucketSpec,
                               KVCachePool, Request, Scheduler, ServeEngine,
                               TrafficConfig, drive)
from repro_torch.weights import params_from_jax
from repro_torch.core.hw import GPU_REGISTRY
from repro_torch.tuner import TuningCache as PortTuningCache
from repro_torch.tuner import set_default_cache

#: 5 ragged requests through 2 slots (mid-decode recycling), including
#: one long prompt that forces a pool-length bucket step (growth).
#: None of these streams meets a near-tie (a JAX top-2 logit gap under
#: 1e-4) on these weights.
PROMPTS = [[7, 3, 99], [11, 5, 2, 42, 17, 101, 9], list(range(2, 38)),
           [250, 1], [33, 44, 55, 66]]
MAX_NEW = 4

@pytest.fixture(autouse=True)
def _memory_tuner():
    """The engine's TUNED plans from a memory-only cache and trace store:
    no test reads or writes the checkout's files."""
    set_default_cache(PortTuningCache(path=None))
    set_default_store(TraceStore(path=None))
    yield
    set_default_cache(None)
    set_default_store(None)



@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_get_config("smollm-135m").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                               dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _serve(engine, prompts):
    reqs = [engine.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    report = engine.run()
    assert report.summary.n_completed == len(prompts)
    return [report.outputs[r.rid] for r in reqs], report


@pytest.mark.parametrize("chunk", [None, 8])
def test_engine_token_streams_match_jax(weights, chunk):
    jcfg, jparams, tcfg, tparams = weights
    jax_eng = JaxServeEngine(jcfg, slots=2, max_len=64, params=jparams,
                             prefill_chunk=chunk,
                             tuning_cache=TuningCache(path=None))
    want, jrep = _serve(jax_eng, PROMPTS)
    eng = ServeEngine(tcfg, slots=2, max_len=64, params=tparams,
                      prefill_chunk=chunk, device="cpu")
    got, rep = _serve(eng, PROMPTS)
    assert got == want
    assert rep.pool_growths == jrep.pool_growths >= 1
    assert all(bs % 16 == 0 for bs in rep.paged_decode_blocks.values())


def test_engine_auto_chunk_uses_the_planned_block_q(weights):
    *_, tcfg, tparams = weights
    eng = ServeEngine(tcfg, slots=2, max_len=64, params=tparams,
                      device="cpu")
    out, rep = _serve(eng, PROMPTS[:3])
    assert all(len(o) == len(p) + MAX_NEW for o, p in zip(out, PROMPTS))
    assert rep.prefill_tiles and all(
        bq % 16 == 0 for bq, _ in rep.prefill_tiles.values())
    whole = ServeEngine(tcfg, slots=2, max_len=64, params=tparams,
                        prefill_chunk=None, device="cpu")
    assert _serve(whole, PROMPTS[:3])[0] == out


def test_engine_options_of_later_slices_raise():
    """The options the engine refuses, as the JAX engine does: an
    unknown prefill chunk, an unknown kv_dtype, and int8 without the
    paged pool (its scales are per physical block).  The decode paths
    themselves are held against JAX in tests/test_torch_serve_paths.py."""
    cfg = get_config("smollm-135m").reduced()
    with pytest.raises(ValueError):
        ServeEngine(cfg, device="cpu", prefill_chunk="whole")
    with pytest.raises(ValueError, match="kv_dtype"):
        ServeEngine(cfg, device="cpu", kv_dtype="fp8")
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(cfg, device="cpu", kv_dtype="int8", paged=False)


def test_traffic_drive_open_and_closed():
    cfg = get_config("smollm-135m").reduced()
    for mode in ("open", "closed"):
        eng = ServeEngine(cfg, slots=2, max_len=64, device="cpu")
        rep = drive(eng, TrafficConfig(n_requests=4, rate=50.0, mode=mode,
                                       prompt_dist=("uniform", 2, 20),
                                       output_dist=("uniform", 1, 4),
                                       vocab=cfg.vocab_size, seed=5))
        assert rep.summary.n_completed == 4
        assert rep.summary.output_tokens == sum(
            len(r.generated) for r in rep.completed)


@pytest.mark.parametrize("seed", range(3))
def test_pool_and_scheduler_invariants_under_random_traffic(seed):
    """Random admit/retire/grow keeps slots and blocks partitioned, live
    tables disjoint and inside the physical grid, and FIFO admission
    completes every request."""
    rng = random.Random(seed)
    pool = KVCachePool(3, 64, block_size=16, max_len=256)
    sched = Scheduler(pool)
    reqs = [Request(prompt=[1] * rng.randint(1, 60),
                    max_new_tokens=rng.randint(1, 40)) for _ in range(12)]
    for r in reqs:
        assert sched.submit(r)
    sched.poll(0.0)
    for _ in range(200):
        need = sched.peek_need_len()
        if need is not None and need > pool.kv_len:
            pool.grow(BucketSpec(max_len=256).quantize(need))
        for r in sched.admissible():
            assert pool.lease(r.rid).slot == r.slot
        live = sched.live
        if live and rng.random() < 0.5:
            sched.finish(rng.choice(live))
        pool.check()
        tables = [pool.block_table(r.rid) for r in sched.live]
        held = [b for t in tables for b in t if b >= 0]
        assert len(held) == len(set(held))
        assert all(b < pool.slots * pool.kv_len // 16 for b in held)
        if sched.idle:
            break
    assert sched.idle and len(sched.completed) == len(reqs)


def test_allocator_and_lattice_edges():
    a = BlockAllocator(num_blocks=8, block_size=16)
    assert a.alloc(rid=0, tokens=40) == [0, 1, 2]
    with pytest.raises(MemoryError):
        a.alloc(rid=1, tokens=16 * 6)
    a.release(0)
    a.check()
    spec = BucketSpec(min_len=32, max_len=256)
    assert spec.quantize(100) == 128 and spec.lattice() == (32, 64, 128, 256)
    with pytest.raises(ValueError):
        spec.quantize(257)
    cfg = get_config("smollm-135m")
    router = BucketRouter(cfg, spec, slots=8, hw=GPU_REGISTRY["h100_sxm"])
    plan = router.resolve(router.bucket(200))
    assert plan is router.resolve(router.bucket(256))
    assert router.stats.cold == 1 and router.stats.warm == 1
    assert router.prefill_tiles(256) == router.prefill_tiles(256)
