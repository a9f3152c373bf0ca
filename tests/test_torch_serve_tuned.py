"""The port's engine on its default policy, TUNED, against the JAX engine
on its own default TUNED, on the CPU, in float32 at reduced width: the
same weights and requests give the same token streams on the default
path (chunked prefill), ``paged=False`` and ``kv_dtype="int8"`` of
smollm-135m, and on mamba2-1.3b; a second engine on the first one's
cache file resolves every bucket from the cache with no probe
(``tests/test_torch_serve_eos.py`` holds ``eos_id`` the same way).

The two engines plan on different hardware (the port on its ``"cpu"``
stand-in, the JAX engine on its own), so their "auto" chunk widths may
differ: streams are compared token for token, and ``prefill_chunk`` is
pinned only where a test needs one width in both.  Both engines get a
memory-only tuning cache, or one under ``tmp_path``.
"""

import dataclasses

import numpy as np
import pytest

import jax

from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro.tuner import TuningCache as JaxTuningCache

from repro_torch.configs import get_config
from repro_torch.serve import ServeEngine
from repro_torch.tuner import TuningCache
from repro_torch.weights import params_from_jax

#: 5 ragged requests through 2 slots (slots recycle mid-decode), one of
#: them long enough to step the pool up a bucket
PROMPTS = [[7, 3, 99], [11, 5, 2, 42, 17, 101, 9], list(range(2, 38)),
           [250, 1], [33, 44, 55, 66]]
MAX_NEW = 6


def _weights(arch):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def smollm():
    return _weights("smollm-135m")


@pytest.fixture(scope="module")
def mamba2():
    return _weights("mamba2-1.3b")


def _serve(engine, prompts, max_new=MAX_NEW):
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    report = engine.run()
    assert report.summary.n_completed == len(prompts)
    return [report.outputs[r.rid] for r in reqs], report


def _pair(weights, **kw):
    jcfg, jparams, tcfg, tparams = weights
    jax_eng = JaxServeEngine(jcfg, slots=2, max_len=64, params=jparams,
                             tuning_cache=JaxTuningCache(path=None), **kw)
    eng = ServeEngine(tcfg, slots=2, max_len=64, params=tparams,
                      device="cpu", tuning_cache=TuningCache(path=None),
                      **kw)
    return jax_eng, eng


PATHS = {"default": {}, "contiguous": {"paged": False},
         "int8": {"kv_dtype": "int8"}}


@pytest.mark.parametrize("path", list(PATHS))
def test_smollm_streams_under_tuned_match_jax(smollm, path):
    jax_eng, eng = _pair(smollm, **PATHS[path])
    assert eng.router.policy.value == "tuned"
    want, _ = _serve(jax_eng, PROMPTS)
    got, rep = _serve(eng, PROMPTS)
    assert got == want
    stats = rep.router_stats
    assert stats["cold"] >= 1 and stats["probes"] > 0
    # the executed plans are the router's tuned ones
    for kv_len, bs in (rep.decode_blocks if path == "contiguous"
                       else rep.paged_decode_blocks).items():
        plan = eng.router.resolve(eng.router.bucket(kv_len))
        assert bs == (plan.decode_block if path == "contiguous"
                      else plan.paged_decode_block)
        assert plan.probes > 0 or plan.decode_info.source == "cache"


@pytest.mark.parametrize("chunk", [None, "auto"])
def test_mamba2_streams_under_tuned_match_jax(mamba2, chunk):
    jax_eng, eng = _pair(mamba2, prefill_chunk=chunk)
    want, _ = _serve(jax_eng, PROMPTS[:4])
    got, rep = _serve(eng, PROMPTS[:4])
    assert got == want
    assert rep.router_stats["probes"] == 0      # no attention to plan


def test_a_second_engine_on_the_cache_file_makes_no_probe(smollm, tmp_path):
    *_, tcfg, tparams = smollm
    path = str(tmp_path / "tuning_cache.json")

    def engine():
        return ServeEngine(tcfg, slots=2, max_len=64, params=tparams,
                           device="cpu", tuning_cache=TuningCache(path))

    first, rep1 = _serve(engine(), PROMPTS)
    assert rep1.router_stats["probes"] > 0
    second, rep2 = _serve(engine(), PROMPTS)
    assert second == first
    assert rep2.router_stats["cache_hits"] > 0
    assert rep2.router_stats["probes"] == 0


def test_swap_plan_legalises_and_replaces_a_decode_plan(smollm):
    *_, tcfg, tparams = smollm
    eng = ServeEngine(tcfg, slots=2, max_len=64, params=tparams,
                      device="cpu", tuning_cache=TuningCache(path=None))
    b = eng.router.bucket(64)
    new = eng.router.swap_plan(b, "paged_decode", (16, 20))
    assert (new.paged_decode_block, new.paged_decode_split) == (16, 32)
    assert eng.router.resolve(b) is new and eng.router.stats.swaps == 1
    with pytest.raises(ValueError):
        eng.router.swap_plan(b, "flash_attention", (32, 32))
