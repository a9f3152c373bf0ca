"""``eos_id`` in the port's engine against the JAX engine, on the CPU,
in float32 at reduced width, each on its default TUNED with a
memory-only tuning cache: the same weights and requests with an
``eos_id`` that a stream meets mid-way stop every stream at the same
token, on smollm-135m with whole-prompt and chunked prefill and on
mamba2-1.3b with chunked prefill (the width pinned, the same in both)."""

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

PROMPTS = [[7, 3, 99], [11, 5, 2, 42, 17, 101, 9], list(range(2, 38))]


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


def _serve(engine, prompts, max_new):
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    report = engine.run()
    assert report.summary.n_completed == len(prompts)
    return [report.outputs[r.rid] for r in reqs]


def _pair(weights, **kw):
    jcfg, jparams, tcfg, tparams = weights
    jax_eng = JaxServeEngine(jcfg, slots=2, max_len=64, params=jparams,
                             tuning_cache=JaxTuningCache(path=None), **kw)
    eng = ServeEngine(tcfg, slots=2, max_len=64, params=tparams,
                      device="cpu", tuning_cache=TuningCache(path=None),
                      **kw)
    return jax_eng, eng


@pytest.mark.parametrize("arch,chunk", [("smollm", None), ("smollm", 8),
                                        ("mamba2", 4)],
                         ids=["smollm-whole", "smollm-chunked",
                              "mamba2-chunked"])
def test_eos_stops_both_engines_at_the_same_token(arch, chunk, request):
    """An ``eos_id`` the streams meet mid-way (the second token the port
    generates for the first request, found by a run without one): both
    engines stop every stream at the same token."""
    weights = request.getfixturevalue(arch)
    _, free_eng = _pair(weights, prefill_chunk=chunk)
    free = _serve(free_eng, PROMPTS, 8)
    eos = free[0][len(PROMPTS[0]) + 1]
    jax_eng, eng = _pair(weights, prefill_chunk=chunk, eos_id=eos)
    want = _serve(jax_eng, PROMPTS, 8)
    got = _serve(eng, PROMPTS, 8)
    assert got == want
    for out, full in zip(got, free):
        assert out == full[:len(out)]          # a prefix of the free run
        if len(out) < len(full):
            assert out[-1] == eos              # cut at an eos
    assert len(got[0]) < len(free[0])          # the eos cut it short
