"""The port's serving engine against the JAX engine on its other decode
paths, on the CPU.

Both engines serve the ``PROMPTS`` of ``tests/test_torch_serve.py`` (five
ragged requests through two slots: mid-decode recycling, and a long
prompt that grows the pool a bucket) with the same weights (the JAX
params through ``params_from_jax``) at reduced width in float32, with
the same engine options:

  paged=False                       contiguous rows, contiguous decode
  fused_decode=False                paged gather, then contiguous decode
  kv_dtype="int8"                   int8 pool, fused int8 paged decode
  kv_dtype="int8", fused_decode=False   dequant gather, contiguous decode

each with whole-prompt and with chunked prefill.  Token streams must be
identical and the pool must grow as often; each path must run the
kernels it names and no other decode kernel.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro.tuner import TuningCache

from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.profiler import TraceStore, set_default_store
from repro_torch.serve import ServeEngine
from repro_torch.tuner import TuningCache as PortTuningCache
from repro_torch.tuner import set_default_cache
from repro_torch.weights import params_from_jax

from test_torch_serve import MAX_NEW, PROMPTS

#: option -> the decode reads its ticks must run (wrapper names in
#: ``repro_torch.models.attention``)
PATHS = {
    "contiguous": (dict(paged=False), {"decode_attention"}),
    "gather": (dict(fused_decode=False),
               {"paged_gather", "decode_attention"}),
    "int8": (dict(kv_dtype="int8"), {"paged_decode_attention"}),
    "int8_gather": (dict(kv_dtype="int8", fused_decode=False),
                    {"paged_dequant_gather", "decode_attention"}),
}
READS = ("decode_attention", "paged_decode_attention", "paged_gather",
         "paged_dequant_gather")

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


def _serve(engine):
    reqs = [engine.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
    report = engine.run()
    assert report.summary.n_completed == len(PROMPTS)
    return [report.outputs[r.rid] for r in reqs], report


@pytest.mark.parametrize("chunk", [None, 8], ids=["whole", "chunked"])
@pytest.mark.parametrize("path", list(PATHS))
def test_decode_path_token_streams_match_jax(weights, path, chunk,
                                             monkeypatch):
    jcfg, jparams, tcfg, tparams = weights
    opts, reads = PATHS[path]
    jax_eng = JaxServeEngine(jcfg, slots=2, max_len=64, params=jparams,
                             prefill_chunk=chunk,
                             tuning_cache=TuningCache(path=None), **opts)
    want, jrep = _serve(jax_eng)
    calls = {name: 0 for name in READS}
    for name in READS:
        fn = getattr(attn, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(attn, name, spy)
    eng = ServeEngine(tcfg, slots=2, max_len=64, params=tparams,
                      prefill_chunk=chunk, device="cpu", **opts)
    got, rep = _serve(eng)
    assert got == want
    assert rep.pool_growths == jrep.pool_growths >= 1
    assert {n for n, c in calls.items() if c} == reads
    fused = "paged_decode_attention" in reads
    assert bool(rep.paged_decode_blocks) == fused
    assert bool(rep.decode_blocks) != fused
    assert all(bs % 16 == 0 for bs in rep.decode_blocks.values())


def test_int8_needs_the_paged_pool():
    cfg = get_config("smollm-135m").reduced()
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(cfg, device="cpu", kv_dtype="int8", paged=False)
    with pytest.raises(ValueError, match="paged"):
        JaxServeEngine(jax_get_config("smollm-135m").reduced(),
                       kv_dtype="int8", paged=False)


@pytest.mark.parametrize("path", list(PATHS))
def test_decode_paths_default_to_cuda_and_raise_without_it(path):
    """Each path's engine runs on the card unless the caller asks for
    the CPU: without a CUDA device the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine("smollm-135m", **PATHS[path][0])
