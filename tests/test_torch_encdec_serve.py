"""The port's engine serving the reduced whisper-medium against the JAX
engine, on the CPU: the same weights (the JAX params through
``params_from_jax``), float32, two slots, ``max_len`` 64, five ragged
prompts through two slots (slot recycling; one 36-token prompt grows the
pool a bucket), each engine on its TUNED and the adapter's stub (zero)
encoder frames.  The token streams must be identical on:

  * whole-prompt prefill, and ``prefill_chunk="auto"`` and 8, which
    both engines serve whole (encdec cannot chunk: the model's
    ``supports_chunked_prefill``), so all three hold the JAX engine's
    whole-prompt streams;
  * ``fused_decode=False`` (gather, then the contiguous sweep),
    ``paged=False`` and ``kv_dtype="int8"`` (self K/V only);
  * an ``eos_id`` met mid-stream.

``prefix_cache=True`` is the reference's no-op for encdec (its context
begins with the frames).  A pool growth pads the self K/V and leaves the
cross ck/cv as they were.  The int8 pool is held against the JAX
engine's int8 logits tick by tick (``ATOL``), not against a bound.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro.tuner import TuningCache as JaxTuningCache

from repro_torch.configs import get_config
from repro_torch.profiler import TraceStore, set_default_store
from repro_torch.serve import ServeEngine
from repro_torch.tuner import TuningCache, set_default_cache
from repro_torch.weights import params_from_jax

#: the reference's int8 mix (``tests/test_quantized_kv.py``): ragged,
#: one prompt past the first bucket
PROMPTS = [[7, 3, 99], [11, 5, 2, 42, 17, 101, 9], list(range(2, 38)),
           [250, 1], [33, 44, 55, 66]]
MAX_NEW = 4
#: engine path -> options
PATHS = {"whole": dict(prefill_chunk=None),
         "auto": dict(prefill_chunk="auto"),
         "chunk8": dict(prefill_chunk=8),
         "gather": dict(prefill_chunk=None, fused_decode=False),
         "contiguous": dict(prefill_chunk=None, paged=False),
         "int8": dict(prefill_chunk=None, kv_dtype="int8")}
#: the JAX run each path is held against: "auto" and 8 prefill whole in
#: the reference too (``test_chunk_options_prefill_whole_as_the_reference``)
JAX_PATH = {"auto": "whole", "chunk8": "whole"}
#: per-tick logits, port against JAX (float32)
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _memory_tuner():
    """The engine's TUNED plans from a memory-only cache and trace store:
    no test reads or writes the checkout's files."""
    set_default_cache(TuningCache(path=None))
    set_default_store(TraceStore(path=None))
    yield
    set_default_cache(None)
    set_default_store(None)


_WEIGHTS: dict = {}


def _weights():
    if not _WEIGHTS:
        jcfg = dataclasses.replace(jax_get_config("whisper-medium").reduced(),
                                   dtype="float32")
        tcfg = dataclasses.replace(get_config("whisper-medium").reduced(),
                                   dtype="float32")
        jparams = jax_build_model(jcfg).init(jax.random.key(0))
        _WEIGHTS.update(jcfg=jcfg, jparams=jparams, tcfg=tcfg,
                        tparams=params_from_jax(
                            jax.tree.map(np.asarray, jparams)))
    return _WEIGHTS


def _engine(kind, **opts):
    w = _weights()
    kw = dict(slots=2, max_len=64, **opts)
    if kind == "jax":
        return JaxServeEngine(w["jcfg"], params=w["jparams"],
                              tuning_cache=JaxTuningCache(path=None), **kw)
    return ServeEngine(w["tcfg"], params=w["tparams"], device="cpu", **kw)


def _serve(engine):
    """(streams, report, each decode tick's logits)."""
    log = []
    if isinstance(engine, ServeEngine):
        step = engine.model.decode_step

        def spy(*a, **kw):
            out = step(*a, **kw)
            log.append(out[0].numpy().copy())
            return out
        engine.model.decode_step = spy
    else:
        real = engine._decode

        def jspy(*a, **kw):
            out = real(*a, **kw)
            log.append(np.asarray(out[0]))
            return out
        engine._decode = jspy
    reqs = [engine.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
    report = engine.run()
    assert report.summary.n_completed == len(PROMPTS)
    return [list(r.generated) for r in reqs], report, log


_RUNS: dict = {}


def _run(kind, **opts):
    """One engine's serve of ``PROMPTS``, kept for the file's other tests
    (the JAX engine's compile is the cost); returns (streams, report,
    logits, engine)."""
    key = (kind, tuple(sorted(opts.items())))
    if key not in _RUNS:
        eng = _engine(kind, **opts)
        _RUNS[key] = (*_serve(eng), eng)
    return _RUNS[key]


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_streams_match_jax(path):
    want, jrep, jlog, _ = _run("jax", **PATHS[JAX_PATH.get(path, path)])
    got, rep, log, eng = _run("port", **PATHS[path])
    assert got == want
    assert rep.pool_growths == jrep.pool_growths >= 1
    assert len(log) == len(jlog)
    assert set(eng._cache) >= {"k", "v", "ck", "cv", "pos"}
    assert tuple(eng._cache["ck"].shape) == (2, 2, 24, 2, 32)
    assert eng._cache["ck"].dtype == torch.float32
    assert not eng._chunked and rep.prefill_tiles
    if path == "int8":
        assert eng._cache["k"].dtype == torch.int8 and "k_scale" in eng._cache
        assert "ck_scale" not in eng._cache
    else:
        assert "k_scale" not in eng._cache
    if path in ("gather", "contiguous"):
        assert rep.decode_blocks and not rep.paged_decode_blocks
    else:
        assert rep.paged_decode_blocks and not rep.decode_blocks


def test_chunk_options_prefill_whole_as_the_reference():
    """``prefill_chunk="auto"`` and 8 leave both engines on whole-prompt
    prefill: no chunk task, no ``prefill_chunk`` call."""
    for path in ("auto", "chunk8"):
        jeng = _engine("jax", **PATHS[path])
        assert not jeng._chunked
        eng = _engine("port", **PATHS[path])
        assert not eng._chunked
        eng.model.prefill_chunk = None          # never reached
        assert _serve(eng)[0] == _run("jax", **PATHS["whole"])[0]


def test_int8_logits_are_the_references():
    """The int8 pool's logits tick by tick against the JAX engine's int8
    logits, and the fp32 pool's against JAX's fp32: the port's int8 error
    against its own fp32 run is the reference's, within ``ATOL``."""
    logs = {}
    for path in ("whole", "int8"):
        want, _, logs["jax", path], _ = _run("jax", **PATHS[path])
        got, _, logs["port", path], _ = _run("port", **PATHS[path])
        assert got == want
        assert len(logs["jax", path]) == len(logs["port", path])
        for a, b in zip(logs["port", path], logs["jax", path]):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    err = {who: max(float(np.abs(a - b).max()) for a, b in
                    zip(logs[who, "whole"], logs[who, "int8"]))
           for who in ("jax", "port")}
    assert err["port"] > 0
    assert abs(err["port"] - err["jax"]) <= ATOL


def test_eos_mid_stream_matches_jax():
    """An ``eos_id`` taken from the middle of a JAX stream: both engines
    stop every request at the same token (the whole-prompt engines
    again, reset with the ``eos_id``: the JAX engine keeps its compiled
    steps)."""
    streams, _, _, jeng = _run("jax", **PATHS["whole"])
    eos = streams[1][1]
    got = []
    for eng in (jeng, _run("port", **PATHS["whole"])[3]):
        eng.eos_id = eos
        eng.reset()
        got.append(_serve(eng)[0])
    assert got[0] == got[1] != streams
    assert any(len(s) < MAX_NEW and s[-1] == eos for s in got[1])


def test_prefix_cache_is_a_noop_for_encdec():
    """``prefix_cache=True`` engages only on a shareable family: the
    port's encdec streams are the JAX engine's without it, no radix
    report is made, and the JAX engine makes no radix either."""
    want = _run("jax", **PATHS["whole"])[0]
    got, rep, _, eng = _run("port", prefix_cache=True, **PATHS["auto"])
    assert got == want
    assert rep.radix is None and not eng._shares_prefixes()
    jeng = _engine("jax", prefix_cache=True, **PATHS["auto"])
    assert jeng._radix is None


def test_pool_growth_leaves_the_cross_cache():
    """The 36-token prompt grows the pool 32 -> 64: the self K/V pad
    along time, the cross ck/cv of the slots keep every value."""
    eng = _engine("port", **PATHS["whole"])
    seen = []
    grow = eng._grow_pool

    def spy(new_len):
        before = {k: eng._cache[k].clone() for k in ("ck", "cv", "k")}
        grow(new_len)
        seen.append((new_len, before, dict(eng._cache)))
    eng._grow_pool = spy
    _serve(eng)
    assert [n for n, _, _ in seen] == [64]
    _, before, after = seen[0]
    for key in ("ck", "cv"):
        assert torch.equal(after[key], before[key]) and before[key].any()
    assert after["k"].shape[2] == 64 and before["k"].shape[2] == 32
