"""The port's radix prefix sharing and its remaining serving options
against the JAX engine, on the CPU.

Both engines serve the shared mix of ``tests/test_prefix_cache.py``
(a 24-token preamble, one full 16-token block and an 8-token tail, in
front of most prompts; a long request that grows the pool a bucket;
two slots, so retirement recycles mid-decode) with the same weights
(the JAX params through ``params_from_jax``) at reduced width in
float32.  Streams are compared POSITIONALLY (request ids are a
process-wide counter in each package):

  * the radix on, at fixed chunks of 8 and 32 ("auto" tunes different
    ``block_q`` in the two packages by design): port-on == port-off ==
    JAX-on, and the port's ``report.radix`` equals the JAX engine's;
  * the int8 pool with the radix on (chunks of 32): port == JAX
    streams, and every decode tick's logits within ``INT8_LOGIT_TOL`` of
    the JAX engine's;
  * a tight ``total_blocks``: the same evictions, every request done;
  * mamba2-1.3b with ``prefix_cache=True``: no radix, the JAX streams;
  * an exact repeat resumes at ``prompt_len - 1`` (27 - 1 = 26, not a
    multiple of 16), as the JAX engine does;
  * ``admission="gang"`` and ``spec=BucketSpec(mode="fixed")``: the JAX
    streams and admission order;
  * ``total_blocks`` above the physical grid raises in both;
  * the trace: the ``radix_hit`` instants and ``radix_*`` counters equal
    the JAX engine's;
  * the CLI with ``--prefix-cache --shared-prefix 24`` prints the radix
    line and writes ``--metrics-json``;
  * ``TrafficConfig.shared_prefix`` draws the reference's timeline.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.obs import Tracer as JaxTracer
from repro.serve import BucketSpec as JaxBucketSpec
from repro.serve import ServeEngine as JaxServeEngine
from repro.tuner import TuningCache

from repro_torch.configs import get_config
from repro_torch.launch.serve import main as serve_main
from repro_torch.obs import Tracer
from repro_torch.profiler import TraceStore, set_default_store
from repro_torch.serve import BucketSpec, ServeEngine
from repro_torch.tuner import TuningCache as PortTuningCache
from repro_torch.tuner import set_default_cache
from repro_torch.weights import params_from_jax

MAX_NEW = 3
#: the shared mix's preamble: one full 16-token block + an 8-token tail
PRE = [5, 9, 2, 14, 7, 3, 11, 6, 4, 13, 8, 1, 10, 12, 15, 7,
       9, 3, 5, 2, 8, 11, 4, 6]
MIX = [
    PRE + [101, 102, 103],
    PRE + [77] * 9,
    PRE + list(range(120, 134)),          # 38 tokens: growth
    [250, 1],                             # the cold request
    PRE + [33, 44],
    PRE[:20] + [9, 9, 9],                 # partial-preamble branch
]
#: the block budget that makes admission evict (the grid holds 4 at the
#: first bucket; the JAX engine evicts 3 blocks at 2)
TIGHT_BLOCKS = 2
#: int8 decode logits, port against the JAX engine (both float32 math on
#: the same codes and scales: summation order only)
INT8_LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _memory_tuner():
    """The engine's TUNED plans from a memory-only cache and trace store:
    no test reads or writes the checkout's files."""
    set_default_cache(PortTuningCache(path=None))
    set_default_store(TraceStore(path=None))
    yield
    set_default_cache(None)
    set_default_store(None)


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


def _engines(weights, *, jax_spec=None, port_spec=None, jax_tracer=None,
             port_tracer=None, **kw):
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(dict(slots=2, max_len=96), **kw)
    jeng = JaxServeEngine(jcfg, params=jparams, spec=jax_spec,
                          tracer=jax_tracer,
                          tuning_cache=TuningCache(path=None), **kw)
    eng = ServeEngine(tcfg, params=tparams, device="cpu", spec=port_spec,
                      tracer=port_tracer, **kw)
    return jeng, eng


def _serve(eng, mix=MIX):
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in mix]
    report = eng.run()
    assert report.summary.n_completed == len(mix)
    return [list(r.generated) for r in reqs], report


#: the JAX engine's traced runs of ``MIX``, by engine options: the JAX
#: side of a comparison is the file's cost, so tests on the same options
#: share one run
_JAX_RUNS: dict = {}


def _jax_run(weights, **kw):
    key = tuple(sorted(kw.items()))
    if key not in _JAX_RUNS:
        tracer = JaxTracer()
        jeng, _ = _engines(weights, jax_tracer=tracer, **kw)
        _JAX_RUNS[key] = _serve(jeng) + (tracer,)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("chunk", [8, 32])
def test_streams_and_radix_stats_match_jax(smollm, chunk):
    want, jrep, _ = _jax_run(smollm, prefill_chunk=chunk, prefix_cache=True)
    _, eng = _engines(smollm, prefill_chunk=chunk, prefix_cache=True)
    got, rep = _serve(eng)
    assert got == want
    assert rep.pool_growths == jrep.pool_growths >= 1
    assert rep.radix == jrep.radix
    assert rep.radix["hits"] >= 4 and rep.radix["hit_tokens"] >= 4 * 16
    eng._radix.check()
    eng.pool.check()
    # the radix off: the same streams, no radix
    _, off = _engines(smollm, prefill_chunk=chunk, prefix_cache=False)
    got_off, rep_off = _serve(off)
    assert got_off == got and rep_off.radix is None and off._radix is None
    # every lease is gone: each block free or radix-retained
    held = eng.pool.allocator.holders()
    assert set(held) <= {"radix"}
    assert eng.pool.allocator.free_blocks + len(held.get("radix", [])) \
        == eng.pool.allocator.num_blocks


def test_int8_radix_streams_and_logits_match_jax(smollm):
    """Shared blocks share their scale rows; the seed dequantises codes
    times scales in f32, and ``write_row`` re-quantises the boundary
    block from the write start on, as the JAX engine does."""
    jeng, eng = _engines(smollm, prefill_chunk=32, prefix_cache=True,
                         kv_dtype="int8")
    jlogits, tlogits = [], []
    jdecode = jeng._decode

    def jspy(*a, **kw):
        lg, cache = jdecode(*a, **kw)
        jlogits.append(np.asarray(lg))
        return lg, cache
    jeng._decode = jspy
    step = eng.model.decode_step

    def tspy(*a, **kw):
        lg, cache = step(*a, **kw)
        tlogits.append(lg.detach().numpy().copy())
        return lg, cache
    eng.model.decode_step = tspy
    want, jrep = _serve(jeng)
    got, rep = _serve(eng)
    assert got == want
    assert rep.radix == jrep.radix and rep.radix["hits"] >= 4
    assert len(tlogits) == len(jlogits)
    err = max(float(np.abs(t.reshape(j.shape) - j).max())
              for t, j in zip(tlogits, jlogits))
    assert err <= INT8_LOGIT_TOL, err
    # the radix off on the same pool: the same streams on this mix
    _, off = _engines(smollm, prefill_chunk=32, kv_dtype="int8")
    assert _serve(off)[0] == got


def test_tight_total_blocks_evicts_as_jax(smollm):
    kw = dict(prefill_chunk=32, prefix_cache=True, total_blocks=TIGHT_BLOCKS)
    want, jrep, _ = _jax_run(smollm, **kw)
    _, eng = _engines(smollm, **kw)
    got, rep = _serve(eng)
    assert got == want and not rep.rejected
    assert rep.radix["evicted_blocks"] == jrep.radix["evicted_blocks"]
    assert rep.radix["evicted_blocks"] > _jax_run(
        smollm, prefill_chunk=32, prefix_cache=True)[1].radix[
            "evicted_blocks"]
    assert rep.radix == jrep.radix
    eng._radix.check()
    eng.pool.check()


def test_mamba2_keeps_its_prefixes_unshared():
    weights = _weights("mamba2-1.3b")
    jeng, eng = _engines(weights, max_len=64, prefix_cache=True)
    mix = [PRE + [3, 4], PRE + [5], [7, 8, 9], PRE + [6, 6]]
    want, jrep = _serve(jeng, mix)
    got, rep = _serve(eng, mix)
    assert got == want
    assert rep.radix is None and eng._radix is None and jrep.radix is None


def test_exact_repeat_resumes_off_the_16_grid(smollm):
    """A repeat of a retired 27-token prompt (arriving after the first
    one finished) maps its full block, copies the 11-token tail up to
    the cap (10 tokens: the last one is recomputed) and resumes at 26:
    its one chunk runs flash at q_offset 26."""
    prompt = PRE + [101, 102, 103]
    starts = {}
    for name, tracer in (("jax", JaxTracer()), ("port", Tracer())):
        kw = {f"{name}_tracer": tracer}
        jeng, eng = _engines(smollm, prefill_chunk=32, prefix_cache=True,
                             **kw)
        e = jeng if name == "jax" else eng
        reqs = [e.submit(prompt, max_new_tokens=MAX_NEW, arrival=t)
                for t in (0.0, 1e6)]
        rep = e.run()
        assert rep.summary.n_completed == 2
        streams = [r.generated for r in reqs]
        assert streams[0] == streams[1]
        assert rep.radix["hit_tokens"] == len(prompt) - 1
        spans = [s.attrs for s in tracer.spans()
                 if s.name == "prefill_chunk"]
        starts[name] = [s["start"] for s in spans]
        hits = [s.attrs for s in tracer.spans() if s.name == "radix_hit"]
        assert [(h["tokens"], h["shared_blocks"], h["tail"])
                for h in hits] == [(26, 1, 10)]
    assert starts["port"] == starts["jax"] == [0, 26]
    assert 26 % 16


def test_gang_admission_and_fixed_spec_match_jax(smollm):
    jeng, eng = _engines(smollm, slots=2, prefill_chunk=32,
                         admission="gang",
                         jax_spec=JaxBucketSpec(max_len=96, mode="fixed"),
                         port_spec=BucketSpec(max_len=96, mode="fixed"))
    orders = []
    for e in (jeng, eng):
        order, admissible = [], e.scheduler.admissible

        def spy(_admissible=admissible, _order=order):
            out = _admissible()
            _order.append([r.rid for r in out])
            return out
        e.scheduler.admissible = spy
        streams, rep = _serve(e)
        base = min(rid for batch in order for rid in batch)
        orders.append(([[rid - base for rid in b] for b in order if b],
                       streams, rep.pool_growths))
    assert orders[0] == orders[1]
    batches = orders[1][0]
    assert batches == [[0, 1], [2, 3], [4, 5]]    # whole batches only
    assert orders[1][2] == 0                       # fixed: one bucket
    assert eng.spec.mode == "fixed" and eng.pool.kv_len == 96
    with pytest.raises(ValueError, match="mode"):
        ServeEngine(smollm[2], params=smollm[3], device="cpu",
                    admission="batch")


def test_total_blocks_above_the_grid_raises_in_both(smollm):
    jcfg, jparams, tcfg, tparams = smollm
    # the first bucket is 32: 2 slots x 2 blocks
    with pytest.raises(ValueError, match="physical block grid"):
        JaxServeEngine(jcfg, slots=2, max_len=96, params=jparams,
                       total_blocks=5, tuning_cache=TuningCache(path=None))
    with pytest.raises(ValueError, match="physical block grid"):
        ServeEngine(tcfg, slots=2, max_len=96, params=tparams,
                    device="cpu", total_blocks=5)
    ServeEngine(tcfg, slots=2, max_len=96, params=tparams, device="cpu",
                total_blocks=4)
    with pytest.raises(ValueError, match="finite length lattice"):
        ServeEngine(tcfg, slots=2, max_len=96, params=tparams,
                    device="cpu", spec=BucketSpec(max_len=96, mode="exact"))


def test_spec_is_trimmed_to_max_len(smollm):
    eng = ServeEngine(smollm[2], params=smollm[3], device="cpu", slots=2,
                      max_len=64, spec=BucketSpec(max_len=256))
    assert eng.spec.max_len == 64 and eng.pool.max_len == 64


def test_trace_radix_instants_and_counters_match_jax(smollm):
    kw = dict(prefill_chunk=32, prefix_cache=True)
    jt = _jax_run(smollm, **kw)[2]
    tt = Tracer()
    _, eng = _engines(smollm, port_tracer=tt, **kw)
    _serve(eng)

    def radix_view(tracer):
        spans = tracer.spans()
        base = min(s.attrs["rid"] for s in spans if s.name == "prefill_chunk")
        hits = [(s.attrs["rid"] - base, s.attrs["tokens"],
                 s.attrs["shared_blocks"], s.attrs["tail"])
                for s in spans if s.name == "radix_hit"]
        evicts = [s.attrs["blocks"] for s in spans
                  if s.name == "radix_evict"]
        counters = {k: v for k, v in tracer.counters().items()
                    if k.startswith("radix_")}
        return hits, evicts, counters

    got, want = radix_view(tt), radix_view(jt)
    assert got == want
    hits, evicts, counters = got
    assert hits and evicts
    assert set(counters) == {"radix_lookups", "radix_hits",
                             "radix_hit_tokens", "radix_evicted_blocks"}
    assert tt.meta["prefix_cache"] is True and jt.meta["prefix_cache"]


def test_cli_prints_the_radix_line_and_writes_metrics(tmp_path, capsys):
    path = tmp_path / "metrics.json"
    out = serve_main(["--device", "cpu", "--prefix-cache",
                      "--shared-prefix", "24", "--mode", "closed",
                      "--requests", "6", "--slots", "2", "--max-len", "96",
                      "--max-new", "4", "--metrics-json", str(path)])
    text = capsys.readouterr().out
    assert "[serve] radix: hit rate" in text
    assert out["radix"]["hits"] > 0 and out["summary"]["n_completed"] == 6
    assert json.loads(path.read_text()) == json.loads(json.dumps(out))


def test_shared_prefix_mix_draws_the_reference_prompts():
    """One preamble per mix, in front of the drawn share of requests:
    the same seed gives the same timeline in both packages."""
    from repro.serve import TrafficConfig as JaxTrafficConfig
    from repro.serve import synthesize as jax_synthesize
    from repro_torch.serve import TrafficConfig, synthesize

    kw = dict(n_requests=12, rate=4.0, prompt_dist=("uniform", 3, 20),
              output_dist=("uniform", 1, 6), vocab=300, seed=5,
              shared_prefix=(24, 0.75))
    got, want = synthesize(TrafficConfig(**kw)), jax_synthesize(
        JaxTrafficConfig(**kw))
    assert [(r.prompt, r.max_new_tokens, r.arrival) for r in got] == \
        [(r.prompt, r.max_new_tokens, r.arrival) for r in want]
    pre = got[0].prompt[:24] if len(got[0].prompt) > 24 else None
    assert sum(r.prompt[:24] == pre for r in got) >= 6
    for bad in ((0, 0.5), (8, 0.0), (8, 1.5)):
        with pytest.raises(ValueError, match="shared_prefix"):
            TrafficConfig(shared_prefix=bad)


def test_prefix_cache_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine("smollm-135m", prefix_cache=True)
