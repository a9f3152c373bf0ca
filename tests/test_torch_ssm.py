"""The port's Mamba-2 model and its serving against the JAX package, on
the CPU.

The reduced mamba2-1.3b (the reference's ``reduced()`` dims) in float32,
with the JAX params (``build_model(cfg).init(jax.random.key(0))``)
handed over through ``params_from_jax``: forward logits within 1e-4, the
prefill cache (state and conv tail, short prompts included) and a few
decode steps' state and conv within 1e-5, and the port's engine emitting
the JAX engine's token streams for the four prompts of
``tests/test_serve.py``'s family test through two slots (slot
recycling), with whole-prompt and chunked prefill, on the fp and the
int8 pool (which quantises nothing on a length-free cache).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro.tuner import TuningCache

from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.hw import GPU_REGISTRY
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model
from repro_torch.profiler import TraceStore, set_default_store
from repro_torch.serve import BucketRouter, BucketSpec, ServeEngine, \
    get_adapter
from repro_torch.tuner import TuningCache as PortTuningCache
from repro_torch.tuner import set_default_cache
from repro_torch.weights import params_from_jax

PROMPTS = [[7, 3, 99], [11, 5, 2, 42, 17, 101, 9], [250, 1],
           [33, 44, 55, 66]]
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
    jcfg = dataclasses.replace(jax_get_config("mamba2-1.3b").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("mamba2-1.3b").reduced(),
                               dtype="float32")
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams))


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(1, 512, size=(b, s))


def test_reduced_dims_equal_the_reference():
    t, j = get_config("mamba2-1.3b"), jax_get_config("mamba2-1.3b")
    for cfg_t, cfg_j in ((t, j), (t.reduced(), j.reduced())):
        for f in ("num_layers", "d_model", "vocab_size", "ssm_state",
                  "ssm_expand", "ssm_head_dim", "ssm_groups", "ssm_conv",
                  "d_inner", "ssm_heads", "is_attention_free", "norm_eps",
                  "dtype", "tie_embeddings", "head_dim"):
            assert getattr(cfg_t, f) == getattr(cfg_j, f), f


def test_params_carry_the_ssm_tree(weights):
    jcfg, jparams, tcfg, tparams = weights
    ours = build_model(tcfg, device="cpu").init(seed=0)
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == 11
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        t, o = tparams, ours
        for k in keys:
            t, o = t[k], o[k]
        assert tuple(t.shape) == leaf.shape == tuple(o.shape), keys
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    ssm = ours["blocks"]["ssm"]
    assert (ssm["d_skip"] == 1).all() and (ssm["a_log"] == 0).all()


@pytest.mark.parametrize("seq", [1, 37, 130])
def test_forward_logits_match_jax(weights, seq):
    jcfg, jparams, tcfg, tparams = weights
    toks = _tokens(2, seq)
    want = jax_build_model(jcfg).forward(jparams,
                                         {"tokens": jnp.asarray(toks)})[0]
    from repro_torch.models.ssm import ssm_forward
    got = ssm_forward(tparams, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("seq", [2, 3, 17, 600])
def test_prefill_cache_matches_jax(weights, seq):
    """State and conv tail from prefill(return_cache); a prompt shorter
    than K-1 = 3 sees the left zero pad; 600 tokens plan chunk 8."""
    jcfg, jparams, tcfg, tparams = weights
    toks = _tokens(1, seq, seed=seq)
    jl, jc = jax_build_model(jcfg).prefill(
        jparams, {"tokens": jnp.asarray(toks)}, seq + 4)
    tl, tc = build_model(tcfg, device="cpu").prefill(
        tparams, torch.from_numpy(toks), seq + 4, prefill_tiles=None)
    assert tc["pos"] == seq and set(tc) == {"state", "conv", "pos"}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for key in ("state", "conv"):
        assert tuple(tc[key].shape) == jc[key].shape
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=1e-5, atol=1e-5)


def test_decode_steps_match_jax(weights):
    jcfg, jparams, tcfg, tparams = weights
    jm, tm = jax_build_model(jcfg), build_model(tcfg, device="cpu")
    toks = _tokens(2, 9)
    _, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, 16)
    _, tc = tm.prefill(tparams, torch.from_numpy(toks), 16,
                       prefill_tiles=None)
    step = _tokens(2, 1, seed=5)
    for _ in range(4):
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(step))
        tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(step),
                                decode_block=16, page_tables=None)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        for key in ("state", "conv"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       rtol=1e-5, atol=1e-5)
        step = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
    assert tc["pos"] == 13


@pytest.mark.parametrize("chunk,kv_dtype", [(None, "fp32"),
                                            ("auto", "fp32"),
                                            (2, "fp32"),
                                            ("auto", "int8")],
                         ids=["whole", "auto", "chunk2", "auto-int8"])
def test_engine_streams_match_jax(weights, chunk, kv_dtype):
    """Four requests through two slots (recycling); exact-length
    prefill, or chunks of the configured width (auto: 32, one chunk per
    prompt here; 2: several, with a padded tail) scanned by the decode
    step; int8 quantises nothing on the length-free cache."""
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(slots=2, max_len=64, prefill_chunk=chunk, kv_dtype=kv_dtype)
    jax_eng = JaxServeEngine(jcfg, params=jparams,
                             tuning_cache=TuningCache(path=None), **kw)
    eng = ServeEngine(tcfg, params=tparams, device="cpu", **kw)
    outs = []
    for e in (jax_eng, eng):
        reqs = [e.submit(p, max_new_tokens=MAX_NEW) for p in PROMPTS]
        report = e.run()
        assert report.summary.n_completed == len(PROMPTS)
        outs.append([report.outputs[r.rid] for r in reqs])
    assert outs[0] == outs[1]
    assert set(eng._cache) == {"state", "conv", "pos"}
    assert eng._cache["state"].dtype == torch.float32
    assert report.prefill_tiles == {} and report.decode_blocks == {}


def test_chunked_prefill_keeps_the_width_and_scans_the_decode(weights):
    """"auto" is 32 for an attention-free family, kept (not clamped to
    the 3-token row) because the row cache is length-free."""
    jcfg, jparams, tcfg, tparams = weights
    eng = ServeEngine(tcfg, params=tparams, device="cpu", slots=2,
                      max_len=64)
    seen = []
    tick = eng._prefill_tick

    def spy():
        if eng._chunk_tasks:
            seen.append((eng._chunk_tasks[0].chunk, eng._chunk_tasks[0].pb))
        return tick()
    eng._prefill_tick = spy
    eng.submit([5, 6, 7], max_new_tokens=2)
    eng.run()
    assert seen and all(c == 32 and pb == 3 for c, pb in seen)


def test_ssm_adapter_router_and_unported_families():
    ad = get_adapter("ssm")
    assert not ad.grows_with_len and ad.prefill_len(37, lambda n: 64) == 37
    assert get_adapter("dense").prefill_len(37, lambda n: 64) == 64
    cfg = get_config("mamba2-1.3b")
    assert cfg.head_dim == 2048 and cfg.is_attention_free
    router = BucketRouter(cfg, BucketSpec(max_len=1024), slots=8,
                          hw=GPU_REGISTRY["h100_sxm"], page_block=16)
    plan = router.resolve(router.bucket(600))
    assert plan.decode_block is None and plan.paged_decode_block is None
    assert router.prefill_tiles(600) is None
    moe = ModelConfig(name="m", family="moe", num_layers=1, d_model=8,
                      num_heads=1, num_kv_heads=1, d_ff=8, vocab_size=8)
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        build_model(moe, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        get_adapter("hybrid")


def test_cli_serves_mamba2_on_cpu(capsys):
    out = serve_main(["--arch", "mamba2-1.3b", "--device", "cpu",
                      "--requests", "6", "--slots", "2", "--max-len", "64"])
    assert out["summary"]["n_completed"] == 6
    assert out["n_rejected"] == 0
