"""qwen3-8b and nemotron-4-340b in the port against the JAX package, on
the CPU.

The reduced configs (two layers, d_model 128, 4 heads over 2 KV heads,
head_dim 32) keep each model's features: qwen3's qk-norm (RMSNorm of q
and k over head_dim, before RoPE) and untied unembedding, nemotron's
squared-ReLU MLP (``w_in``/``w_down``) and untied unembedding.  The JAX
params (``build_model(cfg).init(jax.random.key(0))``) reach the port
through ``params_from_jax``; both packages then run the same numpy
inputs in float32:

  * the config copies and the param trees, key for key;
  * whole-prompt logits, and a prefill followed by one decode step
    against the whole prompt one token longer;
  * the serving CLI on both archs (``--arch``);
  * a radix hit on qwen3 (the engines' streams on the chunked,
    whole-prompt, int8 and ``fused_decode=False`` paths are in
    ``tests/test_torch_dense_serve.py``);
  * ``WIDE``: the reduced nemotron with its head geometry restored (24
    heads over 2 KV heads, head_dim 192: R 12, D 192) through the
    engine's default path.

The kernels' plain versions at that geometry are held against the JAX
functions in ``tests/test_torch_wide_heads.py``; the CUDA kernels run
only on the card (``chip_smoke.py``).

Tolerance: atol 1e-4 on logits (float32; two frameworks' matmul and
summation orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import transformer as jax_tf
from repro.serve import ServeEngine as JaxServeEngine
from repro.tuner import TuningCache as JaxTuningCache

from repro_torch.configs import get_config
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model
from repro_torch.models import transformer as tf
from repro_torch.models.layers import param_shapes
from repro_torch.profiler import TraceStore, set_default_store
from repro_torch.serve import ServeEngine
from repro_torch.tuner import TuningCache, set_default_cache
from repro_torch.weights import params_from_jax

ARCHS = ("qwen3-8b", "nemotron-4-340b")
ATOL = 1e-4
#: nemotron-4-340b's head geometry on the reduced config: R 12, D 192
WIDE = dict(num_heads=24, num_kv_heads=2, head_dim=192)
#: engine prompts: ragged, one past the first bucket (the pool grows)
PROMPTS = [[7, 3, 99], [11, 5, 2, 42, 17, 101, 9], list(range(2, 38))]
MAX_NEW = 3


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


def _weights(arch, **geometry):
    """(JAX cfg, JAX model, JAX params, port cfg, port params), float32,
    reduced (``geometry`` overrides the reduced head geometry in both)."""
    key = (arch, tuple(sorted(geometry.items())))
    if key not in _WEIGHTS:
        jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                                   dtype="float32", **geometry)
        tcfg = dataclasses.replace(get_config(arch).reduced(),
                                   dtype="float32", **geometry)
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.key(0))
        _WEIGHTS[key] = (jcfg, jmodel, jparams, tcfg, params_from_jax(
            jax.tree.map(np.asarray, jparams)))
    return _WEIGHTS[key]


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0, err_msg=what)


# --------------------------------------------------------------------------- #
# configs and params
# --------------------------------------------------------------------------- #

FIELDS = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads",
          "d_ff", "vocab_size", "head_dim", "qk_norm", "rope_theta",
          "mlp_act", "tie_embeddings", "norm_eps", "dtype")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_the_reference(arch):
    j, t = jax_get_config(arch), get_config(arch)
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), f
        assert getattr(t.reduced(), f) == getattr(j.reduced(), f), f
    assert t.heads_per_group == {"qwen3-8b": 4, "nemotron-4-340b": 12}[arch]


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_key_for_key(arch):
    """The JAX tree, the port's spec and the port's own init hold the
    same keys and shapes; the conversion keeps every value."""
    _, _, jparams, tcfg, tparams = _weights(arch)
    jl = _leaves(jax.tree.map(np.asarray, jparams))
    tl = _leaves(tparams)
    spec = {k: v[0] for k, v in _leaves(param_shapes(tcfg)).items()}
    own = _leaves(build_model(tcfg, device="cpu").init(0))
    assert set(jl) == set(tl) == set(spec) == set(own)
    for k, a in jl.items():
        assert tuple(tl[k].shape) == a.shape == tuple(spec[k]) \
            == tuple(own[k].shape), k
        np.testing.assert_array_equal(tl[k].numpy(), a, err_msg=k)
    extra = {"qwen3-8b": {"embed.unembed", "blocks.attn.q_norm",
                          "blocks.attn.k_norm", "blocks.mlp.w_gate"},
             "nemotron-4-340b": {"embed.unembed", "blocks.mlp.w_in"}}[arch]
    assert extra <= set(tl)
    assert float(own["embed.unembed"].std()) == pytest.approx(0.02, rel=0.1)


def test_unported_mlp_and_families_still_raise():
    gemma = get_config("smollm-135m")
    gemma = dataclasses.replace(gemma, mlp_act="geglu")
    with pytest.raises(NotImplementedError, match="queue 1 items 9b and 9c"):
        param_shapes(gemma)


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(arch):
    jcfg, _, jparams, tcfg, tparams = _weights(arch)
    toks = np.random.default_rng(1).integers(1, tcfg.vocab_size, (2, 24))
    jl, _, (jk, jv) = jax_tf.forward(jparams, jnp.asarray(toks, jnp.int32),
                                     jcfg, return_cache=True,
                                     prefill_tiles=(16, 16))
    tl, (tk, tv) = tf.forward(tparams, torch.from_numpy(toks), tcfg,
                              prefill_tiles=(16, 16))
    _close(tl, jl, "logits")
    _close(tk, jk, "k cache (q/k-normed, roped)")
    _close(tv, jv, "v cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(arch):
    """Prefill 11 tokens, decode the 12th over the contiguous cache: its
    logits equal the whole 12-token prompt's last, in both packages."""
    jcfg, _, jparams, tcfg, tparams = _weights(arch)
    toks = np.random.default_rng(2).integers(1, tcfg.vocab_size, (1, 12))
    model = build_model(tcfg, device="cpu")
    _, cache = model.prefill(tparams, torch.from_numpy(toks[:, :11]), 16,
                             prefill_tiles=(16, 16))
    cache = dict(cache, pos=torch.tensor([11]))
    step, _ = model.decode_step(tparams, cache,
                                torch.from_numpy(toks[:, 11:]))
    whole, _ = tf.forward(tparams, torch.from_numpy(toks), tcfg,
                          prefill_tiles=(16, 16))
    jwhole, _ = jax_tf.forward(jparams, jnp.asarray(toks, jnp.int32), jcfg,
                               prefill_tiles=(16, 16))
    _close(step[:, 0], whole[:, -1], "decode step vs forward")
    _close(step[:, 0], jwhole[:, -1], "decode step vs JAX forward")


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #


def _serve(engine, prompts=PROMPTS):
    reqs = [engine.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    report = engine.run()
    assert report.summary.n_completed == len(prompts)
    return [list(r.generated) for r in reqs], report


def _engines(weights, **opts):
    jcfg, _, jparams, tcfg, tparams = weights
    kw = dict(slots=2, max_len=64, **opts)
    return (JaxServeEngine(jcfg, params=jparams,
                           tuning_cache=JaxTuningCache(path=None), **kw),
            ServeEngine(tcfg, params=tparams, device="cpu", **kw))


def test_wide_group_engine_streams_match_jax():
    """The reduced nemotron at R 12, D 192 through the default path."""
    jeng, eng = _engines(_weights("nemotron-4-340b", **WIDE),
                         prefill_chunk=8)
    want, _ = _serve(jeng)
    got, _ = _serve(eng)
    assert got == want


#: a 24-token preamble (one full block and a tail) before three prompts
PRE = [5, 9, 2, 14, 7, 3, 11, 6, 4, 13, 8, 1, 10, 12, 15, 7, 9, 3, 5, 2, 8,
       11, 4, 6]
SHARED = [PRE + [101, 102, 103], PRE + [77] * 9, [250, 1], PRE + [33, 44]]


def test_radix_hit_on_qwen3_matches_jax():
    """The radix resumes a qwen3 prompt mid-way: the resumed chunk
    projects (q/k-norm, RoPE) only its suffix, and the streams and the
    radix's accounting equal the JAX engine's and the radix-off run's."""
    weights = _weights("qwen3-8b")
    jeng, eng = _engines(weights, prefill_chunk=8, prefix_cache=True)
    want, jrep = _serve(jeng, SHARED)
    got, rep = _serve(eng, SHARED)
    assert got == want
    assert rep.radix == jrep.radix and rep.radix["hits"] >= 1
    assert rep.radix["hit_tokens"] >= 16
    _, off = _engines(weights, prefill_chunk=8)
    assert _serve(off, SHARED)[0] == got


@pytest.mark.parametrize("arch,flags", [
    ("qwen3-8b", []), ("nemotron-4-340b", ["--kv-dtype", "int8"])])
def test_cli_serves_the_dense_archs_on_cpu(arch, flags):
    """``launch.serve --arch`` reaches both configs through the registry
    (at reduced width, the default); a name the registry lacks is
    refused."""
    out = serve_main(["--arch", arch, "--device", "cpu", "--requests", "3",
                      "--slots", "2", "--max-len", "48", "--max-new", "3",
                      *flags])
    assert out["summary"]["n_completed"] == 3 and out["n_rejected"] == 0
    with pytest.raises(KeyError, match="unknown arch"):
        serve_main(["--arch", arch + "-x", "--device", "cpu"])
