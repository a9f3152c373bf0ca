"""The port's MoE layer and models against the JAX package, on the CPU.

The reduced configs (two layers, d_model 128, 8 experts, top-2,
``moe_dff`` 64) keep each model's features: deepseek-moe-16b's shared
expert and full multi-head attention (4 heads over 4 KV heads: R 1),
qwen3-moe-235b-a22b's qk-norm and no shared expert.  The JAX params
(``build_model(cfg).init(jax.random.key(0))``) reach the port through
``params_from_jax``; both packages then run the same numpy inputs in
float32:

  * ``moe_mlp`` against ``repro.models.moe.moe_mlp``: output and aux
    loss with and without shared experts, at the planned capacity and a
    tight one (tokens dropped), and with a zero router (every
    probability tied: the lower expert index must win); the routing
    itself (slots, positions, drops) against ``_route_one_group``;
  * ``plan_moe_capacity`` against the reference over a grid;
  * the config copies and the param trees, key for key;
  * whole-prompt logits, and a prefill followed by one decode step;
  * ``prefix_cache=True`` a no-op on moe in both engines (no radix, the
    streams of a run without it), prompts behind a shared preamble.

The engines' token streams on four paths are in
``tests/test_torch_moe_serve.py``.

Tolerance: atol 1e-5 on the layer (float32), 1e-4 on logits (two
frameworks' matmul and summation orders over two layers).
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jax_get_config
from repro.core.mapper import MappingPolicy as JaxPolicy
from repro.core.mapper import plan_moe_capacity as jax_capacity
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.models.layers import NO_SHARD

from repro_torch.configs import get_config
from repro_torch.core.mapper import MappingPolicy, plan_moe_capacity
from repro_torch.models import build_model
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.layers import param_shapes

from test_torch_dense_variants import (_engines, _leaves,  # noqa: F401
                                       _memory_tuner, _serve, _weights)

ARCHS = ("deepseek-moe-16b", "qwen3-moe-235b-a22b")
LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
#: the layer's input: B x S tokens routed as one group
B, S = 2, 16


def _layer_params(arch, *, zero_router=False):
    """Layer 0's MoE params in both packages (the port's from the JAX
    tree through ``params_from_jax``)."""
    jcfg, _, jparams, tcfg, tparams = _weights(arch)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["moe"])
    tp = tf.layer_params(tparams, 0)["moe"]
    if zero_router:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
        tp = dict(tp, router=torch.zeros_like(tp["router"]))
    return jcfg, jp, tcfg, tp


def _input(seed=3):
    return np.random.default_rng(seed).standard_normal(
        (B, S, 128)).astype(np.float32)


def _both(arch, capacity=None, zero_router=False):
    jcfg, jp, tcfg, tp = _layer_params(arch, zero_router=zero_router)
    h = _input()
    jy, jaux = jax_moe.moe_mlp(jp, jnp.asarray(h), jcfg, NO_SHARD,
                               capacity=capacity)
    ty, taux = moe.moe_mlp(tp, torch.from_numpy(h), tcfg, capacity=capacity)
    return (np.asarray(jy), float(jaux)), (ty.numpy(), float(taux))


#: (capacity, zero router): the planned capacity (16 of 32 tokens x 2
#: slots over 8 experts), a tight one (8: the mean, so busier experts
#: drop), every probability tied (experts 0 and 1 take every token, each
#: past its 16)
CASES = {"planned": (None, False), "tight": (8, False),
         "tied": (None, True)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_matches_jax(arch, case):
    capacity, zero = CASES[case]
    (jy, jaux), (ty, taux) = _both(arch, capacity, zero)
    np.testing.assert_allclose(ty, jy, atol=LAYER_TOL, rtol=0)
    assert taux == pytest.approx(jaux, abs=LAYER_TOL)
    assert np.abs(jy).max() > 0.01


@pytest.mark.parametrize("case", list(CASES))
def test_routing_matches_jax(case):
    """Slot for slot: the destination rows, the sorted tokens and gates,
    the kept slots; the tight and tied cases drop some slots, the planned
    one none."""
    capacity, zero = CASES[case]
    jcfg, jp, tcfg, tp = _layer_params("deepseek-moe-16b", zero_router=zero)
    e, k, t = tcfg.moe_experts, tcfg.moe_topk, B * S
    c = min(capacity or plan_moe_capacity(t, e, k), t)
    x = _input().reshape(t, -1)
    jbuf, (jdest, jtok, jgate, jkeep), _ = jax_moe._route_one_group(
        jnp.asarray(x), jp["router"], e, k, c, jcfg.mlp_act)
    tbuf, (tdest, ttok, tgate, tkeep, _), _, _, eidx = moe.route(
        torch.from_numpy(x), tp["router"], e, k, c)
    np.testing.assert_array_equal(tdest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(tgate.numpy(), np.asarray(jgate),
                               atol=LAYER_TOL, rtol=0)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    dropped = int((~tkeep).sum())
    assert (dropped > 0) == (case != "planned")
    if zero:
        assert (eidx == torch.arange(k)).all()
        assert dropped == 2 * (t - c)


POLICIES = ("naive", "fixed", "auto")


def test_plan_moe_capacity_matches_reference():
    for tokens, e, k, pol in itertools.product(
            (1, 2, 7, 8, 32, 100, 512, 1024, 4096), (8, 64, 128),
            (1, 2, 6, 8), POLICIES):
        want = jax_capacity(tokens, e, k, 1, JaxPolicy(pol))
        assert plan_moe_capacity(tokens, e, k, MappingPolicy(pol)) == want
    # TUNED plans as AUTO, its seed
    assert plan_moe_capacity(1000, 64, 6, "tuned") \
        == plan_moe_capacity(1000, 64, 6, "auto") == 120


FIELDS = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads",
          "d_ff", "vocab_size", "head_dim", "qk_norm", "rope_theta",
          "mlp_act", "tie_embeddings", "norm_eps", "dtype", "moe_experts",
          "moe_topk", "moe_shared_experts", "moe_dff")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_the_reference(arch):
    j, t = jax_get_config(arch), get_config(arch)
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), f
        assert getattr(t.reduced(), f) == getattr(j.reduced(), f), f
    for cfg in (t, t.reduced()):
        ref = dataclasses.replace(j, **{f: getattr(cfg, f) for f in FIELDS})
        assert cfg.n_params() == ref.n_params()
        assert cfg.n_params_active() == ref.n_params_active()
    assert t.heads_per_group == {"deepseek-moe-16b": 1,
                                 "qwen3-moe-235b-a22b": 16}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_key_for_key(arch):
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
    moe_keys = {k for k in tl if k.startswith("blocks.moe.")}
    want = {"router", "w_gate", "w_up", "w_down"}
    if tcfg.moe_shared_experts:
        want |= {"shared.w_gate", "shared.w_up", "shared.w_down"}
    assert moe_keys == {"blocks.moe." + k for k in want}
    assert not any(k.startswith("blocks.mlp.") for k in tl)
    # the draw's scales: min(0.02, fan_in^-0.5) with fan_in d or moe_dff
    assert float(own["blocks.moe.w_down"].std()) == pytest.approx(
        min(0.02, tcfg.moe_dff ** -0.5), rel=0.1)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=LOGIT_TOL, rtol=0, err_msg=what)


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
    _close(tk, jk, "k cache")
    _close(tv, jv, "v cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_jax(arch):
    """Prefill 11 tokens, decode the 12th over the contiguous cache, in
    both packages (the decode routes one token: no drop)."""
    jcfg, jmodel, jparams, tcfg, tparams = _weights(arch)
    toks = np.random.default_rng(2).integers(1, tcfg.vocab_size, (1, 12))
    model = build_model(tcfg, device="cpu")
    _, cache = model.prefill(tparams, torch.from_numpy(toks[:, :11]), 16,
                             prefill_tiles=(16, 16))
    cache = dict(cache, pos=torch.tensor([11]))
    step, _ = model.decode_step(tparams, cache,
                                torch.from_numpy(toks[:, 11:]))
    _, jcache = jmodel.prefill(jparams,
                               {"tokens": jnp.asarray(toks[:, :11],
                                                      jnp.int32)},
                               16, prefill_tiles=(16, 16))
    jstep, _ = jmodel.decode_step(jparams, jcache,
                                  jnp.asarray(toks[:, 11:], jnp.int32))
    _close(step[:, 0], jstep[:, 0], "decode step vs JAX")


#: prompts behind a shared 24-token preamble: a radix would hit on dense
PRE = list(range(40, 64))
SHARED = [PRE + [101, 102, 103], PRE + [77] * 9, PRE + [33, 44]]


def test_prefix_cache_is_a_no_op_on_moe():
    weights = _weights("deepseek-moe-16b")
    jeng, eng = _engines(weights, prefill_chunk=8, prefix_cache=True)
    want, jrep = _serve(jeng, SHARED)
    got, rep = _serve(eng, SHARED)
    assert got == want
    assert rep.radix is None and jrep.radix is None
    _, off = _engines(weights, prefill_chunk=8)
    assert _serve(off, SHARED)[0] == got
