"""The port's dense model against the JAX model on the same weights.

The JAX params (``build_model(cfg).init(jax.random.key(0))``) go through
numpy into ``repro_torch.weights.params_from_jax``; both models then run
the same numpy inputs at reduced width in float32.  Covered: whole
prefill, chunked prefill starting at an unaligned offset (with a tail
chunk overhanging the row cache), and paged decode over ragged rows with
-1 table entries (a retired row included).

Tolerance: atol 1e-4 on logits and caches (float32; two frameworks'
matmul and summation orders).
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

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.layers import param_shapes
from repro_torch.weights import params_from_jax

ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jax_get_config("smollm-135m").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                               dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, jmodel, jparams, tcfg, build_model(tcfg, device="cpu"), \
        tparams


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0, err_msg=what)


def test_reduced_config_matches_the_reference():
    j = jax_get_config("smollm-135m")
    t = get_config("smollm-135m")
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "head_dim", "rope_theta", "norm_eps", "dtype"):
        assert getattr(t, f) == getattr(j, f), f
        assert getattr(t.reduced(), f) == getattr(j.reduced(), f), f


def test_init_follows_the_reference_specs(pair):
    """Same tree, shapes and init scales as the JAX specs (the numbers
    differ: torch.Generator is not jax.random)."""
    _, _, jparams, tcfg, model, _ = pair
    ours = model.init(seed=0)
    jflat = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in jflat:
        node = ours
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
        if "ln" in jax.tree_util.keystr(path):
            assert float(node.abs().max()) == 0.0
        else:
            assert abs(float(node.std()) - float(np.std(leaf))) \
                < 0.1 * float(np.std(leaf)), path
    shapes = param_shapes(tcfg)
    assert shapes["embed"]["tok"][2] == 0.02
    assert torch.equal(model.init(seed=0)["ln_f"], ours["ln_f"])
    assert torch.equal(model.init(seed=3)["embed"]["tok"],
                       model.init(seed=3)["embed"]["tok"])


def test_params_from_jax_keeps_bf16_exact():
    a = jnp.asarray(np.random.default_rng(0).standard_normal((4, 8)),
                    jnp.bfloat16)
    t = params_from_jax({"w": {"x": np.asarray(a)}})["w"]["x"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))


@pytest.mark.parametrize("tiles", [(16, 16), (32, 64)])
def test_whole_prefill_matches(pair, tiles):
    jcfg, jmodel, jparams, tcfg, model, tparams = pair
    toks = np.random.default_rng(1).integers(1, tcfg.vocab_size, (2, 24))
    jl, _, (jk, jv) = jax_tf.forward(jparams, jnp.asarray(toks, jnp.int32),
                                     jcfg, return_cache=True,
                                     prefill_tiles=tiles)
    from repro_torch.models import transformer as tf
    tl, (tk, tv) = tf.forward(tparams, torch.from_numpy(toks), tcfg,
                              prefill_tiles=tiles)
    _close(tl, jl, "prefill logits")
    _close(tk, jk, "prefill k")
    _close(tv, jv, "prefill v")
    # the facade: last-position logits at ragged last_pos, padded cache
    last = [23, 9]
    jlast, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 32,
                               last_pos=jnp.asarray(last),
                               prefill_tiles=tiles)
    tlast, tc = model.prefill(tparams, torch.from_numpy(toks), 32,
                              last_pos=last, prefill_tiles=tiles)
    _close(tlast, jlast, "last-token logits")
    _close(tc["k"], jc["k"], "padded cache")
    assert tc["pos"] == int(jc["pos"]) == 24


def test_chunked_prefill_at_unaligned_offsets(pair):
    """Chunks of 5, 8 and 8 over a 16-long row cache: the second starts
    at an unaligned 5, the third overhangs the row (its tail drops)."""
    jcfg, jmodel, jparams, tcfg, model, tparams = pair
    toks = np.random.default_rng(2).integers(1, tcfg.vocab_size, (1, 21))
    jc = jmodel.init_cache(1, 16)
    tc = model.init_cache(1, 16)
    start = 0
    for c in (5, 8, 8):
        chunk = toks[:, start:start + c]
        jl, jc = jmodel.prefill_chunk(jparams, jc, jnp.asarray(chunk), c,
                                      prefill_tiles=(16, 16))
        tl, tc = model.prefill_chunk(tparams, tc, torch.from_numpy(chunk), c,
                                     prefill_tiles=(16, 16))
        _close(tl, jl, f"chunk logits at start {start}")
        start += c
        assert tc["pos"] == int(jc["pos"]) == start
    _close(tc["k"], jc["k"], "row cache k")
    _close(tc["v"], jc["v"], "row cache v")


def _pool_case(cfg, seed=3, b=3, t=64, bs=16):
    """A pool with ragged rows: two live leases over permuted blocks and a
    retired row (all -1) whose position keeps advancing."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, b, t, cfg.num_kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    pos = np.array([37, 9, 5], np.int32)
    tables = np.full((b, t // bs + 2), -1, np.int32)
    perm = list(rng.permutation(b * t // bs))
    for row, need in ((0, 48), (2, 20)):
        for j in range(-(-need // bs)):
            tables[row, j] = perm.pop()
    toks = rng.integers(1, cfg.vocab_size, (b, 1))
    return k, v, pos, tables, toks


@pytest.mark.parametrize("block_s", [16, 32])
def test_paged_decode_matches(pair, block_s):
    jcfg, _, jparams, tcfg, model, tparams = pair
    k, v, pos, tables, toks = _pool_case(tcfg)
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos)}
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
          "pos": torch.from_numpy(pos)}
    for step in range(3):
        jl, jc = jax_tf.decode_step(
            jparams, jc, jnp.asarray(toks, jnp.int32), jcfg,
            page_tables=jnp.asarray(tables), page_block=16,
            paged_decode_block=block_s)
        tl, tc = model.decode_step(
            tparams, tc, torch.from_numpy(toks),
            page_tables=torch.from_numpy(tables), page_block=16,
            paged_decode_block=block_s)
        _close(tl, jl, f"decode logits, step {step}")
        toks = np.asarray(jnp.argmax(jl[:, 0], -1))[:, None]
    _close(tc["k"], jc["k"], "pool k after writes")
    _close(tc["v"], jc["v"], "pool v after writes")
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_decode_paths_not_ported_raise(pair):
    *_, model, tparams = pair
    with pytest.raises(NotImplementedError):
        model.decode_step(tparams, {}, torch.zeros(1, 1, dtype=torch.long))
