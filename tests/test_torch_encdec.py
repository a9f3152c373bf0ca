"""The port's encoder-decoder family (whisper-medium) against the JAX
package, on the CPU.

The reduced config in float32 (2 encoder and 2 decoder layers, 24 stub
frames, d_model 128, 4 heads over 2 KV heads at head_dim 32).  The JAX
params (``build_model(cfg).init(jax.random.key(0))``) reach the port
through ``params_from_jax``; both packages then run the same numpy
inputs, with distinct seeded frames per row (the engine's stub frames
are zeros, so every request's cross K/V are equal and a slot mix-up
could not show in its streams):

  * the config copy (the encoder fields and ``reduced()``), ``n_params``
    and the param tree, key for key;
  * ``_sinusoid``, ``encode``, the prefill's logits and caches (the self
    K/V padded to the row, the cross ck/cv), and decode steps at ragged
    per-row positions on the paged pool (fused), the int8 pool and the
    contiguous pool;
  * flash's plain version non-causal at Sq != Sk with ragged tails, and
    the plain decode sweep over a full 1,500-position cross cache, each
    against the reference's ``chunked_attention``;
  * the adapter (ck/cv land shape-exact, stay in the model's dtype on
    the int8 pool, never grow), the tiles and the cross read's plan.

The engines' streams are in ``tests/test_torch_encdec_serve.py``; the
CUDA kernels run only on the card (``chip_smoke.py``).

Tolerance: atol = rtol = 1e-5 (float32; two frameworks' matmul and
summation orders), except the sinusoid at 1,500 positions (one float32
ulp of its largest angle, 1499 rad: 1.3e-4).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import encdec as jax_encdec
from repro.models.attention import chunked_attention
from repro.models.layers import NO_SHARD
from repro.serve import get_adapter as jax_get_adapter

from repro_torch.configs import get_config
from repro_torch.core.hw import GPU_REGISTRY
from repro_torch.core.mapper import plan_attention_blocks, plan_encdec_tiles
from repro_torch.kernels.decode_attention import check_split, decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_gather import flat_position
from repro_torch.models import build_model
from repro_torch.models import encdec
from repro_torch.models.layers import param_shapes
from repro_torch.serve import ServeEngine, get_adapter
from repro_torch.weights import params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
#: one float32 ulp of 1499 (the sinusoid's largest angle at 1,500
#: positions): XLA's and torch's pow and sin may each round it apart
SINUSOID_TOL = 1.3e-4
H100 = GPU_REGISTRY["h100_sxm"]

_WEIGHTS: dict = {}


def _weights():
    """(JAX cfg, JAX model, JAX params, port cfg, port params), float32."""
    if not _WEIGHTS:
        jcfg = dataclasses.replace(jax_get_config("whisper-medium").reduced(),
                                   dtype="float32")
        tcfg = dataclasses.replace(get_config("whisper-medium").reduced(),
                                   dtype="float32")
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.key(0))
        _WEIGHTS.update(jcfg=jcfg, jmodel=jmodel, jparams=jparams, tcfg=tcfg,
                        tparams=params_from_jax(
                            jax.tree.map(np.asarray, jparams)))
    w = _WEIGHTS
    return w["jcfg"], w["jmodel"], w["jparams"], w["tcfg"], w["tparams"]


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(1, 512, size=(b, s))


def _frames(b, cfg, seed):
    """Distinct seeded frames per row."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.encoder_tokens, cfg.d_model)).astype(
        np.float32)


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol,
                               err_msg=what)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


# --------------------------------------------------------------------------- #
# config and params
# --------------------------------------------------------------------------- #

FIELDS = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads",
          "d_ff", "vocab_size", "head_dim", "mlp_act", "tie_embeddings",
          "encoder_layers", "encoder_tokens", "qk_norm", "norm_eps", "dtype",
          "rope_theta", "is_attention_free")


def test_config_copies_the_reference():
    j, t = jax_get_config("whisper-medium"), get_config("whisper-medium")
    for cj, ct in ((j, t), (j.reduced(), t.reduced())):
        for f in FIELDS:
            assert getattr(ct, f) == getattr(cj, f), f
        assert ct.n_params() == cj.n_params()
    assert (t.encoder_layers, t.num_layers, t.d_model, t.head_dim,
            t.encoder_tokens, t.vocab_size) == (24, 24, 1024, 64, 1500, 51865)
    assert (t.reduced().encoder_layers, t.reduced().encoder_tokens) == (2, 24)
    # ~0.76 B parameters (1.5 GB in bf16); the tree also stores the
    # norms the reference's count leaves out (ln_x a layer, enc_ln_f)
    assert 7.5e8 < t.n_params() < 7.6e8
    stored = sum(int(np.prod(v[0]))
                 for v in _leaves(param_shapes(t)).values())
    assert stored - int(t.n_params()) == (t.num_layers + 1) * t.d_model
    # the other families keep no encoder
    assert get_config("smollm-135m").reduced().encoder_layers == 0


def test_params_from_jax_key_for_key():
    """The JAX tree, the port's spec and the port's own init hold the
    same keys and shapes; the conversion keeps every value."""
    jcfg, _, jparams, tcfg, tparams = _weights()
    jl = _leaves(jax.tree.map(np.asarray, jparams))
    tl = _leaves(tparams)
    spec = {k: v[0] for k, v in _leaves(param_shapes(tcfg)).items()}
    own = _leaves(build_model(tcfg, device="cpu").init(0))
    assert set(jl) == set(tl) == set(spec) == set(own)
    for k, a in jl.items():
        assert tuple(tl[k].shape) == a.shape == tuple(spec[k]) \
            == tuple(own[k].shape), k
        np.testing.assert_array_equal(tl[k].numpy(), a, err_msg=k)
    assert list(param_shapes(tcfg)) == ["embed", "enc_blocks", "enc_ln_f",
                                        "dec_blocks", "ln_f"]
    assert set(param_shapes(tcfg)["dec_blocks"]) == {
        "ln1", "attn", "ln2", "mlp", "ln_x", "cross"}
    assert tl["enc_blocks.mlp.w_in"].shape == (2, 128, 256)
    assert not own["dec_blocks.ln_x"].any()             # norms at zeros
    assert "enc_blocks.attn.q_norm" not in tl


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("t,d", [(24, 128), (1500, 1024)])
def test_sinusoid_matches_jax(t, d):
    got = encdec._sinusoid(t, d, "cpu")
    want = np.asarray(jax_encdec._sinusoid(t, d))
    tol = TOL if t <= 24 else dict(atol=SINUSOID_TOL, rtol=0)
    _close(got, want, "sinusoid", tol)
    # [sin, cos] concatenated, not interleaved: column d/2 is cos(pos)
    assert got[:, d // 2].tolist() == pytest.approx(
        torch.cos(torch.arange(t, dtype=torch.float32)).tolist(), abs=1e-6)


def test_encode_matches_jax():
    jcfg, _, jparams, tcfg, tparams = _weights()
    frames = _frames(2, tcfg, seed=1)
    want = jax_encdec.encode(jparams, jnp.asarray(frames), jcfg, ctx=NO_SHARD)
    got = encdec.encode(tparams, torch.from_numpy(frames), tcfg,
                        tiles=(16, 16))
    _close(got, want, "encoder states")
    assert not np.allclose(np.asarray(want)[0], np.asarray(want)[1])


@pytest.mark.parametrize("seq", [5, 24])
def test_forward_logits_and_caches_match_jax(seq):
    """Batch 2, distinct frames: the logits, the self K/V and the cross
    ck/cv of every layer."""
    jcfg, _, jparams, tcfg, tparams = _weights()
    toks, frames = _tokens(2, seq, seed=seq), _frames(2, tcfg, seed=seq)
    jl, _, ((jk, jv), (jck, jcv)) = jax_encdec.encdec_forward(
        jparams, jnp.asarray(toks), jnp.asarray(frames), jcfg,
        return_cache=True, ctx=NO_SHARD)
    tl, (k, v), (ck, cv) = encdec.encdec_forward(
        tparams, torch.from_numpy(toks), torch.from_numpy(frames), tcfg,
        prefill_tiles=(16, 16))
    _close(tl, jl, "logits")
    for got, want, what in ((k, jk, "k"), (v, jv, "v"), (ck, jck, "ck"),
                            (cv, jcv, "cv")):
        _close(got, want, what)
    assert tuple(ck.shape) == (2, 2, 24, 2, 32)
    assert not torch.allclose(ck[:, 0], ck[:, 1])


def test_prefill_cache_matches_jax_and_zero_frames_are_the_stub():
    """``Model.prefill`` with frames and ``last_pos`` against the JAX
    prefill, and without frames against the JAX prefill given the
    adapter's zeros."""
    jcfg, jmodel, jparams, tcfg, tparams = _weights()
    model = build_model(tcfg, device="cpu")
    toks, frames = _tokens(2, 19, seed=7), _frames(2, tcfg, seed=7)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks),
                                      "frames": jnp.asarray(frames)}, 32,
                            last_pos=[18, 11])
    tl, tc = model.prefill(tparams, torch.from_numpy(toks), 32,
                           prefill_tiles=(16, 16), last_pos=[18, 11],
                           frames=torch.from_numpy(frames))
    _close(tl, jl, "last-token logits")
    assert tc["pos"] == int(jc["pos"]) == 19
    for key in ("k", "v", "ck", "cv"):
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        _close(tc[key], jc[key], key)
    jextra = jax_get_adapter("encdec").prefill_extras(jmodel, 2)
    textra = get_adapter("encdec").prefill_extras(model, 2)
    assert tuple(textra["frames"].shape) == tuple(jextra["frames"].shape)
    assert not textra["frames"].any()
    jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks), **jextra},
                           32)
    tl, _ = model.prefill(tparams, torch.from_numpy(toks), 32,
                          prefill_tiles=(16, 16))
    _close(tl, jl, "logits on the stub frames")


def _pool_states(jmodel, jparams, model, tparams, cfg, path):
    """Both packages' pools (2 slots, 32 positions, pages of 16) holding
    two prefilled rows with distinct frames: through the block tables on
    the paged paths (the int8 pool quantising), in the slot rows on the
    contiguous one.  Returns (JAX cache, port cache, tables or None)."""
    slots, kv_len, bs = 2, 32, 16
    kw = dict(kv_dtype="int8") if path == "int8" else {}
    jad, tad = jax_get_adapter("encdec"), get_adapter("encdec")
    jc = jad.init_pool(jmodel, slots, kv_len, block_size=bs, **kw)
    tc = tad.init_pool(model, slots, kv_len, block_size=bs, **kw)
    leases = [[3, 0], [1, 2]]
    tables = np.asarray(leases, np.int32) if path != "contiguous" else None
    nb = kv_len // bs
    for slot, plen in ((0, 13), (1, 6)):
        toks = _tokens(1, 16, seed=20 + slot)
        toks[0, plen:] = 0
        frames = _frames(1, cfg, seed=30 + slot)
        _, jrow = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks),
                                           "frames": jnp.asarray(frames)},
                                 16, last_pos=[plen - 1])
        _, trow = model.prefill(tparams, torch.from_numpy(toks), 16,
                                prefill_tiles=(16, 16), last_pos=[plen - 1],
                                frames=torch.from_numpy(frames))
        opts = {}
        if tables is not None:
            pid = np.asarray(leases[slot], np.int64)
            tok = np.arange(plen)
            pm = flat_position(pid[tok // bs], tok, slots, kv_len, bs)
            opts = dict(page_map=pm)
            if path == "int8":
                opts.update(scale_map=(pid % slots) * nb + pid // slots,
                            page_block=bs)
        jc = jad.write_row(jc, slot, jrow, plen, kv_len,
                           **{k: (np.asarray(v, np.int32)
                                  if isinstance(v, np.ndarray) else v)
                              for k, v in opts.items()})
        tc = tad.write_row(tc, slot, trow, plen, kv_len,
                           **{k: (torch.from_numpy(v)
                                  if isinstance(v, np.ndarray) else v)
                              for k, v in opts.items()})
    return jc, tc, tables


@pytest.mark.parametrize("path", ["paged", "int8", "contiguous"])
def test_decode_steps_on_the_pool_match_jax(path):
    """Three decode steps at ragged per-row positions (the pool's vector
    ``pos``): the fused paged read, the int8 pool (self K/V only; ck/cv
    stay float32) and the contiguous rows; logits and the self K/V after
    each step, ck/cv untouched."""
    jcfg, jmodel, jparams, tcfg, tparams = _weights()
    model = build_model(tcfg, device="cpu")
    jc, tc, tables = _pool_states(jmodel, jparams, model, tparams, tcfg,
                                  path)
    assert tc["ck"].dtype == torch.float32
    assert (tc["k"].dtype == torch.int8) == (path == "int8")
    kw, jkw = {}, {}
    if tables is not None:
        kw = dict(page_tables=torch.from_numpy(tables), page_block=16,
                  paged_decode_block=16)
        jkw = dict(page_tables=jnp.asarray(tables), page_block=16,
                   paged_decode_block=16)
    ck0 = tc["ck"].clone()
    jstep = jax.jit(jmodel.decode_step, static_argnames=(
        "page_block", "paged_decode_block"))
    step = _tokens(2, 1, seed=5)
    for i in range(3):
        jl, jc = jstep(jparams, jc, jnp.asarray(step), **jkw)
        tl, tc = model.decode_step(tparams, tc, torch.from_numpy(step), **kw)
        _close(tl, jl, f"step {i} logits")
        for key in [k for k in ("k", "v", "k_scale", "v_scale") if k in tc]:
            _close(tc[key].float(), np.asarray(jc[key], np.float32),
                   f"step {i} {key}")
        step = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
    assert tc["pos"].tolist() == [16, 9]
    assert torch.equal(tc["ck"], ck0)


# --------------------------------------------------------------------------- #
# the kernels' plain versions at whisper's geometries
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("sq,sk,tiles", [(21, 50, (16, 16)),
                                         (37, 24, (32, 16)),
                                         (64, 150, (32, 64))])
def test_flash_plain_non_causal_matches_chunked_attention(sq, sk, tiles):
    """Flash's plain version with ``causal=False`` at Sq != Sk, both with
    ragged tails against the tiles (the encoder's 1,500 is a multiple of
    neither), against the reference's ``chunked_attention``."""
    rng = np.random.default_rng(sq)
    g, r, d = 4, 1, 64
    q = rng.standard_normal((2, sq, g, r, d)).astype(np.float32)
    k = rng.standard_normal((2, sk, g, d)).astype(np.float32)
    v = rng.standard_normal((2, sk, g, d)).astype(np.float32)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), block_q=tiles[0],
                          block_k=tiles[1], causal=False)
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=False)
    _close(got, want, "non-causal flash")


def test_decode_plain_over_a_full_cross_cache_matches_chunked_attention():
    """The contiguous sweep's plain version over a full 1,500-position
    cross cache (every row's ``cache_len`` 1500, ending inside a
    ``block_s`` window) at whisper's G 16 / R 1 / D 64 cut to 4 groups,
    against ``chunked_attention`` of the one query."""
    rng = np.random.default_rng(1500)
    b, t, g, r, d = 3, 1500, 4, 1, 64
    bs, w = encdec.cross_decode_plan(t, b * g, d, r, H100)
    assert t % bs
    q = rng.standard_normal((b, g, r, d)).astype(np.float32)
    k = rng.standard_normal((b, t, g, d)).astype(np.float32)
    v = rng.standard_normal((b, t, g, d)).astype(np.float32)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v),
                           torch.full((b,), t, dtype=torch.int32),
                           block_s=bs, split=w)
    want = chunked_attention(jnp.asarray(q)[:, None], jnp.asarray(k),
                             jnp.asarray(v), causal=False)[:, 0]
    _close(got, want, "cross decode")


def test_encdec_tiles_and_cross_plan_are_hopper_legal():
    """The encoder's and the cross-attention's flash tiles are
    ``plan_attention_blocks``'s at (1500, 1500) and (bucket, 1500), in
    multiples of 16 (the bf16 kernel's); the cross read's plan is AUTO's
    at 1,500 positions, a legal split."""
    for bucket in (32, 64, 512):
        enc, cross = plan_encdec_tiles(bucket, 1500, 64, H100)
        e = plan_attention_blocks(1500, 1500, 64, H100)
        c = plan_attention_blocks(bucket, 1500, 64, H100)
        assert enc == (e.block_q, e.block_k) and cross == (c.block_q,
                                                           c.block_k)
        assert not (enc[0] % 16 or enc[1] % 16 or cross[0] % 16
                    or cross[1] % 16)
    bs, w = encdec.cross_decode_plan(1500, 8 * 16, 64, 1, H100)
    assert bs % 16 == 0 and check_split(1500, bs, w) >= 1


# --------------------------------------------------------------------------- #
# the adapter and the entry points
# --------------------------------------------------------------------------- #


def test_encdec_adapter_keeps_the_cross_cache_static():
    """ck/cv are no length keys: the int8 pool leaves them in the
    model's dtype with no scales, a row lands shape-exact, and growth
    pads only the self K/V (and its scales), as the reference's."""
    jcfg, jmodel, jparams, tcfg, tparams = _weights()
    model = build_model(tcfg, device="cpu")
    ad, jad = get_adapter("encdec"), jax_get_adapter("encdec")
    assert ad.length_keys == ("k", "v") and ad.grows_with_len
    assert ad.prefill_buckets and not ad.shareable_prefix
    assert jad.length_keys == ad.length_keys
    jc, tc, _ = _pool_states(jmodel, jparams, model, tparams, tcfg, "int8")
    assert "ck_scale" not in tc and tc["ck"].dtype == torch.float32
    _close(tc["ck"], jc["ck"], "ck")
    grown, jgrown = ad.grow(tc, 64), jad.grow(jc, 64)
    assert grown["ck"] is tc["ck"] and grown["cv"] is tc["cv"]
    for key in ("k", "v", "k_scale", "v_scale"):
        assert tuple(grown[key].shape) == tuple(jgrown[key].shape), key
        _close(grown[key].float(), np.asarray(jgrown[key], np.float32), key)


def test_encdec_cannot_chunk_prefill():
    model = build_model(get_config("whisper-medium").reduced(), device="cpu")
    assert not model.supports_chunked_prefill
    assert build_model(get_config("zamba2-7b").reduced(),
                       device="cpu").supports_chunked_prefill
    with pytest.raises(ValueError, match="no chunked prefill"):
        model.prefill_chunk({}, {}, torch.zeros((1, 8), dtype=torch.long),
                            8, prefill_tiles=(16, 16))
    dense = build_model(get_config("smollm-135m").reduced(), device="cpu")
    with pytest.raises(ValueError, match="no encoder frames"):
        dense.prefill({}, torch.zeros((1, 4), dtype=torch.long), 16,
                      prefill_tiles=(16, 16), frames=torch.zeros(1))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is "
                    "present: the entry points run on it")
def test_entry_points_default_to_cuda_and_raise_without_it():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config("whisper-medium"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine("whisper-medium")
