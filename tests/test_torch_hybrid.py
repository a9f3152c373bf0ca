"""The port's hybrid family (zamba2-7b) against the JAX package, on the
CPU.

Two reduced configs in float32: the reference's ``reduced()`` (4 layers,
a shared attention block every 2: two full groups) and a 3-layer variant
whose second group holds one padded layer, the shape of the published 81
layers (13 full groups of 6 and one of 3 plus 3 padded).  The JAX params
(``build_model(cfg).init(jax.random.key(0))``) reach the port through
``params_from_jax``; both packages then run the same numpy inputs:

  * the config copy, ``n_params``, the group geometry and the param
    tree, key for key (one unstacked ``shared`` block beside ``blocks``
    stacked over the padded layers);
  * whole-prompt logits; the whole-prompt prefill cache (the shared
    block's k/v per group equal, the ssm ``state`` and ``conv`` zero as
    the reference leaves them); decode steps over it; chunked prefill
    (the decode step scanned over each chunk) against
    ``Model.prefill_chunk``, padded tail included;
  * the GELU MLP against ``jax.nn.gelu`` (its default, the tanh form,
    which torch's default is not);
  * flash's plain version at head_dim 112 against
    ``flash_attention_pallas`` in interpret mode, and a narrow hybrid at
    head_dim 112 (2 heads) through the model.

A padded layer passes ``x`` through in both packages; the reference's
scan still advances its ssm state and conv window (unread), the port's
leaves them at zero, so the caches are compared on the active layers and
the padded ones are checked zero.  The engines' streams are in
``tests/test_torch_hybrid_serve.py``; the CUDA kernels run only on the
card (``chip_smoke.py``).

Tolerance: atol = rtol = 1e-5 (float32; two frameworks' matmul and
summation orders).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jax_get_config
from repro.core.hw import TPU_REGISTRY
from repro.core.mapper import MappingPolicy as JaxPolicy
from repro.core.mapper import attention_plan_for_blocks as jax_attn_plan
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import build_model as jax_build_model
from repro.models import hybrid as jax_hybrid
from repro.models.layers import NO_SHARD
from repro.models.layers import mlp as jax_mlp

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model
from repro_torch.models import hybrid
from repro_torch.models.layers import mlp, param_shapes
from repro_torch.profiler import TraceStore, set_default_store
from repro_torch.serve import get_adapter
from repro_torch.tuner import TuningCache, set_default_cache
from repro_torch.weights import params_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
#: the reduced configs: label -> overrides of zamba2-7b's ``reduced()``
#: (4 layers, every 2), in both packages
CONFIGS = {"reduced": {}, "padded": dict(num_layers=3),
           "d112": dict(num_heads=2, num_kv_heads=2, head_dim=112)}

_WEIGHTS: dict = {}


@pytest.fixture(autouse=True)
def _memory_tuner():
    """TUNED plans from a memory-only cache and trace store: no test
    reads or writes the checkout's files."""
    set_default_cache(TuningCache(path=None))
    set_default_store(TraceStore(path=None))
    yield
    set_default_cache(None)
    set_default_store(None)


def _weights(label):
    """(JAX cfg, JAX model, JAX params, port cfg, port params), float32."""
    if label not in _WEIGHTS:
        over = dict(CONFIGS[label], dtype="float32")
        jcfg = dataclasses.replace(jax_get_config("zamba2-7b").reduced(),
                                   **over)
        tcfg = dataclasses.replace(get_config("zamba2-7b").reduced(), **over)
        jmodel = jax_build_model(jcfg)
        jparams = jmodel.init(jax.random.key(0))
        _WEIGHTS[label] = (jcfg, jmodel, jparams, tcfg, params_from_jax(
            jax.tree.map(np.asarray, jparams)))
    return _WEIGHTS[label]


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(1, 512, size=(b, s))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               err_msg=what)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _active(cfg):
    return torch.tensor(hybrid.active_flags(cfg))


def _check_cache(tc, jc, cfg, what):
    """k/v equal; state and conv equal on the active layers, zero on the
    padded ones (which the port skips)."""
    act = _active(cfg)
    for key in ("k", "v"):
        _close(tc[key], jc[key], f"{what} {key}")
    for key in ("state", "conv"):
        want = np.asarray(jc[key])
        assert tuple(tc[key].shape) == want.shape, key
        _close(tc[key][act], want[act.numpy()], f"{what} {key}")
        assert not tc[key][~act].any(), f"{what} padded {key}"


# --------------------------------------------------------------------------- #
# config and params
# --------------------------------------------------------------------------- #

FIELDS = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads",
          "d_ff", "vocab_size", "head_dim", "mlp_act", "tie_embeddings",
          "ssm_state", "ssm_expand", "ssm_head_dim", "ssm_groups", "ssm_conv",
          "hybrid_attn_every", "d_inner", "ssm_heads", "norm_eps", "dtype",
          "rope_theta", "is_attention_free")


def test_config_copies_the_reference():
    j, t = jax_get_config("zamba2-7b"), get_config("zamba2-7b")
    for cj, ct in ((j, t), (j.reduced(), t.reduced())):
        for f in FIELDS:
            assert getattr(ct, f) == getattr(cj, f), f
        assert ct.n_params() == cj.n_params()
        assert hybrid.n_groups(ct) == jax_hybrid.n_groups(cj)
        assert hybrid.padded_layers(ct) == jax_hybrid.padded_layers(cj)
    assert (t.num_layers, t.hybrid_attn_every, t.head_dim) == (81, 6, 112)
    assert (hybrid.n_groups(t), hybrid.padded_layers(t)) == (14, 84)
    assert t.reduced().num_layers == 4 and t.reduced().hybrid_attn_every == 2
    # the other families' reduced depth stays 2
    assert get_config("mamba2-1.3b").reduced().num_layers == 2
    # the reference's count (81 layers, the MLP counted as gated) and
    # what the tree stores (84 padded layers): 13.7 GB in bf16
    assert 6.6e9 < t.n_params() < 6.7e9
    stored = sum(int(np.prod(v[0]))
                 for v in _leaves(param_shapes(t)).values())
    assert 6.8e9 < stored < 6.9e9


@pytest.mark.parametrize("label", ["reduced", "padded"])
def test_params_from_jax_key_for_key(label):
    """The JAX tree, the port's spec and the port's own init hold the
    same keys and shapes; the conversion keeps every value."""
    jcfg, _, jparams, tcfg, tparams = _weights(label)
    jl = _leaves(jax.tree.map(np.asarray, jparams))
    tl = _leaves(tparams)
    spec = {k: v[0] for k, v in _leaves(param_shapes(tcfg)).items()}
    own = _leaves(build_model(tcfg, device="cpu").init(0))
    assert set(jl) == set(tl) == set(spec) == set(own)
    for k, a in jl.items():
        assert tuple(tl[k].shape) == a.shape == tuple(spec[k]) \
            == tuple(own[k].shape), k
        np.testing.assert_array_equal(tl[k].numpy(), a, err_msg=k)
    assert tl["shared.attn.wq"].dim() == 3
    assert tl["shared.mlp.w_in"].shape == (tcfg.d_model, tcfg.d_ff)
    assert tl["blocks.ssm.in_proj"].shape[0] == hybrid.padded_layers(tcfg) \
        == 4
    assert list(param_shapes(tcfg)) == ["embed", "shared", "blocks", "ln_f"]


def test_gelu_mlp_is_jax_gelu():
    """``mlp("gelu")`` is w_in, GELU (the tanh form, ``jax.nn.gelu``'s
    default), w_down; torch's default erf form would differ."""
    rng = np.random.default_rng(3)
    p = {"w_in": rng.standard_normal((16, 48)).astype(np.float32),
         "w_down": rng.standard_normal((48, 16)).astype(np.float32) * 0.1}
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 2
    want = jax_mlp({k: jnp.asarray(v) for k, v in p.items()},
                   jnp.asarray(x), "gelu", NO_SHARD)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = mlp(tp, torch.from_numpy(x), "gelu")
    _close(got, want, "gelu mlp")
    erf = F.gelu(torch.from_numpy(x) @ tp["w_in"]) @ tp["w_down"]
    assert np.abs(erf.numpy() - np.asarray(want)).max() > 1e-4


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("label", list(CONFIGS))
@pytest.mark.parametrize("seq", [5, 24])
def test_forward_logits_match_jax(label, seq):
    jcfg, jmodel, jparams, tcfg, tparams = _weights(label)
    toks = _tokens(2, seq, seed=seq)
    want = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})[0]
    got, (k, v) = hybrid.hybrid_forward(tparams, torch.from_numpy(toks),
                                        tcfg, prefill_tiles=(16, 16))
    _close(got, want, "logits")
    assert tuple(k.shape) == (hybrid.n_groups(tcfg), 2, seq,
                              tcfg.num_kv_heads, tcfg.head_dim)


@pytest.mark.parametrize("label", ["reduced", "padded"])
def test_whole_prompt_prefill_seeds_only_the_attention_cache(label):
    """The reference's hybrid prefill seeds the shared block's k/v and
    leaves the ssm state and conv window at zero ("simplified: zeros");
    the port mirrors it, so the next decode step starts from zero state."""
    jcfg, jmodel, jparams, tcfg, tparams = _weights(label)
    toks = _tokens(2, 19, seed=7)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 32)
    tl, tc = build_model(tcfg, device="cpu").prefill(
        tparams, torch.from_numpy(toks), 32, prefill_tiles=(16, 16),
        last_pos=[18, 11])
    jl2, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 32,
                            last_pos=[18, 11])
    _close(tl, jl2, "last-token logits")
    assert tc["pos"] == int(jc["pos"]) == 19
    _check_cache(tc, jc, tcfg, "prefill")
    assert not tc["state"].any() and not tc["conv"].any()
    assert tc["state"].dtype == torch.float32
    assert tuple(tc["k"].shape) == (hybrid.n_groups(tcfg), 2, 32,
                                    tcfg.num_kv_heads, tcfg.head_dim)


@pytest.mark.parametrize("label", list(CONFIGS))
def test_decode_steps_match_jax(label):
    """Three decode steps over the prefilled cache at ragged per-row
    positions (the pool's vector ``pos``): logits and caches."""
    jcfg, jmodel, jparams, tcfg, tparams = _weights(label)
    model = build_model(tcfg, device="cpu")
    toks = _tokens(2, 12, seed=2)
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 32)
    _, tc = model.prefill(tparams, torch.from_numpy(toks), 32,
                          prefill_tiles=(16, 16))
    pos = np.array([12, 9], np.int32)
    jc = dict(jc, pos=jnp.asarray(pos))
    tc = dict(tc, pos=torch.from_numpy(pos))
    step = _tokens(2, 1, seed=5)
    jstep = jax.jit(jmodel.decode_step)
    for i in range(3):
        jl, jc = jstep(jparams, jc, jnp.asarray(step))
        tl, tc = model.decode_step(tparams, tc, torch.from_numpy(step))
        _close(tl, jl, f"step {i} logits")
        _check_cache(tc, jc, tcfg, f"step {i}")
        step = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
    assert tc["pos"].tolist() == [15, 12]


@pytest.mark.parametrize("label", ["reduced", "padded"])
def test_chunk_steps_match_jax_prefill_chunk(label):
    """Chunked prefill of a 21-token prompt in chunks of 8 (the last
    holding 5 and 3 pads) into a 32-long row cache: each chunk's valid
    logits and the caches after it; the padded steps leave the cache as
    it was."""
    jcfg, jmodel, jparams, tcfg, tparams = _weights(label)
    model = build_model(tcfg, device="cpu")
    prompt = _tokens(1, 21, seed=4)[0]
    jc, tc = jmodel.init_cache(1, 32), model.init_cache(1, 32)
    jchunk = jax.jit(jmodel.prefill_chunk)
    for start in (0, 8, 16):
        n = min(8, len(prompt) - start)
        buf = np.zeros((1, 8), np.int64)
        buf[0, :n] = prompt[start:start + n]
        jl, jc = jchunk(jparams, jc, jnp.asarray(buf, jnp.int32), n)
        tl, tc = model.prefill_chunk(tparams, tc, torch.from_numpy(buf), n,
                                     prefill_tiles=(16, 16))
        _close(tl[:, :n], np.asarray(jl)[:, :n], f"chunk at {start}")
        assert not tl[:, n:].any()
        _check_cache(tc, jc, tcfg, f"chunk at {start}")
        assert tc["pos"] == int(jc["pos"]) == start + n
    assert tc["state"][_active(tcfg)].abs().sum() > 0


def test_hybrid_adapter_and_unported_families():
    ad = get_adapter("hybrid")
    assert ad.length_keys == ("k", "v") and ad.grows_with_len
    assert ad.prefill_buckets and not ad.shareable_prefix
    with pytest.raises(NotImplementedError, match="queue 1 item 9c"):
        get_adapter("vlm")


# --------------------------------------------------------------------------- #
# flash at head_dim 112
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("r,sq,causal", [(1, 40, True), (2, 128, False)])
def test_flash_plain_matches_pallas_at_d112(r, sq, causal):
    """Grouped flash at zamba2-7b's head_dim 112 against the Pallas kernel
    in interpret mode, per (group, head) as the JAX package vmaps it."""
    rng = np.random.default_rng(112)
    g, d = 2, 112
    q = rng.standard_normal((1, sq, g, r, d)).astype(np.float32)
    k = rng.standard_normal((1, sq, g, d)).astype(np.float32)
    v = rng.standard_normal((1, sq, g, d)).astype(np.float32)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), block_q=16, block_k=32,
                             causal=causal).numpy()
    hw = TPU_REGISTRY["cpu_sim"]
    plan = jax_attn_plan(sq, sq, d, hw, 16, 32, JaxPolicy.TUNED,
                         dtype_bytes=4)
    pallas = jax.vmap(jax.vmap(
        lambda qh, kh, vh: flash_attention_pallas(
            qh, kh, vh, hw=hw, plan=plan, causal=causal, interpret=True),
        in_axes=(1, None, None), out_axes=1), in_axes=(1, 1, 1), out_axes=1)
    want = np.asarray(pallas(jnp.asarray(q[0]), jnp.asarray(k[0]),
                             jnp.asarray(v[0])))
    _close(got[0], want, "flash D 112")


def test_d112_is_built_in_both_dtypes():
    from repro_torch.core.mapper import flash_f32_lanes

    for dt in (torch.float32, torch.bfloat16):
        assert 112 in fa.HEAD_DIMS[dt]
    # two lanes of 56 values a row in the f32 kernel, as at 128 (64 each)
    assert (flash_f32_lanes(112), flash_f32_lanes(128),
            flash_f32_lanes(64)) == (2, 2, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_path_takes_d112(dtype, monkeypatch):
    """At head_dim 112 the kernel path passes the wrapper's checks and
    reaches the build with D 112 (CPU tensors reach it only because
    ``use_plain`` is patched off; the build is stubbed)."""
    seen = []

    def no_build(name):
        seen.append(name)
        raise RuntimeError("no nvcc here")

    monkeypatch.setattr(kernels, "use_plain", lambda t: False)
    monkeypatch.setattr(_build, "load", no_build)
    q = torch.zeros(1, 32, 2, 1, 112, dtype=dtype)
    k = torch.zeros(1, 32, 2, 112, dtype=dtype)
    with pytest.raises(RuntimeError, match="no nvcc"):
        fa.flash_attention(q, k, k, block_q=32, block_k=32)
    assert seen == ["flash_attention"]


def test_cli_serves_zamba2_on_cpu():
    out = serve_main(["--arch", "zamba2-7b", "--device", "cpu",
                      "--requests", "4", "--slots", "2", "--max-len", "64",
                      "--max-new", "4"])
    assert out["summary"]["n_completed"] == 4 and out["n_rejected"] == 0
    assert out["radix"] is None
