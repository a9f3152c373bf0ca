"""The kernel variants nemotron-4-340b's and qwen3-8b's head geometry
needs, on the CPU: the plain PyTorch versions against the JAX functions
at R 12 / D 192 (nemotron: 96 heads over 8 KV heads, head_dim 192) and
R 16 / D 256, R 16 / D 128, and flash in float32 at head_dim 128
(qwen3's), on the same seeded numpy inputs:

  * flash against ``flash_attention_pallas`` in interpret mode, per
    (group, head) as the JAX package vmaps it;
  * the paged decode (fp and int8 codes with per-page group scales)
    against ``paged_decode_attention_ref``, the contiguous decode against
    ``decode_attention_grouped``, both gathers at D 192 against
    ``paged_gather_ref`` / ``paged_dequant_gather_ref`` bit for bit;
  * the decode sweep's runs of heads (``decode_head_chunks``): a mirror
    of the kernels' virtual-group indexing against the plain version;
    the plans, shared memory and TUNED's tiles at the new dims.

The CUDA kernels run only on the card: ``chip_smoke.py`` holds each
variant against its plain version there.

Tolerance: atol = rtol = 1e-5 on attention outputs (float32, summation
order only), bitwise on the gathers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.hw import TPU_REGISTRY
from repro.core.mapper import MappingPolicy as JaxPolicy
from repro.core.mapper import attention_plan_for_blocks as jax_attn_plan
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.paged_decode_attention import paged_decode_attention_ref
from repro.kernels.paged_gather import (paged_dequant_gather_ref,
                                        paged_gather_ref)
from repro.models.attention import decode_attention_grouped

from repro_torch.core.hw import GPU_REGISTRY
from repro_torch.core.mapper import (decode_head_chunks, decode_smem_bytes,
                                     plan_decode_split)
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import paged_gather as pg
from repro_torch.tuner import KERNEL_REGISTRY, TuningCache, resolve_plan

TOL = dict(atol=1e-5, rtol=1e-5)
H100 = GPU_REGISTRY["h100_sxm"]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("g,r,d", [(2, 12, 192), (2, 4, 128)],
                         ids=["R12-D192", "f32-D128"])
def test_flash_plain_matches_pallas_at_new_head_dims(g, r, d):
    """Grouped flash at R 12 / D 192 (nemotron) and at qwen3's D 128 (the
    f32 kernel's new width) against the Pallas kernel in interpret
    mode, per (group, head) as the JAX package vmaps it."""
    rng = np.random.default_rng(d)
    sq = 40
    q, k, v = _rand(rng, 1, sq, g, r, d), _rand(rng, 1, sq, g, d), \
        _rand(rng, 1, sq, g, d)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), block_q=16,
                             block_k=32).numpy()
    hw = TPU_REGISTRY["cpu_sim"]
    plan = jax_attn_plan(sq, sq, d, hw, 16, 32, JaxPolicy.TUNED,
                         dtype_bytes=4)
    pallas = jax.vmap(jax.vmap(
        lambda qh, kh, vh: flash_attention_pallas(
            qh, kh, vh, hw=hw, plan=plan, interpret=True),
        in_axes=(1, None, None), out_axes=1), in_axes=(1, 1, 1), out_axes=1)
    want = np.asarray(pallas(jnp.asarray(q[0]), jnp.asarray(k[0]),
                             jnp.asarray(v[0])))
    np.testing.assert_allclose(got[0], want, **TOL)


def _pool(rng, b=3, t=96, g=2, d=192, pb=16, lens=(1, 50, 96)):
    """A paged pool at (B, T, G, D): disjoint leases over permuted blocks,
    -1 tails, ragged lengths (one of 1, one full)."""
    nb = t // pb
    perm = list(rng.permutation(b * nb))
    tables = np.full((b, nb + 1), -1, np.int32)
    for i in range(b):
        for j in range(-(-lens[i] // pb)):
            tables[i, j] = perm.pop()
    return tables, np.array(lens, np.int32)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_paged_decode_plain_matches_jax_at_r12_d192(quant):
    rng = np.random.default_rng(12)
    b, t, g, r, d, pb = 3, 96, 2, 12, 192, 16
    tables, clen = _pool(rng)
    q = _rand(rng, b, g, r, d)
    if quant:
        k = rng.integers(-127, 128, (b, t, g, d)).astype(np.int8)
        v = rng.integers(-127, 128, (b, t, g, d)).astype(np.int8)
        ks = (rng.random((b, t // pb, g)) * 0.05 + 1e-3).astype(np.float32)
        vs = (rng.random((b, t // pb, g)) * 0.05 + 1e-3).astype(np.float32)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        k, v, scales = _rand(rng, b, t, g, d), _rand(rng, b, t, g, d), {}
    got = pda.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables), torch.from_numpy(clen), page_block=pb,
        block_s=32, split=32,
        **{n: torch.from_numpy(a) for n, a in scales.items()}).numpy()
    want = np.asarray(paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(clen), page_block=pb, block_s=32,
        **{n: jnp.asarray(a) for n, a in scales.items()}))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("r,d", [(12, 192), (16, 256), (16, 128)])
def test_contiguous_decode_plain_matches_jax(r, d):
    rng = np.random.default_rng(r + d)
    b, t, g = 3, 80, 2
    q, k, v = _rand(rng, b, g, r, d), _rand(rng, b, t, g, d), \
        _rand(rng, b, t, g, d)
    clen = np.array([0, 33, 80], np.int32)
    got = da.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(clen),
                              block_s=16, split=16).numpy()
    want = np.asarray(decode_attention_grouped(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(clen)))
    np.testing.assert_allclose(got[1:], want[1:], **TOL)
    assert not got[0].any()          # a row of length 0: zeros


def test_gathers_plain_bitwise_at_d192():
    """Rows 5 and 6 at D 192 need no change: the plain versions equal
    the JAX references bit for bit (the copy, and the dequant into f32
    and bf16)."""
    rng = np.random.default_rng(5)
    b, t, g, d, pb = 3, 96, 2, 192, 16
    tables, _ = _pool(rng, lens=(96, 40, 0))
    cache = _rand(rng, b, t, g, d)
    got = pg.paged_gather(torch.from_numpy(cache), torch.from_numpy(tables),
                          pb).numpy()
    want = np.asarray(paged_gather_ref(jnp.asarray(cache),
                                       jnp.asarray(tables), pb))
    np.testing.assert_array_equal(got, want)
    codes = rng.integers(-127, 128, (b, t, g, d)).astype(np.int8)
    scale = (rng.random((b, t // pb, g)) * 0.05 + 1e-3).astype(np.float32)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = pg.paged_dequant_gather(
            torch.from_numpy(codes), torch.from_numpy(scale),
            torch.from_numpy(tables), pb, out_dtype=tdt).float().numpy()
        want = np.asarray(paged_dequant_gather_ref(
            jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(tables), pb,
            out_dtype=jdt).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# the sweep's runs of heads, plans and TUNED at the new dims
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("r,d,runs", [(3, 64, 1), (8, 128, 1), (12, 128, 2),
                                      (16, 128, 2), (12, 192, 3),
                                      (16, 256, 4), (8, 192, 2), (7, 192, 7),
                                      (1, 256, 1)])
def test_decode_head_chunks(r, d, runs):
    assert decode_head_chunks(d, r) == runs
    rh = r // runs
    assert rh * runs == r and rh <= (8 if d <= 128 else 4)


@pytest.mark.parametrize("r,d", [(12, 192), (16, 256), (16, 128)])
def test_virtual_group_indexing_equals_plain(r, d):
    """A mirror of the kernels' indexing: the grid's y runs over G x n_hc
    virtual groups, each reading rh consecutive heads of q (B, G, R, D)
    viewed as (B, G n_hc, rh, D) and the cache of group gv // n_hc, and
    writing the same view of out; the result equals the plain version."""
    rng = np.random.default_rng(r * d)
    b, t, g = 2, 48, 2
    q, k, v = (torch.from_numpy(a) for a in (
        _rand(rng, b, g, r, d), _rand(rng, b, t, g, d),
        _rand(rng, b, t, g, d)))
    clen = torch.tensor([17, 48], dtype=torch.int32)
    runs = decode_head_chunks(d, r)
    rh = r // runs
    qv = q.reshape(b, g * runs, rh, d)
    out = torch.empty_like(qv)
    for gv in range(g * runs):
        out[:, gv] = da.decode_attention_plain(
            qv[:, gv:gv + 1].contiguous(), k[:, :, gv // runs:gv // runs + 1],
            v[:, :, gv // runs:gv // runs + 1], clen, block_s=16,
            scale=d ** -0.5)[:, 0]
    want = da.decode_attention_plain(q, k, v, clen, block_s=16)
    torch.testing.assert_close(out.reshape(b, g, r, d), want, **TOL)


@pytest.mark.parametrize("r,d", [(12, 192), (16, 256), (16, 128), (4, 128)])
def test_decode_plans_at_new_geometry(r, d):
    """The sweep's shared memory stays under 48 KB at every cache dtype;
    the split counts the runs of heads as CTAs; the wrappers take the
    shape."""
    for pb in (None, 16):
        assert decode_smem_bytes(d, r, pb) <= 48 * 1024
    w1 = plan_decode_split(1024, 64, 16, d, H100, heads_per_group=r,
                           page_block=16)
    assert w1 % 16 == 0 and w1 <= 1024
    q = torch.zeros(2, 2, r, d)
    k = torch.zeros(2, 32, 2, d)
    da._check(q, k, k, torch.zeros(2, dtype=torch.int32), 16)
    pda._check(q, k, k, torch.full((2, 2), -1, dtype=torch.int32),
               torch.zeros(2, dtype=torch.int32), 16, 16)


def test_decode_wrappers_refuse_past_r16_d256():
    q = torch.zeros(1, 1, 17, 64)
    k = torch.zeros(1, 16, 1, 64)
    with pytest.raises(ValueError, match="R <= 16"):
        da._check(q, k, k, torch.zeros(1, dtype=torch.int32), 16)
    q, k = torch.zeros(1, 1, 1, 264), torch.zeros(1, 16, 1, 264)
    with pytest.raises(ValueError, match="D <= 256"):
        da._check(q, k, k, torch.zeros(1, dtype=torch.int32), 16)


@pytest.mark.parametrize("dtype,d,built", [
    ("float32", 128, True), ("float32", 32, True), ("bfloat16", 192, True),
    ("float32", 192, False), ("bfloat16", 168, False)])
def test_tuned_flash_resolves_real_tiles_at_built_dims(dtype, d, built):
    """TUNED prices a built head_dim at a finite cost and resolves a
    legal tile; an unbuilt one is priced at infinity.  The signature
    carries D (and the decode's R)."""
    desc = {"seq_q": 512, "seq_kv": 512, "head_dim": d, "dtype": dtype,
            "dtype_bytes": 4 if dtype == "float32" else 2, "causal": True,
            "batch": 32}
    spec = KERNEL_REGISTRY["flash_attention"]
    seed = spec.plan_value(spec.seed_plan(desc, H100, "auto"))
    cost = spec.cost_model(desc, H100)(seed)
    assert np.isfinite(cost) == built
    if built:
        plan, info = resolve_plan("flash_attention", H100, "tuned", desc,
                                  TuningCache(path=None))
        assert plan.smem_bytes <= H100.smem_per_block
        assert np.isfinite(info.cost) and info.cost <= info.seed_cost
        assert plan.block_q % 16 == 0 and plan.block_k % 16 == 0
        assert d in fa.HEAD_DIMS[getattr(torch, dtype)]
    key = spec.sig(desc, "tuned").key
    assert str(d) in key
    dec = {"s": 1024, "d": d, "rows": 16, "heads_per_group": 12,
           "dtype": dtype, "dtype_bytes": desc["dtype_bytes"],
           "page_block": 16, "max_blocks_per_row": 64}
    pspec = KERNEL_REGISTRY["paged_decode"]
    dkey = pspec.sig(dec, "tuned").key
    assert "12" in dkey and str(d) in dkey
    plan, _ = resolve_plan("paged_decode", H100, "tuned", dec,
                           TuningCache(path=None))
    assert plan[0] % 16 == 0 and plan[1] % plan[0] == 0
