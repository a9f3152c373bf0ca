"""The kernels and pool writes of the engine's other decode paths, on the
CPU: each plain PyTorch version against the JAX function it replaces, on
the same seeded numpy inputs (the Pallas kernels in interpret mode, as
the JAX package's own tests run them).

  * the block-table gather (bitwise, unmapped -1 entries included) and
    the int8 dequant gather (bitwise in float32 and bfloat16), also at
    ``chip_smoke.py``'s gather shapes (pages of 1, 8 and 32, D 6 and
    100, G 1 and 8, repeated ids, tables wider than the row);
  * the contiguous grouped decode against ``pallas_decode_attention``
    and ``blocked_decode_attention`` (a cache_len-0 row included), and
    the suite's ``ops.decode_attention`` against the JAX op;
  * the int8 fused paged decode against the Pallas int8 kernel;
  * the int8 pool writes (``_paged_quant_write`` and the prompt
    quantisation of ``write_row``): codes and scales equal, through a
    retired row, a fresh block over stale codes and scale growth;
  * ``plan_cache_block``'s Hopper legality.

The CUDA kernels run only on the card: ``chip_smoke.py`` holds each
against its plain version there.

Tolerance: bitwise for the gathers and the int8 writes; atol = rtol =
1e-5 for the decodes in float32 (summation order only).
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.base import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.kernels.paged_decode_attention import paged_decode_attention_pallas
from repro.kernels.paged_gather import (paged_dequant_gather_pallas,
                                        paged_gather_pallas, paged_gather_ref)
from repro.models import build_model as jax_build_model
from repro.models.attention import (_paged_quant_write,
                                    blocked_decode_attention,
                                    pallas_decode_attention)
from repro.serve import get_adapter as jax_get_adapter

from repro_torch.configs import get_config
from repro_torch.core.dtypes import KV_FP32, KV_INT8, kv_dtype_spec
from repro_torch.core.hw import GPU_REGISTRY
from repro_torch.core.mapper import (decode_block_for, decode_smem_bytes,
                                     plan_cache_block)
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import paged_gather as pg
from repro_torch.models import build_model
from repro_torch.models.attention import paged_quant_write, paged_write_index
from repro_torch.serve import get_adapter

# the card's gather shapes and tables, (B, T, G, D, page)
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import GATHER_SHAPES, gather_tables  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
H100 = GPU_REGISTRY["h100_sxm"]


def _tables(rng, b, t, bs, clen, extra=2):
    """Disjoint per-row leases over permuted physical blocks, -1 tails
    and a table wider than the row."""
    nb = t // bs
    perm = list(rng.permutation(b * nb))
    tables = np.full((b, nb + extra), -1, np.int32)
    for i in range(b):
        for j in range(-(-int(clen[i]) // bs)):
            tables[i, j] = perm.pop()
    return tables


def _int8_pool(rng, b, t, g, d, bs):
    codes = rng.integers(-127, 128, (b, t, g, d)).astype(np.int8)
    ks = rng.uniform(0.001, 0.05, (b, t // bs, g)).astype(np.float32)
    return codes, ks


# --------------------------------------------------------------------------- #
# rows 5 and 6: the gathers
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_gather_plain_is_the_pallas_gather_bitwise(dtype):
    """Row 5: the logical view equals the Pallas gather (interpret) and
    the JAX reference bit for bit; unmapped entries read block 0."""
    rng = np.random.default_rng(0)
    b, t, g, d, bs = 3, 64, 2, 8, 16
    clen = np.array([40, 1, 0])
    tables = _tables(rng, b, t, bs, clen)
    cache = rng.standard_normal((b, t, g, d)).astype(np.float32)
    jc = jnp.asarray(cache, dtype)
    tc = torch.from_numpy(cache).to(getattr(torch, dtype))
    got = pg.paged_gather(tc, torch.from_numpy(tables), bs).float().numpy()
    pal = np.asarray(paged_gather_pallas(jc, jnp.asarray(tables), bs,
                                         interpret=True).astype(jnp.float32))
    ref = np.asarray(paged_gather_ref(jc, jnp.asarray(tables), bs)
                     .astype(jnp.float32))
    np.testing.assert_array_equal(got, pal)
    np.testing.assert_array_equal(got, ref)
    # the retired row (all -1) holds block 0's data, not zeros
    np.testing.assert_array_equal(got[2, :bs], tc.float().numpy()[0, :bs])


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_paged_dequant_gather_plain_is_the_pallas_gather_bitwise(out):
    """Row 6: codes x the page's group scale, in the output dtype, equal
    to the Pallas dequant gather (interpret) bit for bit."""
    rng = np.random.default_rng(1)
    b, t, g, d, bs = 3, 64, 3, 8, 16
    tables = _tables(rng, b, t, bs, np.array([64, 17, 0]))
    codes, ks = _int8_pool(rng, b, t, g, d, bs)
    got = pg.paged_dequant_gather(
        torch.from_numpy(codes), torch.from_numpy(ks),
        torch.from_numpy(tables), bs, out_dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out)
    pal = paged_dequant_gather_pallas(
        jnp.asarray(codes), jnp.asarray(ks), jnp.asarray(tables), bs,
        out_dtype=getattr(jnp, out), interpret=True)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(pal.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shape", GATHER_SHAPES, ids=str)
def test_paged_gather_shapes_plain_is_the_pallas_gather_bitwise(shape,
                                                                 dtype):
    """Row 5 at the card's gather shapes: -1 entries (block 0's data),
    repeated ids and a table wider than nb, bit for bit."""
    b, t, g, d, bs = shape
    rng = np.random.default_rng(t + d)
    tables = gather_tables(rng, b, t // bs)
    if dtype == "int8":
        cache = rng.integers(-127, 128, (b, t, g, d)).astype(np.int8)
        jc, tc = jnp.asarray(cache), torch.from_numpy(cache)
    else:
        cache = rng.standard_normal((b, t, g, d)).astype(np.float32)
        jc = jnp.asarray(cache, dtype)
        tc = torch.from_numpy(cache).to(getattr(torch, dtype))
    got = pg.paged_gather(tc, torch.from_numpy(tables), bs)
    pal = paged_gather_pallas(jc, jnp.asarray(tables), bs, interpret=True)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(pal.astype(jnp.float32)))


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GATHER_SHAPES, ids=str)
def test_paged_dequant_gather_shapes_plain_is_the_pallas_gather_bitwise(
        shape, out):
    """Row 6 at the card's gather shapes, bit for bit."""
    b, t, g, d, bs = shape
    rng = np.random.default_rng(t + d + 1)
    tables = gather_tables(rng, b, t // bs)
    codes, ks = _int8_pool(rng, b, t, g, d, bs)
    got = pg.paged_dequant_gather(
        torch.from_numpy(codes), torch.from_numpy(ks),
        torch.from_numpy(tables), bs, out_dtype=getattr(torch, out))
    pal = paged_dequant_gather_pallas(
        jnp.asarray(codes), jnp.asarray(ks), jnp.asarray(tables), bs,
        out_dtype=getattr(jnp, out), interpret=True)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(pal.astype(jnp.float32)))


# --------------------------------------------------------------------------- #
# row 4: the contiguous decode
# --------------------------------------------------------------------------- #


def _decode_case(seed, b=3, t=48, g=2, r=2, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, g, r, d)).astype(np.float32)
    k = rng.standard_normal((b, t, g, d)).astype(np.float32)
    v = rng.standard_normal((b, t, g, d)).astype(np.float32)
    clen = np.array([0, 17, t + 5][:b], np.int32)    # empty, ragged, overrun
    return q, k, v, clen


@pytest.mark.parametrize("block", [16, 32])
def test_decode_attention_plain_matches_pallas_and_blocked(block):
    """Row 4: the grouped plain sweep equals the Pallas decode kernel
    vmapped over (row, group, head) and the JAX blocked sweep; a row of
    length 0 gives zeros, a length past T reads the whole row."""
    q, k, v, clen = _decode_case(block)
    got = da.decode_attention(*(torch.from_numpy(a) for a in (q, k, v, clen)),
                              block_s=block, split=block).numpy()
    # a length past T means the whole row; the JAX sweeps take it
    # clamped (the blocked one would count its zero padding past T)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(np.minimum(clen, k.shape[1])))
    pal = np.asarray(pallas_decode_attention(*jargs, block=block,
                                             interpret=True))
    ref = np.asarray(blocked_decode_attention(*jargs, block=block))
    np.testing.assert_allclose(got, pal, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
    assert not got[0].any() and np.isfinite(got).all()


@pytest.mark.parametrize("policy", ["naive", "fixed", "auto"])
def test_ops_decode_attention_matches_the_jax_op(policy):
    """The suite's entry point: JAX layout q (..., d), caches
    (..., S, d), cache_len broadcast over the leading dims."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 3, 16)).astype(np.float32)
    k = rng.standard_normal((2, 3, 40, 16)).astype(np.float32)
    v = rng.standard_normal((2, 3, 40, 16)).astype(np.float32)
    clen = np.array([[5, 40, 1], [9, 7, 39]], np.int32)
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(clen),
                               policy=policy).numpy()
    want = np.asarray(jax_ops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(clen)))
    np.testing.assert_allclose(got, want, **TOL)
    full = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), policy=policy).numpy()
    np.testing.assert_allclose(full, np.asarray(jax_ops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))), **TOL)


# --------------------------------------------------------------------------- #
# row 3: the int8 fused paged decode
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("block_s", [16, 32])
def test_int8_paged_decode_plain_matches_pallas(block_s):
    """Row 3: the fused sweep over int8 codes, each page dequantised by
    its group scale, equals the Pallas int8 kernel (interpret)."""
    rng = np.random.default_rng(block_s)
    b, t, g, r, d, bs = 3, 64, 2, 2, 16, 16
    clen = np.array([1, 40, 64], np.int32)
    tables = _tables(rng, b, t, bs, clen)
    kc, ks = _int8_pool(rng, b, t, g, d, bs)
    vc, vs = _int8_pool(rng, b, t, g, d, bs)
    q = rng.standard_normal((b, g, r, d)).astype(np.float32)
    got = pda.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kc, vc, tables, clen)),
        page_block=bs, block_s=block_s, split=block_s,
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs)).numpy()
    pal = np.asarray(paged_decode_attention_pallas(
        *(jnp.asarray(a) for a in (q, kc, vc, tables, clen)), page_block=bs,
        block_s=block_s, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        interpret=True))
    np.testing.assert_allclose(got, pal, **TOL)


# --------------------------------------------------------------------------- #
# the int8 pool writes
# --------------------------------------------------------------------------- #


def test_paged_quant_write_matches_jax():
    """Decode writes into the int8 pool: the token's block requantises
    on scale growth, a fresh block (scale 0) over stale codes is wiped,
    a retired row (-1) and an overrun row write nothing — codes and
    scales bit for bit equal to ``_paged_quant_write``."""
    rng = np.random.default_rng(3)
    b, t, g, d, bs = 4, 32, 2, 8, 16
    cache = rng.integers(-127, 128, (b, t, g, d)).astype(np.int8)
    scale = rng.uniform(0.001, 0.02, (b, t // bs, g)).astype(np.float32)
    tables = np.array([[0, 4], [5, -1], [-1, -1], [2, 6]], np.int32)
    scale.reshape(-1, g)[(6 % b) * (t // bs) + 6 // b] = 0.0   # fresh block
    pos = np.array([3, 17, 9, 40], np.int32)         # ok, -1, retired, overrun
    for step in range(3):
        new = (rng.standard_normal((b, g, d)) * (1 + step)).astype(np.float32)
        jc, js = _paged_quant_write(
            jnp.asarray(cache), jnp.asarray(scale), jnp.asarray(new),
            jnp.asarray(pos), page_tables=jnp.asarray(tables), page_block=bs)
        tc, ts = torch.from_numpy(cache.copy()), torch.from_numpy(scale.copy())
        index = paged_write_index(torch.from_numpy(pos),
                                  torch.from_numpy(tables), bs, t)
        paged_quant_write(tc, ts, torch.from_numpy(new), index, bs)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        cache, scale = np.asarray(jc), np.asarray(js)
        pos = pos + np.array([1, 0, 1, 1], np.int32)
        pos[3] = 22 if step == 0 else pos[3]          # into block 6 (fresh)
    # block 6 (row 2, offset 16) held stale codes: only the two tokens
    # written since its scale was 0 are left
    fresh = cache.reshape(b * t, g, d)[2 * t + bs:2 * t + 2 * bs]
    assert not fresh[[i for i in range(bs) if i not in (6, 7)]].any()
    assert fresh[6].any() and fresh[7].any()


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_get_config("smollm-135m").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                               dtype="float32")
    return jax_build_model(jcfg), build_model(tcfg, device="cpu")


def test_int8_write_row_and_grow_match_jax(models):
    """Prompt quantisation: per-(logical block, group) amax scales on the
    lease's blocks, the lease's tail blocks zeroed (a recycled block's
    LOUD old scale must not survive a quiet new tenant), and growth pads
    the scale grid with zeros — codes and scales equal to JAX's."""
    jmodel, tmodel = models
    jad, tad = jax_get_adapter("dense"), get_adapter("dense")
    slots, kv_len, bs = 2, 64, 16
    nb = kv_len // bs
    jc = jad.init_pool(jmodel, slots, kv_len, kv_dtype="int8", block_size=bs)
    tc = tad.init_pool(tmodel, slots, kv_len, kv_dtype="int8", block_size=bs)
    assert tc["k"].dtype == torch.int8
    assert tc["k_scale"].shape == tuple(jc["k_scale"].shape)
    rng = np.random.default_rng(4)
    n_l, g, d = tc["k"].shape[0], tc["k"].shape[3], tc["k"].shape[4]
    blocks = [0, 2, 4, 6]
    for n, amp in ((40, 100.0), (12, 0.01)):       # loud, then quiet tenant
        row = {key: (amp * rng.standard_normal((n_l, 1, n, g, d))
                     ).astype(np.float32) for key in ("k", "v")}
        pid = np.asarray(blocks)
        tok = np.arange(n)
        p = pid[tok // bs]
        pm = (p % slots) * kv_len + (p // slots) * bs + tok % bs
        sm = (pid % slots) * nb + pid // slots
        jc = jad.write_row(jc, 0, {k: jnp.asarray(a) for k, a in row.items()},
                           n, kv_len, page_map=jnp.asarray(pm),
                           scale_map=sm.astype(np.int32), page_block=bs)
        tc = tad.write_row(tc, 0, {k: torch.from_numpy(a)
                                   for k, a in row.items()}, n, kv_len,
                           page_map=torch.from_numpy(pm),
                           scale_map=torch.from_numpy(sm), page_block=bs)
        for key in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(tc[key].numpy(),
                                          np.asarray(jc[key]), err_msg=key)
    assert tc["k_scale"].reshape(n_l, -1, g)[:, sm[1:]].abs().max() == 0
    jg, tg = jad.grow(jc, 128), tad.grow(tc, 128)
    for key in ("k", "k_scale", "v_scale"):
        np.testing.assert_array_equal(tg[key].numpy(), np.asarray(jg[key]))


def test_unpaged_write_row_pads_the_slot_row(models):
    """The contiguous pool: the row cache replaces the slot's whole row,
    zero-padded past the prompt bucket, as JAX's ``write_row``."""
    jmodel, tmodel = models
    jad, tad = jax_get_adapter("dense"), get_adapter("dense")
    jc, tc = jad.init_pool(jmodel, 2, 64), tad.init_pool(tmodel, 2, 64)
    rng = np.random.default_rng(5)
    shape = tuple(tc["k"].shape)
    stale = rng.standard_normal(shape).astype(np.float32)
    jc = dict(jc, k=jnp.asarray(stale), v=jnp.asarray(stale))
    tc = dict(tc, k=torch.from_numpy(stale.copy()),
              v=torch.from_numpy(stale.copy()))
    row = {key: rng.standard_normal((shape[0], 1, 32) + shape[3:]).astype(
        np.float32) for key in ("k", "v")}
    jc = jad.write_row(jc, 1, {k: jnp.asarray(a) for k, a in row.items()},
                       20, 64)
    tc = tad.write_row(tc, 1, {k: torch.from_numpy(a)
                               for k, a in row.items()}, 20, 64)
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))


# --------------------------------------------------------------------------- #
# planning and the dtype vocabulary
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("s", [1, 17, 512, 1024, 4096])
def test_plan_cache_block_is_hopper_legal(s):
    """Every policy's block is a multiple of 16, at most the cache
    rounded up to 16, and its staged tiles fit shared memory."""
    for hw in (H100, GPU_REGISTRY["cpu"]):
        for policy in ("naive", "fixed", "auto"):
            bs = plan_cache_block(s, 64, hw, policy, heads_per_group=3)
            assert bs % 16 == 0 and 16 <= bs <= -(-s // 16) * 16
            assert decode_smem_bytes(64, 3) <= hw.smem_per_block


def test_plan_cache_block_policies_differ():
    """NAIVE 16, FIXED 512 (the split sweep stages at most 32 positions
    a stage, so its shared memory no longer grows with block_s and 512
    needs no legalising), AUTO Eq. 1's positions per SM."""
    plans = {p: plan_cache_block(4096, 64, H100, p, heads_per_group=3)
             for p in ("naive", "fixed", "auto")}
    assert plans == {"naive": 16, "fixed": 512, "auto": 32}
    assert decode_block_for(4096, 64, H100, 31, 3) == 32
    # TUNED plans as its AUTO seed here (the tuner refines it); a name
    # that is no policy raises
    assert plan_cache_block(4096, 64, H100, "tuned",
                            heads_per_group=3) == plans["auto"]
    with pytest.raises(ValueError):
        plan_cache_block(4096, 64, H100, "fastest")


def test_kv_dtype_spec_is_the_reference_vocabulary():
    from repro.core import dtypes as jd
    for name in (None, "default", "fp32", "float32", "int8"):
        ours, ref = kv_dtype_spec(name), jd.kv_dtype_spec(name)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert kv_dtype_spec(KV_INT8) is KV_INT8 and KV_FP32.bytes is None
    with pytest.raises(ValueError) as ours:
        kv_dtype_spec("fp8")
    with pytest.raises(ValueError) as ref:
        jd.kv_dtype_spec("fp8")
    assert str(ours.value) == str(ref.value)
