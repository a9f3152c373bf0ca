"""The port's kernels, on the CPU: each plain PyTorch version against the
JAX function it replaces, on the same numpy inputs (the Pallas kernels
run in interpret mode, as the JAX package's own tests run them), plus
the wrappers' dispatch rules, the Hopper legality of the Eq. 1 mapper,
and the build's rebuild rule.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each against its plain version there.

Tolerance: atol = rtol = 1e-5 in float32 (summation order only).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.hw import TPU_REGISTRY
from repro.core.mapper import MappingPolicy, attention_plan_for_blocks
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.paged_decode_attention import (
    paged_decode_attention_pallas, paged_decode_attention_ref)
from repro.models.attention import tiled_prefill_attention

from repro_torch import kernels
from repro_torch.core.hw import GPU_REGISTRY
from repro_torch.core.mapper import (decode_smem_bytes, flash_smem_bytes,
                                     plan_attention_blocks, plan_paged_block)
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import paged_gather as pg
from repro_torch.kernels.paged_gather import flat_position

TOL = dict(atol=1e-5, rtol=1e-5)
H100 = GPU_REGISTRY["h100_sxm"]


def _paged_case(seed, b=3, t=64, g=2, r=2, d=32, bs=16):
    """Random paged-decode inputs: disjoint per-row leases over permuted
    physical blocks, ragged cache lengths (one of them 1), -1 tails."""
    rng = np.random.default_rng(seed)
    nb = t // bs
    clen = rng.integers(1, t + 1, size=b).astype(np.int32)
    clen[0] = 1
    perm = list(rng.permutation(b * nb))
    tables = np.full((b, nb + 2), -1, np.int32)      # wider than the row
    for i in range(b):
        for j in range(-(-int(clen[i]) // bs)):
            tables[i, j] = perm.pop()
    k = rng.standard_normal((b, t, g, d)).astype(np.float32)
    v = rng.standard_normal((b, t, g, d)).astype(np.float32)
    q = rng.standard_normal((b, g, r, d)).astype(np.float32)
    return q, k, v, tables, clen


@pytest.mark.parametrize("block_s", [16, 32, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_paged_decode_plain_matches_jax(block_s, seed):
    """Plain paged decode == the Pallas kernel (interpret) and the JAX
    blocked reference, with -1 table tails and ragged cache_len."""
    q, k, v, tables, clen = _paged_case(seed)
    got = pda.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables), torch.from_numpy(clen), page_block=16,
        block_s=block_s, split=block_s).numpy()
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(tables), jnp.asarray(clen))
    ref = np.asarray(paged_decode_attention_ref(*args, page_block=16,
                                                block_s=block_s))
    pallas = np.asarray(paged_decode_attention_pallas(
        *args, page_block=16, block_s=block_s, interpret=True))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("sq,tiles", [(40, (16, 16)), (64, (32, 48))])
def test_flash_plain_matches_pallas_per_head(sq, tiles):
    """Plain grouped flash == the Pallas flash kernel (interpret), run
    per (batch, group, head) at q_offset 0 as the JAX package vmaps it."""
    rng = np.random.default_rng(sq)
    b, g, r, d = 2, 2, 2, 32
    q = rng.standard_normal((b, sq, g, r, d)).astype(np.float32)
    k = rng.standard_normal((b, sq, g, d)).astype(np.float32)
    v = rng.standard_normal((b, sq, g, d)).astype(np.float32)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), block_q=tiles[0],
                             block_k=tiles[1]).numpy()
    hw = TPU_REGISTRY["cpu_sim"]
    plan = attention_plan_for_blocks(sq, sq, d, hw, tiles[0], tiles[1],
                                     MappingPolicy.TUNED, dtype_bytes=4)
    for bi in range(b):
        for gi in range(g):
            for ri in range(r):
                ref = np.asarray(flash_attention_pallas(
                    jnp.asarray(q[bi, :, gi, ri]), jnp.asarray(k[bi, :, gi]),
                    jnp.asarray(v[bi, :, gi]), hw=hw, plan=plan,
                    interpret=True))
                np.testing.assert_allclose(got[bi, :, gi, ri], ref, **TOL)


@pytest.mark.parametrize("start,c,sk", [(5, 8, 32), (21, 11, 32), (0, 16, 16)])
def test_flash_plain_matches_tiled_prefill_with_offset(start, c, sk):
    """Plain flash with a runtime q_offset == the JAX sweep
    ``tiled_prefill_attention`` that chunked prefill runs."""
    rng = np.random.default_rng(start)
    b, g, r, d = 1, 2, 2, 32
    q = rng.standard_normal((b, c, g, r, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, g, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, g, d)).astype(np.float32)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), block_q=16, block_k=16,
                             q_offset=start).numpy()
    ref = np.asarray(tiled_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=16,
        block_k=16, q_offset=start))
    np.testing.assert_allclose(got, ref, **TOL)


def _counts():
    return (pda.paged_decode_attention.launches,
            pda.paged_decode_attention.int8_launches,
            fa.flash_attention.launches, da.decode_attention.launches,
            pg.paged_gather.launches, pg.paged_dequant_gather.launches)


def test_cpu_tensors_take_plain_and_count_no_launch():
    q, k, v, tables, clen = (torch.from_numpy(a) for a in _paged_case(3))
    before = _counts()
    pda.paged_decode_attention(q, k, v, tables, clen, page_block=16,
                               block_s=16, split=16)
    codes = torch.zeros(k.shape, dtype=torch.int8)
    sc = torch.ones(k.shape[0], k.shape[1] // 16, k.shape[2])
    pda.paged_decode_attention(q, codes, codes, tables, clen, page_block=16,
                               block_s=16, split=16, k_scale=sc, v_scale=sc)
    x = torch.zeros(1, 4, 1, 1, 32)
    fa.flash_attention(x, x[:, :, :, 0], x[:, :, :, 0], block_q=16,
                       block_k=16)
    da.decode_attention(q, k, v, clen, block_s=16, split=16)
    pg.paged_gather(k, tables, 16)
    pg.paged_dequant_gather(codes, sc, tables, 16)
    assert _counts() == before


def test_wrappers_raise_on_masks_they_do_not_take():
    x = torch.zeros(1, 4, 1, 1, 32)
    with pytest.raises(NotImplementedError):
        fa.flash_attention(x, x[:, :, :, 0], x[:, :, :, 0], block_q=16,
                           block_k=16, window=8)
    with pytest.raises(NotImplementedError):
        fa.flash_attention(x, x[:, :, :, 0], x[:, :, :, 0], block_q=16,
                           block_k=16, prefix_len=2)
    with pytest.raises(NotImplementedError):
        pda.paged_decode_attention(x[:, 0], x[:, 0, :, 0], x[:, 0, :, 0],
                                   None, None, page_block=16, block_s=16,
                                   split=16, window=4)


def test_force_is_scoped_and_validated():
    t = torch.zeros(1)
    assert kernels.use_plain(t)                       # CPU tensor
    with kernels.force("plain"):
        assert kernels._mode == "plain"
        with kernels.force("kernel"):
            assert kernels._mode == "kernel"
        assert kernels._mode == "plain"
    assert kernels._mode == "kernel"
    with pytest.raises(ValueError):
        with kernels.force("ref"):
            pass


@pytest.mark.parametrize("case", ["dtype", "shape", "tables", "pages",
                                  "contiguous", "head_dim", "int8_codes",
                                  "int8_scale_shape", "int8_scale_dtype",
                                  "decode_block", "gather_pages",
                                  "dequant_codes"])
def test_kernel_input_checks_raise(case):
    """The checks run before a launch; they raise on what the kernels do
    not take."""
    q, k, v, tables, clen = (torch.from_numpy(a) for a in _paged_case(4))
    fq = torch.zeros(1, 8, 2, 2, 64)
    fk = torch.zeros(1, 8, 2, 64)
    codes = torch.zeros(k.shape, dtype=torch.int8)
    sc = torch.ones(k.shape[0], k.shape[1] // 16, k.shape[2])
    with pytest.raises((TypeError, ValueError)):
        if case == "dtype":
            pda._check(q.half(), k.half(), v.half(), tables, clen, 16, 16)
        elif case == "shape":
            pda._check(q, k[:, :, :1], v, tables, clen, 16, 16)
        elif case == "tables":
            pda._check(q, k, v, tables.long(), clen, 16, 16)
        elif case == "pages":
            pda._check(q, k, v, tables, clen, 16, 24)
        elif case == "contiguous":
            fa._check(fq.transpose(1, 2).contiguous().transpose(1, 2), fk,
                      fk, 16, 16, 0)
        elif case == "head_dim":
            fa._check(torch.zeros(1, 8, 2, 2, 48), torch.zeros(1, 8, 2, 48),
                      torch.zeros(1, 8, 2, 48), 16, 16, 0)
        elif case == "int8_codes":         # scales with non-int8 caches
            pda._check(q, k, v, tables, clen, 16, 16, sc, sc)
        elif case == "int8_scale_shape":
            pda._check(q, codes, codes, tables, clen, 16, 16, sc[:, :1],
                       sc[:, :1])
        elif case == "int8_scale_dtype":
            pda._check(q, codes, codes, tables, clen, 16, 16, sc.double(),
                       sc.double())
        elif case == "decode_block":       # not a multiple of 16
            da._check(q, k, v, clen, 24)
        elif case == "gather_pages":       # T not whole pages
            pg._check_tables(k.shape[0], 40, tables, 16, "paged_gather")
        else:
            pg.paged_dequant_gather(k.to("meta"), sc.to("meta"),
                                    tables.to("meta"), 16)


@pytest.mark.parametrize("seq", [1, 17, 512, 1024, 4096])
def test_mapper_plans_are_hopper_legal(seq):
    for hw in (H100, GPU_REGISTRY["cpu"]):
        plan = plan_attention_blocks(seq, seq, 64, hw)
        assert plan.block_q % 16 == 0 and 32 <= plan.block_q <= 128
        assert plan.block_k % 16 == 0 and plan.block_k >= 16
        assert flash_smem_bytes(plan.block_q, plan.block_k, 64) \
            <= hw.smem_per_block
        bs = plan_paged_block(seq, 64, 16, hw, heads_per_group=3)
        assert bs % 16 == 0 and 16 <= bs <= -(-seq // 16) * 16
        assert decode_smem_bytes(64, 3, 16) <= hw.smem_per_block


def test_eq1_reads_hp_from_the_sm_count():
    """Eq. 1 over SMs: more SMs, fewer query rows per CTA."""
    assert H100.hp() == 132 * 64 * 32
    assert plan_attention_blocks(4096, 4096, 64, H100).block_q == 32
    small = GPU_REGISTRY["cpu"]                          # 8 SMs
    assert plan_attention_blocks(1024, 1024, 64, small).block_q == 128
    assert plan_paged_block(1024, 64, 16, H100) == 16
    assert plan_paged_block(1024, 64, 16, small) == 128


def test_flat_position_is_column_major_over_the_grid():
    slots, t, bs = 3, 64, 16
    pid = np.arange(slots * t // bs)
    flat = flat_position(pid, np.zeros_like(pid), slots, t, bs)
    assert sorted(flat.tolist()) == list(range(0, slots * t, bs))
    assert (flat // t == pid % slots).all()


def test_build_names_libraries_by_source_hash(tmp_path, monkeypatch):
    """A library's name carries its source's hash: a changed source is
    rebuilt, a stale library never loads."""
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("int a;")
    first = _build._target("k")
    assert first.parent == tmp_path and first.suffix == ".so"
    (tmp_path / "k.cu").write_text("int b;")
    assert _build._target("k") != first
