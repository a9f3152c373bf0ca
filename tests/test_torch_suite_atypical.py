"""The port's atypical kernels on the CPU: ``repro_torch.kernels.ops``
(gaussian_blur, nn_search, gcn_aggregate; plain versions on CPU tensors)
against the JAX Pallas kernels in interpret mode, on the same seeded
numpy inputs, under each mapping policy and in float32 and bfloat16; and
the Hopper planners of the three ops against the JAX mapper's Eq. 1.

The sizes are small and not multiples of any plan's tiles: blur images
with ragged row blocks and a halo wider than the image; nr not a
multiple of any ``block_r``; graphs with empty rows, empty tiles and a
partly empty last tile.  The CUDA kernels run only on the card:
``chip_smoke.py`` holds each against its plain version there.

Tolerances (port vs JAX):
  blur     float32 atol = rtol = 1e-6 (the taps' exp and XLA's fusion of
           the tap sum may each differ by an ulp); bfloat16 atol 1e-6,
           rtol 8e-3 (one bf16 ulp) for at least 99.9% of the pixels, and
           everywhere one bf16 ulp of the largest row-pass value times
           the largest tap: both round the row pass to bf16, so a value
           on a rounding boundary may round the other way, and the column
           pass carries that ulp, weighted by its tap, into a pixel that
           may be smaller than it;
  search   idx equal (no near-ties in these seeded inputs; a built tie
           must give the lowest index); dist atol = rtol = 1e-5 (float32
           dot products in another order); the kernel's schedule (tiles,
           splits, merge) is modelled in tests/test_torch_nn_split.py;
  gcn      float32 atol = rtol = 1e-5 (summation order); bfloat16 atol
           1e-5, rtol 8e-3 (one ulp of one rounding from float32); the
           kernel's traversal (head, 16-byte vectors, tail, each element
           once, non-zeros in ascending column order) is mirrored in
           Python and its sums held to the same tolerances.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.hw import TPU_REGISTRY
from repro.core.mapper import MappingPolicy as JaxPolicy
from repro.core.mapper import classify_regime as jax_classify_regime
from repro.core.mapper import resolve_lws as jax_resolve_lws
from repro.kernels.gcn_agg import gcn_aggregate_pallas
from repro.kernels.nn_search import nn_search_pallas
from repro.kernels.ref import gaussian_kernel_1d as jax_taps
from repro.kernels.stencil import gaussian_blur_pallas

from repro_torch.core.hw import GPU_REGISTRY, round_up
from repro_torch.core.mapper import (FIXED_LWS, NN_CTAS_PER_SM,
                                     Regime, gcn_plan_for_block,
                                     nn_plan_for_block, nn_smem_bytes,
                                     nn_step_bytes, plan_gcn, plan_nn,
                                     plan_stencil, stencil_plan_for_block,
                                     stencil_smem_bytes)
from repro_torch.kernels import _build, ops
from repro_torch.kernels import gcn_agg as gc
from repro_torch.kernels import nn_search as nn
from repro_torch.kernels import stencil as st

TPU = TPU_REGISTRY["cpu_sim"]
H100 = GPU_REGISTRY["h100_sxm"]
CPU = GPU_REGISTRY["cpu"]
POLICIES = ["naive", "fixed", "auto"]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a torch tensor and a JAX array in ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32), np.float32)


def _graph(n: int, seed: int, empty=(3, 7)) -> np.ndarray:
    """Row-normalised symmetric graph with self-loops, edges mostly within
    64-node communities, and the nodes in ``empty`` cut off (empty rows
    and columns)."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), np.float32)
    for _ in range(2 * n):
        i = int(rng.integers(n))
        j = int(min(n - 1, i // 64 * 64 + rng.integers(64))
                if rng.random() < 0.9 else rng.integers(n))
        a[i, j] = a[j, i] = 1.0
    a[np.arange(n), np.arange(n)] = 1.0
    for i in empty:
        a[i, :] = 0.0
        a[:, i] = 0.0
    return a / np.maximum(a.sum(1, keepdims=True), 1.0)


# --------------------------------------------------------------------------- #
# ops against the Pallas kernels
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("h,w,ksize", [(37, 300, 3), (64, 64, 5),
                                       (130, 70, 7), (5, 3, 7)])
def test_gaussian_blur_matches_pallas(h, w, ksize, policy, dtype):
    rng = np.random.default_rng(h * w + ksize)
    img, jimg = _pair(rng.standard_normal((h, w)), dtype)
    got = ops.gaussian_blur(img, ksize=ksize, sigma=1.0, policy=policy)
    assert got.dtype == img.dtype and got.shape == (h, w)
    want = gaussian_blur_pallas(jimg, hw=TPU, ksize=ksize, sigma=1.0,
                                policy=JaxPolicy(policy), interpret=True)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)
        return
    # one bf16 ulp of the output for all but a few pixels; everywhere,
    # one bf16 ulp of the largest row-pass value times the largest tap
    taps = st.gaussian_kernel_1d(ksize, 1.0)
    inter = st.stencil_rows_plain(img, taps).float().abs().max().item()
    err = np.abs(_np(got) - _np(want))
    assert (err <= 1e-6 + 8e-3 * np.abs(_np(want))).mean() >= 0.999
    assert err.max() <= 2 ** -7 * inter * taps.max().item()


@pytest.mark.parametrize("ksize,sigma", [(3, 0.5), (5, 1.0), (7, 2.0)])
def test_taps_match_the_reference(ksize, sigma):
    got = st.gaussian_kernel_1d(ksize, sigma)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_taps(ksize, sigma)),
                               atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("nq,nr,d", [(64, 128, 8), (100, 300, 16),
                                     (17, 511, 4), (33, 700, 40)])
def test_nn_search_matches_pallas(nq, nr, d, policy, dtype):
    rng = np.random.default_rng(nq + nr + d)
    q, jq = _pair(rng.standard_normal((nq, d)), dtype)
    r, jr = _pair(rng.standard_normal((nr, d)), dtype)
    idx, dist = ops.nn_search(q, r, policy=policy)
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    assert idx.shape == dist.shape == (nq,)
    jidx, jdist = nn_search_pallas(jq, jr, hw=TPU, policy=JaxPolicy(policy),
                                   interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("policy", POLICIES)
def test_nn_search_ties_go_to_the_lowest_index(policy, dtype):
    """Refs 3, 9 and 600 are one vector (equal distances bit for bit);
    query 1 is equidistant from refs 10 and 20 (+-e0 about the origin)."""
    rng = np.random.default_rng(11)
    d, nr = 8, 601
    refs = rng.standard_normal((nr, d)) + 8.0
    refs[9] = refs[600] = refs[3]
    refs[10], refs[20] = 0.0, 0.0
    refs[10, 0], refs[20, 0] = 1.0, -1.0
    queries = np.stack([refs[3] + 1e-3, np.zeros(d)])
    q, jq = _pair(queries, dtype)
    r, jr = _pair(refs, dtype)
    idx, _ = ops.nn_search(q, r, policy=policy)
    jidx, _ = nn_search_pallas(jq, jr, hw=TPU, policy=JaxPolicy(policy),
                               interpret=True, block_r=512)
    assert idx.tolist() == [3, 10] == np.asarray(jidx).tolist()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("n,f", [(300, 40), (520, 33), (64, 128)])
def test_gcn_aggregate_matches_pallas(n, f, policy, dtype):
    rng = np.random.default_rng(n + f)
    adj, jadj = _pair(_graph(n, n), dtype)
    x, jx = _pair(rng.standard_normal((n, f)), dtype)
    got = ops.gcn_aggregate(adj, x, policy=policy)
    assert got.dtype == x.dtype and got.shape == (n, f)
    assert not got[3].any() and not got[7].any()          # empty rows
    want = gcn_aggregate_pallas(jadj, jx, hw=TPU, policy=JaxPolicy(policy),
                                interpret=True)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" \
        else dict(atol=1e-5, rtol=8e-3)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_nan_in_a_reaches_its_row_where_the_jax_wrapper_skips_its_tile():
    """A NaN weight is a non-zero to the port (plain version and kernel):
    its row's sums are NaN, as ``ref.gcn_aggregate``'s.  The JAX wrapper
    skips a tile whose ``sum |a|`` is NaN, so its output stays finite
    (ROADMAP.md, facts of the reference)."""
    n, f = 40, 8
    a = _graph(n, 1)
    a[5, 9] = np.nan
    adj, jadj = _pair(a, "float32")
    x, jx = _pair(np.random.default_rng(0).standard_normal((n, f)),
                  "float32")
    got = _np(ops.gcn_aggregate(adj, x, policy="auto"))
    want = _np(gcn_aggregate_pallas(jadj, jx, hw=TPU, interpret=True))
    assert np.isnan(got[5]).all()
    assert np.isfinite(np.delete(got, 5, axis=0)).all()
    assert np.isfinite(want).all()


# --------------------------------------------------------------------------- #
# the kernel's traversal of A, mirrored (csrc/gcn_agg.cu)
# --------------------------------------------------------------------------- #


GCN_BATCH = 8                  # csrc/gcn_agg.cu's kBatch


def _mirror_gcn(adj: torch.Tensor, feats: torch.Tensor, plan):
    """What ``gcn_kernel`` does under ``plan``, per feature tile and row:
    the scalar head up to the row's first 16-byte boundary (from the
    row's address), the 16-byte vectors in batches of ``GCN_BATCH`` a
    lane, the scalar tail; the non-zeros taken in (batch, lane, element)
    order and summed in f32.  Returns (out, reads per A element and
    feature tile, the row starts' byte offsets off 16)."""
    n, f = feats.shape
    es = adj.element_size()
    v = 16 // es
    a = adj.float().numpy()
    xf = feats.float().numpy()
    out = np.zeros((n, f), np.float32)
    reads = np.zeros((plan.grid[1], n, n), np.int64)
    starts = set()
    for fy in range(plan.grid[1]):
        f0 = fy * 32 * plan.fpl
        f1 = min(f, f0 + 32 * plan.fpl)
        for bx in range(plan.grid[0]):
            for warp in range(8):
                for j in range(plan.lws):
                    row = bx * 8 * plan.lws + warp + 8 * j
                    if row >= n:
                        break
                    addr = adj.data_ptr() + row * n * es
                    starts.add(addr % 16)
                    off = addr % 16 // es
                    head = min(n, v - off if off else 0)
                    nv = (n - head) // v
                    order = [np.arange(head)]
                    for v0 in range(0, nv, 32 * GCN_BATCH):
                        vs = (v0 + 32 * np.arange(GCN_BATCH)[:, None]
                              + np.arange(32)[None, :]).ravel()
                        vs = vs[vs < nv]
                        assert ((addr + (head + vs * v) * es) % 16 == 0).all()
                        order.append((head + vs[:, None] * v
                                      + np.arange(v)[None, :]).ravel())
                    tail0 = head + nv * v
                    assert 0 <= n - tail0 < v and (head == n or (
                        addr + head * es) % 16 == 0)
                    order.append(np.arange(tail0, n))
                    cols = np.concatenate(order)
                    np.add.at(reads[fy, row], cols, 1)
                    nz = cols[a[row, cols] != 0]
                    assert (np.diff(nz) > 0).all()      # ascending columns
                    acc = np.zeros(f1 - f0, np.float32)
                    for col in nz:
                        acc = acc + np.float32(a[row, col]) * xf[col, f0:f1]
                    out[row, f0:f1] = acc
    return torch.from_numpy(out).to(feats.dtype), reads, starts


GCN_MIRROR_N = (1, 7, 40, 520)


def _adj_at(a: np.ndarray, tdt, lead: int) -> torch.Tensor:
    """``a`` in ``tdt``, contiguous, its storage ``lead`` elements past
    the (16-byte aligned) start of its buffer."""
    n = a.shape[0]
    buf = torch.zeros(n * n + 8, dtype=tdt)
    adj = buf[lead:lead + n * n].view(n, n)
    adj.copy_(torch.from_numpy(a).to(tdt))
    return adj


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", GCN_MIRROR_N)
def test_gcn_kernel_traversal_reads_each_element_once_in_order(n, dtype):
    """Under each policy's plan and with A's storage 0 .. 3 elements past
    a 16-byte boundary: every A element read exactly once per feature
    tile, the head, vectors and tail as the kernel cuts them, the
    non-zeros in ascending column order, and the sums equal to the plain
    version's (a feature width of two tiles at n 40)."""
    tdt = DTYPES[dtype][0]
    f = 600 if n == 40 else 9
    a = _graph(n, n, empty=tuple(i for i in (3, 7) if i < n))
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (n, f)).astype(np.float32)).to(tdt)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" \
        else dict(atol=1e-5, rtol=8e-3)
    for lead in range(4):
        adj = _adj_at(a, tdt, lead)
        assert adj.data_ptr() % 16 == lead * adj.element_size()
        for policy in POLICIES:
            plan = plan_gcn(n, f, H100, policy)
            assert plan.grid[1] == (2 if n == 40 else 1)
            got, reads, starts = _mirror_gcn(adj, x, plan)
            assert (reads == 1).all()
            assert starts == {(adj.data_ptr() + r * n * adj.element_size())
                              % 16 for r in range(n)}
            np.testing.assert_allclose(
                _np(got), _np(gc.gcn_aggregate_plain(adj, x)), **tol)


def test_gcn_mirror_rows_start_at_every_offset():
    """The traversal cases above start rows 0, 2, 4, 8 and 12 bytes off
    16: f32 rows at 0, 4, 8 and 12, bf16 rows at every even offset."""
    for dtype, want in (("float32", {0, 4, 8, 12}),
                        ("bfloat16", set(range(0, 16, 2)))):
        tdt = DTYPES[dtype][0]
        seen = set()
        for n in GCN_MIRROR_N:
            for lead in range(4):
                adj = _adj_at(np.zeros((n, n), np.float32), tdt, lead)
                es = adj.element_size()
                seen |= {(adj.data_ptr() + r * n * es) % 16
                         for r in range(n)}
        assert seen == want


# --------------------------------------------------------------------------- #
# the planners: Eq. 1, regimes, coverage, legality
# --------------------------------------------------------------------------- #


BLUR_SHAPES = [(1, 1, 3), (5, 3, 7), (37, 300, 3), (256, 256, 5),
               (4096, 4096, 5), (4096, 4096, 7), (10_000, 77, 63)]
NN_SHAPES = [(1, 1, 1), (17, 511, 4), (4096, 65536, 128),
             (524288, 4096, 4), (1000, 100, 40), (100, 10, 1000)]
GCN_SHAPES = [(1, 1), (300, 40), (2708, 1433), (19717, 500),
              (100_000, 7), (64, 70_000)]


@pytest.mark.parametrize("hw", [H100, CPU], ids=["h100", "cpu"])
def test_auto_is_eq1_and_regimes_equal_the_jax_mapper(hw):
    for h, w, k in BLUR_SHAPES:
        # Eq. 1's pixels a thread, as rows of the route's vector (at
        # most h of them)
        p = plan_stencil(h, w, k, hw, "auto")
        eq1 = jax_resolve_lws(h * w, hw.hp())
        assert p.rows == min(-(-eq1 // p.vec), h)
        assert p.lws == min(eq1, p.rows * p.vec)
        assert p.regime.value == \
            jax_classify_regime(p.lws, h * w, hw.hp()).value
    for nq, nr, d in NN_SHAPES:
        # Eq. 1's queries a thread, legalised to the rows a thread's
        # wgmma fragment holds: 2 of each of mt 64-row tiles, mt in [1, 2]
        p = plan_nn(nq, nr, d, hw, "auto")
        mt = 1 if nq <= 128 else min(2, -(-jax_resolve_lws(nq, hw.hp())
                                           // 2))
        assert p.lws == 2 * mt and p.bm == 128 * mt
        assert p.regime.value == jax_classify_regime(p.lws, nq,
                                                     hw.hp()).value
        # the split: Eq. 1 over (query tile, ref) pairs and the CTA slots
        slots = hw.sm_count * NN_CTAS_PER_SM
        w = jax_resolve_lws(p.grid[0] * nr, slots)
        assert p.split == min(round_up(nr, p.bn), round_up(w, p.bn))
    rows_hp = hw.sm_count * hw.warps_per_sm
    for n, f in GCN_SHAPES:
        p = plan_gcn(n, f, hw, "auto")
        assert p.lws == min(jax_resolve_lws(n, rows_hp), -(-n // 8))
        assert p.regime.value == jax_classify_regime(p.lws, n,
                                                     rows_hp).value


@pytest.mark.parametrize("hw", [H100, CPU], ids=["h100", "cpu"])
@pytest.mark.parametrize("policy", POLICIES)
def test_atypical_plans_cover_gws_and_are_legal(policy, hw):
    for (h, w, k), es in ((s, e) for s in BLUR_SHAPES for e in (4, 2)):
        p = plan_stencil(h, w, k, hw, policy, elem_bytes=es)
        row_blocks, strips = -(-h // p.rows), -(-w // p.tile_w)
        assert p.threads == 256 and p.tile_w == 256 * p.vec
        assert p.vec == (16 // es if p.route == "vector" else 1)
        assert 1 <= p.rows <= h and 1 <= p.lws <= p.rows * p.vec
        assert p.grid == row_blocks * strips < 2 ** 31
        assert p.grid * p.threads * p.rows * p.vec >= h * w
        assert p.halo == (k - 1) // 2 and p.elem_bytes == es
        assert p.smem_bytes == max(stencil_smem_bytes(q, k, p.vec, es)
                                   for q in ("rows", "cols")) \
            <= hw.smem_per_block
    for (nq, nr, d), es in ((s, e) for s in NN_SHAPES for e in (4, 2)):
        p = plan_nn(nq, nr, d, hw, policy, elem_bytes=es)
        tiles, splits = p.grid
        assert p.threads == 256 and p.lws in (2, 4) and p.elem_bytes == es
        assert p.bm == 64 * p.lws and p.bm * p.bn == 128 * 128
        assert tiles * p.bm >= nq > (tiles - 1) * p.bm     # no idle tile
        assert p.split % p.bn == 0 and splits <= 65535
        assert (splits - 1) * p.split < nr <= splits * p.split
        # the ref tile, the K step and the split: one rule, any policy
        assert p == nn_plan_for_block(nq, nr, d, hw, p.lws, policy,
                                      elem_bytes=es)
        assert p.bk * es == nn_step_bytes(d, es) == (32 if d * es <= 32
                                                     else 128)
        assert 2 <= p.stages <= 4
        step = p.bk * es
        assert p.smem_bytes == nn_smem_bytes(p.bm, p.bn, step, p.stages,
                                             es) <= hw.smem_per_block
        assert p.stages == 4 or nn_smem_bytes(
            p.bm, p.bn, step, p.stages + 1, es) > hw.smem_per_block
        assert p.rounds == -(-tiles * splits
                             // (hw.sm_count * NN_CTAS_PER_SM))
    for n, f in GCN_SHAPES:
        p = plan_gcn(n, f, hw, policy)
        assert p.threads == 256 and p.block_n == 8 * p.lws
        assert p.fpl in (1, 2, 4, 8, 16)
        assert p.grid[0] * p.block_n >= n > (p.grid[0] - 1) * p.block_n
        assert p.grid[1] * 32 * p.fpl >= f and p.grid[1] <= 65535


def test_policies_translate_eq1_to_hopper_for_the_atypical_kernels():
    """The H100 plans of the smoke's suite cases: NAIVE one item per thread,
    FIXED 32, AUTO Eq. 1; nn's query tile from lws, its ref tile and split
    by one rule, and the feature tiles fixed per shape."""
    blur = {p: plan_stencil(4096, 4096, 5, H100, p) for p in POLICIES}
    assert blur["naive"].lws == 1 and blur["naive"].grid == 65536
    assert blur["naive"].route == "scalar" and blur["naive"].rows == 1
    assert blur["fixed"].lws == FIXED_LWS and blur["fixed"].rows == 8
    assert blur["fixed"].grid == 512 * 4
    assert blur["auto"].lws == 63 and blur["auto"].rows == 16
    assert blur["auto"].grid == 256 * 4 and blur["auto"].tile_w == 1024
    assert blur["naive"].regime is Regime.OVERSUBSCRIBED
    # nn: query rows a thread 2 (one 64-row tile a warpgroup) or 4 (two),
    # the ref tile 128 / mt, the refs split so every policy fills the card
    for es in (4, 2):
        sift = {p: plan_nn(4096, 65536, 128, H100, p, elem_bytes=es)
                for p in POLICIES}
        assert [sift[p].lws for p in POLICIES] == [2, 4, 2]
        for p in ("naive", "auto"):
            assert (sift[p].bm, sift[p].bn) == (128, 128)
            assert sift[p].split == 16000 and sift[p].grid == (32, 5)
        assert (sift["fixed"].bm, sift["fixed"].bn) == (256, 64)
        assert sift["fixed"].split == 8000
        assert sift["fixed"].grid == (16, 9)
        assert all(p.grid[0] * p.grid[1] >= H100.sm_count
                   for p in sift.values())
        assert {p.bk * es for p in sift.values()} == {128}
        wide = {p: plan_nn(524288, 4096, 4, H100, p, elem_bytes=es)
                for p in POLICIES}
        assert [wide[p].lws for p in POLICIES] == [2, 4, 2]
        assert [wide[p].grid for p in POLICIES] == [(4096, 1), (2048, 1),
                                                    (4096, 1)]
        assert {p.bk * es for p in wide.values()} == {32}   # 32-byte K
    cora = plan_gcn(2708, 1433, H100, "auto")
    assert cora.lws == 1 and cora.fpl == 16 and cora.grid == (339, 3)
    pubmed = {p: plan_gcn(19717, 500, H100, p) for p in POLICIES}
    assert [pubmed[p].lws for p in POLICIES] == [1, 32, 3]
    assert pubmed["auto"].grid == (822, 1)


def test_legalisers_clamp_to_the_image_and_shared_memory():
    short = stencil_plan_for_block(10, 500, 5, H100, 1000)
    assert short.rows == 10 and short.lws == 10 * short.vec
    # ksize 63: the vector ring (62 rows of 4 KB) does not fit, so the
    # plan narrows the strip to one column a thread
    big = stencil_plan_for_block(100_000, 256, 63, H100, 100_000)
    assert big.route == "scalar" and big.rows == 100_000
    assert big.smem_bytes <= H100.smem_per_block
    assert stencil_smem_bytes("cols", 63, 4, 4) > H100.smem_per_block
    assert gcn_plan_for_block(20, 8, H100, 99).lws == 3
    with pytest.raises(ValueError):
        plan_stencil(8, 8, 4, H100)                 # even ksize
    with pytest.raises(ValueError):
        plan_stencil(8, 8, 65, H100)


# --------------------------------------------------------------------------- #
# wrappers, checks, build
# --------------------------------------------------------------------------- #


def test_cpu_tensors_launch_nothing():
    fns = (st.stencil_rows, st.stencil_cols, nn.nn_search, gc.gcn_agg)
    before = [f.launches for f in fns] + [nn.nn_search.prep_launches]
    img = torch.randn(20, 30)
    adj = torch.from_numpy(_graph(40, 1))
    for policy in POLICIES:
        ops.gaussian_blur(img, policy=policy)
        ops.nn_search(img, img[:7].contiguous(), policy=policy)
        ops.gcn_aggregate(adj, torch.randn(40, 5), policy=policy)
    assert [f.launches for f in fns] + [nn.nn_search.prep_launches] \
        == before


@pytest.mark.parametrize("op", ["stencil_rows", "stencil_cols",
                                "nn_search", "gcn_agg"])
def test_empty_inputs_count_no_launch(op, monkeypatch):
    """The kernel path, entered with empty operands, returns before its
    launch and adds nothing to the count (the CPU tensors here reach the
    kernel path only because ``use_plain`` is patched off; an empty
    operand returns before anything is built)."""
    from repro_torch import kernels

    monkeypatch.setattr(kernels, "use_plain", lambda t: False)
    fn = {"stencil_rows": st.stencil_rows, "stencil_cols": st.stencil_cols,
          "nn_search": nn.nn_search, "gcn_agg": gc.gcn_agg}[op]
    before = fn.launches
    if op.startswith("stencil"):
        out = fn(torch.zeros(0, 7), st.gaussian_kernel_1d(5),
                 plan=plan_stencil(1, 7, 5, H100, "auto"))
        assert out.shape == (0, 7)
    elif op == "nn_search":
        idx, dist = fn(torch.zeros(0, 4), torch.zeros(3, 4),
                       plan=plan_nn(1, 3, 4, H100, "auto"))
        assert idx.shape == dist.shape == (0,)
    else:
        plan = plan_gcn(1, 5, H100, "auto")
        out = fn(torch.zeros(0, 0), torch.zeros(0, 5), plan=plan)
        assert out.shape == (0, 5)
    assert fn.launches == before


@pytest.mark.parametrize("case", ["blur_dtype", "blur_shape", "blur_taps",
                                  "blur_plan", "blur_elem", "nn_dtype",
                                  "nn_dims", "nn_empty", "nn_plan",
                                  "nn_split", "nn_elem", "gcn_square",
                                  "gcn_dtype", "gcn_plan"])
def test_kernel_input_checks_raise(case):
    """The checks run before a launch; they raise on what the kernels do
    not take."""
    img = torch.zeros(40, 300)
    splan = plan_stencil(40, 300, 5, H100, "auto")
    taps = st.gaussian_kernel_1d(5)
    q, r = torch.zeros(100, 16), torch.zeros(50, 16)
    nplan = plan_nn(100, 50, 16, H100, "auto")
    adj, x = torch.zeros(30, 30), torch.zeros(30, 8)
    gplan = plan_gcn(30, 8, H100, "auto")
    with pytest.raises((TypeError, ValueError)):
        if case == "blur_dtype":
            st._check(img.half(), taps, splan)
        elif case == "blur_shape":
            st._check(torch.zeros(2, 40, 300), taps, splan)
        elif case == "blur_taps":
            st._check(img, st.gaussian_kernel_1d(7), splan)
        elif case == "blur_plan":
            st._check(torch.zeros(400, 3000), taps, splan)
        elif case == "blur_elem":               # a float32 plan, bf16 in
            st._check(img.bfloat16(), taps, splan)
        elif case == "nn_dtype":
            nn._check(q.double(), r.double(), nplan)
        elif case == "nn_dims":
            nn._check(q, torch.zeros(50, 8), nplan)
        elif case == "nn_empty":
            nn._check(q, torch.zeros(0, 16), nplan)
        elif case == "nn_plan":                 # queries past the tiles
            nn._check(torch.zeros(100_000, 16), r, nplan)
        elif case == "nn_split":                # refs past the splits
            nn._check(q, torch.zeros(50_000, 16), nplan)
        elif case == "nn_elem":                 # a float32 plan, bf16 in
            nn._check(q.bfloat16(), r.bfloat16(), nplan)
        elif case == "gcn_square":
            gc._check(torch.zeros(30, 31), x, gplan)
        elif case == "gcn_dtype":
            gc._check(adj.bfloat16(), x, gplan)
        else:
            gc._check(torch.zeros(3000, 3000), torch.zeros(3000, 8), gplan)


def test_force_plain_is_the_cpu_path():
    from repro_torch import kernels

    img = torch.randn(9, 11)
    with kernels.force("plain"):
        a = ops.gaussian_blur(img, ksize=3)
    taps = st.gaussian_kernel_1d(3)
    b = st.stencil_cols_plain(st.stencil_rows_plain(img, taps), taps)
    assert torch.equal(a, b)


def test_build_sources_name_the_atypical_kernels():
    for name in ("stencil", "nn_search", "gcn_agg"):
        assert name in _build.SOURCES
        assert (_build.CSRC / f"{name}.cu").exists()
