"""The port's float32 matmul route on the CPU: 3xTF32 on the tensor cores
(``csrc/matmul_tf32x3.cu``).  Its plans and route rule, the split's
plain version against a numpy model of ``cvt.rna.tf32.f32``, the padded
workspaces the route's two launches exchange, and the precision that
sets the route apart: three TF32 products stay within the suite's f32
tolerance of the JAX kernel (``matmul_pallas`` in interpret mode, as the
JAX package's own tests run it), one TF32 product does not.  Nothing
here builds or launches a kernel: ``chip_smoke.py`` holds the two
launches against their plain versions on the card.

Tolerances:
  split      bitwise (integer ops on the f32 bits either way); infinities,
             NaNs and floats within half a TF32 step of FLT_MAX by value;
  big+small  within 2^-21 of |x| (each part keeps 11 significant bits);
  product    atol = rtol = 1e-4, ``SUITE_TOL[("matmul", F32)]`` of
             ``chip_smoke.py``, against the Pallas kernel's f32 sums.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.hw import TPU_REGISTRY
from repro.core.mapper import MappingPolicy as JaxPolicy
from repro.kernels.matmul import matmul_pallas

from repro_torch.core.hw import GPU_REGISTRY
from repro_torch.core.mapper import (MM_TF32_BK, matmul_plan_for_blocks,
                                     matmul_tf32x3_smem_bytes,
                                     plan_matmul_blocks)
from repro_torch.kernels import ops
from repro_torch.kernels import matmul as mm
from repro_torch.tuner.dispatch import plan_for

TPU = TPU_REGISTRY["cpu_sim"]
H100 = GPU_REGISTRY["h100_sxm"]
CPU = GPU_REGISTRY["cpu"]
POLICIES = ["naive", "fixed", "auto"]
F32 = torch.float32
TF32 = "tf32x3"
TOL = dict(atol=1e-4, rtol=1e-4)
SHAPES = [(1, 1, 1), (8, 1536, 576), (130, 70, 300), (4096, 4096, 4096),
          (100_000, 48, 9), (37, 5000, 2048)]


def _f32(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


def _np_rna(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` on numpy bits, sign and magnitude apart: half
    of the 13 dropped bits' range added to the magnitude (a tie goes away
    from zero), then the 13 bits cleared."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    mag = (mag + 0x1000) & ~np.uint64(0x1FFF)
    return (sign | mag).astype(np.uint32).view(np.float32)


# --------------------------------------------------------------------------- #
# plans
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("hw", [H100, CPU], ids=["h100", "cpu"])
@pytest.mark.parametrize("policy", POLICIES)
def test_tf32x3_plans_are_legal_warpgroup_tiles(policy, hw):
    for m, n, k in SHAPES:
        p = plan_matmul_blocks(m, n, k, hw, policy, kernel=TF32)
        assert p.kernel == TF32
        assert p.bn == 2 * p.lws and p.bn in (8, 16, 32, 64, 128)
        assert (p.tm, p.tn) == (2, p.bn // 4) and p.tm * p.tn == p.lws
        assert p.bm in (64, 128) and p.threads == 2 * p.bm
        assert p.bm == 128 or m <= 64
        assert p.bk == MM_TF32_BK == 32
        assert 2 <= p.stages <= 4
        assert p.smem_bytes == matmul_tf32x3_smem_bytes(
            p.bm, p.bn, p.stages) <= hw.smem_per_block <= 227 * 1024
        assert p.stages == 4 or matmul_tf32x3_smem_bytes(
            p.bm, p.bn, p.stages + 1) > hw.smem_per_block
        assert p.grid[0] * p.bn >= n and p.grid[1] * p.bm >= m
        assert p.grid[1] <= 65535
        assert p.bn == 8 or p.bn // 2 < n      # halved while half covers N


@pytest.mark.parametrize("hw", [H100, CPU], ids=["h100", "cpu"])
def test_policies_plan_three_tiles_at_4096(hw):
    """Eq. 1 on the H100 (63 outputs a thread -> 64) and the CPU stand-in
    (1024, capped at 64) both give AUTO 128 x 128 in 3 stages of 64 KB;
    NAIVE and FIXED keep the paper's 1 and 32."""
    tiles = {pol: plan_matmul_blocks(4096, 4096, 4096, hw, pol, kernel=TF32)
             for pol in POLICIES}
    assert (tiles["naive"].bm, tiles["naive"].bn) == (128, 8)
    assert (tiles["fixed"].bm, tiles["fixed"].bn) == (128, 64)
    assert (tiles["auto"].bm, tiles["auto"].bn) == (128, 128)
    assert tiles["auto"].stages == 3 and tiles["auto"].grid == (32, 32)
    assert tiles["naive"].stages == tiles["fixed"].stages == 4


def test_tile_stops_at_bn_128():
    """A thread keeps a step's partial and the sum, BN f32: Eq. 1's 500
    outputs a thread is legalised to 64 (BN 128), where the bf16 kernel
    takes 128 (BN 256)."""
    f = matmul_plan_for_blocks(8192, 8192, 64, H100, 500, kernel=TF32)
    t = matmul_plan_for_blocks(8192, 8192, 64, H100, 500,
                               kernel="tensor_core")
    assert (f.lws, f.bn, t.bn) == (64, 128, 256)


def test_plan_needs_two_stages():
    need2 = matmul_tf32x3_smem_bytes(128, 128, 2)
    tight = dataclasses.replace(H100, smem_per_block=need2)
    assert plan_matmul_blocks(4096, 4096, 4096, tight, "auto",
                              kernel=TF32).stages == 2
    short = dataclasses.replace(H100, smem_per_block=need2 - 1)
    with pytest.raises(ValueError, match="no legal tensor-core"):
        plan_matmul_blocks(4096, 4096, 4096, short, "auto", kernel=TF32)


# --------------------------------------------------------------------------- #
# route
# --------------------------------------------------------------------------- #


def _f32_case(case):
    a, b = torch.zeros(16, 32), torch.zeros(32, 24)
    if case == "aligned":
        return a, b
    if case == "k_odd":
        return torch.zeros(16, 33), torch.zeros(33, 24)
    if case == "n_odd":
        return a, torch.zeros(32, 23)
    if case == "misaligned":           # 4 bytes past a 16-byte boundary
        return torch.zeros(16 * 32 + 1)[1:].view(16, 32), b
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["aligned", "k_odd", "n_odd", "misaligned"])
def test_route_sends_every_float32_pair_to_tf32x3(case, monkeypatch):
    a, b = _f32_case(case)
    assert mm.route(a, b) == TF32
    seen = []
    monkeypatch.setattr(mm, "matmul",
                        lambda a, b, *, plan, out_dtype: seen.append(plan))
    ops.matmul(a, b, policy="auto")
    assert seen[0].kernel == TF32 and seen[0].bk == 32
    with pytest.raises(TypeError, match="one dtype"):     # mixed dtypes
        mm.route(a.bfloat16(), b)


@pytest.mark.parametrize("policy", POLICIES)
def test_cpu_tensors_launch_neither_part(policy):
    before = (mm.matmul.split_launches, mm.matmul.tf32_launches,
              mm.matmul.tc_launches)
    rng = np.random.default_rng(7)
    a, b = _f32(rng, (24, 40)), _f32(rng, (40, 18))
    got = ops.matmul(a, b, policy=policy)
    plan = plan_for("matmul", a, b, hw=CPU, policy=policy)[0]
    torch.testing.assert_close(got, mm.matmul_plain(a, b, plan=plan),
                               rtol=0, atol=0)
    mm.tf32_product(*mm.tf32_split(a, b, plan), 18, plan)
    assert (mm.matmul.split_launches, mm.matmul.tf32_launches,
            mm.matmul.tc_launches) == before


def _no_build(name):
    raise AssertionError(f"built {name}: the checks should have raised")


@pytest.mark.parametrize("case", ["a_strided", "b_rows", "ws_k", "ws_n",
                                  "ws_dtype"])
def test_kernel_path_checks_raise_before_a_build(case, monkeypatch):
    """On the kernel path (a CUDA tensor) both launches refuse what their
    kernels do not take before anything is built or launched."""
    monkeypatch.setattr(mm.kernels, "use_plain", lambda t: False)
    monkeypatch.setattr(mm._build, "load", _no_build)
    a, b = torch.zeros(16, 32), torch.zeros(32, 24)
    plan = plan_for("matmul", a, b, hw=H100, policy="auto")[0]
    a_ws, b_ws = torch.zeros(2, 16, 32), torch.zeros(2, 24, 32)
    with pytest.raises(ValueError):
        if case == "a_strided":
            mm.tf32_split(torch.zeros(32, 16).T, b, plan)
        elif case == "b_rows":
            mm.tf32_split(a, torch.zeros(31, 24), plan)
        elif case == "ws_k":                # A's and B's K padding differ
            mm.tf32_product(torch.zeros(2, 16, 64), b_ws, 24, plan)
        elif case == "ws_n":                # more columns than B's rows
            mm.tf32_product(a_ws, b_ws, 25, plan)
        else:
            mm.tf32_product(a_ws.double(), b_ws, 24, plan)


# --------------------------------------------------------------------------- #
# the split
# --------------------------------------------------------------------------- #


def _split_inputs():
    rng = np.random.default_rng(0)
    base = np.float32(1.0).view(np.uint32)
    # mantissa tails at, just under and just over a tie, on both signs
    tails = np.array([0x1000, 0x0FFF, 0x1001, 0x1FFF, 0x0000, 0x2000],
                     np.uint32)
    ties = (base | tails).view(np.float32)
    return np.concatenate([
        rng.standard_normal(4096).astype(np.float32),
        (rng.standard_normal(512) * 1e-30).astype(np.float32),  # tiny
        (rng.standard_normal(512) * 1e30).astype(np.float32),
        np.float32([0.0, -0.0, 1e-45, -1e-45, 3.0e38]),
        ties, -ties, ties * 2.0 ** -60])


def test_split_rounds_as_cvt_rna_tf32():
    x = _split_inputs()
    big, small = mm.tf32_split_plain(torch.from_numpy(x))
    want_big = _np_rna(x)
    np.testing.assert_array_equal(big.numpy().view(np.uint32),
                                  want_big.view(np.uint32))
    want_small = _np_rna((x - want_big).astype(np.float32))
    np.testing.assert_array_equal(small.numpy().view(np.uint32),
                                  want_small.view(np.uint32))
    for part in (big, small):
        assert (part.view(torch.int32) & 0x1FFF == 0).all()


def test_split_ties_go_away_from_zero():
    one = 1.0 + 2.0 ** -11                     # halfway between TF32s
    big, small = mm.tf32_split_plain(torch.tensor([one, -one, 1.0 + 2.0
                                                   ** -12]))
    assert big.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]
    assert small.tolist() == [-2.0 ** -11, 2.0 ** -11, 2.0 ** -12]


def test_big_plus_small_keeps_21_bits():
    x = _split_inputs()
    x = torch.from_numpy(x[(x == 0) | (np.abs(x) >= 2.0 ** -100)])  # normal
    big, small = mm.tf32_split_plain(x)
    gap = ((big.double() + small.double()) - x.double()).abs()
    assert (gap <= 2.0 ** -21 * x.double().abs()).all()


FLT_MAX = float(np.finfo(np.float32).max)
NEAR_MAX = float(np.float32(3.4027e38))   # rounds past FLT_MAX to TF32


@pytest.mark.parametrize("x, big, small", [
    (float("inf"), float("inf"), 0.0),
    (-float("inf"), -float("inf"), 0.0),
    (float("nan"), "nan", 0.0),
    (FLT_MAX, "finite", "rest"),
    (-FLT_MAX, "finite", "rest"),
    (NEAR_MAX, "finite", "rest"),
])
def test_split_of_infinities_nans_and_the_largest_floats(x, big, small):
    """An infinity is its own big part with small 0 (not inf - inf); a
    NaN becomes the quiet NaN 0x7fffe000; a finite x within half a TF32
    step of FLT_MAX is cut toward zero, not rounded to infinity, and
    big + small still keeps 21 bits."""
    b, s = (t.item() for t in mm.tf32_split_plain(torch.tensor([x])))
    bits = torch.tensor([b]).view(torch.int32).item() & 0xFFFFFFFF
    assert bits & 0x1FFF == 0
    if big == "nan":
        assert bits == 0x7FFFE000
    elif big == "finite":
        assert np.isfinite(b) and abs(b) <= abs(x) and np.sign(b) == np.sign(x)
        assert abs((b + s) - x) <= 2.0 ** -21 * abs(x)
    else:
        assert b == big
    if small != "rest":
        assert s == small


def test_largest_floats_give_finite_products():
    """Operands near FLT_MAX whose products are finite stay finite through
    the three TF32 products (rounding them to TF32 overflowed to inf)."""
    rng = np.random.default_rng(38)
    a = torch.full((4, 8), NEAR_MAX)
    a[1::2] *= -1
    b = _f32(rng, (8, 5), 1e-3)
    plan = plan_for("matmul", a, b, hw=H100, policy="auto")[0]
    got = mm.tf32_product(*mm.tf32_split(a, b, plan), 5, plan)
    want = a.double() @ b.double()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=0)


@pytest.mark.parametrize("mnk", [(130, 70, 300), (8, 1536, 576), (1, 1, 1),
                                 (64, 999, 33)])
def test_workspaces_are_padded_k_major_halves(mnk):
    m, n, k = mnk
    rng = np.random.default_rng(m + n)
    a, b = _f32(rng, (m, k)), _f32(rng, (k, n))
    plan = plan_for("matmul", a, b, hw=H100, policy="auto")[0]
    a_ws, b_ws = mm.tf32_split(a, b, plan)
    kp, np_ = -(-k // 32) * 32, -(-n // plan.bn) * plan.bn
    assert a_ws.shape == (2, m, kp) and b_ws.shape == (2, np_, kp)
    for i, (ha, hb) in enumerate(zip(mm.tf32_split_plain(a),
                                     mm.tf32_split_plain(b))):
        assert torch.equal(a_ws[i, :, :k], ha)
        assert torch.equal(b_ws[i, :n, :k], hb.T)
    assert not a_ws[:, :, k:].any() and not b_ws[:, :, k:].any()
    assert not b_ws[:, n:].any()


# --------------------------------------------------------------------------- #
# precision
# --------------------------------------------------------------------------- #


def test_three_tf32_products_meet_the_f32_tolerance_and_one_does_not():
    """At K = 4096 (the suite's sgemm depth) with the suite's k^-1/4
    scaling, the route's three products (on the CPU: the plain product of
    the split's workspaces) stay within 1e-4 of the JAX kernel; the big
    halves alone, one TF32 product, miss it: the unchanged tolerance
    tells the two apart."""
    m, n, k = 32, 32, 4096
    rng = np.random.default_rng(4096)
    a, b = _f32(rng, (m, k), k ** -0.25), _f32(rng, (k, n), k ** -0.25)
    want = np.asarray(matmul_pallas(jnp.asarray(a.numpy()),
                                    jnp.asarray(b.numpy()), hw=TPU,
                                    policy=JaxPolicy.AUTO, interpret=True))
    plan = plan_for("matmul", a, b, hw=H100, policy="auto")[0]
    a_ws, b_ws = mm.tf32_split(a, b, plan)
    three = mm.tf32_product(a_ws, b_ws, n, plan).numpy()
    one = (a_ws[0] @ b_ws[0, :n].T).numpy()
    np.testing.assert_allclose(three, want, **TOL)
    assert not np.allclose(one, want, **TOL)
    assert np.abs(one - want).max() > 10 * np.abs(three - want).max()
