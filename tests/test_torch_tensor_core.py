"""The port's tensor-core kernels, on the CPU: the bf16 matmul's plans,
route and odd shapes (``csrc/matmul_tc.cu``: any K, N and alignment;
TMA or the CTA's own copies), and the flash kernel's new forms —
non-causal, head_dim 32 and 128 — and ``ops.flash_attention``, each
plain version against the JAX function it replaces on the same numpy
inputs (the Pallas kernels in interpret mode, as the JAX package's own
tests run them).  Nothing here needs a GPU or builds a kernel: the CUDA
kernels run only on the card, where ``chip_smoke.py`` holds each
against its plain version.

Tolerances:
  matmul   bfloat16 atol = rtol = 1.6e-2 (two ulps; the port's plain
           version and the Pallas kernel both sum f32 products over the
           plan's 64-wide K steps, rounding once to bf16);
  flash    float32 atol = rtol = 1e-5 (summation order only).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.hw import TPU_REGISTRY
from repro.core.mapper import MappingPolicy as JaxPolicy
from repro.core.mapper import attention_plan_for_blocks as jax_attn_plan
from repro.core.mapper import matmul_plan_for_blocks as jax_matmul_plan
from repro.kernels import ops as jax_ops
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.matmul import matmul_pallas

from repro_torch import kernels
from repro_torch.core.hw import GPU_REGISTRY
from repro_torch.core.mapper import (MM_TC_BK, matmul_tc_smem_bytes,
                                     plan_attention_blocks,
                                     plan_matmul_blocks)
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.tuner.dispatch import plan_for

TPU = TPU_REGISTRY["cpu_sim"]
H100 = GPU_REGISTRY["h100_sxm"]
CPU = GPU_REGISTRY["cpu"]
POLICIES = ["naive", "fixed", "auto"]
BF16 = torch.bfloat16
TC = "tensor_core"
TOL = dict(atol=1e-5, rtol=1e-5)
SHAPES = [(1, 8, 8), (8, 1536, 576), (130, 72, 200), (64, 64, 64),
          (4096, 4096, 4096), (100_000, 48, 8), (37, 5000, 2048)]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32), np.float32)


def _bf16(rng, shape, scale=1.0):
    """Seeded normals rounded to bf16: (torch tensor, JAX array)."""
    t = torch.from_numpy((rng.standard_normal(shape) * scale)
                         .astype(np.float32)).to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


# --------------------------------------------------------------------------- #
# bf16 matmul plans
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("hw", [H100, CPU], ids=["h100", "cpu"])
@pytest.mark.parametrize("policy", POLICIES)
def test_bf16_matmul_plans_are_warpgroup_tiles(policy, hw):
    for m, n, k in SHAPES:
        p = plan_matmul_blocks(m, n, k, hw, policy, kernel=TC)
        assert p.kernel == "tensor_core"
        assert p.bn == 2 * p.lws and p.bn in (8, 16, 32, 64, 128, 256)
        assert (p.tm, p.tn) == (2, p.bn // 4) and p.tm * p.tn == p.lws
        assert p.bm in (64, 128) and p.threads == 2 * p.bm
        assert p.bm == 128 or m <= 64
        assert p.bk == MM_TC_BK == 64
        assert 2 <= p.stages <= 4
        assert p.smem_bytes == matmul_tc_smem_bytes(p.bm, p.bn, p.stages) \
            <= hw.smem_per_block <= 227 * 1024
        assert p.grid[0] * p.bn >= n and p.grid[1] * p.bm >= m
        assert p.grid[1] <= 65535
        assert p.bn == 8 or p.bn // 2 < n      # halved while half covers N


@pytest.mark.parametrize("hw", [H100, CPU], ids=["h100", "cpu"])
def test_bf16_policies_plan_three_tiles_at_4096(hw):
    tiles = {pol: plan_matmul_blocks(4096, 4096, 4096, hw, pol, kernel=TC)
             for pol in POLICIES}
    assert len({(t.bm, t.bn) for t in tiles.values()}) == 3
    assert (tiles["naive"].bm, tiles["naive"].bn) == (128, 8)
    assert (tiles["fixed"].bm, tiles["fixed"].bn) == (128, 64)
    if hw is H100:                     # Eq. 1: 63 outputs a thread -> 64
        assert (tiles["auto"].bm, tiles["auto"].bn) == (128, 128)
        assert tiles["auto"].stages == 4 and tiles["auto"].grid == (32, 32)
    else:                              # 8 SMs: lws 1024 -> capped at 128
        assert (tiles["auto"].bm, tiles["auto"].bn) == (128, 256)


# --------------------------------------------------------------------------- #
# bf16 matmul against the Pallas kernel, and the route
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mnk", [(8, 1536, 576), (130, 72, 200),
                                 (256, 192, 96)])
def test_bf16_ops_matmul_matches_pallas_at_the_tc_plan(mnk, policy):
    m, n, k = mnk
    rng = np.random.default_rng(m + n + k)
    (a, ja), (b, jb) = (_bf16(rng, (m, k), k ** -0.25),
                        _bf16(rng, (k, n), k ** -0.25))
    assert mm.route(a, b) == "tensor_core"
    got = ops.matmul(a, b, policy=policy)
    assert got.dtype == BF16 and got.shape == (m, n)
    plan = plan_matmul_blocks(m, n, k, CPU, policy, kernel=TC)
    jplan = jax_matmul_plan(m, n, k, TPU, plan.bm, plan.bn, plan.bk,
                            JaxPolicy(policy))
    assert jplan.bk == plan.bk == 64
    want = matmul_pallas(ja, jb, hw=TPU, plan=jplan, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=1.6e-2,
                               rtol=1.6e-2)
    np.testing.assert_array_equal(
        _np(got), _np(mm.matmul_plain(a, b, plan=plan)))


# bf16 shapes that TMA cannot take: the kernel copies such an operand
# into its stages itself (8-, 4- or 2-byte copies); on the CPU the
# wrapper runs the plain version at the same tile plan.
ODD = {"k_odd": (130, 72, 257), "k_4_mod_8": (130, 70, 300),
       "n_odd": (64, 1001, 192), "n_1532": (8, 1532, 576),
       "a_misaligned": (8, 576, 576)}
# the bytes of each operand's copies (16: TMA's): every width is reached
LOADERS = {"k_odd": (2, 16), "k_4_mod_8": (8, 4), "n_odd": (16, 2),
           "n_1532": (16, 8), "a_misaligned": (2, 16)}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", list(ODD))
def test_bf16_odd_shapes_match_pallas_at_the_tc_plan(case, policy):
    m, n, k = ODD[case]
    rng = np.random.default_rng(m + n + k)
    (a, ja), (b, jb) = (_bf16(rng, (m, k), k ** -0.25),
                        _bf16(rng, (k, n), k ** -0.25))
    if case == "a_misaligned":         # A 2 bytes past a 16-byte boundary
        flat = torch.empty(m * k + 1, dtype=BF16)
        flat[1:] = a.flatten()
        a = flat[1:].view(m, k)
        assert a.data_ptr() % 16 == 2 and a.is_contiguous()
    assert mm.route(a, b) == "tensor_core"
    assert mm.loader_bytes(a, b) == LOADERS[case]
    got = ops.matmul(a, b, policy=policy)
    assert got.dtype == BF16 and got.shape == (m, n)
    plan = plan_matmul_blocks(m, n, k, CPU, policy, kernel=TC)
    assert plan_for("matmul", a, b, hw=CPU, policy=policy)[0] == plan
    jplan = jax_matmul_plan(m, n, k, TPU, plan.bm, plan.bn, plan.bk,
                            JaxPolicy(policy))
    assert jplan.bk == plan.bk == 64
    want = matmul_pallas(ja, jb, hw=TPU, plan=jplan, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=1.6e-2,
                               rtol=1.6e-2)
    np.testing.assert_array_equal(
        _np(got), _np(mm.matmul_plain(a, b, plan=plan)))


def _route_case(case):
    a, b = torch.zeros(16, 32, dtype=BF16), torch.zeros(32, 24, dtype=BF16)
    if case == "bf16":
        return a, b, "tensor_core"
    if case == "f32":
        return a.float(), b.float(), "tf32x3"
    if case == "k_not_8":
        return a[:, :12].contiguous(), b[:12].contiguous(), "tensor_core"
    if case == "n_not_8":
        return a, b[:, :20].contiguous(), "tensor_core"
    if case == "strided":
        return torch.zeros(32, 16, dtype=BF16).T, b, "tensor_core"
    if case == "misaligned":           # 2 bytes past a 16-byte boundary
        flat = torch.zeros(16 * 32 + 1, dtype=BF16)
        return flat[1:].view(16, 32), b, "tensor_core"
    if case == "mixed":
        return a, b.float(), None
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["bf16", "f32", "k_not_8", "n_not_8",
                                  "strided", "misaligned", "mixed"])
def test_route_rule(case, monkeypatch):
    """Every bf16 pair goes to the tensor-core kernel and every f32 pair to
    3xTF32, whatever the shape or alignment; two dtypes raise, and the
    wrapper refuses a strided operand; ``ops.matmul`` plans for the
    route."""
    a, b, want = _route_case(case)
    if want is None:
        with pytest.raises(TypeError, match="one dtype"):
            mm.route(a, b)
        with pytest.raises(ValueError, match="one dtype"):
            mm._check(a, b, plan_matmul_blocks(16, 24, 32, H100, kernel=TC),
                      BF16)
        return
    assert mm.route(a, b) == want
    if case == "strided":
        with pytest.raises(ValueError, match="contiguous"):
            plan = plan_for("matmul", a, b, hw=H100, policy="auto")[0]
            mm._check(a, b, plan, BF16)
        return
    seen = []
    monkeypatch.setattr(mm, "matmul",
                        lambda a, b, *, plan, out_dtype: seen.append(plan))
    ops.matmul(a, b, policy="auto")
    assert seen[0].kernel == want
    assert (seen[0].bk == 64) == (want == "tensor_core")


def test_wrapper_refuses_a_plan_of_the_other_route(monkeypatch):
    monkeypatch.setattr(kernels, "use_plain", lambda t: False)
    monkeypatch.setattr(_build, "load", _no_build)
    a, b = torch.zeros(16, 32, dtype=BF16), torch.zeros(32, 24, dtype=BF16)
    f32_plan = plan_matmul_blocks(16, 24, 32, H100, "auto", kernel="tf32x3")
    tc_plan = plan_matmul_blocks(16, 24, 32, H100, "auto", kernel=TC)
    with pytest.raises(ValueError, match="route"):
        mm.matmul(a, b, plan=f32_plan)
    with pytest.raises(ValueError, match="route"):
        mm.matmul(a.float(), b.float(), plan=tc_plan)
    with pytest.raises(ValueError, match="route"):
        mm.matmul(a[:, :12].contiguous(), b[:12].contiguous(), plan=f32_plan)


@pytest.mark.parametrize("case", ["bf16", "f32", "k_not_8", "n_not_8",
                                  "misaligned"])
@pytest.mark.parametrize("policy", POLICIES)
def test_plan_for_plans_the_routes_kernel(case, policy):
    a, b, want = _route_case(case)
    p = plan_for("matmul", a, b, hw=H100, policy=policy)[0]
    assert p == plan_matmul_blocks(a.shape[0], b.shape[1], a.shape[1], H100,
                                   policy, kernel=want)
    assert p.kernel == want


@pytest.mark.parametrize("kernel", ["bfloat16", "cuda_core"])
def test_planner_refuses_an_unknown_kernel(kernel):
    with pytest.raises(ValueError, match="tensor_core or tf32x3"):
        plan_matmul_blocks(64, 64, 64, H100, "auto", kernel=kernel)


def test_tc_plan_takes_two_stages_at_least():
    """One stage would hang the prefetch ring (the tile of step k + 1 is
    loaded only after step k + 1 waits on it): the planner gives up to
    two stages and raises when two do not fit."""
    need2 = matmul_tc_smem_bytes(128, 128, 2)      # AUTO's tile at 4096^3
    tight = dataclasses.replace(H100, smem_per_block=need2)
    assert plan_matmul_blocks(4096, 4096, 4096, tight, "auto",
                              kernel=TC).stages == 2
    short = dataclasses.replace(H100, smem_per_block=need2 - 1)
    with pytest.raises(ValueError, match="no legal tensor-core"):
        plan_matmul_blocks(4096, 4096, 4096, short, "auto", kernel=TC)


def _launches():
    return (mm.matmul.tc_launches, mm.matmul.split_launches,
            mm.matmul.tf32_launches)


def test_cpu_tensors_count_no_launch_on_either_route():
    before = _launches()
    rng = np.random.default_rng(3)
    (a, _), (b, _) = _bf16(rng, (16, 64)), _bf16(rng, (64, 40))
    for policy in POLICIES:
        assert mm.route(a, b) == "tensor_core"
        ops.matmul(a, b, policy=policy)
        ops.matmul(a.float(), b.float(), policy=policy)
        ops.matmul(a, b, policy=policy, out_dtype=torch.float32)
    assert _launches() == before


# --------------------------------------------------------------------------- #
# flash: non-causal, head_dim 32 and 128, ops.flash_attention
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("causal,d,sq,sk", [
    (False, 32, 64, 128), (False, 64, 40, 128), (False, 128, 128, 128),
    (True, 32, 64, 64), (True, 128, 48, 48)])
def test_flash_plain_matches_pallas_per_head(causal, d, sq, sk):
    """The grouped plain version == the Pallas kernel (interpret), per
    (batch, group, head), causal or not, at head_dim 32, 64 and 128 (the
    Pallas kernel takes non-causal keys in whole 128-key blocks)."""
    rng = np.random.default_rng(d + sq + causal)
    g, r = 2, 2
    q = rng.standard_normal((1, sq, g, r, d)).astype(np.float32)
    k = rng.standard_normal((1, sk, g, d)).astype(np.float32)
    v = rng.standard_normal((1, sk, g, d)).astype(np.float32)
    tiles = (32, 16)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), block_q=tiles[0],
                             block_k=tiles[1], q_offset=sk - sq,
                             causal=causal).numpy()
    plan = jax_attn_plan(sq, sk, d, TPU, *tiles, JaxPolicy.TUNED,
                         dtype_bytes=4)
    for gi in range(g):
        for ri in range(r):
            ref = np.asarray(flash_attention_pallas(
                jnp.asarray(q[0, :, gi, ri]), jnp.asarray(k[0, :, gi]),
                jnp.asarray(v[0, :, gi]), hw=TPU, plan=plan, causal=causal,
                interpret=True))
            np.testing.assert_allclose(got[0, :, gi, ri], ref, **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lead,sq,sk,d", [((2, 3), 40, 40, 32),
                                          ((4,), 24, 72, 64),
                                          ((), 33, 33, 128)])
def test_ops_flash_attention_matches_jax_ops(lead, sq, sk, d, causal):
    """``ops.flash_attention`` == the JAX package's ``ops.flash_attention``
    on leading dims, with causal queries aligned to the end of the keys."""
    rng = np.random.default_rng(sq + sk + d)
    q = rng.standard_normal((*lead, sq, d)).astype(np.float32)
    k = rng.standard_normal((*lead, sk, d)).astype(np.float32)
    v = rng.standard_normal((*lead, sk, d)).astype(np.float32)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              policy="naive")
    assert got.shape == q.shape
    want = np.asarray(jax_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_ops_flash_attention_takes_the_planned_tiles(monkeypatch):
    seen = []
    real = fa.flash_attention

    def spy(q, k, v, **kw):
        seen.append(kw)
        return real(q, k, v, **kw)

    monkeypatch.setattr(fa, "flash_attention", spy)
    x = torch.zeros(2, 100, 32)
    ops.flash_attention(x, x, x, hw=H100)
    plan = plan_attention_blocks(100, 100, 32, H100)
    assert (seen[0]["block_q"], seen[0]["block_k"]) == (plan.block_q,
                                                        plan.block_k)
    assert seen[0]["q_offset"] == 0 and seen[0]["causal"]
    with pytest.raises(ValueError, match="sq <= skv"):
        ops.flash_attention(x[:, :10], x[:, :5], x[:, :5])


def _no_build(name):
    raise AssertionError(f"{name} was built on the CPU")


@pytest.mark.parametrize("dtype,d", [(BF16, 96), (torch.float32, 96),
                                     (BF16, 168), (BF16, 256)])
def test_flash_kernel_path_raises_on_what_no_kernel_takes(dtype, d,
                                                          monkeypatch):
    """The kernel path raises a ValueError naming ROADMAP §2 A.1 before
    anything is built or counted (CPU tensors reach it only because
    ``use_plain`` is patched off)."""
    monkeypatch.setattr(kernels, "use_plain", lambda t: False)
    monkeypatch.setattr(_build, "load", _no_build)
    before = fa.flash_attention.launches
    q = torch.zeros(1, 32, 1, 1, d, dtype=dtype)
    k = torch.zeros(1, 32, 1, d, dtype=dtype)
    with pytest.raises(ValueError, match="A.1"):
        fa.flash_attention(q, k, k, block_q=32, block_k=32)
    with pytest.raises(ValueError, match="A.1"):
        ops.flash_attention(q[:, :, 0, 0], k[:, :, 0], k[:, :, 0],
                            causal=False)
    assert fa.flash_attention.launches == before


def test_bf16_flash_kernel_path_takes_tiles_of_16_only(monkeypatch):
    monkeypatch.setattr(kernels, "use_plain", lambda t: False)
    monkeypatch.setattr(_build, "load", _no_build)
    q = torch.zeros(1, 32, 1, 1, 64, dtype=BF16)
    k = torch.zeros(1, 32, 1, 64, dtype=BF16)
    with pytest.raises(ValueError, match="multiples of 16"):
        fa.flash_attention(q, k, k, block_q=24, block_k=32)


def test_flash_plans_fit_both_kernels_at_every_head_dim():
    """The plan is free of dtype: legal for the larger of the two
    kernels' shared memory at head_dim 32, 64 and 128."""
    for hw in (H100, CPU):
        for d in (32, 64, 128):
            for s in (1, 32, 64, 512, 4096):
                p = plan_attention_blocks(s, s, d, hw)
                f32 = 4 * (2 * p.block_k * d
                           + -(-p.block_q // 32) * 32 * (p.block_k + 1))
                bf16 = 8 * p.block_k * (d + 8)
                assert p.smem_bytes == max(f32, bf16) <= hw.smem_per_block
                assert p.block_q % 16 == 0 and 32 <= p.block_q <= 128
