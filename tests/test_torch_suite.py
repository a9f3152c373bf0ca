"""The port's paper kernel suite on the CPU: ``repro_torch.kernels.ops``
(vecadd, saxpy, matmul, rmsnorm; plain versions on CPU tensors) against
the JAX Pallas kernels in interpret mode, on the same numpy inputs, under
each mapping policy and in float32 and bfloat16; and the Hopper mapper's
policies, legality and Eq. 1 against the JAX mapper.

The port plans under the ``"cpu"`` stand-in (``hp`` = 8 x 64 x 32 =
16,384), so the sizes below fall under, at and over ``hp``.  The CUDA
kernels themselves run only on the card: ``chip_smoke.py`` holds each
against its plain version there.

Tolerances (port vs JAX):
  vecadd   bitwise (one rounding of an exact sum either way);
  saxpy    float32 atol = rtol = 1e-6; bfloat16 bitwise (both round the
           product to bf16 before the add, then the sum);
  rmsnorm  float32 atol = rtol = 1e-5; bfloat16 rtol 8e-3 (one ulp);
  matmul   float32 atol = rtol = 1e-4 (k <= 600: summation order);
           bfloat16 atol = rtol = 1.6e-2 (two ulps; atol for outputs
           near zero, where the float32 sums differ before rounding).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.hw import TPU_REGISTRY
from repro.core.mapper import MappingPolicy as JaxPolicy
from repro.core.mapper import classify_regime as jax_classify_regime
from repro.core.mapper import resolve_lws as jax_resolve_lws
from repro.kernels.matmul import matmul_pallas
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.kernels.saxpy import saxpy_pallas
from repro.kernels.vecadd import vecadd_pallas

from repro_torch.core import workload
from repro_torch.core.hw import GPU_REGISTRY
from repro_torch.core.mapper import (FIXED_LWS, MappingPolicy, Regime,
                                     classify_regime, matmul_plan_for_blocks,
                                     plan_matmul_blocks,
                                     plan_rows, plan_vector_blocks,
                                     resolve_lws)
from repro_torch.kernels import _build, ops
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import saxpy as sx
from repro_torch.kernels import vecadd as va

TPU = TPU_REGISTRY["cpu_sim"]
H100 = GPU_REGISTRY["h100_sxm"]
CPU = GPU_REGISTRY["cpu"]
POLICIES = ["naive", "fixed", "auto"]
TC = "tensor_core"
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, *shapes, dtype="float32", scale=1.0):
    """Seeded numpy normals rounded to ``dtype``: the same values as a
    torch tensor and as a JAX array for each shape."""
    rng = np.random.default_rng(seed)
    tdt, jdt = DTYPES[dtype]
    out = []
    for shape in shapes:
        t = torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(tdt)
        out.append((t, jnp.asarray(t.float().numpy()).astype(jdt)))
    return out


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32), np.float32)


# --------------------------------------------------------------------------- #
# ops against the Pallas kernels
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("n", [1000, 16384, 70000])
def test_vecadd_matches_pallas(n, policy, dtype):
    (x, jx), (y, jy) = _inputs(n, (n,), (n,), dtype=dtype)
    got = ops.vecadd(x, y, policy=policy)
    assert got.dtype == x.dtype and got.shape == (n,)
    want = vecadd_pallas(jx, jy, hw=TPU, policy=JaxPolicy(policy),
                         interpret=True)
    np.testing.assert_array_equal(_np(got), _np(want))


class _Recorder:
    """Stands in for a kernel's C entry point: keeps the arguments of
    each call and reports a launch that succeeded."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def _launch_args(monkeypatch, op, plan, x, y):
    """``(n, lws, grid, steps)`` that the ``op`` wrapper (vecadd or saxpy)
    passes to its kernel under ``plan`` for CPU tensors ``x``, ``y``: the
    kernel path
    is entered with ``use_plain`` patched off and the library replaced
    by a recorder, so nothing is built or launched."""
    from types import SimpleNamespace

    from repro_torch import kernels

    rec = _Recorder()
    monkeypatch.setattr(kernels, "use_plain", lambda t: False)
    monkeypatch.setattr(_build, "load",
                        lambda name: SimpleNamespace(**{name: rec}))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    if op == "vecadd":
        va.vecadd(x, y, plan=plan)
    else:
        sx.saxpy(1.7, x, y, plan=plan)
    (args,) = rec.calls
    if op == "saxpy":
        args = args[1:]                          # the scalar a first
    return args[3:7]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("n", [1, 5, 4097, (1 << 20) + 3])
@pytest.mark.parametrize("op", ["vecadd", "saxpy"])
def test_vecadd_launch_takes_each_element_once(op, n, policy, dtype,
                                               monkeypatch):
    """The launch each wrapper (vecadd's and saxpy's, one schedule,
    ``csrc/vector_map.cuh``) gives its kernel on the H100's plan, read
    from the arguments it passes: with ``steps`` > 0, thread t of T
    takes 16-byte vectors t, t + T, ... below n // v for that many steps
    and threads 0 ... n % v - 1 one element each of the tail; with 0,
    lws scalars at stride T.  Modelled item by item: every element is
    taken once and no vector runs past n.  A pointer off 16 bytes takes
    the scalars."""
    x = torch.zeros(n + 1, dtype=DTYPES[dtype][0])[:n]
    plan = plan_vector_blocks(getattr(workload, op)(n, x.element_size()),
                              H100, policy)
    got_n, lws, grid, steps = _launch_args(monkeypatch, op, plan, x, x)
    assert (got_n, lws, grid) == (n, plan.lws, plan.grid)
    assert steps == va.vector_steps(plan, x, x, x)
    v = 16 // x.element_size()
    t = np.arange(grid * plan.threads, dtype=np.int64)
    if steps == 0:
        assert lws < v
        items = (t + np.arange(lws)[:, None] * t.size).ravel()
        taken = items[items < n]
    else:
        assert steps == -(-lws // v)
        assert grid * plan.threads * steps * v >= n
        vec = (t + np.arange(steps)[:, None] * t.size).ravel()
        vec = vec[vec < n // v]
        assert (vec.max() + 1) * v <= n
        tail = n // v * v + t
        taken = np.concatenate([(vec[:, None] * v + np.arange(v)).ravel(),
                                tail[tail < n]])
    np.testing.assert_array_equal(np.sort(taken), np.arange(n))
    off = torch.zeros(n + 1, dtype=x.dtype)[1:]
    assert _launch_args(monkeypatch, op, plan, x, off)[3] == 0


@pytest.mark.parametrize("a", [1.7, 0.3, -2.5])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("n", [1000, 16384, 70000])
def test_saxpy_matches_pallas(n, policy, dtype, a):
    (x, jx), (y, jy) = _inputs(n + 1, (n,), (n,), dtype=dtype)
    got = ops.saxpy(a, x, y, policy=policy)
    assert got.dtype == x.dtype and got.shape == (n,)
    want = _np(saxpy_pallas(jnp.float32(a), jx, jy, hw=TPU,
                            policy=JaxPolicy(policy), interpret=True))
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, atol=1e-6, rtol=1e-6)
    else:
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mnk", [(8, 1536, 576), (130, 70, 300),
                                 (256, 192, 96)])
def test_matmul_matches_pallas(mnk, policy, dtype):
    m, n, k = mnk
    (a, ja), (b, jb) = _inputs(m + k, (m, k), (k, n), dtype=dtype,
                               scale=k ** -0.25)
    got = ops.matmul(a, b, policy=policy)
    assert got.dtype == a.dtype and got.shape == (m, n)
    want = matmul_pallas(ja, jb, hw=TPU, policy=JaxPolicy(policy),
                         interpret=True)
    tol = 1e-4 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_matmul_out_dtype(out_dtype):
    (a, ja), (b, jb) = _inputs(5, (40, 48), (48, 24), dtype="bfloat16")
    got = ops.matmul(a, b, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    want = matmul_pallas(ja, jb, hw=TPU, out_dtype=DTYPES[
        str(out_dtype).split(".")[1]][1], interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=1.6e-2, rtol=1.6e-2)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("shape", [(8, 576), (37, 256), (3, 400, 64)])
def test_rmsnorm_matches_pallas(shape, policy, dtype):
    d = shape[-1]
    (x, jx), (g, jg) = _inputs(sum(shape), shape, (d,), dtype=dtype)
    got = ops.rmsnorm(x, g, eps=1e-6, policy=policy)
    assert got.dtype == x.dtype and got.shape == shape
    want = rmsnorm_pallas(jx.reshape(-1, d), jg, hw=TPU, eps=1e-6,
                          policy=JaxPolicy(policy), interpret=True)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" \
        else dict(atol=0, rtol=8e-3)
    np.testing.assert_allclose(_np(got), _np(want).reshape(shape), **tol)


# --------------------------------------------------------------------------- #
# the mapper: Eq. 1, policies, legality
# --------------------------------------------------------------------------- #


def test_eq1_and_regimes_equal_the_jax_mapper():
    rng = np.random.default_rng(0)
    for gws, hp, lws in rng.integers(1, 1 << 20, size=(500, 3)):
        gws, hp, lws = int(gws), int(hp), int(lws) % 512 + 1
        assert resolve_lws(gws, hp) == jax_resolve_lws(gws, hp)
        assert classify_regime(lws, gws, hp).value == \
            jax_classify_regime(lws, gws, hp).value
    for gws, hp in [(16384, 16384), (1, 16384), (16385, 16384)]:
        lws = resolve_lws(gws, hp)
        assert classify_regime(lws, gws, hp).value == \
            jax_classify_regime(lws, gws, hp).value


def test_tuned_policy_raises_and_names_the_tuner_slice():
    """The tuner slice has landed: "tuned" is a policy, which the ops
    resolve through the tuner (a memory-only cache here); a name that is
    no policy still raises."""
    from repro_torch.tuner import TuningCache, set_default_cache

    assert MappingPolicy("tuned") is MappingPolicy.TUNED
    cache = TuningCache(path=None)
    set_default_cache(cache)
    try:
        out = ops.vecadd(torch.ones(4), torch.ones(4), policy="tuned")
    finally:
        set_default_cache(None)
    assert out.tolist() == [2.0] * 4 and cache.stats.misses == 1
    with pytest.raises(ValueError):
        MappingPolicy("fastest")
    assert [p.value for p in MappingPolicy] == POLICIES + ["tuned"]


SIZES = [1, 255, 1000, 16384, 70000, 270336, 1 << 20, (1 << 26) + 3]


@pytest.mark.parametrize("hw", [H100, CPU], ids=["h100", "cpu"])
@pytest.mark.parametrize("policy", POLICIES)
def test_vector_and_row_plans_cover_gws_and_are_legal(policy, hw):
    for gws in SIZES:
        p = plan_vector_blocks(workload.vecadd(gws), hw, policy)
        assert p.threads == 256 and p.lws >= 1 and 1 <= p.grid < 2 ** 31
        assert p.grid * p.threads * p.lws >= gws
        assert (p.grid - 1) * p.threads * p.lws < gws     # no idle CTA
        r = plan_rows(gws, hw, policy)
        assert r.threads == 256 and r.grid * 8 * r.lws >= gws
        assert (r.grid - 1) * 8 * r.lws < gws


def test_policies_translate_eq1_to_hopper():
    """NAIVE one item per thread, FIXED 32, AUTO Eq. 1 over hp =
    SMs x warps x 32 (rows: SMs x warps), matmul rounded up to a power of
    two on the warpgroup tile (BN = 2 lws, at least 8)."""
    n = 1 << 26
    plans = {p: plan_vector_blocks(workload.vecadd(n), H100, p)
             for p in POLICIES}
    assert plans["naive"].lws == 1 and plans["naive"].grid == n // 256
    assert plans["fixed"].lws == FIXED_LWS
    assert plans["auto"].lws == -(-n // H100.hp()) == 249
    assert plans["naive"].regime is Regime.OVERSUBSCRIBED
    assert plan_vector_blocks(workload.vecadd(H100.hp()), H100,
                              "auto").regime is Regime.EXACT
    assert plan_rows(16384, H100, "auto").lws == -(-16384 // (132 * 64))
    mm_auto = plan_matmul_blocks(4096, 4096, 4096, H100, "auto", kernel=TC)
    assert resolve_lws(4096 * 4096, H100.hp()) == 63
    assert (mm_auto.tm, mm_auto.tn, mm_auto.lws) == (2, 32, 64)
    assert (mm_auto.bm, mm_auto.bn) == (128, 128)
    assert plan_matmul_blocks(4096, 4096, 4096, H100, "fixed",
                              kernel=TC).lws == 32
    # NAIVE's one output a thread rounds up to the least tile, BN 8
    naive = plan_matmul_blocks(4096, 4096, 4096, H100, "naive", kernel=TC)
    assert (naive.lws, naive.bn) == (4, 8)
    # a tile side never outgrows the matrix: 8 rows take one warpgroup,
    # and the odd N of a decode row the same tile as its neighbours
    for n in (1536, 1532):
        p = plan_matmul_blocks(8, n, 576, H100, "fixed", kernel=TC)
        assert (p.bm, p.bn, p.threads, p.grid) == (64, 64, 128, (24, 1))
    # the accumulators cap lws at 128 whatever Eq. 1 asks
    assert matmul_plan_for_blocks(4096, 4096, 64, H100, 500,
                                  kernel=TC).lws == 128


@pytest.mark.parametrize("hw", [H100, CPU], ids=["h100", "cpu"])
def test_auto_takes_one_round_at_or_above_hp(hw):
    for mult in (1, 2, 3.7, 64, 249):
        gws = int(hw.hp() * mult)
        assert plan_vector_blocks(workload.vecadd(gws), hw, "auto").rounds \
            == 1
        assert plan_rows(int(hw.sm_count * hw.warps_per_sm * mult), hw,
                         "auto").rounds == 1
    assert plan_matmul_blocks(4096, 4096, 4096, H100, "auto",
                              kernel=TC).rounds == 1
    # NAIVE past hp needs more than one round; FIXED under hp idles SMs
    big = plan_vector_blocks(workload.vecadd(4 * hw.hp()), hw, "naive")
    assert big.rounds > 1
    small = plan_vector_blocks(workload.vecadd(hw.hp() // 4), hw, "fixed")
    assert small.grid < hw.sm_count


# --------------------------------------------------------------------------- #
# wrappers, scoped policy, build
# --------------------------------------------------------------------------- #


def test_default_policy_is_auto_and_scoped(monkeypatch):
    from repro_torch.tuner import dispatch

    seen = []
    real = dispatch.resolve_plan

    def spy(kernel, hw, policy, *a, **kw):
        seen.append(policy)
        return real(kernel, hw, policy, *a, **kw)

    monkeypatch.setattr(dispatch, "resolve_plan", spy)
    x = torch.ones(100)
    ops.vecadd(x, x)
    with ops.policy("naive"):
        ops.vecadd(x, x)
        ops.vecadd(x, x, policy="fixed")
    ops.vecadd(x, x)
    assert [p.value for p in seen] == ["auto", "naive", "fixed", "auto"]


def test_cpu_tensors_launch_nothing():
    counts = ((va.vecadd, "launches"), (sx.saxpy, "launches"),
              (mm.matmul, "tc_launches"), (mm.matmul, "split_launches"),
              (mm.matmul, "tf32_launches"), (rn.rmsnorm, "launches"))
    before = [getattr(f, attr) for f, attr in counts]
    x = torch.randn(64)
    a = torch.randn(16, 32)
    for policy in POLICIES:
        ops.vecadd(x, x, policy=policy)
        ops.saxpy(2.0, x, x, policy=policy)
        ops.matmul(a, a.T.contiguous(), policy=policy)
        ops.matmul(a.bfloat16(), a.T.bfloat16(), policy=policy)
        ops.rmsnorm(a, torch.ones(32), policy=policy)
    assert [getattr(f, attr) for f, attr in counts] == before


@pytest.mark.parametrize("case", ["vec_dtype", "vec_shape", "vec_plan",
                                  "mm_dtype", "mm_shape", "mm_contiguous",
                                  "rms_gamma", "rms_dtype"])
def test_kernel_input_checks_raise(case):
    """The checks run before a launch; they raise on what the kernels do
    not take."""
    x = torch.zeros(1000)
    vplan = plan_vector_blocks(workload.vecadd(1000), H100, "auto")
    a, b = torch.zeros(8, 16), torch.zeros(16, 4)
    mplan = plan_matmul_blocks(8, 4, 16, H100, "auto", kernel="tf32x3")
    rplan = plan_rows(8, H100, "auto")
    with pytest.raises((TypeError, ValueError)):
        if case == "vec_dtype":
            va.check_vector_args("vecadd", vplan, x.half(), x.half())
        elif case == "vec_shape":
            va.check_vector_args("vecadd", vplan, x, torch.zeros(999))
        elif case == "vec_plan":
            small = plan_vector_blocks(workload.vecadd(10), H100, "naive")
            va.check_vector_args("vecadd", small, x, x)
        elif case == "mm_dtype":
            mm._check(a, b.bfloat16(), mplan, torch.float32)
        elif case == "mm_shape":
            mm._check(a, torch.zeros(15, 4), mplan, torch.float32)
        elif case == "mm_contiguous":
            mm._check(a, torch.zeros(4, 16).T, mplan, torch.float32)
        elif case == "rms_gamma":
            rn._check(a, torch.zeros(15), rplan)
        else:
            rn._check(a.double(), torch.zeros(16).double(), rplan)


def test_saxpy_scalar_is_rounded_to_x_dtype():
    x = torch.ones(4, dtype=torch.bfloat16)
    y = torch.zeros(4, dtype=torch.bfloat16)
    a = 1.0 + 2 ** -9                     # not a bf16 value: rounds to 1.0
    assert (sx.saxpy_plain(a, x, y) == 1.0).all()
    assert (sx.saxpy_plain(torch.tensor(a), x.float(), y.float())
            == torch.tensor(a)).all()


def test_build_sources_name_every_cu():
    on_disk = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sorted(_build.SOURCES) == on_disk
    for name in ("vecadd", "saxpy", "rmsnorm", "matmul_tc",
                 "matmul_tf32x3"):
        assert name in _build.SOURCES
