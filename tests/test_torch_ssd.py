"""The port's SSD (Mamba-2's chunked scan, kernel row 9) against the JAX
package, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX
``ssd_pallas`` in interpret mode (the Pallas kernel itself) and the
port's ``kernels.ssd.ssd`` (its plain version on CPU tensors) at the
shapes of ``tests/test_kernels.py``'s SSD tests: float32 within 1e-5
(summation order only), bfloat16 within 1.6e-2 (two bf16 ulps near 1).
Both agree with the O(L) recurrence within 1e-3, as the reference tests
hold; the chunk planner equals JAX's; the causal mask stays finite under
a strongly negative decay; the kernel path raises rather than falling
back.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.mapper import MappingPolicy as JaxPolicy
from repro.kernels import ref
from repro.kernels.ssd import ssd_pallas
from repro.models.ssm import plan_ssd_chunk as jax_plan_ssd_chunk

from repro_torch import kernels
from repro_torch.core.hw import GPU_REGISTRY
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as ssd_mod
from repro_torch.models.ssm import plan_ssd_chunk

TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, dtype="float32", decay=0.1, seed=0):
    """(L, H, P, G, N) -> the reference tests' scaling: x * 0.5,
    a = -|N(0, 1)| * decay (float32), b and c * 0.3; x, b, c in dtype.
    Returns (torch tuple, jax tuple) of the same values."""
    length, heads, p, g, n = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((length, heads, p), np.float32) * 0.5
    a = -np.abs(rng.standard_normal((length, heads), np.float32)) * decay
    b = rng.standard_normal((length, g, n), np.float32) * 0.3
    c = rng.standard_normal((length, g, n), np.float32) * 0.3
    tdt, jdt = DTYPES[dtype]
    t = tuple(torch.from_numpy(v).to(tdt) if i != 1 else torch.from_numpy(v)
              for i, v in enumerate((x, a, b, c)))
    j = tuple(jnp.asarray(v).astype(jdt) if i != 1 else jnp.asarray(v)
              for i, v in enumerate((x, a, b, c)))
    return t, j


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _np(t):
    return t.float().numpy()


KERNEL_SHAPE = (256, 4, 32, 2, 16)
RAGGED_SHAPE = (192, 2, 16, 1, 8)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,chunk", [(KERNEL_SHAPE, 32),
                                         (KERNEL_SHAPE, 64),
                                         (KERNEL_SHAPE, 128),
                                         (RAGGED_SHAPE, 128)],
                         ids=["c32", "c64", "c128", "ragged192-c128"])
def test_plain_ssd_matches_pallas_interpret(shape, chunk, dtype):
    (x, a, b, c), (jx, ja, jb, jc) = _inputs(shape, dtype)
    want = ssd_pallas(jx, ja, jb, jc, chunk=chunk, interpret=True)
    got = ssd_mod.ssd(x, a, b, c, chunk=chunk)
    assert got.dtype == x.dtype and got.shape == x.shape
    _close(_np(got), want, TOL[dtype])


@pytest.mark.parametrize("shape,chunk", [(KERNEL_SHAPE, 32),
                                         (KERNEL_SHAPE, 64),
                                         (KERNEL_SHAPE, 128),
                                         (RAGGED_SHAPE, 128)],
                         ids=["c32", "c64", "c128", "ragged192-c128"])
def test_ssd_and_pallas_match_the_sequential_recurrence(shape, chunk):
    (x, a, b, c), (jx, ja, jb, jc) = _inputs(shape)
    seq = ssd_mod.ssd_sequential(x, a, b, c)
    _close(_np(seq), ref.ssd_sequential(jx, ja, jb, jc), 1e-5)
    _close(_np(ssd_mod.ssd(x, a, b, c, chunk=chunk)), _np(seq), 1e-3)
    _close(ssd_pallas(jx, ja, jb, jc, chunk=chunk, interpret=True),
           _np(seq), 1e-3)


@pytest.mark.parametrize("chunk", [16, 32, 128])
def test_return_state_matches_reference(chunk):
    (x, a, b, c), (jx, ja, jb, jc) = _inputs((128, 4, 16, 2, 8))
    y, state = ssd_mod.ssd_chunked(x, a, b, c, chunk=chunk,
                                   return_state=True)
    jy, jstate = ref.ssd_chunked(jx, ja, jb, jc, chunk=chunk,
                                 return_state=True)
    assert state.dtype == torch.float32 and state.shape == (4, 8, 16)
    _close(_np(y), jy, 1e-5)
    _close(state.numpy(), jstate, 1e-5)


@pytest.mark.parametrize("policy", ["naive", "fixed", "auto"])
def test_plan_ssd_chunk_equals_jax_without_hw(policy):
    lengths = list(range(1, 5001, 7)) + [64, 96, 600, 1200, 2048, 4096,
                                         4097, 5000]
    for n in lengths:
        assert plan_ssd_chunk(n, None, policy) == \
            jax_plan_ssd_chunk(n, None, JaxPolicy(policy)), n


def test_plan_ssd_chunk_on_the_h100():
    """Eq. 1 against SMs x resident warps (8,448 on an H100): AUTO plans
    64 below ~532k steps, like NAIVE; FIXED plans 256."""
    h100 = GPU_REGISTRY["h100_sxm"]
    assert h100.sm_count * h100.warps_per_sm == 8448
    for n in (1, 600, 1200, 2048, 32768, 63 * 8448):
        assert plan_ssd_chunk(n, h100, "auto") == 64
        assert plan_ssd_chunk(n, h100, "naive") == 64
        assert plan_ssd_chunk(n, h100, "fixed") == 256
    assert plan_ssd_chunk(1 << 20, h100, "auto") == 128


@pytest.mark.parametrize("length,chunk,want", [(2048, None, 64),
                                               (1200, None, 16),
                                               (1200, 256, 16),
                                               (192, 128, 64),
                                               (40, 64, 40),
                                               (600, 64, 8)])
def test_legal_chunk_halves_like_ssd_pallas(length, chunk, want):
    assert ssd_mod.legal_chunk(length, chunk) == want


def test_ops_ssd_runs_the_plain_version_on_cpu():
    (x, a, b, c), (jx, ja, jb, jc) = _inputs(KERNEL_SHAPE)
    before = ssd_mod.ssd.launches
    got = ops.ssd(x, a, b, c, policy="fixed")          # policy is ignored
    assert ssd_mod.ssd.launches == before
    _close(_np(got), ssd_pallas(jx, ja, jb, jc, chunk=64, interpret=True),
           1e-5)
    # a of another float dtype is cast to float32, as the kernel body does
    got64 = ops.ssd(x, a.to(torch.float64), b, c, chunk=64)
    _close(_np(got64), _np(got), 1e-6)
    with kernels.force("plain"):
        assert torch.equal(ops.ssd(x, a, b, c, chunk=64), got)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_strongly_negative_decay_masks_before_the_exponent(dtype):
    """|a| up to 20: exp(cum_t - cum_s) for s > t would be inf; the plain
    version selects before the exponent, so nothing is NaN."""
    (x, a, b, c), (jx, ja, jb, jc) = _inputs(KERNEL_SHAPE, dtype,
                                             decay=20.0 / 3)
    assert float(a.min()) < -20
    got = ssd_mod.ssd(x, a, b, c, chunk=64)
    assert torch.isfinite(got.float()).all()
    _close(_np(got), ssd_pallas(jx, ja, jb, jc, chunk=64, interpret=True),
           TOL[dtype])
    _close(_np(got), _np(ssd_mod.ssd_sequential(x, a, b, c)), 1e-3
           if dtype == "float32" else TOL[dtype])


@pytest.mark.parametrize("bad", ["state", "head_dim", "groups"])
def test_kernel_path_raises_instead_of_falling_back(bad, monkeypatch):
    """Off the plain version (as on a CUDA tensor), an input the kernel
    does not take raises before anything is built or launched."""
    shape = {"state": (64, 4, 16, 2, 256), "head_dim": (64, 4, 128, 2, 16),
             "groups": (64, 4, 16, 3, 16)}[bad]
    length, heads, p, g, n = shape
    x, a = torch.zeros(length, heads, p), torch.zeros(length, heads)
    b = c = torch.zeros(length, g, n)
    monkeypatch.setattr(kernels, "use_plain", lambda t: False)
    before = ssd_mod.ssd.launches
    with pytest.raises(ValueError):
        ssd_mod.ssd(x, a, b, c, chunk=64)
    assert ssd_mod.ssd.launches == before


def test_smem_layout_fits_fixed_chunks_on_hopper():
    """Each step's staged layout fits the 227 KB opt-in at every chunk
    the planner can give (1 to 512), FIXED's 256 included."""
    limit = GPU_REGISTRY["h100_sxm"].smem_per_block
    for chunk in range(1, 513):
        assert max(ssd_mod.smem_bytes(chunk).values()) <= limit, chunk
    assert ssd_mod.smem_bytes(256)["outputs"] < limit
