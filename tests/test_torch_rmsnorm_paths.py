"""How the port's rmsnorm kernel reads a row (``csrc/rmsnorm.cu``), on
the CPU: ``kernels.rmsnorm.row_path`` picks 16-byte vectors staged in
shared memory where the pointers, the row length and the device's
shared memory a block allow, and scalars elsewhere; and
``ops.rmsnorm`` against the JAX kernel (``rmsnorm_pallas`` in interpret
mode) at the rows that ``chip_smoke.py`` adds for the scalar path.  The
kernel runs only on the card, where ``chip_smoke.py`` holds each path
against the plain version.

Tolerances (port vs JAX): float32 atol = rtol = 1e-5; bfloat16 rtol
8e-3 (one ulp), as ``tests/test_torch_suite.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.hw import TPU_REGISTRY
from repro.core.mapper import MappingPolicy as JaxPolicy
from repro.kernels.rmsnorm import rmsnorm_pallas

from repro_torch.core.hw import GPU_REGISTRY
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn

TPU = TPU_REGISTRY["cpu_sim"]
BF16, F32 = torch.bfloat16, torch.float32


def _rows(d, dtype, offset=0):
    """4 rows of ``d`` starting ``offset`` elements into a fresh buffer
    (a fresh buffer is 16-byte aligned)."""
    return torch.zeros(4 * d + offset, dtype=dtype)[offset:].view(4, d)


@pytest.mark.parametrize("d, dtype, offset, want", [
    (576, BF16, 0, "vector"),            # smollm's rows: 10 KB staged
    (32, F32, 0, "vector"),
    (512, F32, 0, "vector"),
    (576, F32, 0, "vector"),
    (4096, BF16, 0, "vector"),
    (4096, F32, 0, "vector"),
    (12864, BF16, 0, "vector"),          # 9 rows of 25,728 B fit
    (12928, BF16, 0, "scalar"),          # 9 rows of 25,856 B do not
    (999, BF16, 0, "scalar"),            # not whole 16-byte vectors
    (1000, BF16, 1, "scalar"),           # x 2 bytes past a boundary
    (1000, BF16, 0, "vector"),
])
def test_row_path(d, dtype, offset, want):
    x = _rows(d, dtype, offset)
    assert rn.row_path(x, torch.zeros(d, dtype=dtype)) == want


def test_misaligned_gamma_takes_the_scalar_path():
    x = _rows(1024, BF16)
    gamma = torch.zeros(1025, dtype=BF16)[1:]
    assert rn.row_path(x, gamma) == "scalar"


@pytest.mark.parametrize("smem, d, dtype, want", [
    (9 * 1152, 576, BF16, "vector"),     # exactly 8 rows and gamma
    (9 * 1152 - 16, 576, BF16, "scalar"),
    (48 * 1024, 4096, BF16, "scalar"),   # 72 KB: past the default 48 KB
    (100 * 1024, 4096, BF16, "vector"),
    (100 * 1024, 4096, F32, "scalar"),   # 144 KB
])
def test_row_path_reads_the_devices_shared_memory(smem, d, dtype, want,
                                                   monkeypatch):
    """The limit is the ``smem_per_block`` of the device's ``GpuParams``
    (``core.hw.detect``), not a constant of the kernel layer."""
    card = dataclasses.replace(GPU_REGISTRY["cpu"], smem_per_block=smem)
    monkeypatch.setattr(rn, "detect", lambda device: card)
    rn._smem_per_block.cache_clear()
    try:
        x = _rows(d, dtype)
        assert rn.row_path(x, torch.zeros(d, dtype=dtype)) == want
    finally:
        rn._smem_per_block.cache_clear()


@pytest.mark.parametrize("policy", ["naive", "fixed", "auto"])
@pytest.mark.parametrize("t, d, offset", [(37, 999, 0), (64, 1000, 1)])
def test_scalar_path_rows_match_pallas(t, d, offset, policy):
    """The smoke's scalar-path rows, x made as the smoke makes it (one
    bf16 past the start of its buffer for the misaligned case)."""
    rng = np.random.default_rng(t + d)
    flat = torch.from_numpy(rng.standard_normal(t * d + offset)
                            .astype(np.float32)).to(BF16)
    x = flat[offset:].view(t, d)
    g = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(BF16)
    got = ops.rmsnorm(x, g, eps=1e-6, policy=policy)
    want = rmsnorm_pallas(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                          jnp.asarray(g.float().numpy()).astype(jnp.bfloat16),
                          hw=TPU, eps=1e-6, policy=JaxPolicy(policy),
                          interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert (np.abs(got - want) <= 8e-3 * np.abs(want)).all()
