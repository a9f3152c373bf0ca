"""Public kernel API of the paper's suite, with the mapping policy.

Each op resolves its launch at call time from the hardware parameters
(``hw`` defaults to ``detect()`` of the inputs' device: the paper's
runtime technique) and the mapping policy, then runs its kernel wrapper:
the hand-written CUDA kernel for CUDA tensors, the plain version for CPU
tensors.  Nothing here moves a tensor between devices.

The policy is ``"naive"``, ``"fixed"`` or ``"auto"`` (the default, Eq.
1); ``policy=`` overrides per call, ``set_default_policy`` for the
process, and ``with ops.policy("naive"): ...`` for a scope::

    >>> import torch
    >>> from repro_torch.kernels import ops
    >>> x = torch.ones(1000)
    >>> ops.vecadd(x, x, policy="fixed")[:3]
    tensor([2., 2., 2.])
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from repro_torch.core import workload
from repro_torch.core.hw import GpuParams, detect
from repro_torch.core.mapper import (MappingPolicy, plan_matmul_blocks,
                                     plan_rows, plan_vector_blocks)
from repro_torch.kernels import matmul as _matmul
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import saxpy as _saxpy
from repro_torch.kernels import vecadd as _vecadd

__all__ = ["vecadd", "saxpy", "matmul", "rmsnorm", "set_default_policy",
           "policy"]

_DEFAULT_POLICY: MappingPolicy = MappingPolicy.AUTO


def set_default_policy(policy: MappingPolicy | str) -> None:
    global _DEFAULT_POLICY
    _DEFAULT_POLICY = MappingPolicy(policy)


@contextlib.contextmanager
def policy(policy: MappingPolicy | str) -> Iterator[None]:
    """Scoped ``set_default_policy``: ``with ops.policy("naive"): ...``"""
    global _DEFAULT_POLICY
    prev = _DEFAULT_POLICY
    set_default_policy(policy)
    try:
        yield
    finally:
        _DEFAULT_POLICY = prev


def _resolve(policy) -> MappingPolicy:
    return MappingPolicy(policy) if policy is not None else _DEFAULT_POLICY


def _hw(t: torch.Tensor, hw: Optional[GpuParams]) -> GpuParams:
    return hw or detect(t.device)


def vecadd(x, y, *, policy=None, hw: Optional[GpuParams] = None):
    plan = plan_vector_blocks(workload.vecadd(x.numel(), x.element_size()),
                              _hw(x, hw), _resolve(policy))
    return _vecadd.vecadd(x, y, plan=plan)


def saxpy(a, x, y, *, policy=None, hw: Optional[GpuParams] = None):
    plan = plan_vector_blocks(workload.saxpy(x.numel(), x.element_size()),
                              _hw(x, hw), _resolve(policy))
    return _saxpy.saxpy(a, x, y, plan=plan)


def matmul(a, b, *, policy=None, out_dtype=None,
           hw: Optional[GpuParams] = None):
    plan = plan_matmul_blocks(a.shape[0], b.shape[1], a.shape[1],
                              _hw(a, hw), _resolve(policy))
    return _matmul.matmul(a, b, plan=plan, out_dtype=out_dtype)


def rmsnorm(x, gamma, *, eps: float = 1e-6, policy=None,
            hw: Optional[GpuParams] = None):
    """x: (..., d) — leading dims flattened into token rows."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    plan = plan_rows(x2.shape[0], _hw(x, hw), _resolve(policy))
    return _rmsnorm.rmsnorm(x2, gamma, eps=eps, plan=plan).reshape(shape)
