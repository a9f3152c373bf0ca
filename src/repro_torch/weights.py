"""Parameter conversion from the JAX package's layout.

``params_from_jax`` takes the JAX parameter tree as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)`` on the caller's side)
and returns the port's params in the same layout, as torch tensors.
Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax"]


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16; the f32 round trip is exact
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))          # a writable copy
    return t.to(device)


def params_from_jax(tree: dict, *, device="cpu") -> dict:
    """Nested dicts of numpy arrays -> the same nesting of tensors, each
    in its array's dtype, on ``device``."""
    return {k: params_from_jax(v, device=device)
            if isinstance(v, dict) else _tensor(v, device)
            for k, v in tree.items()}
