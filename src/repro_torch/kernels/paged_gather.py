"""The paged KV pool's layout invariant, defined once.

The serving pool's physical KV store is a block grid: each pool row of
length T holds T / block_size blocks, and physical block ids map onto it
column-major, so pool growth appends new ids without moving live blocks:

    pid  ->  (row = pid % slots, offset = (pid // slots) * block_size)

The paged scatter writes (``models.attention``), the engine's prefill
page map and the decode kernel's page addressing all go through these
functions, so writers and readers can never disagree.  (The gather
kernel of the JAX package is not ported yet.)
"""

from __future__ import annotations

import torch

__all__ = ["flat_position", "paged_flat_indices"]


def flat_position(pid, pos, slots: int, kv_len: int, block_size: int):
    """The flat (slots * kv_len) cache position of logical token ``pos``
    inside physical block ``pid`` — pure arithmetic over numpy arrays or
    torch tensors."""
    return ((pid % slots) * kv_len + (pid // slots) * block_size
            + pos % block_size)


def paged_flat_indices(tables: torch.Tensor, slots: int, kv_len: int,
                       block_size: int) -> torch.Tensor:
    """Flat (slots * kv_len) positions of each row's logical tokens:
    ``tables`` (slots, nb) of physical block ids (-1 = unmapped, clamped
    to block 0 — callers mask by cache length) -> (slots, kv_len) int64.
    """
    t = torch.arange(kv_len, device=tables.device)
    pid = tables[:, t // block_size].long().clamp_min(0)
    return flat_position(pid, t, slots, kv_len, block_size)
