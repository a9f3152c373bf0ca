"""CacheAdapter — the dense family's face of the ragged decode pool.

The dense subset of the JAX package's ``serve/adapters.py`` (no int8
pool, no other families).  The engine keeps one cache dict for the pool
— K/V (L, slots, T, G, hd) plus a per-row ``pos`` vector — and needs
four operations on it:

  ``init_pool``    build the pool cache with a per-row ``pos`` vector
  ``prefill_len``  how long to pad a prompt before prefill
  ``write_row``    scatter one prefilled request's cache into its blocks
  ``grow``         pad the pool's time axis to a longer bucket

Unlike the JAX package, ``write_row`` updates the pool IN PLACE
(``index_put_`` on the flat view) and ``grow`` allocates the longer
arrays once and copies the old rows in.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["FamilyCacheAdapter", "ADAPTERS", "get_adapter"]


@dataclasses.dataclass(frozen=True)
class FamilyCacheAdapter:
    """``CacheAdapter`` over dict-of-(L, batch, T, ...) caches.

    Example::

        adapter = get_adapter("dense")
        cache = adapter.init_pool(model, slots=4, kv_len=64)
    """

    family: str
    length_keys: tuple[str, ...] = ("k", "v")

    def init_pool(self, model, slots: int, kv_len: int) -> dict:
        """The family's decode cache with a per-row (ragged) ``pos``."""
        cache = model.init_cache(slots, kv_len)
        cache["pos"] = torch.zeros((slots,), dtype=torch.int32,
                                   device=model.device)
        return cache

    def prefill_len(self, prompt_len: int,
                    quantize: Callable[[int], int]) -> int:
        """Prompt bucket: per-row length masks make padding safe."""
        return quantize(prompt_len)

    def write_row(self, cache: dict, slot: int, row_cache: dict,
                  prompt_len: int, kv_len: int, page_map: torch.Tensor
                  ) -> dict:
        """Scatter one prefilled request's prompt K/V into its leased
        blocks, IN PLACE: ``page_map`` (prompt_len,) holds the flat
        physical positions of the prompt's tokens (from the request's
        block table).  Positions past the prompt are masked by ``pos``
        until decode overwrites them.  The row's ``pos`` becomes the true
        prompt length."""
        for key in self.length_keys:
            arr = cache[key]                        # (L, B, T, G, hd)
            n, b = arr.shape[:2]
            vals = row_cache[key][:, 0, :prompt_len]
            arr.view(n, b * kv_len, *arr.shape[3:])[:, page_map] = \
                vals.to(arr.dtype)
        cache["pos"][slot] = prompt_len
        return cache

    def grow(self, cache: dict, new_len: int) -> dict:
        """Pad the time axis up to the new bucket.  The physical block of
        every id keeps its (row, offset), so live leases stay valid."""
        out = dict(cache)
        for key in self.length_keys:
            old = cache[key]
            if new_len <= old.shape[2]:
                raise ValueError("grow called without a longer bucket")
            new = old.new_zeros(old.shape[:2] + (new_len,) + old.shape[3:])
            new[:, :, :old.shape[2]] = old
            out[key] = new
        return out


ADAPTERS: dict[str, FamilyCacheAdapter] = {
    "dense": FamilyCacheAdapter("dense"),
}


def get_adapter(family: str) -> FamilyCacheAdapter:
    """The registered adapter for a model family; raises
    ``NotImplementedError`` for families the port does not serve yet."""
    try:
        return ADAPTERS[family]
    except KeyError:
        raise NotImplementedError(
            f"no CacheAdapter for family {family!r}; the port serves "
            f"{tuple(sorted(ADAPTERS))}") from None
