"""CacheAdapter — each served family's face of the ragged decode pool.

The dense and ssm subset of the JAX package's ``serve/adapters.py`` (no
radix-resumed writes).  One generic ``FamilyCacheAdapter`` serves both,
because the families differ only in which cache keys carry a time axis
(``length_keys``) and whether prompt padding is safe
(``prefill_buckets``): dense keeps K/V (L, slots, T, G, hd) — for the
int8 pool with per-(physical block, KV group) scales — and a padded
prompt is masked by each row's ``pos``; ssm keeps a length-free
recurrent state and conv window, which padding would corrupt, so its
prompts prefill at their exact length.  moe, hybrid, encdec and vlm come
with ROADMAP queue 1 item 9.  The engine keeps one cache dict for the
pool plus a per-row ``pos`` vector, and needs four operations on it:

  ``init_pool``    build the pool cache with a per-row ``pos`` vector
  ``prefill_len``  how long to pad a prompt before prefill
  ``write_row``    land one prefilled request's cache in the pool
  ``grow``         pad the pool's time axis to a longer bucket

Unlike the JAX package, ``write_row`` updates the pool IN PLACE
(``index_put_`` on the flat view, slice assignment on a row) and
``grow`` allocates the longer arrays once and copies the old rows in.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.dtypes import kv_dtype_spec

__all__ = ["FamilyCacheAdapter", "ADAPTERS", "get_adapter"]


@dataclasses.dataclass(frozen=True)
class FamilyCacheAdapter:
    """``CacheAdapter`` over dict-of-(L, batch, ...) caches.

    Example::

        adapter = get_adapter("dense")
        cache = adapter.init_pool(model, slots=4, kv_len=64)
        ssm = FamilyCacheAdapter("ssm", length_keys=(),
                                 prefill_buckets=False)
    """

    family: str
    length_keys: tuple[str, ...] = ("k", "v")
    prefill_buckets: bool = True

    @property
    def grows_with_len(self) -> bool:
        """False for length-free (recurrent) caches: growth is block
        accounting only."""
        return bool(self.length_keys)

    def init_pool(self, model, slots: int, kv_len: int, *,
                  kv_dtype: str = "fp32", block_size: int = 16) -> dict:
        """The family's decode cache with a per-row (ragged) ``pos``.
        ``kv_dtype="int8"`` allocates the K/V as int8 codes and adds
        ``k_scale``/``v_scale`` (L, slots, kv_len / block_size, G) f32,
        all at the ZERO dead-block sentinel: no block carries a scale
        until a tenant writes one.  A family with no length keys
        quantises nothing."""
        quantize = kv_dtype_spec(kv_dtype).quantized and bool(
            self.length_keys)
        cache = model.init_cache(
            slots, kv_len, cache_dtype=torch.int8 if quantize else None)
        if quantize:
            for key in self.length_keys:
                arr = cache[key]                    # (L, B, T, G, hd)
                cache[key + "_scale"] = torch.zeros(
                    arr.shape[:2] + (kv_len // block_size, arr.shape[3]),
                    dtype=torch.float32, device=arr.device)
        cache["pos"] = torch.zeros((slots,), dtype=torch.int32,
                                   device=model.device)
        return cache

    def prefill_len(self, prompt_len: int,
                    quantize: Callable[[int], int]) -> int:
        """Prompt bucket when per-row length masks make padding safe,
        else the exact length."""
        return quantize(prompt_len) if self.prefill_buckets else prompt_len

    def write_row(self, cache: dict, slot: int, row_cache: dict,
                  prompt_len: int, kv_len: int,
                  page_map: Optional[torch.Tensor] = None,
                  scale_map: Optional[torch.Tensor] = None,
                  page_block: Optional[int] = None) -> dict:
        """Land one prefilled request's prompt K/V in the pool, IN PLACE.

        With ``page_map`` (prompt_len,) — the flat physical positions of
        the prompt's tokens from the request's block table — only the
        prompt's own tokens scatter into the leased blocks; positions
        past the prompt are masked by ``pos`` until decode overwrites
        them.  Without it (the contiguous pool) the row cache, padded
        with zeros to ``kv_len``, replaces the slot's whole row.

        On the int8 pool (``k_scale``/``v_scale`` present) ``scale_map``
        (the lease's flat physical blocks, logical order) and
        ``page_block`` drive the quantising write (``_quantize_prompt``).
        Keys with no time axis (the ssm state and conv window) land
        shape-exact in the slot.  The row's ``pos`` becomes the true
        prompt length."""
        for key, arr in row_cache.items():
            if key != "pos" and key not in self.length_keys:
                cache[key][:, slot] = arr[:, 0].to(cache[key].dtype)
        for key in self.length_keys:
            arr = cache[key]                        # (L, B, T, G, hd)
            n, b = arr.shape[:2]
            row = row_cache[key][:, 0]              # (L, pb, G, hd)
            if page_map is None:
                arr[:, slot, :row.shape[1]] = row.to(arr.dtype)
                arr[:, slot, row.shape[1]:] = 0
                continue
            vals = row[:, :prompt_len]
            if key + "_scale" in cache:
                vals = self._quantize_prompt(cache, key, vals, prompt_len,
                                             kv_len, scale_map,
                                             int(page_block))
            arr.view(n, b * kv_len, *arr.shape[3:])[:, page_map] = \
                vals.to(arr.dtype)
        cache["pos"][slot] = prompt_len
        return cache

    def _quantize_prompt(self, cache: dict, key: str, vals: torch.Tensor,
                         prompt_len: int, kv_len: int,
                         scale_map: torch.Tensor, bs: int) -> torch.Tensor:
        """Quantise one prompt's (L, prompt_len, G, hd) values to int8
        codes with per-(logical block, KV group) amax scales, and land
        the scales on the lease's physical blocks IN PLACE: written
        blocks get their amax / 127, leased blocks past the prompt the
        zero dead sentinel (so a recycled block's old scale never
        aliases into the new tenant).  Returns the codes."""
        n, g = vals.shape[0], vals.shape[2]
        npb = -(-prompt_len // bs)
        scales = cache[key + "_scale"]              # (L, B, nb, G)
        sflat = scales.view(n, -1, g)
        v = F.pad(vals.float(), (0, 0, 0, 0, 0, npb * bs - prompt_len))
        v = v.reshape(n, npb, bs, g, -1)
        sc = v.abs().amax(dim=(2, 4)) / 127.0                   # (L, npb, G)
        safe = torch.where(sc > 0, sc, 1.0)
        codes = torch.round(v / safe[:, :, None, :, None]).clamp(-127, 127)
        codes = codes.reshape(n, npb * bs, g, -1)[:, :prompt_len]
        sflat[:, scale_map[:npb]] = sc
        if len(scale_map) > npb:                    # zero the lease's tail
            sflat[:, scale_map[npb:]] = 0.0
        return codes.to(cache[key].dtype)

    def grow(self, cache: dict, new_len: int) -> dict:
        """Pad the time axis up to the new bucket.  The physical block of
        every id keeps its (row, offset), so live leases stay valid; the
        int8 pool's scale grid gains ZERO (dead) blocks, like recycled
        ones."""
        out = dict(cache)
        for key in self.length_keys:
            old = cache[key]
            t_old = old.shape[2]
            if new_len <= t_old:
                raise ValueError("grow called without a longer bucket")
            new = old.new_zeros(old.shape[:2] + (new_len,) + old.shape[3:])
            new[:, :, :t_old] = old
            out[key] = new
            skey = key + "_scale"
            if skey in cache:
                sc = cache[skey]
                bs = t_old // sc.shape[2]           # the layout's block size
                grown = sc.new_zeros(sc.shape[:2] + (new_len // bs,)
                                     + sc.shape[3:])
                grown[:, :, :sc.shape[2]] = sc
                out[skey] = grown
        return out


ADAPTERS: dict[str, FamilyCacheAdapter] = {
    "dense": FamilyCacheAdapter("dense"),
    "ssm": FamilyCacheAdapter("ssm", length_keys=(), prefill_buckets=False),
}


def get_adapter(family: str) -> FamilyCacheAdapter:
    """The registered adapter for a model family; raises
    ``NotImplementedError`` for families the port does not serve yet."""
    try:
        return ADAPTERS[family]
    except KeyError:
        raise NotImplementedError(
            f"no CacheAdapter for family {family!r}; the port serves "
            f"{tuple(sorted(ADAPTERS))}, and moe, hybrid, encdec and vlm "
            f"come with ROADMAP queue 1 item 9") from None
