"""CacheAdapter — each served family's face of the ragged decode pool.

The dense, moe, ssm, hybrid and encdec subset of the JAX package's
``serve/adapters.py``.  One generic ``FamilyCacheAdapter`` serves all
five, because the families differ only in which cache keys carry a time
axis (``length_keys``), whether prompt padding is safe
(``prefill_buckets``), whether a cached prompt prefix is complete
context for another request (``shareable_prefix``) and what else a
prefill takes (``extras``): dense and moe keep
K/V (L, slots, T, G, hd) — for the int8 pool with per-(physical block,
KV group) scales — and a padded prompt is masked by each row's ``pos``;
ssm keeps a length-free recurrent state and conv window, which padding
would corrupt, so its prompts prefill at their exact length and it
shares no prefix.  moe shares none either: capacity routing couples a
token's deeper K/V to the other tokens routed with it, so a cached block
is not what another request would compute (the reference excludes it
for the same reason).  hybrid keeps its shared block's K/V (n_groups,
slots, T, G, hd) as the length keys beside a length-free ssm state and
conv window per padded layer, which land shape-exact in the slot; its
whole-prompt prefill leaves those at zero and its chunked prefill steps
only the prompt's own tokens, so padding stays safe, and it shares no
prefix: its recurrent state lives outside the blocks.  encdec (whisper)
keeps the self-attention's K/V as the length keys beside the
cross-attention's static ck/cv (L, slots, T_enc, G, hd), which land
shape-exact in the slot, stay in the model's dtype on the int8 pool and
never grow; its prefill takes stub encoder frames (``prefill_extras``),
and it shares no prefix: its context begins with the frames, not with
tokens.  vlm comes with ROADMAP queue 1 item 9c.  The engine keeps one
cache dict for the pool plus a per-row ``pos`` vector, and needs five
operations on it:

  ``init_pool``       build the pool cache with a per-row ``pos`` vector
  ``prefill_len``     how long to pad a prompt before prefill
  ``prefill_extras``  the family's other prefill inputs (encoder frames)
  ``write_row``       land one prefilled request's cache in the pool
                      (from ``start`` on when a radix prefix is shared)
  ``grow``            pad the pool's time axis to a longer bucket

Unlike the JAX package, ``write_row`` updates the pool IN PLACE
(``index_put_`` on the flat view, slice assignment on a row) and
``grow`` allocates the longer arrays once and copies the old rows in.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

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
    #: True when the family's whole per-position sequence state lives in
    #: the paged K/V blocks, so a prompt prefix cached by one request is
    #: complete context for another (radix prefix sharing): dense only;
    #: ssm and hybrid carry a state outside any block, and moe's blocks
    #: depend on the tokens routed beside them
    shareable_prefix: bool = False
    #: (model, rows) -> the family's other prefill inputs, keyword
    #: arguments of ``Model.prefill`` (encdec: the stub ``frames``)
    extras: Optional[Callable[[Any, int], dict]] = None

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

    def prefill_extras(self, model, rows: int) -> dict:
        """The family's other prefill inputs for ``rows`` requests
        (``{}`` for most families)."""
        return self.extras(model, rows) if self.extras else {}

    def write_row(self, cache: dict, slot: int, row_cache: dict,
                  prompt_len: int, kv_len: int,
                  page_map: Optional[torch.Tensor] = None,
                  scale_map: Optional[torch.Tensor] = None,
                  page_block: Optional[int] = None,
                  start: int = 0) -> dict:
        """Land one prefilled request's prompt K/V in the pool, IN PLACE.

        With ``page_map`` (prompt_len - start,) — the flat physical
        positions of the prompt's tokens ``[start, prompt_len)`` from the
        request's block table — only those tokens scatter into the
        leased blocks; positions past the prompt are masked by ``pos``
        until decode overwrites them.  Without it (the contiguous pool)
        the row cache, padded with zeros to ``kv_len``, replaces the
        slot's whole row.

        ``start`` (block-aligned, paged only) begins the write
        mid-prompt: positions ``[0, start)`` live in radix-SHARED blocks
        another request wrote, and this write never touches them —
        neither their values nor, on the int8 pool, their scale rows
        (shared blocks share their scales).

        On the int8 pool (``k_scale``/``v_scale`` present) ``scale_map``
        (the lease's flat physical blocks, logical order) and
        ``page_block`` drive the quantising write (``_quantize_prompt``).
        Keys with no time axis (the ssm state and conv window, the
        cross-attention's ck/cv) land shape-exact in the slot.  The row's ``pos`` becomes the true
        prompt length."""
        assert start == 0 or page_map is not None, \
            "a mid-prompt write start needs the paged pool"
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
            vals = row[:, start:prompt_len]
            if key + "_scale" in cache:
                vals = self._quantize_prompt(cache, key, vals, start,
                                             prompt_len, scale_map,
                                             int(page_block))
            if prompt_len > start:
                arr.view(n, b * kv_len, *arr.shape[3:])[:, page_map] = \
                    vals.to(arr.dtype)
        cache["pos"][slot] = prompt_len
        return cache

    def _quantize_prompt(self, cache: dict, key: str, vals: torch.Tensor,
                         start: int, prompt_len: int,
                         scale_map: torch.Tensor, bs: int) -> torch.Tensor:
        """Quantise one prompt's (L, prompt_len - start, G, hd) values to
        int8 codes with per-(logical block, KV group) amax scales, and
        land the scales on the lease's physical blocks IN PLACE: written
        blocks get their amax / 127, leased blocks past the prompt the
        zero dead sentinel (so a recycled block's old scale never
        aliases into the new tenant), and the radix-shared blocks BEFORE
        ``start`` are never touched (a shared block's scale row belongs
        to the block, not the lease).  Returns the codes."""
        assert start % bs == 0, "the write start must be block-aligned"
        n, g = vals.shape[0], vals.shape[2]
        sb0 = start // bs
        npb = -(-prompt_len // bs)
        nw = npb - sb0                              # blocks being written
        sflat = cache[key + "_scale"].view(n, -1, g)   # (L, B * nb, G)
        if nw > 0:
            v = F.pad(vals.float(), (0, 0, 0, 0, 0, npb * bs - prompt_len))
            v = v.reshape(n, nw, bs, g, -1)
            sc = v.abs().amax(dim=(2, 4)) / 127.0               # (L, nw, G)
            safe = torch.where(sc > 0, sc, 1.0)
            codes = torch.round(v / safe[:, :, None, :, None]).clamp(-127,
                                                                    127)
            codes = codes.reshape(n, nw * bs, g, -1)[:, :prompt_len - start]
            sflat[:, scale_map[sb0:npb]] = sc
        else:
            codes = vals
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


def _encdec_frames(model, rows: int) -> dict:
    """Stub encoder frames, zeros (rows, T_enc, d) in the model's dtype
    (``Model.stub_frames``: the conv/mel frontend is a stub)."""
    return {"frames": model.stub_frames(rows)}


ADAPTERS: dict[str, FamilyCacheAdapter] = {
    "dense": FamilyCacheAdapter("dense", shareable_prefix=True),
    "moe": FamilyCacheAdapter("moe"),
    "ssm": FamilyCacheAdapter("ssm", length_keys=(), prefill_buckets=False),
    "hybrid": FamilyCacheAdapter("hybrid"),
    "encdec": FamilyCacheAdapter("encdec", extras=_encdec_frames),
}


def get_adapter(family: str) -> FamilyCacheAdapter:
    """The registered adapter for a model family; raises
    ``NotImplementedError`` for families the port does not serve yet."""
    try:
        return ADAPTERS[family]
    except KeyError:
        raise NotImplementedError(
            f"no CacheAdapter for family {family!r}; the port serves "
            f"{tuple(sorted(ADAPTERS))}, and vlm comes with ROADMAP "
            f"queue 1 item 9c") from None
