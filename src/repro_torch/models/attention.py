"""Grouped-query attention, dense subset: prefill and every decode path.

GQA stays grouped — q (B, S, G, R, D) against k/v (B, T, G, D) — so the
KV heads are never repeated.  Prefill runs the flash kernel at the
router's tiles (``kernels.flash_attention``).  Decode writes the new
token's K/V into the pool (torch ops) and reads it through one of the
decode kernels, chosen as the JAX package's ``attention_decode`` chooses:

  pool, read                 kernels
  paged, fused               paged_decode_attention (walks the tables)
  paged, not fused           paged_gather, then decode_attention
  contiguous rows            decode_attention
  int8 paged, fused          paged_decode_attention with the scales
  int8 paged, not fused      paged_dequant_gather, then decode_attention

With no plan (``decode_block`` None on a non-fused read) the contiguous
sweep's ``block_s`` is planned here (``plan_cache_block`` under AUTO for
the tensors' device), and a sweep given no split width gets AUTO's
(``plan_decode_split``), so every read goes through a kernel wrapper.

The KV pool is updated IN PLACE (``index_put_`` on flat views, slice
assignment on row caches) where the JAX package rebuilds it
functionally; every such write says so.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hw import detect
from repro_torch.core.mapper import plan_cache_block, plan_decode_split
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.kernels.paged_gather import (flat_position,
                                              paged_dequant_gather,
                                              paged_gather)
from repro_torch.models.layers import apply_rope

__all__ = ["project_qkv", "attention_block", "paged_write_index",
           "row_write_index", "cache_write", "paged_quant_write",
           "chunk_cache_write", "attention_decode", "out_proj"]


def project_qkv(params: dict, x: torch.Tensor, cfg: ModelConfig, cos, sin):
    """Project into the grouped layout: q (B, S, G, R, D), k/v
    (B, S, G, D), rope applied, all contiguous."""
    b, s, _ = x.shape
    g = max(cfg.num_kv_heads, 1)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dgk->bsgk", x, params["wk"])
    v = torch.einsum("bsd,dgk->bsgk", x, params["wv"])
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = q.reshape(b, s, g, cfg.heads_per_group, cfg.head_dim)
    return q.contiguous(), k.contiguous(), v.contiguous()


def out_proj(params: dict, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, S, G, R, D) attention output -> (B, S, d_model)."""
    b, s = o.shape[:2]
    return torch.einsum("bshk,hkd->bsd", o.reshape(b, s, -1, cfg.head_dim),
                        params["wo"])


def attention_block(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    cos, sin, prefill_tiles: tuple):
    """Whole-prompt causal attention at the mapper's ``prefill_tiles``
    (block_q, block_k); returns (out (B, S, D), (k, v))."""
    q, k, v = project_qkv(params, x, cfg, cos, sin)
    bq, bk = prefill_tiles
    o = flash_attention(q, k, v, block_q=bq, block_k=bk, q_offset=0)
    return out_proj(params, o, cfg), (k, v)


def paged_write_index(pos: torch.Tensor, page_tables: torch.Tensor,
                      page_block: int, kv_len: int):
    """Where each pool row's new token lands: (rows, flat) — the rows
    whose write is valid and their flat (slots * kv_len) positions.  A
    row whose table entry is unmapped (-1: retired, or still in chunked
    prefill) or whose position overruns the table or the row writes
    NOTHING — the JAX package gets this from an out-of-range scatter
    with ``mode="drop"``; here those rows are filtered out (one host
    sync per decode step; the index is shared by every layer)."""
    b = pos.shape[0]
    bs = int(page_block)
    nb = page_tables.shape[1]
    pos = pos.long()
    bi = (pos // bs).clamp(0, nb - 1)
    pid = page_tables[torch.arange(b, device=pos.device), bi].long()
    valid = (pid >= 0) & (pos // bs < nb) & (pos < kv_len)
    rows = valid.nonzero().flatten()
    flat = flat_position(pid[rows], pos[rows], b, kv_len, bs)
    return rows, flat


def row_write_index(pos: torch.Tensor, kv_len: int):
    """The contiguous pool's write index: (rows, flat) for the rows whose
    position lies inside the row (``pos < kv_len``) at flat position
    ``row * kv_len + pos``.  Rows at or past the end write NOTHING (the
    JAX package's one-hot write never fires for them), so a retired
    slot whose position keeps advancing is inert; they are dropped, not
    clamped."""
    pos = pos.long()
    rows = (pos < kv_len).nonzero().flatten()
    return rows, rows * kv_len + pos[rows]


def cache_write(cache: torch.Tensor, new: torch.Tensor, index) -> None:
    """Scatter one decode token's (B, G, D) K or V rows into the
    (B, T, G, D) cache at ``index`` (``paged_write_index`` or
    ``row_write_index``), IN PLACE."""
    rows, flat = index
    b, t = cache.shape[:2]
    cache.view(b * t, *cache.shape[2:]).index_put_(
        (flat,), new[rows].to(cache.dtype))


def paged_quant_write(cache: torch.Tensor, scale: torch.Tensor,
                      new: torch.Tensor, index, page_block: int) -> None:
    """Write one decode token's (B, G, D) K or V rows into the int8 paged
    pool at ``index = paged_write_index(...)``, maintaining the
    per-(physical block, KV group) symmetric scales, IN PLACE — the JAX
    package's ``_paged_quant_write``.

    A block's scale only grows: ``new = max(old, amax|token| / 127)``,
    and when it grows the block's codes are requantised by ``old / new``.
    A scale of 0 is the dead sentinel (a fresh or recycled block): the
    ratio is then 0, which wipes the previous tenant's codes.  The whole
    block is read before anything is written, and rows the index drops
    (retired, unmapped, overrun) write neither codes nor scale."""
    rows, flat = index
    b, t = cache.shape[:2]
    g, d = cache.shape[2:]
    bs = int(page_block)
    n = rows.numel()
    if n == 0:
        return
    blk = flat // bs                 # flat physical block = its scale row
    sflat = scale.view(b * (t // bs), g)
    old = sflat[blk]                                             # (n, G)
    tok = new[rows].float()                                      # (n, G, D)
    amax = tok.abs().amax(-1)
    new_scale = torch.maximum(old, amax / 127.0)
    safe = torch.where(new_scale > 0, new_scale, 1.0)
    ratio = torch.where(new_scale > 0, old / safe, 0.0)          # 0 wipes
    idx = (blk * bs)[:, None] + torch.arange(bs, device=flat.device)
    cflat = cache.view(b * t, g, d)
    codes = cflat[idx.reshape(-1)].reshape(n, bs, g, d)
    codes = torch.round(codes.float() * ratio[:, None, :, None])
    hot = (torch.arange(bs, device=flat.device)[None, :]
           == (flat % bs)[:, None])                              # (n, bs)
    codes = torch.where(hot[..., None, None],
                        torch.round(tok / safe[..., None])[:, None], codes)
    codes = codes.clamp(-127, 127).to(cache.dtype)
    cflat.index_put_((idx.reshape(-1),), codes.reshape(n * bs, g, d))
    sflat.index_put_((blk,), new_scale)


def chunk_cache_write(cache: torch.Tensor, new: torch.Tensor,
                      start: int) -> None:
    """Write one C-row prompt chunk at positions ``start..start+C-1`` of a
    (B, T, G, D) row cache, IN PLACE.  Rows overhanging the cache carry
    only the tail chunk's padding and are dropped (the JAX package's
    ``mode="drop"`` scatter)."""
    n = max(0, min(new.shape[1], cache.shape[1] - start))
    cache[:, start:start + n] = new[:, :n].to(cache.dtype)


def attention_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor, *, cos, sin, write_index,
                     decode_block: Optional[int] = None,
                     decode_split: Optional[int] = None,
                     page_tables: Optional[torch.Tensor] = None,
                     page_block: Optional[int] = None,
                     paged_decode_block: Optional[int] = None,
                     paged_decode_split: Optional[int] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token decode: write the new K/V into the pool (in place), then
    read it through the path the arguments select (module docstring).
    ``pos`` (B,) is each row's position; ``write_index`` is the step's
    ``paged_write_index`` (with ``page_tables``) or ``row_write_index``.
    ``k_scale``/``v_scale`` mark the int8 paged pool.  The splits are
    the router's split widths of the two sweeps, passed to the kernels
    as planned; ``None`` plans AUTO here (``plan_decode_split``), as a
    ``None`` ``decode_block`` plans the block.  Returns (B, 1,
    d_model)."""
    q, k, v = project_qkv(params, x, cfg, cos, sin)
    q = q[:, 0]
    if k_scale is not None:
        if page_tables is None:
            raise ValueError("kv scales require the paged pool")
        paged_quant_write(k_cache, k_scale, k[:, 0], write_index, page_block)
        paged_quant_write(v_cache, v_scale, v[:, 0], write_index, page_block)
    else:
        cache_write(k_cache, k[:, 0], write_index)
        cache_write(v_cache, v[:, 0], write_index)
    clen = (pos + 1).to(torch.int32)
    b, g, r, d = q.shape
    if page_tables is not None and paged_decode_block is not None:
        # fused: the sweep reads the pages through the tables
        if paged_decode_split is None:
            paged_decode_split = plan_decode_split(
                k_cache.shape[1], b * g, int(paged_decode_block), d,
                detect(q.device), heads_per_group=r,
                page_block=int(page_block))
        o = paged_decode_attention(q, k_cache, v_cache, page_tables, clen,
                                   page_block=int(page_block),
                                   block_s=int(paged_decode_block),
                                   split=paged_decode_split,
                                   k_scale=k_scale, v_scale=v_scale)
        return out_proj(params, o[:, None], cfg)
    kr, vr = k_cache, v_cache
    if k_scale is not None:
        kr = paged_dequant_gather(k_cache, k_scale, page_tables,
                                  int(page_block), out_dtype=x.dtype)
        vr = paged_dequant_gather(v_cache, v_scale, page_tables,
                                  int(page_block), out_dtype=x.dtype)
    elif page_tables is not None:
        kr = paged_gather(k_cache, page_tables, int(page_block))
        vr = paged_gather(v_cache, page_tables, int(page_block))
    if decode_block is None:
        decode_block = plan_cache_block(kr.shape[1], d, detect(q.device),
                                        heads_per_group=r)
        decode_split = None         # planned with its block, below
    if decode_split is None:
        decode_split = plan_decode_split(kr.shape[1], b * g,
                                         int(decode_block), d,
                                         detect(q.device), heads_per_group=r)
    o = decode_attention(q, kr, vr, clen, block_s=int(decode_block),
                         split=decode_split)
    return out_proj(params, o[:, None], cfg)
