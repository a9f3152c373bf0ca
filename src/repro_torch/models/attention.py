"""Grouped-query attention, dense subset: prefill and paged decode.

GQA stays grouped — q (B, S, G, R, D) against k/v (B, T, G, D) — so the
KV heads are never repeated.  Prefill runs the flash kernel at the
router's tiles (``kernels.flash_attention``); decode writes the new
token's K/V through the block tables and runs the fused paged kernel
(``kernels.paged_decode_attention``).

The KV pool is updated IN PLACE (``index_put_`` on flat views, slice
assignment on row caches) where the JAX package rebuilds it
functionally; every such write says so.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.kernels.paged_gather import flat_position
from repro_torch.models.layers import apply_rope

__all__ = ["project_qkv", "attention_block", "paged_write_index",
           "cache_write", "chunk_cache_write", "attention_decode", "out_proj"]


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


def cache_write(cache: torch.Tensor, new: torch.Tensor, index) -> None:
    """Scatter one decode token's (B, G, D) K or V rows into the paged
    (B, T, G, D) cache at ``index = paged_write_index(...)``, IN PLACE."""
    rows, flat = index
    b, t = cache.shape[:2]
    cache.view(b * t, *cache.shape[2:]).index_put_(
        (flat,), new[rows].to(cache.dtype))


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
                     page_tables: torch.Tensor, page_block: int,
                     paged_decode_block: int) -> torch.Tensor:
    """One-token decode over the paged pool: write the new K/V (in
    place), then the fused paged kernel reads the pages through the
    tables.  ``pos`` (B,) is each row's position; returns (B, 1, D)."""
    q, k, v = project_qkv(params, x, cfg, cos, sin)
    cache_write(k_cache, k[:, 0], write_index)
    cache_write(v_cache, v[:, 0], write_index)
    clen = (pos + 1).to(torch.int32)
    o = paged_decode_attention(q[:, 0], k_cache, v_cache, page_tables, clen,
                               page_block=int(page_block),
                               block_s=int(paged_decode_block))
    return out_proj(params, o[:, None], cfg)
