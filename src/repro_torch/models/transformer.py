"""Decoder-only transformer (dense and moe): prefill, chunked prefill,
decode.

A plain Python loop over layers (the JAX package scans them); the layer
params are views into the stacked tensors.  A moe layer routes every
token of the call as one group (``models.moe``), so a prompt's padded
positions take expert capacity as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.attention import (attention_block, attention_decode,
                                          chunk_cache_write, out_proj,
                                          project_qkv, decode_write_index)
from repro_torch.models.layers import (embed, mlp, rmsnorm, rope_tables,
                                       unembed)
from repro_torch.models.moe import moe_mlp

__all__ = ["layer_params", "forward", "init_cache", "chunk_prefill_step",
           "decode_step"]


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s params: views into the stacked ``blocks`` tensors."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return pick(params["blocks"])


def _mlp_or_moe(lp: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The layer's feed-forward: the moe layer (its aux loss unused in
    serving) or the dense MLP."""
    if cfg.family == "moe":
        return moe_mlp(lp["moe"], h, cfg)[0]
    return mlp(lp["mlp"], h, cfg.mlp_act)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            prefill_tiles: tuple):
    """Whole-prompt prefill at the mapper's ``prefill_tiles``.  Returns
    (logits (B, S, V) float32, (k, v) caches each (L, B, S, G, hd))."""
    x = embed(params["embed"], tokens)
    s = tokens.shape[1]
    cos, sin = rope_tables(torch.arange(s, device=tokens.device),
                           cfg.head_dim, cfg.rope_theta)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, (k, v) = attention_block(lp["attn"], h, cfg, cos=cos, sin=sin,
                                    prefill_tiles=prefill_tiles)
        x = x + a
        x = x + _mlp_or_moe(lp, rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg)
        ks.append(k)
        vs.append(v)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return unembed(params["embed"], x), (torch.stack(ks), torch.stack(vs))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype, device) -> dict:
    """Zeroed (L, B, T, G, hd) K/V caches; ``pos`` 0 (a Python int for a
    row cache — the engine's pool replaces it by a per-row tensor)."""
    shape = (cfg.num_layers, batch, max_len, max(cfg.num_kv_heads, 1),
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}


def chunk_prefill_step(params: dict, cache: dict, tokens: torch.Tensor,
                       cfg: ModelConfig, *,
                       prefill_tiles: tuple):
    """Advance a prefill row cache by one (B, C) prompt chunk, attention
    at the mapper's ``prefill_tiles``.

    The chunk's queries attend over the whole row cache with
    ``q_offset = cache["pos"]`` (a runtime kernel argument); the chunk's
    K/V land at ``pos .. pos+C-1`` first (in place; overhang dropped).
    Tail chunks may carry right-padding: padded queries compute rows the
    caller discards, and their K/V sit at positions no valid query can
    see.  Returns (logits (B, C, V), the cache with ``pos`` advanced)."""
    c = tokens.shape[1]
    start = int(cache["pos"])
    x = embed(params["embed"], tokens)
    cos, sin = rope_tables(start + torch.arange(c, device=tokens.device),
                           cfg.head_dim, cfg.rope_theta)
    bq, bk = prefill_tiles
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        k_c, v_c = cache["k"][i], cache["v"][i]
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = project_qkv(lp["attn"], h, cfg, cos, sin)
        chunk_cache_write(k_c, k, start)
        chunk_cache_write(v_c, v, start)
        o = flash_attention(q, k_c, v_c, block_q=bq, block_k=bk,
                            q_offset=start)
        x = x + out_proj(lp["attn"], o, cfg)
        x = x + _mlp_or_moe(lp, rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return unembed(params["embed"], x), dict(cache, pos=start + c)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ModelConfig, *, decode_block=None, decode_split=None,
                page_tables=None, page_block=None, paged_decode_block=None,
                paged_decode_split=None):
    """One greedy decode step over the pool: ``cache["pos"]`` is a (B,)
    tensor of per-row positions (ragged rows).  Writes each row's new K/V
    in place and returns (logits (B, 1, V), the cache with ``pos``
    advanced by one).

    ``page_tables`` (B, nb) + ``page_block`` make the pool paged (writes
    through the block tables); ``paged_decode_block`` then fuses the read
    into the paged sweep, and without it the read gathers the logical
    view first.  ``decode_block`` is the contiguous sweep's ``block_s``
    (the contiguous pool and the gathered view); ``None`` plans it
    (``plan_cache_block``, AUTO) for the cache's length.
    ``decode_split``/``paged_decode_split`` are the two sweeps' split
    widths (``None``: AUTO, planned in ``attention_decode``).  A cache with
    ``k_scale``/``v_scale`` is the int8 paged pool.  The branches are
    ``attention.attention_decode``'s."""
    pos = cache["pos"]
    x = embed(params["embed"], tokens)
    cos, sin = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    index = decode_write_index(pos, cache["k"].shape[2], page_tables,
                               page_block)
    quant = "k_scale" in cache
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        x = x + attention_decode(
            lp["attn"], h, cfg, cache["k"][i], cache["v"][i], pos,
            cos=cos, sin=sin, write_index=index, decode_block=decode_block,
            decode_split=decode_split, page_tables=page_tables,
            page_block=page_block, paged_decode_block=paged_decode_block,
            paged_decode_split=paged_decode_split,
            k_scale=cache["k_scale"][i] if quant else None,
            v_scale=cache["v_scale"][i] if quant else None)
        x = x + _mlp_or_moe(lp, rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return unembed(params["embed"], x), dict(cache, pos=pos + 1)
