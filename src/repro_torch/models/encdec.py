"""whisper — the encoder-decoder family (arXiv:2212.04356).

A copy of the JAX package's ``models/encdec.py`` on PyTorch.  The
conv/mel frontend is a stub: the encoder takes precomputed frame
embeddings (B, T_enc, d) (the serving adapter's zeros), to which a
sinusoid of the positions is added; the decoder's self-attention uses
RoPE (the reference's adaptation of whisper's learned positions).

Prefill (``encdec_forward``) encodes the frames — pre-norm blocks whose
self-attention is flash with ``causal=False`` and no RoPE — then runs
each decoder layer: the causal self-attention through
``attention.attention_block`` at the router's prefill tiles, the
cross-attention's K/V projected from the encoder states and read by
flash with ``causal=False`` (``attention.cross_attention``), the GELU
MLP.  The encoder's and the cross-attention's tiles are
``core.mapper.plan_encdec_tiles``'s.  Decode
(``encdec_decode``) runs ``attention.attention_decode`` over the self
K/V pool (the dense family's read paths, on the same switches) and
``attention.cross_attention_decode`` over the static per-row
``ck``/``cv``: the contiguous decode sweep at every row's full encoder
length, its ``block_s`` and split planned once a step under AUTO.  The
self K/V pool is updated IN PLACE; ``ck``/``cv`` are read only.

A plain Python loop over the stacked layers (the reference scans them);
a layer's params are views into the stacked tensors.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hw import GpuParams, detect
from repro_torch.core.mapper import (plan_cache_block, plan_decode_split,
                                     plan_encdec_tiles)
from repro_torch.models.attention import (attention_block, attention_decode,
                                          cross_attention,
                                          cross_attention_decode, cross_kv,
                                          decode_write_index)
from repro_torch.models.layers import (embed, mlp, rmsnorm, rope_tables,
                                       unembed)

__all__ = ["encode", "encdec_forward", "encdec_init_cache", "encdec_decode",
           "cross_decode_plan"]


def _sinusoid(t: int, d: int, device) -> torch.Tensor:
    """(t, d) float32 positions: ``[sin, cos]`` concatenated (not
    interleaved) of ``pos / 10000^(2i / d)``, the reference's."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _layer(stack: dict, i: int) -> dict:
    """Layer ``i``'s params: views into a stacked tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stack.items()}


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig, *,
           tiles: tuple) -> torch.Tensor:
    """frames (B, T_enc, d) stub embeddings -> the encoder states
    (B, T_enc, d): the sinusoid (cast to the frames' dtype) added, then
    ``encoder_layers`` pre-norm blocks of non-causal self-attention at
    the flash ``tiles`` (no RoPE) and the MLP, then the final norm."""
    x = frames + _sinusoid(frames.shape[1], cfg.d_model,
                           frames.device).to(frames.dtype)
    for i in range(cfg.encoder_layers):
        lp = _layer(params["enc_blocks"], i)
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, _ = attention_block(lp["attn"], h, cfg, prefill_tiles=tiles,
                               causal=False)
        x = x + a
        x = x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps),
                    cfg.mlp_act)
    return rmsnorm(x, params["enc_ln_f"], cfg.norm_eps)


def encdec_forward(params: dict, tokens: torch.Tensor, frames: torch.Tensor,
                   cfg: ModelConfig, *, prefill_tiles: tuple):
    """Whole-prompt prefill of ``tokens`` (B, S) given the encoder
    ``frames`` (B, T_enc, d): the decoder's self-attention at the
    router's ``prefill_tiles``, the encoder's and the cross-attention's
    at ``plan_encdec_tiles``'s for the tokens' device.  Returns (logits
    (B, S, V) float32, (k, v) of the self-attention, each
    (L, B, S, G, hd), (ck, cv) of the cross-attention, each
    (L, B, T_enc, G, hd))."""
    s = tokens.shape[1]
    enc_tiles, cross_tiles = plan_encdec_tiles(
        s, frames.shape[1], cfg.head_dim, detect(tokens.device))
    enc = encode(params, frames, cfg, tiles=enc_tiles)
    x = embed(params["embed"], tokens)
    cos, sin = rope_tables(torch.arange(s, device=tokens.device),
                           cfg.head_dim, cfg.rope_theta)
    ks, vs, cks, cvs = [], [], [], []
    for i in range(cfg.num_layers):
        lp = _layer(params["dec_blocks"], i)
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, (k, v) = attention_block(lp["attn"], h, cfg, cos=cos, sin=sin,
                                    prefill_tiles=prefill_tiles)
        x = x + a
        ck, cv = cross_kv(lp["cross"], enc)
        h = rmsnorm(x, lp["ln_x"], cfg.norm_eps)
        x = x + cross_attention(lp["cross"], h, ck, cv, cfg,
                                tiles=cross_tiles)
        x = x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps),
                    cfg.mlp_act)
        ks.append(k)
        vs.append(v)
        cks.append(ck)
        cvs.append(cv)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return (unembed(params["embed"], x), (torch.stack(ks), torch.stack(vs)),
            (torch.stack(cks), torch.stack(cvs)))


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype, device,
                      cache_dtype: Optional[torch.dtype] = None) -> dict:
    """Zeroed caches: the self-attention's k/v (L, B, T, G, hd) in
    ``cache_dtype`` (default ``dtype``; the int8 pool passes
    ``torch.int8``) and the cross-attention's ck/cv (L, B, T_enc, G, hd)
    in ``dtype`` always (int8 quantises only the growing self-attention
    K/V, as the reference); ``pos`` 0 (the pool replaces it by a per-row
    vector)."""
    g, l = max(cfg.num_kv_heads, 1), cfg.num_layers
    kv = (l, batch, max_len, g, cfg.head_dim)
    cross = (l, batch, cfg.encoder_tokens, g, cfg.head_dim)
    kv_dt = cache_dtype or dtype
    return {"k": torch.zeros(kv, dtype=kv_dt, device=device),
            "v": torch.zeros(kv, dtype=kv_dt, device=device),
            "ck": torch.zeros(cross, dtype=dtype, device=device),
            "cv": torch.zeros(cross, dtype=dtype, device=device),
            "pos": 0}


@functools.lru_cache(maxsize=None)
def cross_decode_plan(t: int, rows: int, head_dim: int, heads_per_group: int,
                      hw: GpuParams) -> tuple[int, int]:
    """The cross read's (block_s, split) over a static cache of ``t``
    encoder positions, ``rows`` = B x G: AUTO's ``plan_cache_block`` and
    ``plan_decode_split``, as ``attention_decode`` plans a read given no
    plan (the router's decode plans are keyed on the self-attention
    pool's length, which the cross cache does not share)."""
    bs = plan_cache_block(t, head_dim, hw, heads_per_group=heads_per_group)
    return bs, plan_decode_split(t, rows, bs, head_dim, hw,
                                 heads_per_group=heads_per_group)


def encdec_decode(params: dict, cache: dict, tokens: torch.Tensor,
                  cfg: ModelConfig, *, decode_block=None, decode_split=None,
                  page_tables=None, page_block=None, paged_decode_block=None,
                  paged_decode_split=None):
    """One decoder step over every row: ``cache["pos"]`` is a (B,) tensor
    of per-row positions.  The self-attention reads the pool through
    ``attention.attention_decode`` (the block and page arguments are the
    dense decode step's: fused paged, gather-then-sweep, contiguous,
    int8); the cross-attention reads each row's static ck/cv through the
    contiguous sweep (``cross_decode_plan``), never paged.  Updates the
    self K/V in place and returns (logits (B, 1, V), the cache with
    ``pos`` advanced by one)."""
    pos = cache["pos"]
    x = embed(params["embed"], tokens)
    cos, sin = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    index = decode_write_index(pos, cache["k"].shape[2], page_tables,
                               page_block)
    quant = "k_scale" in cache
    b, t = cache["ck"].shape[1:3]
    g, r = max(cfg.num_kv_heads, 1), cfg.heads_per_group
    bs, w = cross_decode_plan(t, b * g, cfg.head_dim, r, detect(x.device))
    clen = torch.full((b,), t, dtype=torch.int32, device=x.device)
    for i in range(cfg.num_layers):
        lp = _layer(params["dec_blocks"], i)
        h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        x = x + attention_decode(
            lp["attn"], h, cfg, cache["k"][i], cache["v"][i], pos,
            cos=cos, sin=sin, write_index=index, decode_block=decode_block,
            decode_split=decode_split, page_tables=page_tables,
            page_block=page_block, paged_decode_block=paged_decode_block,
            paged_decode_split=paged_decode_split,
            k_scale=cache["k_scale"][i] if quant else None,
            v_scale=cache["v_scale"][i] if quant else None)
        h = rmsnorm(x, lp["ln_x"], cfg.norm_eps)
        x = x + cross_attention_decode(lp["cross"], h, cache["ck"][i],
                                       cache["cv"][i], cfg, cache_len=clen,
                                       block_s=bs, split=w)
        x = x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps),
                    cfg.mlp_act)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return unembed(params["embed"], x), dict(cache, pos=pos + 1)
