"""zamba2 — a Mamba-2 backbone with one SHARED attention block applied
every ``hybrid_attn_every`` layers (arXiv:2411.15242).

A copy of the JAX package's ``models/hybrid.py`` on PyTorch.  The layers
are padded to ``n_groups x k`` and run as groups: each group is the
shared attention block (attention and MLP, with its own K/V cache slot)
followed by k Mamba-2 layers.  The shared block's params are one copy,
reused by every group.  A padded layer (index >= ``num_layers``) passes
``x`` through unchanged: the reference computes it and adds
``where(active, y, 0)``; here it is skipped, so its ssm state and conv
window stay at zero where the reference's scan advances them, unread.

Prefill runs the shared block through ``attention.attention_block``
(flash at the router's tiles) and each layer through ``ssm.ssm_block``;
decode runs ``attention.attention_decode`` (the dense family's read
paths, on the same switches) and ``ssm.ssm_decode_step``.  Decode
updates the K/V pool, the ssm states and the conv windows IN PLACE.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (attention_block, attention_decode,
                                          decode_write_index)
from repro_torch.models.layers import (embed, mlp, rmsnorm, rope_tables,
                                       unembed)
from repro_torch.models.ssm import (ssm_block, ssm_cache_shape,
                                    ssm_decode_step)
from repro_torch.models.transformer import layer_params

__all__ = ["n_groups", "padded_layers", "active_flags", "hybrid_forward",
           "hybrid_init_cache", "hybrid_decode"]


def n_groups(cfg: ModelConfig) -> int:
    """Shared-block applications: ceil(num_layers / hybrid_attn_every)."""
    return -(-cfg.num_layers // cfg.hybrid_attn_every)


def padded_layers(cfg: ModelConfig) -> int:
    """Mamba-2 layers the params and the cache stack: whole groups."""
    return n_groups(cfg) * cfg.hybrid_attn_every


def active_flags(cfg: ModelConfig) -> list[bool]:
    """Per padded layer: True for the model's own layers."""
    return [i < cfg.num_layers for i in range(padded_layers(cfg))]


def _group_layers(cfg: ModelConfig, grp: int) -> range:
    """The active layers of group ``grp`` (padded ones left out)."""
    k = cfg.hybrid_attn_every
    return range(grp * k, min((grp + 1) * k, cfg.num_layers))


def hybrid_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                   prefill_tiles: tuple, chunk: Optional[int] = None):
    """Whole-prompt prefill at the mapper's ``prefill_tiles``.  Returns
    (logits (B, S, V) float32, (k, v) of the shared block, each
    (n_groups, B, S, G, hd)); ``chunk`` is the SSD chunk (None: planned
    by ``ssm_block``)."""
    shared = params["shared"]
    x = embed(params["embed"], tokens)
    s = tokens.shape[1]
    cos, sin = rope_tables(torch.arange(s, device=tokens.device),
                           cfg.head_dim, cfg.rope_theta)
    ks, vs = [], []
    for grp in range(n_groups(cfg)):
        h = rmsnorm(x, shared["ln1"], cfg.norm_eps)
        a, (k, v) = attention_block(shared["attn"], h, cfg, cos=cos, sin=sin,
                                    prefill_tiles=prefill_tiles)
        x = x + a
        x = x + mlp(shared["mlp"], rmsnorm(x, shared["ln2"], cfg.norm_eps),
                    cfg.mlp_act)
        ks.append(k)
        vs.append(v)
        for i in _group_layers(cfg, grp):
            lp = layer_params(params, i)
            h = rmsnorm(x, lp["ln"], cfg.norm_eps)
            x = x + ssm_block(lp["ssm"], h, cfg, chunk=chunk)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return unembed(params["embed"], x), (torch.stack(ks), torch.stack(vs))


def hybrid_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype, device,
                      cache_dtype: Optional[torch.dtype] = None) -> dict:
    """Zeroed caches: the shared block's k/v (n_groups, B, T, G, hd) in
    ``cache_dtype`` (default ``dtype``; the int8 pool passes
    ``torch.int8``), the ssm state (padded_layers, B, H, N, P) in float32
    and the conv window (padded_layers, B, K-1, C) in ``dtype``; ``pos``
    0 (the pool replaces it by a per-row vector)."""
    ng, lp = n_groups(cfg), padded_layers(cfg)
    kv = (ng, batch, max_len, max(cfg.num_kv_heads, 1), cfg.head_dim)
    shapes = ssm_cache_shape(cfg, batch)
    kv_dt = cache_dtype or dtype
    return {"k": torch.zeros(kv, dtype=kv_dt, device=device),
            "v": torch.zeros(kv, dtype=kv_dt, device=device),
            "state": torch.zeros((lp,) + shapes["state"],
                                 dtype=torch.float32, device=device),
            "conv": torch.zeros((lp,) + shapes["conv"], dtype=dtype,
                                device=device),
            "pos": 0}


def hybrid_decode(params: dict, cache: dict, tokens: torch.Tensor,
                  cfg: ModelConfig, *, decode_block=None, decode_split=None,
                  page_tables=None, page_block=None, paged_decode_block=None,
                  paged_decode_split=None):
    """One decode step over every row: ``cache["pos"]`` is a (B,) tensor
    of per-row positions.  The shared block's attention in each group
    reads that group's K/V slot through ``attention.attention_decode``
    (the block and page arguments are the dense decode step's: fused
    paged, gather-then-sweep, contiguous, int8); the ssm states are
    position-free and never page.  Updates the caches in place and
    returns (logits (B, 1, V), the cache with ``pos`` advanced by
    one)."""
    shared = params["shared"]
    pos = cache["pos"]
    x = embed(params["embed"], tokens)
    cos, sin = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    index = decode_write_index(pos, cache["k"].shape[2], page_tables,
                               page_block)
    quant = "k_scale" in cache
    for grp in range(n_groups(cfg)):
        h = rmsnorm(x, shared["ln1"], cfg.norm_eps)
        x = x + attention_decode(
            shared["attn"], h, cfg, cache["k"][grp], cache["v"][grp], pos,
            cos=cos, sin=sin, write_index=index, decode_block=decode_block,
            decode_split=decode_split, page_tables=page_tables,
            page_block=page_block, paged_decode_block=paged_decode_block,
            paged_decode_split=paged_decode_split,
            k_scale=cache["k_scale"][grp] if quant else None,
            v_scale=cache["v_scale"][grp] if quant else None)
        x = x + mlp(shared["mlp"], rmsnorm(x, shared["ln2"], cfg.norm_eps),
                    cfg.mlp_act)
        for i in _group_layers(cfg, grp):
            lp = layer_params(params, i)
            h = rmsnorm(x, lp["ln"], cfg.norm_eps)
            y, st, cv = ssm_decode_step(lp["ssm"], h, cache["state"][i],
                                        cache["conv"][i], cfg)
            cache["state"][i] = st
            cache["conv"][i] = cv
            x = x + y
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return unembed(params["embed"], x), dict(cache, pos=pos + 1)
