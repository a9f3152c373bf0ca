"""Mamba-2 block and the attention-free LM stack (mamba2-1.3b).

A copy of the JAX package's ``models/ssm.py`` on PyTorch.  Prefill uses
the chunked SSD form, quadratic within a chunk and linear across chunks,
at the chunk ``plan_ssd_chunk`` resolves (the ``lws`` over time steps);
decode is the O(1) recurrent update of the carried (H, N, P) state.

Layout: in_proj fans out to [z | x | B | C | dt]; a depthwise causal conv
runs over [x | B | C]; the per-head decay is a = -exp(A_log) dt; the skip
D x is added in float32; a gated RMSNorm comes before out_proj.

The prefill calls the plain ``kernels.ssd.ssd_chunked(...,
return_state=True)``, as the JAX model calls ``ref.ssd_chunked``: the
decode needs the final state, which the TPU kernel (and so its CUDA
counterpart behind ``kernels.ops.ssd``) does not output.  The rest of
the path is jnp in the reference, so torch ops here too.  Decode updates
the cache's state and conv window IN PLACE.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hw import GpuParams
from repro_torch.core.mapper import MappingPolicy, resolve_lws
from repro_torch.kernels.ssd import ssd_chunked
from repro_torch.models.layers import embed, rmsnorm, unembed

__all__ = ["plan_ssd_chunk", "ssm_block",
           "ssm_cache_shape", "ssm_decode_step", "ssm_forward",
           "ssm_init_cache", "ssm_decode"]


def plan_ssd_chunk(seq: int, hw: Optional[GpuParams] = None,
                   policy: MappingPolicy | str = MappingPolicy.AUTO) -> int:
    """Chunk length = ``lws`` over time steps, a power of two in [64, 512]
    (halved while it does not divide ``seq``, down to 64).  NAIVE plans
    64 and FIXED 256.  AUTO resolves Eq. 1 against ``cores x 64
    pipeline slots``, which on a GPU is SMs x resident warps per SM (the
    rmsnorm row planner's ``hp``: 8,448 on an H100); ``hw=None`` counts
    one core (64), as the JAX model calls it."""
    policy = MappingPolicy(policy)
    if policy is MappingPolicy.NAIVE:
        return 64
    if policy is MappingPolicy.FIXED:
        return 256
    hp = hw.sm_count * hw.warps_per_sm if hw else 64
    lws = resolve_lws(seq, hp)
    c = max(64, min(512, 1 << max(6, lws.bit_length())))
    while seq % c and c > 64:
        c //= 2
    return c


def _split(proj, cfg: ModelConfig):
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    return (proj[..., :di], proj[..., di:2 * di + 2 * g * n],
            proj[..., 2 * di + 2 * g * n:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time: xbc (B, S, C), w (K, C)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s] * w[i] for i in range(k))
    return F.silu(out + b)


def _gate_norm(y, z, params, x_dtype, eps):
    """``rmsnorm(y * silu(z in f32) cast to the model dtype)`` — the gate
    is cast BEFORE the norm, as the reference does."""
    return rmsnorm(y * F.silu(z.float()).to(x_dtype), params["out_norm"], eps)


def ssm_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
              chunk: Optional[int] = None, return_cache: bool = False):
    """x (B, S, d) -> (B, S, d), the prefill path.  With ``return_cache``
    also returns (final ssm state (B, H, N, P) f32, conv tail (B, K-1,
    C)) to seed the decode recurrence."""
    b, s, _ = x.shape
    di, g, n, hh, p = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                       cfg.ssm_heads, cfg.ssm_head_dim)
    proj = x @ params["in_proj"]
    z, xbc_raw, dt_raw = _split(proj, cfg)
    xbc = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    xs = xbc[..., :di].reshape(b, s, hh, p)
    bs_ = xbc[..., di:di + g * n].reshape(b, s, g, n)
    cs = xbc[..., di + g * n:].reshape(b, s, g, n)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())   # (B,S,H)
    a = -torch.exp(params["a_log"].float()) * dt                   # decay
    x_eff = xs.float() * dt[..., None]
    # no hw: one core (the JAX model's call), then min and halving
    chunk = chunk or plan_ssd_chunk(s)
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    outs = [ssd_chunked(x_eff[i], a[i], bs_[i].float(), cs[i].float(),
                        chunk=chunk, return_state=True) for i in range(b)]
    y = torch.stack([o[0] for o in outs])
    state = torch.stack([o[1] for o in outs])
    y = y + params["d_skip"].float()[None, None, :, None] * xs.float()
    y = y.reshape(b, s, di).to(x.dtype)
    out = _gate_norm(y, z, params, x.dtype, cfg.norm_eps) @ params["out_proj"]
    if return_cache:
        # the decode conv window is the last K-1 inputs; prompts shorter
        # than that see pre-sequence zeros, matching _causal_conv's pad
        tail = cfg.ssm_conv - 1
        conv_tail = F.pad(xbc_raw, (0, 0, max(tail - s, 0), 0))[:, -tail:]
        return out, (state, conv_tail.to(x.dtype))
    return out


def ssm_cache_shape(cfg: ModelConfig, batch: int) -> dict:
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {"state": (batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
            "conv": (batch, cfg.ssm_conv - 1, conv_ch)}


def ssm_decode_step(params: dict, x: torch.Tensor, state: torch.Tensor,
                    conv_state: torch.Tensor, cfg: ModelConfig):
    """x (B, 1, d); state (B, H, N, P) f32; conv_state (B, K-1, C).
    Returns (out (B, 1, d), new state, new conv window)."""
    b = x.shape[0]
    di, g, n, hh, p = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                       cfg.ssm_heads, cfg.ssm_head_dim)
    proj = x @ params["in_proj"]
    z, xbc, dt_raw = _split(proj, cfg)
    window = torch.cat([conv_state, xbc], dim=1)               # (B, K, C)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, params["conv_w"])
                      + params["conv_b"])
    new_conv = window[:, 1:]
    xs = conv_out[..., :di].reshape(b, hh, p)
    rep = hh // g
    bh = conv_out[..., di:di + g * n].reshape(b, g, n) \
        .repeat_interleave(rep, dim=1)                          # (B, H, N)
    ch = conv_out[..., di + g * n:].reshape(b, g, n) \
        .repeat_interleave(rep, dim=1)
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"].float())
    # decode takes the multiplier exp(-exp(A_log) dt); prefill the log
    a = torch.exp(-torch.exp(params["a_log"].float()) * dt)      # (B, H)
    x_eff = xs.float() * dt[..., None]
    state = state * a[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", bh.float(), x_eff)
    y = torch.einsum("bhn,bhnp->bhp", ch.float(), state)
    y = y + params["d_skip"].float()[None, :, None] * xs.float()
    y = y.reshape(b, di).to(x.dtype)
    out = _gate_norm(y, z[:, 0], params, x.dtype, cfg.norm_eps) \
        @ params["out_proj"]
    return out[:, None, :], state, new_conv


def _layer(params: dict, i: int) -> dict:
    return {"ln": params["blocks"]["ln"][i],
            "ssm": {k: v[i] for k, v in params["blocks"]["ssm"].items()}}


def ssm_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                return_cache: bool = False, chunk: Optional[int] = None):
    """Whole-prompt prefill.  Returns logits (B, S, V) float32 and, with
    ``return_cache``, the stacked (states (L, B, H, N, P), conv tails
    (L, B, K-1, C))."""
    x = embed(params["embed"], tokens)
    states, convs = [], []
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = rmsnorm(x, lp["ln"], cfg.norm_eps)
        if return_cache:
            y, (st, cv) = ssm_block(lp["ssm"], h, cfg, chunk=chunk,
                                    return_cache=True)
            states.append(st)
            convs.append(cv)
        else:
            y = ssm_block(lp["ssm"], h, cfg, chunk=chunk)
        x = x + y
    logits = unembed(params["embed"], rmsnorm(x, params["ln_f"],
                                              cfg.norm_eps))
    if return_cache:
        return logits, (torch.stack(states), torch.stack(convs))
    return logits


def ssm_init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device) -> dict:
    """Zeroed state (f32 whatever the model dtype) and conv window (the
    model dtype); ``pos`` 0 (the pool replaces it by a per-row vector)."""
    shapes = ssm_cache_shape(cfg, batch)
    return {"state": torch.zeros((cfg.num_layers,) + shapes["state"],
                                 dtype=torch.float32, device=device),
            "conv": torch.zeros((cfg.num_layers,) + shapes["conv"],
                                dtype=dtype, device=device),
            "pos": 0}


def ssm_decode(params: dict, cache: dict, tokens: torch.Tensor,
               cfg: ModelConfig) -> tuple:
    """One recurrent decode step over every row.  The update is
    position-free, so a vector ``pos`` (the pool's ragged rows) only
    advances per row.  The state and conv window are updated in place;
    returns (logits (B, 1, V), the cache with ``pos`` advanced)."""
    x = embed(params["embed"], tokens)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        h = rmsnorm(x, lp["ln"], cfg.norm_eps)
        y, st, cv = ssm_decode_step(lp["ssm"], h, cache["state"][i],
                                    cache["conv"][i], cfg)
        cache["state"][i] = st
        cache["conv"][i] = cv
        x = x + y
    logits = unembed(params["embed"], rmsnorm(x, params["ln_f"],
                                              cfg.norm_eps))
    return logits, dict(cache, pos=cache["pos"] + 1)
