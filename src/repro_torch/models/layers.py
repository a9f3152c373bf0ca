"""Parameter initialisation and the shared dense layers.

Params are nested dicts of tensors in the JAX package's layout (layers
stacked on a leading axis):

    embed.tok (V, D), and embed.unembed (D, V) when untied
    blocks.ln1 (L, D), blocks.ln2 (L, D)
    blocks.attn.{wq (L, D, H, hd), wk/wv (L, D, G, hd), wo (L, H, hd, D)},
        and q_norm / k_norm (L, hd) with ``qk_norm``
    blocks.mlp.{w_gate, w_up (L, D, F), w_down (L, F, D)} (swiglu) or
        {w_in (L, D, F), w_down (L, F, D)} (squared_relu); for the moe
        family blocks.moe.{router (L, D, E), w_gate, w_up (L, E, D, Fe),
        w_down (L, E, Fe, D)} and, with shared experts,
        blocks.moe.shared.{w_gate, w_up (L, D, S Fe), w_down (L, S Fe, D)}
    ln_f (D,)

and for the ssm family (Mamba-2) ``blocks.ln (L, D)`` and ``blocks.ssm``
(``in_proj``, ``conv_w``, ``conv_b``, ``a_log``, ``d_skip``, ``dt_bias``,
``out_norm``, ``out_proj``, each with a leading layer axis); for the
hybrid family (zamba2) the same ``blocks`` stacked over the padded
layers (``models.hybrid.padded_layers``) beside one unstacked
``shared.{ln1 (D,), attn, ln2 (D,), mlp}`` block (the attention and MLP
shapes above without the layer axis); for the encdec family (whisper)
``enc_blocks.{ln1, attn, ln2, mlp}`` stacked over ``encoder_layers``,
``enc_ln_f (D,)``, ``dec_blocks.{ln1, attn, ln2, mlp, ln_x, cross}``
stacked over ``num_layers`` (``cross`` an attention's projections) and
``ln_f``, beside the tied ``embed.tok``,

so ``weights.params_from_jax`` is a plain conversion and the tests hold
the port against the reference on the same weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe import moe_shapes

__all__ = ["param_shapes", "init_params", "rmsnorm", "embed", "unembed",
           "mlp", "rope_tables", "apply_rope"]


def param_shapes(cfg: ModelConfig) -> dict:
    """The param tree as {name: (shape, init, scale)}; ``init`` is
    "normal", "zeros" or "ones", ``scale`` None means min(0.02,
    fan_in^-0.5).  The keys are the JAX package's (``embed_specs``,
    ``attention_specs``, ``mlp_specs``, ``moe_specs``)."""
    served = (cfg.family in ("ssm", "hybrid", "encdec")
              and cfg.tie_embeddings) or (
        cfg.family == "dense" and cfg.mlp_act in ("swiglu", "squared_relu")
    ) or cfg.family == "moe"
    if not served:
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense family (swiglu or "
            f"squared_relu, tied or untied), the moe family and the tied "
            f"ssm, hybrid and encdec families; the geglu MLP, the window "
            f"and prefix-LM masks and vlm come with ROADMAP queue 1 items "
            f"9b and 9c")
    if cfg.family == "encdec":
        return _encdec_shapes(cfg)
    if cfg.family == "ssm":
        return _ssm_shapes(cfg, cfg.num_layers)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import padded_layers

        tree = _ssm_shapes(cfg, padded_layers(cfg))
        d = cfg.d_model
        shared = {"ln1": ((d,), "zeros", None), "attn": _attn_shapes(cfg),
                  "ln2": ((d,), "zeros", None), "mlp": _mlp_shapes(cfg)}
        # the reference's key order (the order init_params draws in)
        return {"embed": tree["embed"], "shared": shared,
                "blocks": tree["blocks"], "ln_f": tree["ln_f"]}
    d, n = cfg.d_model, cfg.num_layers
    emb = {"tok": ((cfg.vocab_size, d), "normal", 0.02)}
    if not cfg.tie_embeddings:
        emb["unembed"] = ((d, cfg.vocab_size), "normal", 0.02)
    blocks = {"ln1": ((n, d), "zeros", None),
              "attn": _stacked(_attn_shapes(cfg), n),
              "ln2": ((n, d), "zeros", None)}
    if cfg.family == "moe":
        blocks["moe"] = _stacked(moe_shapes(cfg), n)
    else:
        blocks["mlp"] = _stacked(_mlp_shapes(cfg), n)
    return {"embed": emb, "blocks": blocks, "ln_f": ((d,), "zeros", None)}


def _encdec_shapes(cfg: ModelConfig) -> dict:
    """The whisper tree (the JAX ``encdec_model_specs``): pre-norm
    encoder blocks, decoder blocks with a cross-attention block after
    the self-attention, norms at zeros, no qk-norm, a tied embedding."""
    d = cfg.d_model
    enc = {"ln1": ((d,), "zeros", None), "attn": _attn_shapes(cfg),
           "ln2": ((d,), "zeros", None), "mlp": _mlp_shapes(cfg)}
    dec = dict(enc, ln_x=((d,), "zeros", None), cross=_attn_shapes(cfg))
    return {"embed": {"tok": ((cfg.vocab_size, d), "normal", 0.02)},
            "enc_blocks": _stacked(enc, cfg.encoder_layers),
            "enc_ln_f": ((d,), "zeros", None),
            "dec_blocks": _stacked(dec, cfg.num_layers),
            "ln_f": ((d,), "zeros", None)}


def _attn_shapes(cfg: ModelConfig) -> dict:
    """One layer's attention projections (the JAX ``attention_specs``)."""
    d, h, g, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = {"wq": ((d, h, hd), "normal", None),
            "wk": ((d, g, hd), "normal", None),
            "wv": ((d, g, hd), "normal", None),
            "wo": ((h, hd, d), "normal", None)}
    if cfg.qk_norm:
        attn["q_norm"] = ((hd,), "zeros", None)
        attn["k_norm"] = ((hd,), "zeros", None)
    return attn


def _mlp_shapes(cfg: ModelConfig) -> dict:
    """One layer's MLP (the JAX ``mlp_specs``): gated for swiglu, else
    ``w_in`` and ``w_down``."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return {"w_gate": ((d, f), "normal", None),
                "w_up": ((d, f), "normal", None),
                "w_down": ((f, d), "normal", None)}
    return {"w_in": ((d, f), "normal", None),
            "w_down": ((f, d), "normal", None)}


def _stacked(tree: dict, n: int) -> dict:
    """A leading layer axis of ``n`` on every shape of ``tree``."""
    return {k: _stacked(v, n) if isinstance(v, dict)
            else ((n, *v[0]), *v[1:]) for k, v in tree.items()}


def _ssm_shapes(cfg: ModelConfig, L: int) -> dict:
    """The Mamba-2 tree stacked over ``L`` layers (the JAX
    ``ssm_model_specs``; the hybrid's ``blocks`` over its padded
    layers)."""
    d, di = cfg.d_model, cfg.d_inner
    g, n, hh = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * g * n
    return {
        "embed": {"tok": ((cfg.vocab_size, d), "normal", 0.02)},
        "blocks": {
            "ln": ((L, d), "zeros", None),
            "ssm": {
                "in_proj": ((L, d, 2 * di + 2 * g * n + hh), "normal", None),
                "conv_w": ((L, cfg.ssm_conv, conv_ch), "normal", None),
                "conv_b": ((L, conv_ch), "zeros", None),
                "a_log": ((L, hh), "zeros", None),
                "d_skip": ((L, hh), "ones", None),
                "dt_bias": ((L, hh), "zeros", None),
                "out_norm": ((L, di), "zeros", None),
                "out_proj": ((L, di, d), "normal", None),
            },
        },
        "ln_f": ((d,), "zeros", None),
    }


#: values a CUDA generator draws at once (``init_params``)
INIT_PIECE = 1 << 28


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype, device) -> dict:
    """Random params from ``generator`` with the JAX package's spec
    shapes and scales: ``normal x min(0.02, fan_in^-0.5)`` with fan_in
    the second-to-last dim of the stacked shape, ``tok`` and ``unembed``
    at 0.02, the ``zeros`` and ``ones`` kinds constant.  Drawn in float32
    on the generator's device, in flat pieces of at most ``INIT_PIECE``
    values, each scaled, cast and copied into place, so the float32
    transient stays ~1 GB however large the tensor (nemotron-4-340b's
    embedding table is 4.7 B values).  A tensor of one piece gets the
    numbers a whole-tensor draw gives."""
    draw_dev = generator.device

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, init, scale = spec
        if init in ("zeros", "ones"):
            fill = torch.zeros if init == "zeros" else torch.ones
            return fill(shape, dtype=dtype, device=device)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = scale if scale is not None else min(0.02, fan_in ** -0.5)
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in out.view(-1).split(INIT_PIECE):
            w = torch.randn(part.shape, generator=generator,
                            dtype=torch.float32, device=draw_dev)
            part.copy_(w * scale)
        return out

    return make(param_shapes(cfg))


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + gamma)`` in float32."""
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * rms * (1.0 + gamma.float())).to(x.dtype)


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens]


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Float32 logits from float32 accumulation over the untied
    ``unembed`` (D, V) or, tied, ``tok.T``.  A float32 table takes one
    float32 product.  Any other, on a card, takes one product of the
    stored inputs with a float32 output (``out_dtype``: the GEMM
    accumulates in float32), so no float32 copy of the table is made, as
    the reference's ``preferred_element_type``; the CPU has no such
    product and multiplies float32 copies."""
    w = params.get("unembed")
    w = params["tok"].t() if w is None else w
    if w.dtype == torch.float32 or not x.is_cuda:
        return x.float() @ w.float()
    out = torch.mm(x.reshape(-1, x.shape[-1]).to(w.dtype), w,
                   out_dtype=torch.float32)
    return out.view(*x.shape[:-1], w.shape[1])


def mlp(params: dict, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    """SwiGLU ``(silu(x W_gate) * x W_up) W_down``, squared ReLU
    ``relu(x W_in)^2 W_down`` or GELU ``gelu(x W_in) W_down``.  GELU is
    the tanh approximation, the default of the reference's
    ``jax.nn.gelu`` (torch's default is the exact erf form)."""
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif act == "squared_relu":
        h = torch.square(F.relu(x @ params["w_in"]))
    elif act == "gelu":
        h = F.gelu(x @ params["w_in"], approximate="tanh")
    else:
        raise NotImplementedError(f"mlp_act {act!r} is not ported")
    return h @ params["w_down"]


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., head_dim // 2), float32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, nheads, head_dim); cos/sin (..., S, head_dim // 2)."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)
