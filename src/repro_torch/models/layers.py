"""Parameter initialisation and the shared dense layers.

Params are nested dicts of tensors in the JAX package's layout (layers
stacked on a leading axis):

    embed.tok (V, D)
    blocks.ln1 (L, D), blocks.ln2 (L, D)
    blocks.attn.{wq (L, D, H, hd), wk/wv (L, D, G, hd), wo (L, H, hd, D)}
    blocks.mlp.{w_gate, w_up (L, D, F), w_down (L, F, D)}
    ln_f (D,)

so ``weights.params_from_jax`` is a plain conversion and the tests hold
the port against the reference on the same weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

__all__ = ["param_shapes", "init_params", "rmsnorm", "embed", "unembed",
           "mlp", "rope_tables", "apply_rope"]


def param_shapes(cfg: ModelConfig) -> dict:
    """The param tree as {name: (shape, init, scale)}; ``init`` is
    "normal" or "zeros", ``scale`` None means min(0.02, fan_in^-0.5)."""
    d, h, g, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    n, f = cfg.num_layers, cfg.d_ff
    if cfg.family != "dense" or cfg.mlp_act != "swiglu" \
            or not cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense swiglu family with tied "
            f"embeddings only; other families are queued for later slices")
    return {
        "embed": {"tok": ((cfg.vocab_size, d), "normal", 0.02)},
        "blocks": {
            "ln1": ((n, d), "zeros", None),
            "attn": {"wq": ((n, d, h, hd), "normal", None),
                     "wk": ((n, d, g, hd), "normal", None),
                     "wv": ((n, d, g, hd), "normal", None),
                     "wo": ((n, h, hd, d), "normal", None)},
            "ln2": ((n, d), "zeros", None),
            "mlp": {"w_gate": ((n, d, f), "normal", None),
                    "w_up": ((n, d, f), "normal", None),
                    "w_down": ((n, f, d), "normal", None)},
        },
        "ln_f": ((d,), "zeros", None),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype, device) -> dict:
    """Random params from ``generator`` with the JAX package's spec
    shapes and scales: ``normal x min(0.02, fan_in^-0.5)`` with fan_in
    the second-to-last dim of the stacked shape, ``tok`` at 0.02, norms
    zero.  Drawn in float32 on the CPU (the same numbers on every
    device), then cast and moved."""
    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, init, scale = spec
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = scale if scale is not None else min(0.02, fan_in ** -0.5)
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w * scale).to(dtype=dtype, device=device)

    return make(param_shapes(cfg))


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + gamma)`` in float32."""
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * rms * (1.0 + gamma.float())).to(x.dtype)


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens]


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding; float32 logits from float32 accumulation."""
    return x.float() @ params["tok"].float().t()


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x W_gate) * x W_up) W_down``."""
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
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
