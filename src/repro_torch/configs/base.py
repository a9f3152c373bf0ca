"""Model configuration schema and the registry of served architectures.

A trimmed copy of the JAX package's ``configs/base.py``: only the fields
the served families read (dense, with qk-norm and untied embeddings, moe,
ssm, hybrid and encdec).  ``window``, ``local_global_ratio`` (gemma3's
window masks), ``prefix_tokens`` (vlm) and ``skip_shapes`` (the port has
no ``SHAPES``) stay out: they come with ROADMAP queue 1 items 9b and 9c.
The port keeps its own copy so it imports nothing of the JAX package.
``reduced()`` yields the scaled-down variant the CPU tests run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig", "register", "get_config", "list_configs"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense (swiglu or squared_relu, tied
                                     # or not) | moe | ssm | hybrid |
                                     # encdec served; vlm: ROADMAP queue 1
                                     # item 9c
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    qk_norm: bool = False            # RMSNorm of q and k over head_dim
    rope_theta: float = 10_000.0
    mlp_act: str = "swiglu"          # swiglu | squared_relu | gelu

    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    moe_shared_experts: int = 0
    moe_dff: int = 0                 # per-expert hidden dim

    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4

    # hybrid (zamba2): one *shared* attention block applied every k layers
    hybrid_attn_every: int = 0

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_tokens: int = 0          # stub frame count (1500 for whisper)

    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def heads_per_group(self) -> int:
        """Query heads sharing one KV head (GQA's R)."""
        return self.num_heads // max(self.num_kv_heads, 1)

    def n_params(self) -> float:
        """Analytic parameter count (embedding included once if tied),
        the reference's for the served families."""
        d, hd = self.d_model, self.head_dim
        h, kv = self.num_heads, self.num_kv_heads
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        mlp = (3 if self.mlp_act == "swiglu" else 2) * d * self.d_ff
        if self.family == "moe":
            e_mlp = 3 * d * self.moe_dff
            mlp = (self.moe_experts + self.moe_shared_experts) * e_mlp \
                + d * self.moe_experts          # router
        per_layer = attn + mlp + 2 * d
        if self.family == "ssm":
            di, ns = self.d_inner, self.ssm_state
            per_layer = (
                d * (2 * di + 2 * self.ssm_groups * ns + self.ssm_heads)
                + self.ssm_conv * (di + 2 * self.ssm_groups * ns)
                + 2 * self.ssm_heads + di * d + di + 2 * d
            )
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "hybrid":
            # the reference's count: num_layers Mamba-2 layers (not the
            # padded ones) and one shared block, its MLP counted as gated
            di, ns = self.d_inner, self.ssm_state
            mamba_layer = (
                d * (2 * di + 2 * self.ssm_groups * ns + self.ssm_heads)
                + self.ssm_conv * (di + 2 * self.ssm_groups * ns)
                + 2 * self.ssm_heads + di * d + di + 2 * d
            )
            shared = attn + 3 * d * self.d_ff + 2 * d
            return float(self.num_layers * mamba_layer + shared + emb)
        total = self.num_layers * per_layer
        if self.family == "encdec":
            # encoder layers: self-attention and MLP; the decoder adds a
            # cross-attention block a layer
            total += self.encoder_layers * (attn + mlp + 2 * d) \
                + self.num_layers * attn
        return float(total + emb + d)

    def n_params_active(self) -> float:
        """Active params per token (moe: the routed top-k and the shared
        experts only)."""
        if self.family != "moe":
            return self.n_params()
        inactive = (self.moe_experts - self.moe_topk) * 3 * self.d_model \
            * self.moe_dff
        return self.n_params() - self.num_layers * inactive

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family and topology, tiny dims (the
        same numbers as the JAX package's ``reduced()`` for the served
        families: 2 layers, or 4 with a shared attention block every 2;
        encdec 2 encoder layers over 24 frames)."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 4 if self.hybrid_attn_every
                           else 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            moe_experts=min(self.moe_experts, 8),
            moe_topk=min(self.moe_topk, 2),
            moe_shared_experts=min(self.moe_shared_experts, 1),
            moe_dff=64 if self.moe_dff else 0,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16,
            hybrid_attn_every=min(self.hybrid_attn_every, 2),
            encoder_layers=min(self.encoder_layers, 2),
            encoder_tokens=min(self.encoder_tokens, 24),
        )


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        import repro_torch.configs  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
