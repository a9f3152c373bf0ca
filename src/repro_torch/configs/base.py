"""Model configuration schema and the registry of served architectures.

A trimmed copy of the JAX package's ``configs/base.py``: only the fields
the served families read (dense, with qk-norm and untied embeddings, and
ssm).  ``window``, ``local_global_ratio``, the MoE, hybrid, encdec and
vlm fields and ``skip_shapes`` (the port has no ``SHAPES``) stay out.
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
                                     # or not) | ssm served; moe, hybrid,
                                     # encdec, vlm: ROADMAP queue 1 item 9
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    qk_norm: bool = False            # RMSNorm of q and k over head_dim
    rope_theta: float = 10_000.0
    mlp_act: str = "swiglu"          # swiglu | squared_relu

    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4

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

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family and topology, tiny dims (the
        same numbers as the JAX package's ``reduced()`` for dense and
        ssm)."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16,
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
