"""Served architecture configs (the port's own copy)."""
from repro_torch.configs import (  # noqa: F401  (registration)
    deepseek_moe_16b, mamba2_1_3b, nemotron_4_340b, qwen3_8b,
    qwen3_moe_235b_a22b, smollm_135m, whisper_medium, zamba2_7b)
from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                      register)

__all__ = ["ModelConfig", "get_config", "list_configs", "register"]
