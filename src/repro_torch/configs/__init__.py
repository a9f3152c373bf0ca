"""Served architecture configs (the port's own copy)."""
from repro_torch.configs import mamba2_1_3b, smollm_135m  # noqa: F401
from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                      register)

__all__ = ["ModelConfig", "get_config", "list_configs", "register"]
