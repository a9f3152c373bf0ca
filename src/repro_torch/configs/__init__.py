"""Served architecture configs (the port's own copy)."""
from repro_torch.configs import smollm_135m  # noqa: F401  (registers)
from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                      register)

__all__ = ["ModelConfig", "get_config", "list_configs", "register"]
