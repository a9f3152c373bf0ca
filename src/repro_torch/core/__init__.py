"""Hardware introspection and the Eq. 1 mapper over a GPU."""
from repro_torch.core.hw import GPU_REGISTRY, GpuParams, detect, resolve_device
from repro_torch.core.mapper import (AttentionPlan, plan_attention_blocks,
                                     plan_paged_block, resolve_lws)

__all__ = ["GPU_REGISTRY", "GpuParams", "detect", "resolve_device",
           "AttentionPlan", "plan_attention_blocks", "plan_paged_block",
           "resolve_lws"]
