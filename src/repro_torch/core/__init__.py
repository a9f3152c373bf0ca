"""Hardware introspection, workloads and the Eq. 1 mapper over a GPU."""
from repro_torch.core.hw import GPU_REGISTRY, GpuParams, detect, resolve_device
from repro_torch.core.mapper import (AttentionPlan, BlockPlan, MappingPolicy,
                                     MatmulPlan, Regime, plan_attention_blocks,
                                     plan_matmul_blocks, plan_paged_block,
                                     plan_rows, plan_vector_blocks,
                                     resolve_lws)

__all__ = ["GPU_REGISTRY", "GpuParams", "detect", "resolve_device",
           "AttentionPlan", "BlockPlan", "MappingPolicy", "MatmulPlan",
           "Regime", "plan_attention_blocks", "plan_matmul_blocks",
           "plan_paged_block", "plan_rows", "plan_vector_blocks",
           "resolve_lws"]
