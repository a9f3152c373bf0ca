"""zamba2-7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, head_dim=112,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_groups=2,
    hybrid_attn_every=6,   # one shared attn+mlp block applied every 6 layers
    mlp_act="gelu", tie_embeddings=True,
))
