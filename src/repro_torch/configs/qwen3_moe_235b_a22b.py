"""qwen3-moe-235b-a22b — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B family]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=1536, vocab_size=151936, head_dim=128,
    moe_experts=128, moe_topk=8, moe_shared_experts=0, moe_dff=1536,
    qk_norm=True, mlp_act="swiglu", rope_theta=1_000_000.0,
    tie_embeddings=False,
))
