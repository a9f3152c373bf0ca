"""smollm-135m — llama-arch small dense LM [hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="smollm-135m", family="dense",
    num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
    d_ff=1536, vocab_size=49152, head_dim=64,
    mlp_act="swiglu", rope_theta=10_000.0, tie_embeddings=True,
))
