"""nemotron-4-340b — dense GQA with squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    d_ff=73728, vocab_size=256000, head_dim=192,
    mlp_act="squared_relu", rope_theta=10_000.0, tie_embeddings=False,
))
