"""whisper-medium — encoder-decoder audio backbone [arXiv:2212.04356].

The conv/mel frontend is a stub: the encoder consumes 1500 precomputed
frame embeddings (the serving adapter's zeros)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=51865, head_dim=64,
    mlp_act="gelu", tie_embeddings=True,
    encoder_layers=24, encoder_tokens=1500,
))
