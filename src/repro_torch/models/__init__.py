"""The served models (dense decoder, Mamba-2) over the hand-written kernels."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
