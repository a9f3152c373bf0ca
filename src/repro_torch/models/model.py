"""Model facade — the dense branches of the JAX package's ``Model``.

    m = build_model(get_config("smollm-135m"), device="cuda")
    params = m.init(seed=0)
    tiles = (plan.block_q, plan.block_k)       # core.mapper's plan
    logits, cache = m.prefill(params, tokens, max_len, prefill_tiles=tiles,
                              last_pos=...)
    logits, cache = m.prefill_chunk(params, cache, chunk_tokens, n_valid,
                                    prefill_tiles=tiles)
    logits, cache = m.decode_step(params, pool_cache, tokens,
                                  page_tables=..., page_block=16,
                                  paged_decode_block=...)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hw import resolve_device
from repro_torch.models import transformer as tf_mod
from repro_torch.models.layers import init_params

__all__ = ["Model", "build_model"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.cfg.dtype]

    def init(self, seed: int = 0) -> dict:
        """Random params drawn from ``torch.Generator().manual_seed(seed)``."""
        gen = torch.Generator().manual_seed(seed)
        return init_params(self.cfg, gen, self.dtype, self.device)

    def init_cache(self, batch: int, max_len: int) -> dict:
        return tf_mod.init_cache(self.cfg, batch, max_len, self.dtype,
                                 self.device)

    def prefill(self, params: dict, tokens: torch.Tensor, max_len: int, *,
                prefill_tiles: tuple, last_pos=None):
        """Run the prompt at the mapper's ``prefill_tiles``; return
        (last-token logits (B, 1, V), primed cache padded to ``max_len``).
        ``last_pos`` (B,) picks each row's true final-token logits when
        prompts are right-padded."""
        logits, (k, v) = tf_mod.forward(params, tokens, self.cfg,
                                        prefill_tiles=prefill_tiles)
        s = k.shape[2]
        pad = max_len - s
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        cache = {"k": k.to(self.dtype), "v": v.to(self.dtype), "pos": s}
        if last_pos is not None:
            idx = torch.as_tensor(last_pos, device=logits.device).long()
            rows = torch.arange(logits.shape[0], device=logits.device)
            return logits[rows, idx][:, None], cache
        return logits[:, -1:], cache

    def prefill_chunk(self, params: dict, cache: dict, tokens: torch.Tensor,
                      n_valid: int, *, prefill_tiles: tuple):
        """Advance a prefill cache by one (B, C) prompt chunk; the caller
        reads the true last-token logits at ``[:, n_valid - 1]`` of the
        final chunk (attention needs no validity mask: padded queries
        are independent rows the caller discards)."""
        del n_valid
        return tf_mod.chunk_prefill_step(params, cache, tokens, self.cfg,
                                         prefill_tiles=prefill_tiles)

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor, *,
                    page_tables=None, page_block: Optional[int] = None,
                    paged_decode_block: Optional[int] = None):
        """One decode step over the paged pool, the attention read fused
        with the block tables.  The contiguous and gather-then-sweep
        decode paths are not ported yet."""
        if page_tables is None or paged_decode_block is None:
            raise NotImplementedError(
                "only the paged, fused decode is ported; contiguous and "
                "gather-then-sweep decode are queued for a later slice")
        return tf_mod.decode_step(params, cache, tokens, self.cfg,
                                  page_tables=page_tables,
                                  page_block=int(page_block),
                                  paged_decode_block=int(paged_decode_block))


def build_model(cfg: ModelConfig, *, device="cuda") -> Model:
    """The model on ``device`` (default "cuda"; raises when there is no
    CUDA device — pass device="cpu" for the plain versions)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported; only dense is served")
    return Model(cfg, resolve_device(device))
