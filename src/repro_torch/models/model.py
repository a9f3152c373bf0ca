"""Model facade — the dense, moe, ssm, hybrid and encdec branches of the
JAX package's ``Model``.

    m = build_model(get_config("smollm-135m"), device="cuda")
    params = m.init(seed=0)
    tiles = (plan.block_q, plan.block_k)       # core.mapper's plan
    logits, cache = m.prefill(params, tokens, max_len, prefill_tiles=tiles,
                              last_pos=...)
    logits, cache = m.prefill_chunk(params, cache, chunk_tokens, n_valid,
                                    prefill_tiles=tiles)
    logits, cache = m.decode_step(params, pool_cache, tokens,
                                  decode_block=..., decode_split=...,
                                  page_tables=..., page_block=16,
                                  paged_decode_block=...,
                                  paged_decode_split=...)

The ssm family (Mamba-2) takes ``prefill_tiles=None`` (no attention to
map) and ignores the decode step's block and page arguments.  The hybrid
family (zamba2) takes both for its shared attention block; its
whole-prompt prefill seeds only that block's K/V and leaves the ssm
states and conv windows at zero, as the reference's does ("simplified:
zeros", ``repro/models/model.py``), and its chunked prefill is the exact
recurrence (its decode step over the prompt).  The encdec family
(whisper) prefills whole prompts only (``supports_chunked_prefill``):
``prefill`` takes the encoder's ``frames`` (B, T_enc, d), zeros when
none are given (the serving adapter's stub), and its cache carries the
cross-attention's static ``ck``/``cv`` beside the self-attention's
K/V.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hw import resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import ssm as ssm_mod
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
        """Random params drawn on the model's device from
        ``torch.Generator(device).manual_seed(seed)``: on the CPU the
        numbers the CPU tests have always drawn, on a card a card's own
        (so full-width weights take seconds, not minutes, and never pass
        through the host)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self.cfg, gen, self.dtype, self.device)

    def init_cache(self, batch: int, max_len: int,
                   cache_dtype: Optional[torch.dtype] = None) -> dict:
        """Zeroed K/V caches in ``cache_dtype`` (default: the model's
        dtype; the int8 pool passes ``torch.int8``).  ssm: the
        length-free state and conv window (``max_len`` and
        ``cache_dtype`` unused); hybrid: the shared block's K/V per group
        in ``cache_dtype`` beside the ssm state and conv window; encdec:
        the self-attention's K/V in ``cache_dtype`` beside the
        cross-attention's ck/cv in the model's dtype."""
        if self.cfg.family == "encdec":
            return encdec_mod.encdec_init_cache(
                self.cfg, batch, max_len, self.dtype, self.device,
                cache_dtype=cache_dtype)
        if self.cfg.family == "ssm":
            return ssm_mod.ssm_init_cache(self.cfg, batch, self.dtype,
                                          self.device)
        if self.cfg.family == "hybrid":
            return hybrid_mod.hybrid_init_cache(
                self.cfg, batch, max_len, self.dtype, self.device,
                cache_dtype=cache_dtype)
        return tf_mod.init_cache(self.cfg, batch, max_len,
                                 cache_dtype or self.dtype, self.device)

    @property
    def supports_chunked_prefill(self) -> bool:
        """Families servable through ``prefill_chunk``: encdec is out (its
        cross-attention cache needs the whole encoder pass up front)."""
        return self.cfg.family in ("dense", "moe", "ssm", "hybrid")

    def stub_frames(self, rows: int) -> torch.Tensor:
        """Zero encoder frames (rows, T_enc, d) in the model's dtype: the
        conv/mel frontend is a stub, as in the reference."""
        cfg = self.cfg
        return torch.zeros((rows, cfg.encoder_tokens, cfg.d_model),
                           dtype=self.dtype, device=self.device)

    def prefill(self, params: dict, tokens: torch.Tensor, max_len: int, *,
                prefill_tiles: tuple, last_pos=None, frames=None):
        """Run the prompt at the mapper's ``prefill_tiles``; return
        (last-token logits (B, 1, V), primed cache padded to ``max_len``).
        ``last_pos`` (B,) picks each row's true final-token logits when
        prompts are right-padded.  ``frames`` (B, T_enc, d) are encdec's
        encoder inputs (None: ``stub_frames``); other families take
        none."""
        if frames is not None and self.cfg.family != "encdec":
            raise ValueError(f"{self.cfg.family} takes no encoder frames")
        if self.cfg.family == "encdec":
            if frames is None:
                frames = self.stub_frames(tokens.shape[0])
            logits, (k, v), (ck, cv) = encdec_mod.encdec_forward(
                params, tokens, frames, self.cfg,
                prefill_tiles=prefill_tiles)
            pad = (0, 0, 0, 0, 0, max_len - k.shape[2])
            cache = {"k": torch.nn.functional.pad(k, pad).to(self.dtype),
                     "v": torch.nn.functional.pad(v, pad).to(self.dtype),
                     "ck": ck.to(self.dtype), "cv": cv.to(self.dtype),
                     "pos": tokens.shape[1]}
        elif self.cfg.family == "ssm":
            logits, (state, conv) = ssm_mod.ssm_forward(
                params, tokens, self.cfg, return_cache=True)
            cache = {"state": state, "conv": conv.to(self.dtype),
                     "pos": tokens.shape[1]}
        elif self.cfg.family == "hybrid":
            logits, (k, v) = hybrid_mod.hybrid_forward(
                params, tokens, self.cfg, prefill_tiles=prefill_tiles)
            # the K/V of the shared block; the ssm state and conv window
            # stay zero (the reference's "simplified: zeros")
            cache = self.init_cache(tokens.shape[0], 0)
            pad = (0, 0, 0, 0, 0, max_len - k.shape[2])
            cache.update(k=torch.nn.functional.pad(k, pad).to(self.dtype),
                         v=torch.nn.functional.pad(v, pad).to(self.dtype),
                         pos=tokens.shape[1])
        else:
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
        are independent rows the caller discards).

        ssm and hybrid run their own decode step over the chunk's first
        ``n_valid`` tokens (the exact recurrence; the reference scans all
        C steps and masks the padded ones, which leave the cache as it
        was); the padded positions' logits are zeros.  The hybrid's
        step reads the row cache's K/V through the contiguous decode
        kernel (a ``None`` block: planned for the row), where the
        reference's step, given no ``decode_block``, runs the jnp
        ``decode_attention_grouped`` of the same function."""
        fam = self.cfg.family
        if not self.supports_chunked_prefill:
            raise ValueError(f"family {fam!r} has no chunked prefill (see "
                             f"supports_chunked_prefill)")
        if fam in ("ssm", "hybrid"):
            b, c = tokens.shape
            logits = torch.zeros((b, c, self.cfg.vocab_size),
                                 dtype=torch.float32, device=tokens.device)
            start = int(cache["pos"])
            for i in range(int(n_valid)):
                if fam == "ssm":
                    lg, cache = ssm_mod.ssm_decode(
                        params, cache, tokens[:, i:i + 1], self.cfg)
                else:
                    pos = torch.full((b,), start + i, dtype=torch.int32,
                                     device=tokens.device)
                    lg, cache = hybrid_mod.hybrid_decode(
                        params, dict(cache, pos=pos), tokens[:, i:i + 1],
                        self.cfg)
                logits[:, i] = lg[:, 0]
            return logits, dict(cache, pos=start + int(n_valid))
        return tf_mod.chunk_prefill_step(params, cache, tokens, self.cfg,
                                         prefill_tiles=prefill_tiles)

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor, *,
                    decode_block: Optional[int] = None,
                    decode_split: Optional[int] = None, page_tables=None,
                    page_block: Optional[int] = None,
                    paged_decode_block: Optional[int] = None,
                    paged_decode_split: Optional[int] = None):
        """One decode step.  ``page_tables`` (B, nb) + ``page_block``
        make the pool paged; ``paged_decode_block`` (the router's paged
        ``block_s``) then fuses the read with the block tables, and
        without it the read gathers a logical view first.
        ``decode_block`` (the router's contiguous ``block_s``) is the
        sweep of the contiguous pool and of the gathered view; ``None``
        plans it (``plan_cache_block``, AUTO) for the cache's length.
        ``decode_split``/``paged_decode_split`` are the router's split
        widths of the two sweeps (``None``: ``attention_decode`` plans
        AUTO).  ssm ignores all six: no attention sweep, no time axis to
        page; hybrid passes them to its shared block's attention, encdec
        to its self-attention (its cross-attention plans its own read)."""
        if self.cfg.family == "ssm":
            return ssm_mod.ssm_decode(params, cache, tokens, self.cfg)
        step = {"hybrid": hybrid_mod.hybrid_decode,
                "encdec": encdec_mod.encdec_decode}.get(
                    self.cfg.family, tf_mod.decode_step)
        return step(
            params, cache, tokens, self.cfg, decode_block=decode_block,
            decode_split=decode_split, page_tables=page_tables,
            page_block=None if page_block is None else int(page_block),
            paged_decode_block=paged_decode_block,
            paged_decode_split=paged_decode_split)


def build_model(cfg: ModelConfig, *, device="cuda") -> Model:
    """The model on ``device`` (default "cuda"; raises when there is no
    CUDA device — pass device="cpu" for the plain versions)."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "encdec"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported; the port serves dense "
            f"(swiglu or squared_relu, qk-norm, tied or untied), moe, ssm, "
            f"hybrid and encdec, and vlm, the geglu MLP and the window and "
            f"prefix-LM masks come with ROADMAP queue 1 items 9b and 9c")
    return Model(cfg, resolve_device(device))
