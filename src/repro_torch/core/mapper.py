"""Runtime hardware-aware workload mapping — Eq. 1 resolved over a GPU.

``lws = gws / hp`` is resolved at runtime from ``GpuParams``: the
streaming multiprocessors take the place of the TPU's TensorCores at the
program tier, and Hopper's rules take the place of the 8x128 tile and
VMEM rules when a plan is legalised:

  * flash ``block_q`` and ``block_k`` are multiples of 16; ``block_q``
    is at least one warp of rows (the kernel maps one query row to one
    thread) and at most 128;
  * the paged sweep's ``block_s`` is a whole number of pages;
  * each kernel's staged tiles fit the block's opt-in shared memory
    (227 KB on an H100).

This is the seed of the JAX package's AUTO policy, and the only plan
there is: the mapping policies (NAIVE/FIXED baselines, TUNED with its
measured refinement and tuning cache) come with the tuner slice.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.hw import GpuParams, ceil_div, round_up

__all__ = ["resolve_lws", "AttentionPlan", "plan_attention_blocks",
           "attention_plan_for_blocks", "flash_smem_bytes",
           "paged_smem_bytes", "plan_paged_block"]

MAX_BLOCK_Q = 128         # one query row per thread, 128 threads at most
MAX_BLOCK_K = 128
TILE_QUANTUM = 16         # mma's row/column quantum on Hopper


def resolve_lws(gws: int, hp: int) -> int:
    """Eq. 1: ``lws = gws / hp`` — 1 when ``hp`` exceeds ``gws``."""
    return max(1, ceil_div(gws, hp))


# --------------------------------------------------------------------------- #
# Flash attention tiles
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    block_q: int
    block_k: int
    smem_bytes: int


def flash_smem_bytes(block_q: int, block_k: int, head_dim: int) -> int:
    """Dynamic shared memory of ``csrc/flash_attention.cu``: the f32 K
    and V tiles plus one padded score row per thread."""
    threads = round_up(block_q, 32)
    return 4 * (2 * block_k * head_dim + threads * (block_k + 1))


def plan_attention_blocks(seq_q: int, seq_k: int, head_dim: int,
                          hw: GpuParams) -> AttentionPlan:
    """Flash tiling: ``block_q`` query rows per CTA, keys swept in
    ``block_k`` tiles (the temporal ``lws`` loop).  Eq. 1 is resolved
    over query rows and SMs — rows per CTA = seq_q / SMs — so a short
    prompt still spreads over the card, then legalised."""
    return attention_plan_for_blocks(seq_q, seq_k, head_dim, hw,
                                     resolve_lws(seq_q, hw.sm_count),
                                     MAX_BLOCK_K)


def attention_plan_for_blocks(seq_q: int, seq_k: int, head_dim: int,
                              hw: GpuParams, bq: int, bk: int
                              ) -> AttentionPlan:
    """Legalise a (block_q, block_k) decision onto Hopper's rules."""
    bq = min(MAX_BLOCK_Q, max(32, round_up(bq, TILE_QUANTUM)))
    bk = min(MAX_BLOCK_K, round_up(max(1, min(bk, seq_k)), TILE_QUANTUM))
    while flash_smem_bytes(bq, bk, head_dim) > hw.smem_per_block \
            and bk > TILE_QUANTUM:
        bk -= TILE_QUANTUM
    smem = flash_smem_bytes(bq, bk, head_dim)
    if smem > hw.smem_per_block:
        raise ValueError(f"no legal flash tile for head_dim={head_dim}: "
                         f"{smem} B of shared memory at the smallest tile")
    return AttentionPlan(block_q=bq, block_k=bk, smem_bytes=smem)


# --------------------------------------------------------------------------- #
# Paged decode staging chunk
# --------------------------------------------------------------------------- #


def paged_smem_bytes(block_s: int, head_dim: int, heads_per_group: int) -> int:
    """Dynamic shared memory of ``csrc/paged_decode_attention.cu``: the
    staged f32 K and V rows (padded by one word against bank conflicts),
    the group's scaled queries and one score row per query head."""
    return 4 * (2 * block_s * (head_dim + 1) + heads_per_group * head_dim
                + heads_per_group * block_s)


def plan_paged_block(s: int, d: int, page_block: int, hw: GpuParams,
                     heads_per_group: int = 1) -> int:
    """Eq. 1 seed for the paged sweep's ``block_s`` (cache positions
    staged per iteration): positions per SM, quantised UP to whole pages,
    clamped to the padded cache length and shrunk while the staged tiles
    overflow shared memory.

    Example::

        >>> from repro_torch.core.hw import GPU_REGISTRY
        >>> plan_paged_block(1024, 64, 16, GPU_REGISTRY["h100_sxm"]) % 16
        0
    """
    bs = round_up(resolve_lws(s, hw.sm_count), page_block)
    bs = min(bs, round_up(s, page_block))
    while paged_smem_bytes(bs, d, heads_per_group) > hw.smem_per_block \
            and bs > page_block:
        bs -= page_block
    return bs
