"""Runtime hardware-aware workload mapping — Eq. 1 resolved over a GPU.

``lws = gws / hp`` is resolved at runtime from ``GpuParams``.  On a GPU
the paper's ``hp = cores x warps x threads`` is literal: streaming
multiprocessors x resident warps per SM x the 32 lanes of a warp
(270,336 on an H100).  Hopper's rules take the place of the TPU's 8x128
tile and VMEM rules when a plan is legalised.

**The paper's kernel suite** (vecadd, saxpy, matmul, rmsnorm, gaussian
blur, nn_search, gcn_aggregate; and Mamba-2's ssd) runs under
three mapping policies, which decide two counts: how many work items each
hardware thread loops over (``lws``) and how many threads are launched.

  * ``NAIVE``: ``lws = 1``, one work item per thread, maximal grid;
  * ``FIXED``: ``lws = FIXED_LWS = 32`` whatever the workload or card;
  * ``AUTO``: Eq. 1, ``lws = resolve_lws(gws, hp)``, so a workload at or
    above ``hp`` fills the card exactly once (one round of CTAs).

Per kernel (every CTA has 256 threads, i.e. 8 warps):

  * vecadd / saxpy: a work item is one element, ``gws = n``,
    ``hp = GpuParams.hp()``; ``grid = ceil(n / (256 lws))``.  Thread
    ``t`` of ``T`` launched takes items ``t, t + T, t + 2T, ...`` so a
    warp's 32 loads are consecutive (coalesced); a bounds check stands
    where the JAX kernel pads.
  * rmsnorm: a row reduction is one warp's work, ``gws = tokens``,
    ``hp = SMs x warps_per_sm``; ``lws`` = rows per warp and a CTA owns
    ``8 lws`` consecutive rows, so ``grid = ceil(tokens / (8 lws))``.
  * matmul: a work item is one output element, ``gws = m n``,
    ``hp = GpuParams.hp()``; ``lws`` = outputs per thread.  Both
    kernels run ``wgmma`` warpgroup tiles: ``kernel="tensor_core"``
    (``csrc/matmul_tc.cu``: bfloat16 of any shape and alignment, TMA or
    the CTA's own copies into shared-memory stages) and
    ``kernel="tf32x3"`` (``csrc/matmul_tf32x3.cu``: float32 as 3xTF32
    products from padded, K-major big and small halves of A and B);
    the tuner's ``dispatch.plan_for`` picks the kernel from the
    operands' dtype (``kernels.matmul.route``).  A thread of a ``wgmma.m64nBN`` warpgroup holds 64 BN / 128 =
    BN / 2 f32 accumulators (2 rows x BN / 4 columns: ``tm = 2``, ``tn =
    BN / 4``), so ``BN = 2 lws`` with ``lws`` rounded up to a power of
    two in [4, 128] (BN 8 ... 256).  BM is 128 (two consumer warpgroups,
    256 threads) or 64 (one, 128 threads) when 64 rows cover M; BN is
    halved while half still covers N.  bf16: ``bk`` is 64 (128 bytes,
    one 128-byte swizzle row) and ``stages`` as many as fit, from 2 (the
    least the prefetch ring runs with) up to 4.  At 4096^3 AUTO's 63 ->
    64 gives a 128 x 128 tile, FIXED's 32 128 x 64 and NAIVE's 1 -> 4
    128 x 8; at smollm's decode row (8, 1536, 576) every policy's
    ``lws`` is under 4: 64 x 8, 192 CTAs.  f32 takes the same tile and
    the same ``lws`` -> BN rule, but ``lws`` at most 64 (BN 8 ... 128: a
    thread keeps a K step's partial and the f32 sum, BN f32), so at
    4096^3 NAIVE plans 128 x 8, FIXED 128 x 64 and AUTO 128 x 128;
    ``bk`` is 32 (128 bytes of f32) and a stage holds four tiles (A and
    B, big and small), so ``stages`` is as many as fit from 2 to 4: 3
    at 128 x 128.  Every K and N is legal: the kernels mask or pad the
    ragged edges.

  * gaussian blur (two passes, one plan; ``csrc/stencil.cu``): a work
    item is one output pixel, ``gws = h w``, ``hp = GpuParams.hp()``;
    ``lws`` = pixels per thread.  A CTA of 256 threads owns a strip of
    columns and streams down a block of ``rows`` rows of it, a thread
    owning ``vec`` columns of each row.  The plan translates ``lws`` into
    that tile as vecadd's does: on the vector route (``lws >= vec``, a
    row whole 16-byte vectors, the image on 16 bytes, the rings within
    ``smem_per_block``) a thread takes one 16-byte vector, ``vec`` = 4
    f32 or 8 bf16 columns, by ``rows = ceil(lws / vec)`` rows, and a
    strip is ``tile_w = 256 vec`` columns; otherwise (NAIVE's ``lws``
    1, or a row or a pointer off 16 bytes, or a ksize whose vector ring
    does not fit) one column by ``rows = lws`` rows of a 256-column
    strip.  ``rows`` is at most ``h``.  ``grid`` is 1-D: row blocks x
    strips, the strips of a row block consecutive.  Shared memory is a ring
    of a few row slots, not the tile, so it does not grow with ``lws``:
    at 4096^2 f32 NAIVE plans one row of scalars (65,536 CTAs), FIXED 8
    rows of 1,024-column strips (2,048 CTAs) and AUTO (``lws`` 63) 16
    rows (1,024 CTAs, one wave at 8 an SM); bf16 strips are 2,048
    columns, FIXED 4 rows and AUTO 8.
  * nn_search (``csrc/nn_search.cu``): a work item is one query,
    ``gws = nq``, ``hp = GpuParams.hp()``.  A CTA's two warpgroups
    compute the dots of a ``bm``-query x ``bn``-ref tile with ``wgmma``
    (queries as A, refs as B, both K-major as they arrive), and each
    thread keeps the running ``(min d^2, argmin)`` of the query rows its
    accumulators hold: 2 rows of each 64-row ``wgmma`` tile, each shared
    by the 4 lanes of a quad over a quarter of the ref columns.  So
    ``lws`` = query rows a thread holds, legalised to ``2 mt`` with ``mt
    = ceil(lws / 2)`` in [1, 2] (1 when 128 queries cover ``nq``), and
    the query tile is ``bm = 128 mt``: how many queries share one staged
    ref tile, the reuse the JAX planner's ``block_q`` expresses.  The
    ref tile and the split follow one rule for every policy: ``bn = 128
    / mt`` (a thread holds ``mt bn`` f32 for a K step's partial and the
    sum, at most 128); K in steps of 128 bytes (32 f32, 64 bf16; 128B
    swizzle), or 32 bytes when ``d`` fits in them (d up to 8 in f32, 16
    in bf16); ``stages`` as many as fit, 2 to 4.  The grid is (query
    tiles, S ref splits), the splits merged by the last CTA of a query
    tile: the split width W is
    Eq. 1 over the (query tile, ref) pairs and the resident CTA slots
    (SMs x ``NN_CTAS_PER_SM``, the kernel's register bound), ``W =
    ceil(tiles nr / slots)`` rounded up to whole ref tiles, ``S =
    ceil(nr / W)``, so one round of CTAs covers the search, as
    ``plan_decode_split`` does for decode.  At 4,096 x 65,536 x 128 on
    an H100: NAIVE and AUTO (``lws`` 1) plan 128 x 128 tiles and 5
    splits, 160 CTAs; FIXED (32) 256 x 64 and 9 splits, 144 CTAs.
  * gcn_aggregate: a node's output row is one warp's work (lanes over
    features, as rmsnorm's row per warp), ``gws = n``, ``hp = SMs x
    warps_per_sm``; ``lws`` = node rows per warp, a CTA's 8 warps own
    ``block_n = 8 lws`` consecutive rows.  Nothing is staged in shared
    memory: a warp streams its A row once in 16-byte vectors, finds the
    non-zeros with a ballot and gathers only those rows of X (from L2);
    the JAX kernel's source tiles, which skip the MXU work of an empty
    tile, have no counterpart on the GPU.  So the feature
    width is tiled by the register budget, not by shared memory: each
    lane holds ``fpl`` accumulators (a power of two up to 16), a feature
    tile is ``32 fpl`` wide and ``grid`` is (node blocks, feature
    tiles): at F = 1,433 (Cora) three tiles of 512.
  * ssd (Mamba-2's chunked scan, ``models.ssm.plan_ssd_chunk``): a
    work item is one time step, ``gws = L``; the JAX planner's ``cores x
    64 pipeline slots`` is, on a GPU, SMs x resident warps per SM (the
    row planners' ``hp``, 8,448 on an H100; ``hw=None`` counts one
    core, 64, as the JAX model calls it).  ``lws`` sets the chunk: the
    power of two ``2^bit_length(lws)``, in [64, 512], halved while it
    does not divide L.  NAIVE plans 64 and FIXED 256; AUTO plans 64 for
    any L up to 63 x 8,448 = 532,224 steps on an H100, the same as
    NAIVE, and 128 from there.  The kernel's grid is one CTA per head
    whatever the chunk (64 at mamba2-1.3b): the chunk only trades the
    c x c quadratic work against the sequential chunk count.

``rounds`` counts waves of CTAs at full residency (``warps_per_sm / 8``
CTAs of 8 warps on each SM); the matmul tiles' registers and shared
memory lower the real residency, which ``chip_smoke.py`` reads from the CUDA runtime
beside the plan and the tuner's cost models read from it too.
``TUNED`` plans here as AUTO: the tuner (``repro_torch.tuner``) takes
that plan as its seed and refines it over each kernel's legaliser below
(``*_plan_for_block*``), keeping the winner in its cache.

**The serving kernels** plan their AUTO seed here (the tuner refines the
flash tiles and the decode ``block_s`` and split width):

  * flash ``block_q`` and ``block_k`` are multiples of 16; ``block_q``
    is 32 to 128 rows (the bf16 kernel gives a warp 16 rows, the f32
    kernel a thread one row); the staged tiles fit the larger of the two
    kernels' shared memory, so the plan does not depend on the dtype;
  * the paged sweep's ``block_s`` is a whole number of pages, the
    contiguous sweep's a multiple of 16 (``plan_cache_block`` also
    takes NAIVE and FIXED, for ``kernels.ops.decode_attention``);
  * both decode sweeps split each row over CTAs: the grid is
    (B, G, ceil(T / W)) and the split width W (``plan_decode_split``)
    is a whole number of ``block_s``.  AUTO is Eq. 1 over the split: a
    work item is one (row, KV group, position), ``gws = B G T``, and
    ``hp`` the resident CTA slots, SMs x ``decode_ctas_per_sm`` (the
    least of the thread limit, the sweep's shared memory and the
    kernels' register bound of 4 CTAs), so ``lws = W`` positions a CTA
    and one round of CTAs covers the pool (W 48, 528 CTAs, at
    smollm-135m's 8 slots x 3 groups over a 1024 pool on an H100).  NAIVE is one split (the row swept whole, B G CTAs), FIXED
    the JAX package's 512-position block;
  * each kernel's staged tiles fit the block's opt-in shared memory
    (227 KB on an H100);
  * the block-table gathers (``plan_gather``): a work item is one copy
    unit of the view, the widest of 16, 8, 4, 2 or 1 bytes that divides
    the page's bytes and both pointers (the dequant gather: the int8
    codes behind one 16-byte store, 8 for a bf16 output and 4 for f32,
    else 4 or 1, by D and the codes' pointer), ``gws`` the view's items and
    ``hp = GpuParams.hp()``; ``lws = ceil(gws / hp)`` items a thread,
    taken at a stride of the grid's threads (coalesced), over
    ``ceil(gws / (256 lws))`` CTAs of 256 threads.  One cache of
    smollm-135m's pool (8, 1024, 3, 64) bf16 is 196,608 vectors, ``lws``
    1, 768 CTAs; (8, 4096, 8, 128) bf16 is 4,194,304, ``lws`` 16, 1,024
    CTAs.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Optional

from repro_torch.core.hw import GpuParams, ceil_div, round_up
from repro_torch.core.workload import (Workload, gaussian_blur, gcn_aggregate,
                                       nearest_neighbor)

__all__ = ["MappingPolicy", "Regime", "resolve_lws", "classify_regime",
           "BlockPlan", "plan_vector_blocks", "vector_plan_for_block",
           "plan_rows", "row_plan_for_block", "MatmulPlan",
           "plan_matmul_blocks", "matmul_plan_for_blocks",
           "matmul_tc_smem_bytes",
           "matmul_tf32x3_smem_bytes", "StencilPlan",
           "plan_stencil", "stencil_plan_for_block", "stencil_smem_bytes",
           "stencil_depth", "NNPlan",
           "plan_nn", "nn_plan_for_block", "nn_smem_bytes",
           "nn_step_bytes",
           "GcnPlan", "plan_gcn", "gcn_plan_for_block", "AttentionPlan",
           "plan_attention_blocks", "plan_encdec_tiles",
           "attention_plan_for_blocks", "flash_smem_bytes",
           "flash_f32_lanes",
           "decode_smem_bytes", "decode_block_for", "plan_cache_block",
           "plan_paged_block", "decode_chunk", "decode_ctas_per_sm",
           "decode_epl", "decode_head_chunks",
           "plan_decode_split", "decode_splits", "GatherPlan",
           "GATHER_WIDTHS", "DEQUANT_WIDTHS", "gather_width",
           "plan_gather", "gather_plan_for_block", "plan_moe_capacity"]

MAX_BLOCK_Q = 128         # 16 rows a warp (bf16), a row a thread (f32)
MAX_BLOCK_K = 128
TILE_QUANTUM = 16         # mma's row/column quantum on Hopper


FIXED_LWS = 32            # the paper's fixed baseline
CTA_THREADS = 256         # every suite kernel's CTA: 8 warps
MM_TC_BK = 64             # tensor-core matmul: 128 bytes of bf16 a K step
MM_TC_MAX_STAGES = 4
MM_TC_LWS = (4, 128)      # BN = 2 lws from 8 to 256
MM_TF32_BK = 32           # 3xTF32 matmul: 128 bytes of f32 a K step
MM_TF32_LWS = (4, 64)     # BN 8 to 128: a partial and a sum a thread
STENCIL_THREADS = 256     # blur CTA: a vector or a column per thread
STENCIL_VEC_BYTES = 16    # the blur's vector route: 16-byte loads
MAX_KSIZE = 63            # blur taps passed by value (csrc/stencil.cu)
NN_MAX_MT = 2             # nn_search: 64-row query tiles a warpgroup
NN_ACC = 128              # f32 a thread holds for the partial and the sum
NN_CTAS_PER_SM = 1        # nn_search's registers: one 256-thread CTA an SM
GCN_MAX_FPL = 16          # feature accumulators per lane


class MappingPolicy(str, enum.Enum):
    """The paper's three mappings (module docstring) and ``TUNED``, the
    tuner's refinement of the AUTO seed (``repro_torch.tuner``); the
    planners here plan TUNED as AUTO, its seed."""

    NAIVE = "naive"
    FIXED = "fixed"
    AUTO = "auto"
    TUNED = "tuned"


class Regime(str, enum.Enum):
    """The three scenarios of the paper's Fig. 1."""

    OVERSUBSCRIBED = "oversubscribed"    # lws < gws/hp: several rounds
    EXACT = "exact"                      # lws = gws/hp: one full round
    UNDERSUBSCRIBED = "undersubscribed"  # lws > gws/hp: idle hardware


def resolve_lws(gws: int, hp: int) -> int:
    """Eq. 1: ``lws = gws / hp`` — 1 when ``hp`` exceeds ``gws``."""
    return max(1, ceil_div(gws, hp))


def classify_regime(lws: int, gws: int, hp: int) -> Regime:
    needed_lanes = ceil_div(gws, lws)
    if needed_lanes > hp:
        return Regime.OVERSUBSCRIBED
    if needed_lanes == hp or gws == lws * hp:
        return Regime.EXACT
    return Regime.UNDERSUBSCRIBED


def _policy_lws(policy: MappingPolicy, gws: int, hp: int) -> int:
    policy = MappingPolicy(policy)
    if policy is MappingPolicy.NAIVE:
        return 1
    if policy is MappingPolicy.FIXED:
        return FIXED_LWS
    return resolve_lws(gws, hp)


def _rounds(grid: int, hw: GpuParams) -> int:
    """Waves of 256-thread CTAs at full residency on every SM."""
    per_sm = max(1, hw.warps_per_sm * hw.warp_size // CTA_THREADS)
    return ceil_div(grid, hw.sm_count * per_sm)


# --------------------------------------------------------------------------- #
# Vector and row kernels (vecadd, saxpy, rmsnorm)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Launch of a vector or row kernel: ``grid`` CTAs of ``threads``
    threads; each thread (vector) or warp (rows) loops over ``lws`` work
    items; ``rounds`` waves of CTAs at full residency."""

    policy: MappingPolicy
    lws: int
    threads: int
    grid: int
    rounds: int
    regime: Regime


def plan_vector_blocks(w: Workload, hw: GpuParams,
                       policy: MappingPolicy = MappingPolicy.AUTO
                       ) -> BlockPlan:
    """Map an elementwise kernel of ``w.gws`` elements onto the card.

    Example::

        >>> from repro_torch.core.hw import GPU_REGISTRY
        >>> from repro_torch.core.workload import vecadd
        >>> p = plan_vector_blocks(vecadd(1 << 26), GPU_REGISTRY["h100_sxm"])
        >>> p.lws, p.grid, p.rounds
        (249, 1053, 1)
    """
    lws = _policy_lws(policy, w.gws, hw.hp())
    return vector_plan_for_block(w, hw, lws, policy)


def vector_plan_for_block(w: Workload, hw: GpuParams, lws: int,
                          policy: MappingPolicy = MappingPolicy.AUTO
                          ) -> BlockPlan:
    """Legalise an ``lws`` decision: at least 1, at most what one CTA
    needs to cover the whole vector."""
    lws = max(1, min(int(lws), ceil_div(w.gws, CTA_THREADS)))
    grid = ceil_div(w.gws, CTA_THREADS * lws)
    return BlockPlan(policy=MappingPolicy(policy), lws=lws,
                     threads=CTA_THREADS, grid=grid,
                     rounds=_rounds(grid, hw),
                     regime=classify_regime(lws, w.gws, hw.hp()))


def plan_rows(tokens: int, hw: GpuParams,
              policy: MappingPolicy = MappingPolicy.AUTO) -> BlockPlan:
    """Row plan for rmsnorm: one warp reduces one row at a time, so Eq. 1
    runs over rows and resident warps (``hp = SMs x warps_per_sm``)."""
    lws = _policy_lws(policy, tokens, hw.sm_count * hw.warps_per_sm)
    return row_plan_for_block(tokens, hw, lws, policy)


def row_plan_for_block(tokens: int, hw: GpuParams, lws: int,
                       policy: MappingPolicy = MappingPolicy.AUTO
                       ) -> BlockPlan:
    """Legalise rows per warp: at least 1, at most what one CTA (8 warps)
    needs to cover every row.  A CTA owns ``8 lws`` consecutive rows."""
    warps = CTA_THREADS // hw.warp_size
    lws = max(1, min(int(lws), ceil_div(tokens, warps)))
    grid = ceil_div(tokens, warps * lws)
    return BlockPlan(policy=MappingPolicy(policy), lws=lws,
                     threads=CTA_THREADS, grid=grid,
                     rounds=_rounds(grid, hw),
                     regime=classify_regime(lws, tokens,
                                            hw.sm_count * hw.warps_per_sm))


# --------------------------------------------------------------------------- #
# Matmul
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """``kernel`` "tensor_core": ``bm / 64`` warpgroups own a ``bm x bn``
    tile, a thread ``tm x tn = 2 x bn / 4`` outputs, K swept in ``bk`` =
    64 steps through ``stages`` shared-memory stages.  ``kernel``
    "tf32x3": the same warpgroup tile over f32 operands split into TF32
    big and small halves, ``bk`` = 32.  ``grid`` is (n tiles, m
    tiles)."""

    policy: MappingPolicy
    lws: int
    tm: int
    tn: int
    bm: int
    bn: int
    bk: int
    threads: int
    grid: tuple[int, int]
    rounds: int
    regime: Regime
    smem_bytes: int
    kernel: str
    stages: int


def matmul_tc_smem_bytes(bm: int, bn: int, stages: int) -> int:
    """Dynamic shared memory of ``csrc/matmul_tc.cu``: ``stages`` bf16 A
    (bm x 64) and B (64 x bn) tiles, two mbarriers a stage (room for 4),
    and 1024 bytes to align the tiles on the swizzle atom."""
    return stages * (bm + bn) * MM_TC_BK * 2 + 2 * MM_TC_MAX_STAGES * 8 \
        + 1024


def matmul_tf32x3_smem_bytes(bm: int, bn: int, stages: int) -> int:
    """Dynamic shared memory of ``csrc/matmul_tf32x3.cu``'s product:
    ``stages`` x (A big, A small: bm x 32 f32; B big, B small: bn x 32
    f32, K-major), two mbarriers a stage (room for 4), and 1024 bytes to
    align the tiles on the swizzle atom."""
    return stages * (bm + bn) * MM_TF32_BK * 4 * 2 \
        + 2 * MM_TC_MAX_STAGES * 8 + 1024


def plan_matmul_blocks(m: int, n: int, k: int, hw: GpuParams,
                       policy: MappingPolicy = MappingPolicy.AUTO, *,
                       kernel: str) -> MatmulPlan:
    """Map ``C[m,n] = A[m,k] @ B[k,n]`` onto the card: ``lws`` outputs
    per thread from the policy, legalised to a warpgroup tile of the
    bf16 tensor-core kernel (``kernel="tensor_core"``) or of the 3xTF32
    kernel (``kernel="tf32x3"``).  Any ``k`` is legal: the kernels sweep
    it in their own steps.

    Example::

        >>> from repro_torch.core.hw import GPU_REGISTRY
        >>> t = plan_matmul_blocks(4096, 4096, 4096, GPU_REGISTRY["h100_sxm"],
        ...                        kernel="tensor_core")
        >>> t.lws, (t.bm, t.bn), t.grid, t.rounds, t.bk, t.stages
        (64, (128, 128), (32, 32), 1, 64, 4)
        >>> d = plan_matmul_blocks(8, 1532, 576, GPU_REGISTRY["h100_sxm"],
        ...                        kernel="tensor_core")
        >>> (d.bm, d.bn), d.grid
        ((64, 8), (192, 1))
        >>> f = plan_matmul_blocks(4096, 4096, 4096, GPU_REGISTRY["h100_sxm"],
        ...                        kernel="tf32x3")
        >>> f.kernel, (f.bm, f.bn), f.bk, f.stages
        ('tf32x3', (128, 128), 32, 3)
    """
    lws = _policy_lws(policy, m * n, hw.hp())
    return matmul_plan_for_blocks(m, n, k, hw, lws, policy, kernel=kernel)


def matmul_plan_for_blocks(m: int, n: int, k: int, hw: GpuParams, lws: int,
                           policy: MappingPolicy = MappingPolicy.AUTO, *,
                           kernel: str) -> MatmulPlan:
    """Legalise an ``lws`` decision onto the kernel's warpgroup tile (the
    module docstring's rule; ``bk`` is 64 for "tensor_core", 32 for
    "tf32x3")."""
    if kernel not in ("tensor_core", "tf32x3"):
        raise ValueError(f"no matmul kernel {kernel!r}: tensor_core or "
                         f"tf32x3")
    return _matmul_tc_plan(m, n, hw, lws, policy, kernel)


def _matmul_tc_plan(m: int, n: int, hw: GpuParams, lws: int,
                    policy: MappingPolicy, kernel: str) -> MatmulPlan:
    lo, hi = MM_TC_LWS if kernel == "tensor_core" else MM_TF32_LWS
    lws = 1 << (min(max(lo, int(lws)), hi) - 1).bit_length()
    bn = 2 * lws
    while bn > 2 * lo and bn // 2 >= n:
        bn //= 2
    bm = 64 if m <= 64 else 128
    bk, smem_bytes = (MM_TC_BK, matmul_tc_smem_bytes) \
        if kernel == "tensor_core" else (MM_TF32_BK, matmul_tf32x3_smem_bytes)
    stages = MM_TC_MAX_STAGES
    while stages > 2 and smem_bytes(bm, bn, stages) > hw.smem_per_block:
        stages -= 1
    smem = smem_bytes(bm, bn, stages)
    if smem > hw.smem_per_block:
        raise ValueError(f"no legal tensor-core matmul tile: {smem} B of "
                         f"shared memory")
    grid = (ceil_div(n, bn), ceil_div(m, bm))
    return MatmulPlan(policy=MappingPolicy(policy), lws=bn // 2, tm=2,
                      tn=bn // 4, bm=bm, bn=bn, bk=bk, threads=2 * bm,
                      grid=grid, rounds=_rounds(grid[0] * grid[1], hw),
                      regime=classify_regime(bn // 2, m * n, hw.hp()),
                      smem_bytes=smem, kernel=kernel, stages=stages)


# --------------------------------------------------------------------------- #
# Gaussian blur (two stencil passes, one plan)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class StencilPlan:
    """Both blur passes: ``grid`` CTAs (1-D: row blocks x strips, the
    strips of a row block consecutive) of ``threads`` threads; a CTA covers
    ``rows`` rows of a strip ``tile_w = 256 vec`` columns wide, a thread
    ``vec`` columns of each row (``route`` "vector": one 16-byte vector
    of ``elem_bytes`` elements; "scalar": one column); ``lws`` is Eq. 1's
    pixels a thread, at most ``rows vec``; ``halo`` the taps on each
    side; ``smem_bytes`` the larger pass's shared memory."""

    policy: MappingPolicy
    lws: int
    threads: int
    grid: int
    rounds: int
    regime: Regime
    halo: int
    tile_w: int
    smem_bytes: int
    route: str
    vec: int
    rows: int
    elem_bytes: int


def stencil_depth(pass_: str, vec: int, elem_bytes: int) -> int:
    """Rows a thread of ``csrc/stencil.cu``'s ``pass_`` (``"rows"`` or
    ``"cols"``) keeps in flight ahead of the row whose taps run: on the
    vector route four in the row pass and two in the column pass; on the
    scalar route eight f32 (by cp.async) or four bf16 (in registers)."""
    if pass_ not in ("rows", "cols"):
        raise ValueError(f"no blur pass {pass_!r}: rows or cols")
    if vec == 1:
        return 8 if elem_bytes == 4 else 4
    return 4 if pass_ == "rows" else 2


def stencil_smem_bytes(pass_: str, ksize: int, vec: int,
                       elem_bytes: int) -> int:
    """Shared memory of one pass of ``csrc/stencil.cu`` (``"rows"`` or
    ``"cols"``): its ring of row slots plus the 64 f32 taps.  The row
    pass keeps ``depth + 1`` rows, each ``256 + 2 ceil(halo / vec)``
    vectors; the column pass ``ksize + depth - 1`` rows of the strip."""
    halo = (ksize - 1) // 2
    depth = stencil_depth(pass_, vec, elem_bytes)
    if pass_ == "rows":
        ring = (depth + 1) * vec * (STENCIL_THREADS
                                    + 2 * ceil_div(halo, vec))
    else:
        ring = (ksize + depth - 1) * STENCIL_THREADS * vec
    return ring * elem_bytes + 4 * (MAX_KSIZE + 1)


def _stencil_smem(ksize: int, vec: int, elem_bytes: int) -> int:
    return max(stencil_smem_bytes(p, ksize, vec, elem_bytes)
               for p in ("rows", "cols"))


def _check_ksize(ksize: int) -> int:
    if ksize < 1 or ksize % 2 == 0 or ksize > MAX_KSIZE:
        raise ValueError(f"ksize must be odd and in [1, {MAX_KSIZE}], got "
                         f"{ksize}")
    return (ksize - 1) // 2


def plan_stencil(h: int, w: int, ksize: int, hw: GpuParams,
                 policy: MappingPolicy = MappingPolicy.AUTO, *,
                 elem_bytes: int = 4, aligned: bool = True) -> StencilPlan:
    """Map the blur of an ``(h, w)`` image of ``elem_bytes`` elements
    onto the card; ``aligned``: the image starts on 16 bytes.

    Example::

        >>> from repro_torch.core.hw import GPU_REGISTRY
        >>> p = plan_stencil(4096, 4096, 5, GPU_REGISTRY["h100_sxm"])
        >>> p.lws, p.route, p.rows, p.tile_w, p.grid
        (63, 'vector', 16, 1024, 1024)
    """
    gws = gaussian_blur(h, w, ksize).gws
    lws = _policy_lws(policy, gws, hw.hp())
    return stencil_plan_for_block(h, w, ksize, hw, lws, policy,
                                  elem_bytes=elem_bytes, aligned=aligned)


def stencil_plan_for_block(h: int, w: int, ksize: int, hw: GpuParams,
                           lws: int,
                           policy: MappingPolicy = MappingPolicy.AUTO, *,
                           elem_bytes: int = 4, aligned: bool = True
                           ) -> StencilPlan:
    """Legalise pixels per thread onto the route's tile (the module
    docstring's rule): the vector route where ``lws`` holds a vector,
    the rows are whole vectors, the image is ``aligned`` and both rings
    fit; else the scalar route.  ``rows`` at most ``h``."""
    halo = _check_ksize(ksize)
    if elem_bytes not in (2, 4):
        raise ValueError(f"the blur takes float32 or bfloat16 elements, "
                         f"got {elem_bytes} bytes")
    lws = max(1, int(lws))
    vec = STENCIL_VEC_BYTES // elem_bytes
    if not (aligned and lws >= vec and (w * elem_bytes) % STENCIL_VEC_BYTES
            == 0 and _stencil_smem(ksize, vec, elem_bytes)
            <= hw.smem_per_block):
        vec = 1
    rows = max(1, min(ceil_div(lws, vec), h))
    lws = min(lws, rows * vec)
    smem = _stencil_smem(ksize, vec, elem_bytes)
    if smem > hw.smem_per_block:
        raise ValueError(f"no legal blur tile: {smem} B of shared memory")
    tile_w = STENCIL_THREADS * vec
    grid = ceil_div(h, rows) * ceil_div(w, tile_w)
    return StencilPlan(policy=MappingPolicy(policy), lws=lws,
                       threads=STENCIL_THREADS, grid=grid,
                       rounds=_rounds(grid, hw),
                       regime=classify_regime(lws, h * w, hw.hp()),
                       halo=halo, tile_w=tile_w, smem_bytes=smem,
                       route="vector" if vec > 1 else "scalar", vec=vec,
                       rows=rows, elem_bytes=elem_bytes)


# --------------------------------------------------------------------------- #
# Nearest-neighbour search
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class NNPlan:
    """``csrc/nn_search.cu``'s launch: ``grid`` = (query tiles, ref
    splits) CTAs of ``threads`` threads (two warpgroups); a CTA owns a
    ``bm``-query tile and sweeps ``split`` refs (whole ``bn``-ref tiles)
    in K steps of ``bk`` elements through ``stages`` shared-memory
    stages; a thread holds ``lws`` query rows.  ``elem_bytes`` is the
    inputs' element size (4: float32 as 3xTF32, 2: bfloat16)."""

    policy: MappingPolicy
    lws: int
    threads: int
    bm: int
    bn: int
    bk: int
    stages: int
    split: int
    grid: tuple[int, int]
    rounds: int
    regime: Regime
    smem_bytes: int
    elem_bytes: int


def nn_step_bytes(d: int, elem_bytes: int) -> int:
    """Bytes of K a stage holds a row: 32 (the 32-byte swizzle) when
    ``d`` fits in them, else 128 (the 128-byte swizzle)."""
    return 32 if d * elem_bytes <= 32 else 128


def nn_smem_bytes(bm: int, bn: int, step_bytes: int, stages: int,
                  elem_bytes: int) -> int:
    """Dynamic shared memory of ``csrc/nn_search.cu``'s product:
    ``stages`` x (a bm-row query tile and a bn-row ref tile, each
    ``step_bytes`` of K a row; float32 keeps a big and a small TF32 half
    of each), two mbarriers a stage (room for 4), the merge's flag (16
    bytes), and 1024 bytes to align the tiles on the swizzle atom."""
    halves = 2 if elem_bytes == 4 else 1
    return stages * halves * (bm + bn) * step_bytes \
        + 2 * MM_TC_MAX_STAGES * 8 + 16 + 1024


def plan_nn(nq: int, nr: int, d: int, hw: GpuParams,
            policy: MappingPolicy = MappingPolicy.AUTO, *,
            elem_bytes: int = 4) -> NNPlan:
    """Map a search of ``nq`` queries over ``nr`` refs of ``d`` dims
    (elements of ``elem_bytes``) onto the card.

    Example::

        >>> from repro_torch.core.hw import GPU_REGISTRY
        >>> h100 = GPU_REGISTRY["h100_sxm"]
        >>> p = plan_nn(4096, 65536, 128, h100)
        >>> (p.bm, p.bn), p.split, p.grid, p.stages
        ((128, 128), 16000, (32, 5), 3)
        >>> f = plan_nn(4096, 65536, 128, h100, "fixed")
        >>> (f.bm, f.bn), f.grid
        ((256, 64), (16, 9))
    """
    gws = nearest_neighbor(nq, nr, d).gws
    lws = _policy_lws(policy, gws, hw.hp())
    return nn_plan_for_block(nq, nr, d, hw, lws, policy,
                             elem_bytes=elem_bytes)


def nn_plan_for_block(nq: int, nr: int, d: int, hw: GpuParams, lws: int,
                      policy: MappingPolicy = MappingPolicy.AUTO, *,
                      elem_bytes: int = 4) -> NNPlan:
    """Legalise query rows per thread onto the kernel's tiles (the module
    docstring's rule): ``mt = ceil(lws / 2)`` in [1, 2] 64-row tiles a
    warpgroup (1 when 128 queries cover ``nq``), the ref tile, the K
    step, the stages that fit, and the split of the refs."""
    if elem_bytes not in (2, 4):
        raise ValueError(f"nn_search takes float32 or bfloat16 elements, "
                         f"got {elem_bytes} bytes")
    mt = min(max(1, ceil_div(int(lws), 2)), NN_MAX_MT)
    if nq <= CTA_THREADS // 2:
        mt = 1
    bm, bn = 2 * 64 * mt, NN_ACC // mt
    step = nn_step_bytes(d, elem_bytes)
    stages = MM_TC_MAX_STAGES
    while stages > 2 and nn_smem_bytes(bm, bn, step, stages, elem_bytes) \
            > hw.smem_per_block:
        stages -= 1
    smem = nn_smem_bytes(bm, bn, step, stages, elem_bytes)
    if smem > hw.smem_per_block:
        raise ValueError(f"no legal nn_search tile: {smem} B of shared "
                         f"memory")
    tiles = ceil_div(max(nq, 1), bm)
    whole = round_up(max(nr, 1), bn)
    slots = hw.sm_count * NN_CTAS_PER_SM
    split = min(whole, round_up(resolve_lws(tiles * max(nr, 1), slots), bn))
    grid = (tiles, ceil_div(max(nr, 1), split))
    return NNPlan(policy=MappingPolicy(policy), lws=2 * mt,
                  threads=CTA_THREADS, bm=bm, bn=bn,
                  bk=step // elem_bytes, stages=stages, split=split,
                  grid=grid, rounds=ceil_div(grid[0] * grid[1], slots),
                  regime=classify_regime(2 * mt, nq, hw.hp()),
                  smem_bytes=smem, elem_bytes=elem_bytes)


# --------------------------------------------------------------------------- #
# GCN aggregation
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class GcnPlan:
    """``grid`` = (node blocks, feature tiles) CTAs of ``threads``
    threads; a warp owns ``lws`` node rows, a CTA ``block_n = 8 lws``;
    a lane holds ``fpl`` features of a ``32 fpl`` feature tile."""

    policy: MappingPolicy
    lws: int
    threads: int
    grid: tuple[int, int]
    rounds: int
    regime: Regime
    block_n: int
    fpl: int


def plan_gcn(n: int, f: int, hw: GpuParams,
             policy: MappingPolicy = MappingPolicy.AUTO) -> GcnPlan:
    """Map ``A_hat (n, n) @ X (n, f)``: Eq. 1 over node rows and resident
    warps (``gws = n``, as ``workload.gcn_aggregate``).

    Example::

        >>> from repro_torch.core.hw import GPU_REGISTRY
        >>> p = plan_gcn(19717, 500, GPU_REGISTRY["h100_sxm"])
        >>> p.lws, p.block_n, p.grid, p.fpl
        (3, 24, (822, 1), 16)
    """
    gws = gcn_aggregate(n, 1, f).gws
    lws = _policy_lws(policy, gws, hw.sm_count * hw.warps_per_sm)
    return gcn_plan_for_block(n, f, hw, lws, policy)


def gcn_plan_for_block(n: int, f: int, hw: GpuParams, lws: int,
                       policy: MappingPolicy = MappingPolicy.AUTO
                       ) -> GcnPlan:
    """Legalise rows per warp (at least 1, at most what one CTA needs to
    cover every node) and size the lane's feature accumulators: the
    least power of two covering ``f`` over 32 lanes, at most 16."""
    warps = CTA_THREADS // hw.warp_size
    lws = max(1, min(int(lws), ceil_div(n, warps)))
    fpl = 1
    while fpl < GCN_MAX_FPL and 32 * fpl < f:
        fpl *= 2
    grid = (ceil_div(n, warps * lws), ceil_div(max(f, 1), 32 * fpl))
    return GcnPlan(policy=MappingPolicy(policy), lws=lws,
                   threads=CTA_THREADS, grid=grid,
                   rounds=_rounds(grid[0] * grid[1], hw),
                   regime=classify_regime(lws, n,
                                          hw.sm_count * hw.warps_per_sm),
                   block_n=warps * lws, fpl=fpl)


# --------------------------------------------------------------------------- #
# Flash attention tiles
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    block_q: int
    block_k: int
    smem_bytes: int


#: the f32 flash kernel's largest head_dim (csrc/flash_attention.cu)
FLASH_F32_MAX_HEAD_DIM = 128


def flash_f32_lanes(head_dim: int) -> int:
    """Lanes a query row takes in the f32 flash kernel: one up to
    head_dim 64, ceil(head_dim / 64) past it (two at 112 and 128;
    ``f32_lanes`` in the source)."""
    return -(-head_dim // 64) if head_dim > 64 else 1


def flash_smem_bytes(block_q: int, block_k: int, head_dim: int) -> int:
    """Dynamic shared memory of ``csrc/flash_attention.cu`` at these
    tiles, the larger of its two kernels', so a plan is legal whatever
    the dtype: the f32 kernel's K and V tiles plus one padded score row
    per query row (counted only up to the f32 kernel's largest
    head_dim); the bf16 kernel's double-buffered K and V tiles, rows
    padded by 8 values."""
    f32 = 0
    if head_dim <= FLASH_F32_MAX_HEAD_DIM:
        lanes = flash_f32_lanes(head_dim)
        rows = round_up(block_q * lanes, 32) // lanes
        f32 = 4 * (2 * block_k * head_dim + rows * (block_k + 1))
    bf16 = 2 * 2 * 2 * block_k * (head_dim + 8)
    return max(f32, bf16)


def plan_attention_blocks(seq_q: int, seq_k: int, head_dim: int,
                          hw: GpuParams) -> AttentionPlan:
    """Flash tiling: ``block_q`` query rows per CTA, keys swept in
    ``block_k`` tiles (the temporal ``lws`` loop).  Eq. 1 is resolved
    over query rows and SMs — rows per CTA = seq_q / SMs — so a short
    prompt still spreads over the card, then legalised."""
    return attention_plan_for_blocks(seq_q, seq_k, head_dim, hw,
                                     resolve_lws(seq_q, hw.sm_count),
                                     MAX_BLOCK_K)


def plan_encdec_tiles(prompt_len: int, encoder_tokens: int, head_dim: int,
                      hw: GpuParams) -> tuple[tuple, tuple]:
    """The flash tiles of an encoder-decoder prefill's two non-causal
    sweeps, which the serving router does not key (its prefill tiles are
    the decoder's causal self-attention at the prompt bucket): the
    encoder's self-attention, ``encoder_tokens`` queries over as many
    keys, and the decoder's cross-attention, ``prompt_len`` queries over
    the ``encoder_tokens`` encoder positions; each
    ``plan_attention_blocks``'s Eq. 1 tiles.  Flash has that one rule
    under every policy (the tuner's seed for it too; only TUNED refines
    the router's own flash plans), so these are the engine's tiles
    whatever its policy.  Returns ((block_q, block_k) of the encoder,
    (block_q, block_k) of the cross-attention)."""
    enc = plan_attention_blocks(encoder_tokens, encoder_tokens, head_dim, hw)
    cross = plan_attention_blocks(prompt_len, encoder_tokens, head_dim, hw)
    return (enc.block_q, enc.block_k), (cross.block_q, cross.block_k)


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
# Decode: the split sweep's block_s and split width (contiguous and paged)
# --------------------------------------------------------------------------- #

CACHE_BLOCK_QUANTUM = 16  # decode block_s: a multiple of mma's quantum
NAIVE_CACHE_BLOCK = 16    # one quantum per staged chunk
FIXED_CACHE_BLOCK = 512   # the JAX package's fixed cache block
DECODE_THREADS = 128      # both decode kernels' CTA: 4 warps
# the sweep's shared-memory layout (csrc/decode_sweep.cuh)
DECODE_STAGES = 4         # cp.async ring depth
DECODE_STAGE_BYTES = 4096 # K bytes one stage holds, at most
DECODE_MAX_CHUNK = 32     # positions one stage holds, at most
DECODE_NARROW_D = 128     # up to it a lane holds 4 head_dim values, past 8
DECODE_MAX_HEADS = 8      # heads a CTA takes at 4 values a lane (4 at 8)
SMEM_RESERVED = 1024      # shared memory the runtime keeps per resident CTA
DECODE_MIN_CTAS = 4       # the kernels' __launch_bounds__ minimum: ptxas
                          # keeps them within 128 registers, 4 CTAs an SM
                          # (3, 168 registers, past DECODE_NARROW_D)


def decode_epl(head_dim: int) -> int:
    """head_dim values a lane holds in the decode sweep
    (``csrc/decode_sweep.cuh::epl_of``)."""
    return 8 if head_dim > DECODE_NARROW_D else 4


def decode_head_chunks(head_dim: int, heads_per_group: int) -> int:
    """Runs of heads a KV group's R query heads split into, each a CTA of
    its own (``csrc/decode_sweep.cuh::head_chunks``): the run is the
    largest divisor of R within 8 heads (4 past head_dim 128), so R <= 8
    at head_dim <= 128 is one run.

    Example::

        >>> decode_head_chunks(192, 12), decode_head_chunks(128, 16)
        (3, 2)
    """
    r = max(1, int(heads_per_group))
    rh = min(r, DECODE_MAX_HEADS if head_dim <= DECODE_NARROW_D
             else DECODE_MAX_HEADS // 2)
    while r % rh:
        rh -= 1
    return r // rh


@functools.lru_cache(maxsize=None)
def decode_chunk(head_dim: int, cache_bytes: int = 4) -> int:
    """Positions the decode sweep stages per ring stage: a power of two,
    at most 32 and at most what keeps a stage's K within 4 KB
    (``csrc/decode_sweep.cuh::chunk_rows``)."""
    cap = DECODE_STAGE_BYTES // (round_up(head_dim, decode_epl(head_dim))
                                 * cache_bytes)
    rows = 1
    while rows * 2 <= min(cap, DECODE_MAX_CHUNK):
        rows *= 2
    return rows


@functools.lru_cache(maxsize=None)
def decode_smem_bytes(head_dim: int, heads_per_group: int,
                      page_block: Optional[int] = None,
                      cache_bytes: Optional[int] = None) -> int:
    """Dynamic shared memory of both decode kernels
    (``csrc/decode_sweep.cuh::smem_bytes``, shared by
    ``csrc/decode_attention.cu`` and ``csrc/paged_decode_attention.cu``):
    the larger of the staging (a ring of 4 stages of ``decode_chunk``
    K and V rows in the cache's dtype, ``cache_bytes`` a value, rows
    padded to ``decode_epl`` values; on the paged path 5 page slots of
    (flat block, two scales) and two scales beside each staged row) and
    the end-of-sweep merge area (each lane group's (m, l, acc) of the
    CTA's run of heads, ``decode_head_chunks``).  It does not depend on
    ``block_s`` and stays under 48 KB for any head_dim up to 256.
    ``cache_bytes=None`` (what the planner counts) takes the most over
    f32, bf16 and int8 caches; the wrappers check each launch at its own
    dtype.

    Example::

        >>> decode_smem_bytes(64, 3, page_block=16)
        33972
    """
    if cache_bytes is None:
        return max(decode_smem_bytes(head_dim, heads_per_group, page_block,
                                     es) for es in (1, 2, 4))
    c = decode_chunk(head_dim, cache_bytes)
    epl = decode_epl(head_dim)
    ring = DECODE_STAGES * 2 * round_up(
        c * round_up(head_dim, epl) * cache_bytes, 16)
    pages = 0
    if page_block is not None:
        ppc = min(c, (c + page_block - 2) // page_block + 1)
        pages = (DECODE_STAGES + 1) * ppc * 12 + DECODE_STAGES * c * 8
    lanes = 1
    while lanes * epl < head_dim:
        lanes *= 2
    heads = heads_per_group // decode_head_chunks(head_dim, heads_per_group)
    merge = 4 * heads * (DECODE_THREADS // lanes) * (epl * lanes + 2)
    return max(ring + pages, merge)


def decode_ctas_per_sm(head_dim: int, heads_per_group: int, hw: GpuParams,
                       page_block: Optional[int] = None) -> int:
    """Resident decode CTAs per SM: the least of the thread limit
    (``warps_per_sm`` warps, 4 a CTA), the SM's shared memory at the
    sweep's size plus the runtime's 1 KB a CTA, and the 4 CTAs the
    kernels' register bound (``__launch_bounds__(128, 4)``) guarantees
    (3 past head_dim 128)."""
    by_threads = hw.warps_per_sm * hw.warp_size // DECODE_THREADS
    smem = decode_smem_bytes(head_dim, heads_per_group, page_block)
    by_smem = hw.smem_per_sm // (smem + SMEM_RESERVED)
    by_regs = DECODE_MIN_CTAS - (head_dim > DECODE_NARROW_D)
    return max(1, min(by_threads, by_smem, by_regs))


def decode_block_for(s: int, d: int, hw: GpuParams, block: int,
                     heads_per_group: int = 1,
                     quantum: int = CACHE_BLOCK_QUANTUM) -> int:
    """Legalise a decode ``block_s`` decision onto Hopper's rules:
    rounded up to a multiple of ``quantum`` (16 for the contiguous
    sweep, the page for the paged one), at most the cache length rounded
    up to it; raises when the sweep's shared memory, which no longer
    grows with ``block_s``, does not fit the block's.

    Example::

        >>> from repro_torch.core.hw import GPU_REGISTRY
        >>> decode_block_for(1024, 64, GPU_REGISTRY["h100_sxm"], 512, 3)
        512
    """
    q = int(quantum)
    if decode_smem_bytes(d, heads_per_group) > hw.smem_per_block:
        raise ValueError(f"no legal decode block for head_dim={d}, "
                         f"heads_per_group={heads_per_group}")
    return min(round_up(max(1, int(block)), q), round_up(max(1, s), q))


def plan_cache_block(s: int, d: int, hw: GpuParams,
                     policy: MappingPolicy = MappingPolicy.AUTO,
                     heads_per_group: int = 1) -> int:
    """The contiguous decode sweep's ``block_s`` (the Hopper translation
    of the JAX package's ``kernels/decode_attention.py::plan_cache_block``):
    NAIVE 16 positions, FIXED 512, AUTO Eq. 1 over the cache length and
    the SMs (positions per SM), each legalised by ``decode_block_for``.
    It is the quantum of the split width (``plan_decode_split``).

    Example::

        >>> from repro_torch.core.hw import GPU_REGISTRY
        >>> plan_cache_block(4096, 64, GPU_REGISTRY["h100_sxm"])
        32
    """
    policy = MappingPolicy(policy)
    if policy is MappingPolicy.NAIVE:
        block = NAIVE_CACHE_BLOCK
    elif policy is MappingPolicy.FIXED:
        block = FIXED_CACHE_BLOCK
    else:
        block = resolve_lws(s, hw.sm_count)
    return decode_block_for(s, d, hw, block, heads_per_group)


def plan_paged_block(s: int, d: int, page_block: int, hw: GpuParams,
                     heads_per_group: int = 1) -> int:
    """Eq. 1 seed for the paged sweep's ``block_s`` (the quantum of its
    split width, whole pages): positions per SM, quantised UP to whole
    pages, clamped to the padded cache length and legalised by
    ``decode_block_for``.

    Example::

        >>> from repro_torch.core.hw import GPU_REGISTRY
        >>> plan_paged_block(1024, 64, 16, GPU_REGISTRY["h100_sxm"]) % 16
        0
    """
    return decode_block_for(s, d, hw, resolve_lws(s, hw.sm_count),
                            heads_per_group, quantum=page_block)


def plan_decode_split(t: int, rows: int, block_s: int, head_dim: int,
                      hw: GpuParams,
                      policy: MappingPolicy = MappingPolicy.AUTO,
                      heads_per_group: int = 1,
                      page_block: Optional[int] = None) -> int:
    """The split width W of the decode sweep: each CTA of the grid
    (B, G, ceil(t / W)) sweeps W positions of one (row, KV group), and a
    row's splits are merged in the same launch.  W is a whole number of
    ``block_s`` (so of pages on the paged path), at most the row ``t``
    rounded up to it.  ``rows`` is B x G; ``t`` is the pool row's length
    (the host plans from it, never from the live cache lengths).

      * NAIVE: one split, the row swept whole by one CTA per (row, group)
        whatever the card;
      * FIXED: the JAX package's fixed 512-position block;
      * AUTO: Eq. 1 over the split: the (row, group, run of heads,
        position) work ``rows x decode_head_chunks x t`` over the
        resident CTA slots, ``sm_count`` x ``decode_ctas_per_sm``, so
        the grid fills the card once.

    Example::

        >>> from repro_torch.core.hw import GPU_REGISTRY
        >>> plan_decode_split(1024, 24, 16, 64, GPU_REGISTRY["h100_sxm"],
        ...                   heads_per_group=3, page_block=16)
        48
    """
    policy = MappingPolicy(policy)
    bs = int(block_s)
    whole = round_up(max(1, int(t)), bs)
    if policy is MappingPolicy.NAIVE:
        return whole
    if policy is MappingPolicy.FIXED:
        return min(whole, round_up(FIXED_CACHE_BLOCK, bs))
    slots = hw.sm_count * decode_ctas_per_sm(head_dim, heads_per_group, hw,
                                             page_block)
    runs = decode_head_chunks(head_dim, heads_per_group)
    w = resolve_lws(max(1, int(rows)) * runs * max(1, int(t)), slots)
    return min(whole, round_up(w, bs))


def decode_splits(t: int, split: int) -> int:
    """CTAs a (row, group) gets at split width ``split``: ceil(t / W)."""
    return max(1, ceil_div(int(t), int(split)))


# --------------------------------------------------------------------------- #
# Block-table gathers (the paged pool's logical view)
# --------------------------------------------------------------------------- #

GATHER_THREADS = 256          # both gathers' CTA: 8 warps
GATHER_WIDTHS = (16, 8, 4, 2, 1)   # bytes a copy item moves, widest first
#: int8 codes a dequant item takes, widest first, by the output's bytes
#: a value: at most the codes behind one 16-byte store
DEQUANT_WIDTHS = {2: (8, 4, 1), 4: (4, 1)}


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """Launch of a block-table gather: the view is ``gws`` items of
    ``width`` (bytes for the copy, int8 codes for the dequant gather);
    ``grid`` CTAs of ``threads`` threads, thread ``t`` of ``T = grid x
    threads`` taking items ``t, t + T, ...``, ``lws`` of them at most;
    ``rounds`` waves of CTAs at full residency."""

    width: int
    gws: int
    lws: int
    threads: int
    grid: int
    rounds: int


def gather_width(unit: int, align: int, widths=GATHER_WIDTHS) -> int:
    """The widest of ``widths`` dividing both ``unit`` (a page's bytes
    for the copy, D for the dequant gather) and ``align`` (the pointers'
    common alignment in bytes; any multiple of 16 for aligned ones).

    Example::

        >>> [gather_width(u, a) for u, a in ((6144, 256), (12, 256),
        ...                                  (6144, 2))]
        [16, 4, 2]
    """
    for w in widths:
        if unit % w == 0 and align % w == 0:
            return w
    raise ValueError(f"no gather width of {widths} divides {unit} and "
                     f"{align}")


def plan_gather(size: int, width: int, hw: GpuParams) -> GatherPlan:
    """Eq. 1 over a gather of ``size`` bytes (the copy) or codes (the
    dequant gather) in items of ``width``: ``lws = ceil(gws / hp)``.

    Example::

        >>> from repro_torch.core.hw import GPU_REGISTRY
        >>> p = plan_gather(8 * 1024 * 3 * 64 * 2, 16,
        ...                 GPU_REGISTRY["h100_sxm"])
        >>> p.gws, p.lws, p.grid
        (196608, 1, 768)
    """
    if width < 1 or size % width:
        raise ValueError(f"a gather of {size} in items of {width}")
    return gather_plan_for_block(size, width, hw,
                                 resolve_lws(size // width, hw.hp()))


def gather_plan_for_block(size: int, width: int, hw: GpuParams,
                          lws: int) -> GatherPlan:
    """Legalise an ``lws`` decision (the tuner's candidate space): the
    width must divide ``size``; ``lws`` at least 1, at most what one CTA
    needs to cover every item; the grid covers the view once."""
    if width < 1 or size < 1 or size % width:
        raise ValueError(f"a gather of {size} in items of {width}")
    gws = size // width
    lws = max(1, min(int(lws), ceil_div(gws, GATHER_THREADS)))
    grid = ceil_div(gws, GATHER_THREADS * lws)
    return GatherPlan(width=width, gws=gws, lws=lws, threads=GATHER_THREADS,
                      grid=grid, rounds=_rounds(grid, hw))


#: AUTO's load-imbalance slack over the mean routed slots an expert
_MOE_SLACK = 1.25


def plan_moe_capacity(tokens: int, num_experts: int, top_k: int,
                      policy: MappingPolicy = MappingPolicy.AUTO) -> int:
    """Expert capacity: Eq. 1 over routed token slots, the reference's
    numbers.  ``gws = tokens x top_k`` slots over ``hp = num_experts``
    expert lanes; NAIVE takes the mean (drops under any imbalance),
    FIXED ``4 FIXED_LWS`` whatever the call, AUTO (and TUNED, its seed)
    the mean times 1.25; every capacity is rounded up to a multiple
    of 8, at least 8.  Host arithmetic: the expert products are batched
    GEMMs with no Hopper tile rule of their own.

    Example::

        >>> plan_moe_capacity(32, 64, 6)
        8
        >>> plan_moe_capacity(1024, 64, 6)
        120
    """
    ideal = ceil_div(tokens * top_k, num_experts)
    policy = MappingPolicy(policy)
    if policy is MappingPolicy.NAIVE:
        cap = ideal
    elif policy is MappingPolicy.FIXED:
        cap = FIXED_LWS * 4
    else:
        cap = int(ideal * _MOE_SLACK)
    return max(8, round_up(cap, 8))
