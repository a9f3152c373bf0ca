"""Mamba-2 SSD (state-space duality): the chunked scan of one sequence.

The CUDA kernels (``csrc/ssd.cu``) replace the JAX package's
``kernels/ssd.py::_ssd_kernel``, which ``ssd_pallas`` vmaps over heads.
What bounds them on the H100 is operations on the tensor cores: the
function needs at least the recurrence's ``L H (2(N + P) + 4NP)``
FLOPs, every product but ``C B^T`` with an f32 operand, so three TF32
products each in f32, and two in bf16, where the other operand is a
bf16 input and exact in TF32.  Their design spreads the work over
(chunk, head) in three launches: each chunk's state contribution
``dS_k`` into an f32 workspace (``ssd_states``), a scan over the chunks
that turns it into the state entering each chunk (``ssd_pass``), and
each chunk's outputs from its scores and entering state
(``ssd_outputs``); the products run
on ``mma.sync`` TF32, split 3xTF32 where an operand is f32.  Every chunk
length works; a head indexes its group of b and c instead of repeating
them.  ``launch_geometry`` describes the grids, shared memory and
workspace of a call (the C entry point decides the grids and reports
them; the workspace is ``L / chunk * H * N * P`` f32, 67 MB at one
mamba2-1.3b layer at chunk 64, and grows as the chunk shrinks).

``ssd_chunked`` is the plain PyTorch version, a copy of the JAX
package's ``kernels/ref.py::ssd_chunked`` (including ``return_state``);
``ssd_sequential`` is the O(L) recurrence oracle of ``ref.py``.  The
wrapper ``ssd`` copies ``ssd_pallas``'s chunk rules: with no ``chunk``
it plans one (``models.ssm.plan_ssd_chunk(L, hw)``), then takes
``min(chunk, L)`` and halves it until it divides L.  It runs the plain
version for CPU tensors and under ``kernels.force("plain")``; for CUDA
tensors it launches the three kernels (``ssd.launches`` counts calls;
``ssd.last_grids`` holds the grids the last call launched) or raises.

The port's Mamba-2 model calls ``ssd_chunked(..., return_state=True)``
directly, as the JAX model calls ``ref.ssd_chunked``: the TPU kernel
has no state output, so the model's prefill is not this kernel's path.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch import kernels
from repro_torch.core.hw import detect
from repro_torch.kernels import _build

__all__ = ["ssd", "ssd_chunked", "ssd_sequential", "legal_chunk",
           "launch_geometry", "SsdLaunch", "smem_bytes", "occupancy",
           "STEPS", "MAX_STATE", "MAX_HEAD_DIM"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE, MAX_HEAD_DIM = 128, 64      # csrc/ssd.cu's kMaxN, kMaxP
STEPS = ("states", "pass", "outputs")  # csrc/ssd.cu's launches, in order
_THREADS = 256
_ROWS = 64                             # csrc/ssd.cu's kRows
# csrc/ssd.cu's row strides (floats): kBN, kBT, kXP, kSS
_BN, _BT, _XP, _SS = MAX_STATE + 4, MAX_STATE + 8, MAX_HEAD_DIM + 8, _ROWS + 4
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
             + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])


def smem_bytes(chunk: int) -> dict[str, int]:
    """Dynamic shared memory of each step at ``chunk`` (csrc/ssd.cu's
    layout).  states: the B o w and X tiles, the chunk's cumsum and
    decay weights; outputs: the C tile, one region that holds S_in and
    then the B, X and score tiles, and the cumsum; the pass none."""
    chunk = int(chunk)
    return {"states": 4 * (_ROWS * (_BT + _XP) + 2 * chunk),
            "pass": 0,
            "outputs": 4 * (_ROWS * _BN + _ROWS * (_BN + _XP + _SS)
                            + chunk)}


@dataclasses.dataclass(frozen=True)
class SsdLaunch:
    """One call's launches: ``grids[step]`` = (x, y) CTAs of ``threads``
    threads for each of ``STEPS``, their dynamic shared memory, and the
    f32 workspace (states and chunk totals) in bytes."""

    chunks: int
    grids: dict
    smem_bytes: dict
    workspace_bytes: int
    threads: int = _THREADS


def launch_geometry(length: int, heads: int, n: int, p: int,
                    chunk: int) -> SsdLaunch:
    """The grids csrc/ssd.cu launches (its C entry point reports them,
    ``ssd.last_grids``): states (chunks, H), the pass (ceil(N P / 1024),
    H: four elements a thread), outputs (chunks x 64-row tiles of a
    chunk, H)."""
    chunks = length // chunk
    tiles = -(-chunk // _ROWS)
    return SsdLaunch(
        chunks=chunks,
        grids={"states": (chunks, heads),
               "pass": (-(-n * p // (4 * _THREADS)), heads),
               "outputs": (chunks * tiles, heads)},
        smem_bytes=smem_bytes(chunk),
        workspace_bytes=4 * chunks * heads * (n * p + 1))


@functools.lru_cache(maxsize=None)
def _smem_limit(device: torch.device) -> int:
    return detect(device).smem_per_block


def _repeat_groups(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(L, G, N) -> (L, H, N): each group repeated H / G times (jnp.repeat)."""
    return t.repeat_interleave(heads // t.shape[1], dim=1)


def ssd_chunked(x, a, b, c, chunk: int = 64, return_state: bool = False):
    """Plain version: x (L, H, P), a (L, H) log-decay (negative), b/c
    (L, G, N); ``L % chunk == 0``.  All math in float32; returns y in
    x's dtype and, with ``return_state``, the final (H, N, P) f32 state.

    y[t] = sum_{s<=t} C_t^T (prod_{r=s+1..t} exp(a_r)) B_s x_s
    """
    length, heads, p = x.shape
    n = b.shape[2]
    if length % chunk:
        raise ValueError(f"L={length} is not a multiple of chunk={chunk}")
    nc = length // chunk
    xc = x.float().reshape(nc, chunk, heads, p)
    ac = a.float().reshape(nc, chunk, heads)
    bc = _repeat_groups(b.float(), heads).reshape(nc, chunk, heads, n)
    cc = _repeat_groups(c.float(), heads).reshape(nc, chunk, heads, n)
    below = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=x.device).tril()[..., None]
    state = torch.zeros(heads, n, p, dtype=torch.float32, device=x.device)
    ys = []
    for k in range(nc):
        xk, ak, bk, ck = xc[k], ac[k], bc[k], cc[k]
        cum = torch.cumsum(ak, dim=0)                      # (c, H)
        total = cum[-1]
        # decay(t, s) = exp(cum[t] - cum[s]) for s <= t; the mask selects
        # before the exponent (s > t would overflow to inf)
        dt = cum[:, None, :] - cum[None, :, :]             # (c, c, H)
        dec = torch.exp(dt.masked_fill(~below, float("-inf")))
        sc = torch.einsum("thn,shn->tsh", ck, bk) * dec
        y_intra = torch.einsum("tsh,shp->thp", sc, xk)
        y_state = torch.einsum("thn,hnp->thp",
                               ck * torch.exp(cum)[..., None], state)
        w = torch.exp(total[None, :] - cum)                # (c, H)
        state = state * torch.exp(total)[..., None, None] + torch.einsum(
            "shn,shp->hnp", bk * w[..., None], xk)
        ys.append(y_intra + y_state)
    y = torch.stack(ys).reshape(length, heads, p).to(x.dtype)
    return (y, state) if return_state else y


def ssd_sequential(x, a, b, c) -> torch.Tensor:
    """O(L) sequential recurrence oracle (slow, exact), in x's dtype."""
    length, heads, p = x.shape
    bh = _repeat_groups(b.float(), heads)
    ch = _repeat_groups(c.float(), heads)
    xf, af = x.float(), a.float()
    state = torch.zeros(heads, b.shape[2], p, dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(length):
        state = state * torch.exp(af[t])[:, None, None] + torch.einsum(
            "hn,hp->hnp", bh[t], xf[t])
        ys.append(torch.einsum("hn,hnp->hp", ch[t], state))
    return torch.stack(ys).to(x.dtype)


def legal_chunk(length: int, chunk: int | None, hw=None) -> int:
    """``ssd_pallas``'s chunk rules: plan one when none is given
    (``plan_ssd_chunk(L, hw)``), cap it at L, halve it until it divides
    L."""
    if chunk is None:
        from repro_torch.models.ssm import plan_ssd_chunk
        chunk = plan_ssd_chunk(length, hw)
    chunk = min(int(chunk), length)
    while length % chunk:
        chunk //= 2
    return chunk


def _check(x, a, b, c, chunk):
    if x.dim() != 3 or a.dim() != 2 or b.dim() != 3 or c.shape != b.shape:
        raise ValueError("ssd takes x (L, H, P), a (L, H), b/c (L, G, N)")
    length, heads, p = x.shape
    groups, n = b.shape[1:]
    if a.shape != (length, heads) or b.shape[0] != length:
        raise ValueError(f"shapes {tuple(a.shape)}, {tuple(b.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if heads % groups or heads > 65535:
        raise ValueError(f"H={heads} is not a multiple of G={groups} or "
                         f"is over a grid's 65535")
    if n > MAX_STATE or p > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes N <= {MAX_STATE} and P <= "
                         f"{MAX_HEAD_DIM}, got N={n}, P={p}")
    if length % chunk:
        raise ValueError(f"L={length} is not a multiple of chunk={chunk}")
    need = max(smem_bytes(chunk).values())
    if need > _smem_limit(x.device):
        raise ValueError(f"chunk={chunk} stages {need} B of shared memory, "
                         f"over the block's limit")
    for t in (x, a, b, c):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("all operands must be contiguous on one device")


def occupancy(chunk: int, dtype: torch.dtype) -> dict[str, int]:
    """Resident CTAs per SM that the CUDA runtime reports for each step
    of a call at ``chunk`` with x, b and c in ``dtype``."""
    fn = _build.load("ssd").ssd_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = {}
    for i, step in enumerate(STEPS):
        blocks = ctypes.c_int(0)
        _build.check(fn(i, int(chunk), _DTYPES[dtype], ctypes.byref(blocks)),
                     "ssd_occupancy")
        out[step] = blocks.value
    return out


def _operands(x, a, b, c, chunk):
    """The kernel's operands: x, b and c in one dtype, float32 or
    bfloat16 (else all cast to float32), a as float32; checked."""
    xk, bk, ck = x, b, c
    if x.dtype not in _DTYPES or not b.dtype == c.dtype == x.dtype:
        xk, bk, ck = x.float(), b.float(), c.float()
    xk, ak = xk.contiguous(), a.float().contiguous()
    bk, ck = bk.contiguous(), ck.contiguous()
    _check(xk, ak, bk, ck, chunk)
    return xk, ak, bk, ck


def ssd(x, a, b, c, *, chunk: int | None = None, hw=None) -> torch.Tensor:
    """Multi-head SSD with ``ref.ssd_chunked``'s semantics at a legal
    chunk (``legal_chunk``).  Inputs of any float dtype; the math is
    float32 and the output is in x's dtype.  The kernels read x, b and c
    in one dtype, float32 or bfloat16, and a as float32: other inputs
    are cast to float32 on the way in (and the output back to x's
    dtype), which changes no value the float32 math sees."""
    chunk = legal_chunk(x.shape[0], chunk, hw)
    if kernels.use_plain(x):
        return ssd_chunked(x, a, b, c, chunk=chunk)
    xk, ak, bk, ck = _operands(x, a, b, c, chunk)
    length, heads, p = xk.shape
    groups, n = bk.shape[1:]
    chunks = length // chunk
    out = torch.empty_like(xk)
    ws = torch.empty(chunks * heads * n * p, dtype=torch.float32,
                     device=xk.device)
    tot = torch.empty(chunks * heads, dtype=torch.float32, device=xk.device)
    grids = (ctypes.c_int * 6)()
    fn = _build.load("ssd").ssd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    _build.check(fn(xk.data_ptr(), ak.data_ptr(), bk.data_ptr(),
                    ck.data_ptr(), out.data_ptr(), ws.data_ptr(),
                    tot.data_ptr(), length, heads, groups, n, p, chunk,
                    _DTYPES[xk.dtype],
                    torch.cuda.current_stream(xk.device).cuda_stream, grids),
                 "ssd")
    ssd.launches += 1
    ssd.last_grids = {step: (grids[2 * i], grids[2 * i + 1])
                      for i, step in enumerate(STEPS)}
    return out.to(x.dtype)


ssd.launches = 0
ssd.last_grids = None
