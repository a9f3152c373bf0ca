"""The SSD's three-launch schedule (``csrc/ssd.cu``, kernel row 9) on the
CPU: a torch model of its steps, and its launch geometry.

  * the model: (1) each chunk's state contribution ``dS_k = (B o
    exp(total_k - cum))^T X`` and ``total_k``; (2) the pass that turns
    the workspace into the state entering each chunk, ``S_in,k+1 =
    exp(total_k) S_in,k + dS_k``; (3) each chunk's outputs in 64-row
    tiles, ``exp(cum_t) (C S_in,k)`` plus, for each 64-row tile of s at
    or below the diagonal, the causal, decayed scores ``C B^T`` times X.
    Its products are the kernel's: each f32 operand split into TF32
    halves (big: the TF32 rounding of ``kernels.matmul.tf32_split_plain``;
    small: the exact rest with the low 13 bits that the tensor cores drop
    cleared), a bf16 operand exact in TF32, the products of each 32-deep
    K step summed into a partial that is added to the f32 sum.  Held
    against ``ssd_chunked`` and the JAX package's ``ssd_pallas`` in
    interpret mode at chunks 4 to 128,
    L 48, 100, 256 and 1200 (the smoke's ragged length), G 1 and 2, in
    float32 (1e-5, as ``tests/test_torch_ssd.py``) and bfloat16 (1.6e-2);
  * the state entering each chunk equals ``ssd_chunked(...,
    return_state=True)``'s state over the prefix before it (1e-5);
  * three TF32 products hold ``chip_smoke.py``'s f32 tolerance (2e-5 of
    the largest |y|) against a float64 model where one TF32 product does
    not;
  * the launch geometry (grids, shared memory, workspace) of the
    kernels on the H100 at the smoke's cases, that every legal chunk fits
    the block's shared memory, and that the outputs grid takes each row
    once.

The CUDA kernels run only on the card: ``chip_smoke.py`` holds them
against ``ssd_chunked`` there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ssd import ssd_pallas

from repro_torch.core.hw import GPU_REGISTRY
from repro_torch.kernels import ssd as ssd_mod
from repro_torch.kernels.matmul import tf32_split_plain
from repro_torch.models.ssm import plan_ssd_chunk

H100 = GPU_REGISTRY["h100_sxm"]
TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
ROWS, STEP = 64, 32           # csrc/ssd.cu's kRows and kStep


def _inputs(shape, dtype="float32", seed=0):
    """(L, H, P, G, N) -> ``tests/test_kernels.py``'s scaling: x * 0.5,
    a = -|N(0, 1)| * 0.1 (float32), b and c * 0.3; (torch, jax) tuples."""
    length, heads, p, g, n = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((length, heads, p), np.float32) * 0.5
    a = -np.abs(rng.standard_normal((length, heads), np.float32)) * 0.1
    b = rng.standard_normal((length, g, n), np.float32) * 0.3
    c = rng.standard_normal((length, g, n), np.float32) * 0.3
    tdt, jdt = DTYPES[dtype]
    t = tuple(torch.from_numpy(v).to(tdt) if i != 1 else torch.from_numpy(v)
              for i, v in enumerate((x, a, b, c)))
    j = tuple(jnp.asarray(v).astype(jdt) if i != 1 else jnp.asarray(v)
              for i, v in enumerate((x, a, b, c)))
    return t, j


def _halves(v):
    """csrc/ssd.cu's ``halves``: big = v rounded to TF32, small = v - big
    as the tensor cores read it (its low 13 bits dropped), 0 where not
    finite."""
    big = tf32_split_plain(v)[0]
    small = (v.float() - big).contiguous().view(torch.int32) & ~0x1FFF
    small = small.view(torch.float32)
    return big, torch.where(small.isfinite(), small, 0.0)


def _mm(a, b, exact_a, exact_b, mode):
    """Batched ``a @ b`` as the kernel's warp product.  ``mode`` "3x":
    TF32 halves of each operand that is not exact, small products first,
    each 32-deep K step's partial added to the f32 sum; "1x": one TF32
    product; "f64": plain float64."""
    if mode == "f64":
        return a.double() @ b.double()
    ab, as_ = _halves(a)
    bb, bs = _halves(b)
    if exact_a:
        ab, as_ = a.float(), torch.zeros_like(as_)
    if exact_b:
        bb, bs = b.float(), torch.zeros_like(bs)
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], STEP):
        ka, kb = (..., slice(None), slice(k0, k0 + STEP)), \
            (..., slice(k0, k0 + STEP), slice(None))
        part = ab[ka] @ bb[kb]
        if mode == "3x":
            part = (as_[ka] @ bb[kb] + ab[ka] @ bs[kb]) + part
        acc = acc + part
    return acc


def model(x, a, b, c, chunk, mode="3x"):
    """csrc/ssd.cu's three steps.  Returns (y in x's dtype, or float64 in
    mode "f64"; the workspace after the pass: the (chunks, H, N, P)
    states entering each chunk)."""
    length, heads, p = x.shape
    groups, n = b.shape[1:]
    exact = x.dtype == torch.bfloat16
    ft = torch.float64 if mode == "f64" else torch.float32
    rep = heads // groups
    xf = x.to(ft).permute(1, 0, 2)                           # (H, L, P)
    bf = b.to(ft).repeat_interleave(rep, 1).permute(1, 0, 2)  # (H, L, N)
    cf = c.to(ft).repeat_interleave(rep, 1).permute(1, 0, 2)
    af = a.to(ft).T                                          # (H, L)
    nc = length // chunk
    cums = [torch.cumsum(af[:, k * chunk:(k + 1) * chunk], 1)
            for k in range(nc)]
    # 1. states: dS_k = (B o w)^T X over the chunk, 64 rows of s a tile
    ws = torch.zeros(nc, heads, n, p, dtype=ft)
    tot = torch.stack([cum[:, -1] for cum in cums])          # (nc, H)
    for k in range(nc):
        w = torch.exp(tot[k][:, None] - cums[k])             # (H, c)
        for s0 in range(0, chunk, ROWS):
            sl = slice(k * chunk + s0, k * chunk + min(chunk, s0 + ROWS))
            bw = bf[:, sl] * w[:, s0:s0 + ROWS, None]
            ws[k] += _mm(bw.transpose(1, 2), xf[:, sl], False, exact, mode)
    # 2. the pass, in place
    s = torch.zeros(heads, n, p, dtype=ft)
    for k in range(nc):
        d = ws[k].clone()
        ws[k] = s
        s = s * torch.exp(tot[k])[:, None, None] + d
    # 3. outputs, a 64-row tile of t at a time
    y = torch.zeros(heads, length, p, dtype=ft)
    for k in range(nc):
        cum = cums[k]
        for t0 in range(0, chunk, ROWS):
            t1 = min(chunk, t0 + ROWS)
            ct = cf[:, k * chunk + t0:k * chunk + t1]
            acc = _mm(ct, ws[k], exact, False, mode) \
                * torch.exp(cum[:, t0:t1, None])
            for s0 in range(0, t1, ROWS):
                s1 = min(chunk, s0 + ROWS)
                sl = slice(k * chunk + s0, k * chunk + s1)
                sc = _mm(ct, bf[:, sl].transpose(1, 2), exact, exact, mode)
                below = (torch.arange(s0, s1)[None, :]
                         <= torch.arange(t0, t1)[:, None])
                dt = cum[:, t0:t1, None] - cum[:, None, s0:s1]
                sc = torch.where(below, sc * torch.exp(
                    dt.masked_fill(~below, 0.0)), 0.0)
                acc = acc + _mm(sc, xf[:, sl], False, exact, mode)
            y[:, k * chunk + t0:k * chunk + t1] = acc
    y = y.permute(1, 0, 2)
    return (y if mode == "f64" else y.to(x.dtype)), ws


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _np(t):
    return t.float().numpy()


KERNEL_SHAPE = (256, 4, 32, 2, 16)
SCHEDULE_CASES = [(KERNEL_SHAPE, 16), (KERNEL_SHAPE, 32),
                  (KERNEL_SHAPE, 64), (KERNEL_SHAPE, 128),
                  ((1200, 2, 16, 1, 8), 16),      # the smoke's ragged L
                  ((48, 2, 16, 1, 8), 48),        # a chunk of no power of 2
                  ((100, 2, 16, 2, 8), 4)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,chunk", SCHEDULE_CASES,
                         ids=["c16", "c32", "c64", "c128", "ragged1200-c16",
                              "L48-c48", "L100-c4"])
def test_schedule_matches_ssd_chunked_and_pallas(shape, chunk, dtype):
    (x, a, b, c), (jx, ja, jb, jc) = _inputs(shape, dtype)
    assert ssd_mod.legal_chunk(shape[0], chunk) == chunk
    got, _ = model(x, a, b, c, chunk)
    assert got.dtype == x.dtype and got.shape == x.shape
    _close(_np(got), _np(ssd_mod.ssd_chunked(x, a, b, c, chunk=chunk)),
           TOL[dtype])
    _close(_np(got), ssd_pallas(jx, ja, jb, jc, chunk=chunk, interpret=True),
           TOL[dtype])


@pytest.mark.parametrize("shape,chunk", [(KERNEL_SHAPE, 16),
                                         (KERNEL_SHAPE, 64),
                                         ((100, 2, 16, 2, 8), 4)])
def test_state_entering_each_chunk_is_the_prefix_state(shape, chunk):
    (x, a, b, c), _ = _inputs(shape)
    _, ws = model(x, a, b, c, chunk)
    assert not ws[0].any()
    for k in range(1, shape[0] // chunk):
        end = k * chunk
        _, state = ssd_mod.ssd_chunked(x[:end], a[:end], b[:end], c[:end],
                                       chunk=chunk, return_state=True)
        _close(ws[k].numpy(), state.numpy(), 1e-5)


def test_three_tf32_products_hold_the_f32_tolerance_where_one_does_not():
    """Against a float64 model of the same schedule, at a chunk of 128
    (two t tiles, a 128-deep state product): 3xTF32 within
    ``chip_smoke.py``'s 2e-5 of the largest |y|, one TF32 product not."""
    (x, a, b, c), _ = _inputs((256, 2, 64, 1, 128), seed=3)
    want, _ = model(x, a, b, c, 128, mode="f64")
    tol = 2e-5 * float(want.abs().max())
    err3 = float((model(x, a, b, c, 128)[0].double() - want).abs().max())
    err1 = float((model(x, a, b, c, 128, mode="1x")[0].double()
                  - want).abs().max())
    assert err3 < tol < err1


# --------------------------------------------------------------------------- #
# launch geometry (the wrapper's, checked by the C entry point)
# --------------------------------------------------------------------------- #


MAMBA2_LAYER = (2048, 64, 64, 1, 128)
SSD_RAGGED = (1200, 64, 64, 1, 128)


@pytest.mark.parametrize("shape,policy,chunk,grids,ws_bytes", [
    (MAMBA2_LAYER, "naive", 64,
     {"states": (32, 64), "pass": (8, 64), "outputs": (32, 64)},
     67_117_056),
    (MAMBA2_LAYER, "fixed", 256,
     {"states": (8, 64), "pass": (8, 64), "outputs": (32, 64)},
     16_779_264),
    (MAMBA2_LAYER, "auto", 64,
     {"states": (32, 64), "pass": (8, 64), "outputs": (32, 64)},
     67_117_056),
    (SSD_RAGGED, "auto", 16,
     {"states": (75, 64), "pass": (8, 64), "outputs": (75, 64)},
     157_305_600)])
def test_launch_geometry_on_the_h100(shape, policy, chunk, grids, ws_bytes):
    """The smoke's cases: the (chunk, head) grids (2,048 CTAs at chunk 64
    where the one-CTA-a-head kernel launched 64), the pass over N P / 1024
    element tiles, and the f32 workspace (states and chunk totals)."""
    length, heads, p, _, n = shape
    legal = ssd_mod.legal_chunk(length,
                                plan_ssd_chunk(length, H100, policy))
    assert legal == chunk
    geo = ssd_mod.launch_geometry(length, heads, n, p, chunk)
    assert geo.grids == grids and geo.threads == 256
    assert geo.chunks == length // chunk
    assert geo.workspace_bytes == ws_bytes == 4 * geo.chunks * heads * (
        n * p + 1)
    assert geo.smem_bytes == ssd_mod.smem_bytes(chunk)
    assert max(geo.smem_bytes.values()) <= H100.smem_per_block


def test_smem_bytes_follow_the_staged_layout():
    """states: the B o w (64 x 136) and X (64 x 72) tiles, the cumsum and
    the weights; outputs: the C tile (64 x 132), a region of 64 x (132 +
    72 + 68) floats that holds S_in (128 x 72) first, and the cumsum."""
    assert ssd_mod.smem_bytes(64) == {"states": 4 * (64 * 208 + 128),
                                      "pass": 0,
                                      "outputs": 4 * (64 * 404 + 64)}
    assert 128 * 72 <= 64 * (132 + 72 + 68)
    # two outputs CTAs an SM fit at every chunk up to 512
    assert 2 * (ssd_mod.smem_bytes(512)["outputs"] + 1024) <= 233_472


@pytest.mark.parametrize("length", [48, 100, 1200, 2048])
def test_outputs_grid_takes_each_row_once(length):
    """csrc/ssd.cu's outputs CTA x takes chunk x / tiles, 64-row tile
    x % tiles: at every chunk ``legal_chunk`` gives for L, the grid's CTAs
    cover each of the L rows once; the pass's 4 (n, p) elements a thread
    cover N P (mamba2's and odd widths)."""
    for plan in range(1, 513):
        chunk = ssd_mod.legal_chunk(length, plan)
        geo = ssd_mod.launch_geometry(length, 2, 128, 64, chunk)
        tiles = -(-chunk // 64)
        rows = []
        for bx in range(geo.grids["outputs"][0]):
            k, it = divmod(bx, tiles)
            t0 = it * 64
            rows += [k * chunk + t for t in range(t0, min(t0 + 64, chunk))]
        assert sorted(rows) == list(range(length)), (length, chunk)
        assert geo.grids["states"] == (length // chunk, 2)
    for n, p in ((128, 64), (7, 5), (128, 63)):
        geo = ssd_mod.launch_geometry(length, 2, n, p, length)
        assert (geo.grids["pass"][0] - 1) * 1024 < n * p \
            <= geo.grids["pass"][0] * 1024
