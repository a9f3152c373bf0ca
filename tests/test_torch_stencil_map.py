"""The blur's plan and a Python mirror of ``csrc/stencil.cu``'s map, on
the CPU.

  * ``plan_stencil``'s routes and tiles: the vector route (one 16-byte
    vector a thread, ``ceil(lws / vec)`` rows) where ``lws`` holds a
    vector, the rows are whole vectors, the image starts on 16 bytes and
    both rings fit, else the scalar route (one column, ``lws`` rows);
    the 4096^2 plans on the H100 pinned; the wrappers' check of a plan
    against an image.
  * a mirror of the two kernels, standing in for the C entry points:
    the same arguments, reading and writing the tensors' memory through
    the pointers the wrappers pass.  It walks what each thread of each
    CTA does, step by step: the row block and strip of CTA b (the strips
    of a row block consecutive), the rows in flight (``stencil_depth``: by
    cp.async, landing in their slot when issued, or for bf16 scalars in
    registers, landing when their row comes up), the ring of row slots
    (the column pass's ``ksize + depth - 1`` slots indexed by adds, each
    thread reading its own, odd row blocks of more inputs than ``depth``
    streaming up; the row pass's
    ``depth + 1`` slots with
    ``ceil(halo / vec)`` halo vectors a side loaded by the first
    threads, a thread computing the columns ``t + 256 e`` of its strip),
    the taps in order with each product and sum rounded to float32, one
    rounding to the image's dtype.  Each slot element carries the flat
    index of the pixel it was loaded from (or -1 for a zero off the
    image), so the mirror checks that every tap reads the right input
    pixel, or zero off the image; it counts the writes of each output
    pixel (each exactly once) and its outputs equal
    ``stencil_rows_plain`` and ``stencil_cols_plain`` bit for bit.

Shapes are ragged: images narrower and shorter than the halo, widths
that are and are not whole vectors in either dtype, more than one strip,
a last row block cut short, images 2 bytes past a 16-byte boundary (the
scalar route), every policy and several ``lws``.  The CUDA kernels run
only on the card: ``chip_smoke.py`` holds each pass bit for bit against
its plain version there.
"""

import ctypes
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.hw import GPU_REGISTRY, ceil_div
from repro_torch.core.mapper import (MAX_KSIZE, STENCIL_THREADS,
                                     plan_stencil, stencil_depth,
                                     stencil_plan_for_block,
                                     stencil_smem_bytes)
from repro_torch.kernels import _build, ops
from repro_torch.kernels import stencil as st
from repro_torch.tuner.dispatch import plan_for

H100 = GPU_REGISTRY["h100_sxm"]
POLICIES = ["naive", "fixed", "auto"]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
THREADS = STENCIL_THREADS
INVALID = 1                       # cudaErrorInvalidValue


# --------------------------------------------------------------------------- #
# the plan
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("es, policy, route, rows, tile_w, grid", [
    (4, "naive", "scalar", 1, 256, 65536),
    (4, "fixed", "vector", 8, 1024, 2048),
    (4, "auto", "vector", 16, 1024, 1024),
    (2, "naive", "scalar", 1, 256, 65536),
    (2, "fixed", "vector", 4, 2048, 2048),
    (2, "auto", "vector", 8, 2048, 1024),
])
def test_4096_plans_on_the_h100(es, policy, route, rows, tile_w, grid):
    """Eq. 1's lws (1, 32, 63) as rows of 16-byte vectors: AUTO 16 rows
    of f32 (8 of bf16), 1,024 CTAs, one wave at 8 an SM; NAIVE one row of
    scalars; the rings a few KB whatever lws is."""
    p = plan_stencil(4096, 4096, 5, H100, policy, elem_bytes=es)
    assert p.lws == {"naive": 1, "fixed": 32, "auto": 63}[policy]
    assert (p.route, p.rows, p.tile_w, p.grid) == (route, rows, tile_w, grid)
    assert p.vec == (16 // es if route == "vector" else 1)
    assert p.rounds == ceil_div(grid, 132 * 8)
    # the column ring, ksize 5 + depth - 1 rows of the strip, is the
    # larger: 6 rows of 4 KB (vectors), 12 of 1 KB (f32 scalars), 8 of 512
    # bytes (bf16 scalars)
    assert p.smem_bytes == max(stencil_smem_bytes(q, 5, p.vec, es)
                               for q in ("rows", "cols"))
    assert p.smem_bytes == {"vector": 6 * 4096, "scalar": 12 * 1024
                            if es == 4 else 8 * 512}[route] + 256


@pytest.mark.parametrize("h, w, k, es, aligned, lws, route", [
    (4096, 4096, 5, 4, True, 63, "vector"),
    (4096, 4096, 5, 4, False, 63, "scalar"),     # image off 16 bytes
    (3000, 4001, 5, 4, True, 45, "scalar"),      # rows not whole vectors
    (2160, 3840, 5, 2, True, 31, "vector"),
    (2160, 3840, 5, 2, False, 31, "scalar"),
    (4096, 4096, 5, 4, True, 3, "scalar"),       # lws under a vector
    (4096, 4096, 5, 2, True, 7, "scalar"),
    (4096, 4096, 5, 2, True, 8, "vector"),
    (1024, 1024, 55, 4, True, 32, "vector"),     # the vector ring fits
    (1024, 1024, 57, 4, True, 32, "scalar"),     # it does not: one column
    (1024, 1024, 63, 2, True, 32, "scalar"),
])
def test_route_rule(h, w, k, es, aligned, lws, route):
    p = stencil_plan_for_block(h, w, k, H100, lws, elem_bytes=es,
                               aligned=aligned)
    assert p.route == route and p.lws == lws
    vec = 16 // es
    assert p.vec == (vec if route == "vector" else 1)
    assert p.rows == -(-lws // p.vec) and p.tile_w == THREADS * p.vec
    assert p.grid == ceil_div(h, p.rows) * ceil_div(w, p.tile_w)
    fits = max(stencil_smem_bytes(q, k, vec, es) for q in ("rows", "cols")) \
        <= H100.smem_per_block
    assert fits == (k <= 55)              # the vector ring: (k + 1) 4 KB
    assert p.smem_bytes == max(stencil_smem_bytes(q, k, p.vec, es)
                               for q in ("rows", "cols")) \
        <= H100.smem_per_block


@pytest.mark.parametrize("k", range(1, MAX_KSIZE + 1, 2))
def test_rings_do_not_grow_with_lws(k):
    """Shared memory follows the route and ksize only; every ksize has a
    legal plan, the rows at most h."""
    plans = [stencil_plan_for_block(50, 2048, k, H100, lws)
             for lws in (4, 32, 63, 1000)]
    assert len({p.smem_bytes for p in plans}) == 1
    assert all(p.rows <= 50 and p.smem_bytes <= H100.smem_per_block
               for p in plans)
    halo = (k - 1) // 2
    for vec, es in ((4, 4), (8, 2), (1, 4), (1, 2)):
        rows, cols = (stencil_depth(q, vec, es) for q in ("rows", "cols"))
        assert (rows, cols) == ((4, 2) if vec > 1 else (8, 8) if es == 4
                                else (4, 4))
        assert stencil_smem_bytes("cols", k, vec, es) == \
            (k + cols - 1) * 256 * vec * es + 256
        assert stencil_smem_bytes("rows", k, vec, es) == \
            (rows + 1) * vec * (256 + 2 * -(-halo // vec)) * es + 256


def test_plan_for_reads_the_image():
    x = _image(64, 1024, "bfloat16", 0, seed=1)
    p = plan_for("gaussian_blur", x, ksize=5, hw=H100, policy="fixed")[0]
    assert (p.route, p.vec, p.rows, p.elem_bytes) == ("vector", 8, 4, 2)
    assert st.route(x, p) == "vector"
    off = _image(64, 1024, "bfloat16", 2, seed=1)        # 2 bytes off 16
    q = plan_for("gaussian_blur", off, ksize=5, hw=H100, policy="fixed")[0]
    assert (q.route, q.vec, q.rows) == ("scalar", 1, 32)
    assert st.route(off, q) == "scalar" and st.route(x, q) == "scalar"
    with pytest.raises(ValueError):            # a vector plan, off 16
        st.route(off, p)


# --------------------------------------------------------------------------- #
# a mirror of csrc/stencil.cu, standing in for the C entry points
# --------------------------------------------------------------------------- #


def _memory(ptr, nbytes):
    return np.ctypeslib.as_array((ctypes.c_uint8 * nbytes).from_address(ptr))


def _f32(raw, es):
    """Memory of f32 or bf16 elements as float32 values."""
    if es == 4:
        return raw.view(np.float32).copy()
    return (raw.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


class _Mirror:
    """The two C entry points, in Python: same arguments, same memory.
    Returns the C checks' error code where the kernels would refuse."""

    def __init__(self):
        self.calls = []
        self.writes = None

    def stencil_rows(self, *args):
        return self._run(0, *args)

    def stencil_cols(self, *args):
        return self._run(1, *args)

    def _run(self, pass_, x, out, h, w, rows, vec, grid, ksize, taps, dtype,
             stream):
        es = 4 if dtype == 0 else 2
        if vec not in (1, 16 // es) or rows < 1 or ksize % 2 == 0:
            return INVALID
        row_blocks = ceil_div(h, rows)
        if grid != ceil_div(w, THREADS * vec) * row_blocks:
            return INVALID
        if vec > 1 and (w % vec or (x | out) % 16):
            return INVALID
        self.calls.append((pass_, rows, vec, grid))
        img = _f32(_memory(x, h * w * es), es).reshape(h, w)
        coef = np.ctypeslib.as_array(taps)[:ksize].astype(np.float32)
        res = np.zeros((h, w), np.float32)
        self.writes = np.zeros((h, w), np.int64)
        run = _row_pass if pass_ == 0 else _col_pass
        chunk = max(1, (1 << 22) // (THREADS * vec * (ksize + 4)))
        for b0 in range(0, grid, chunk):
            run(np.arange(b0, min(grid, b0 + chunk)), img, es, res,
                self.writes, rows, grid // row_blocks, vec, coef)
        got = torch.from_numpy(res).to(torch.float32 if es == 4
                                       else torch.bfloat16)
        view = _memory(out, h * w * es).view(np.uint32 if es == 4
                                             else np.uint16)
        view[:] = got.view(torch.int32 if es == 4 else torch.int16) \
            .numpy().view(view.dtype).ravel()
        return 0


def _load(h, w, row, col, ok, vec):
    """Each thread's load of one vector (vec elements from column col of
    image row row) where ok, else zeros, as the flat index of each
    element in the image (-1 for a zero)."""
    c = col[..., None] + np.arange(vec, dtype=np.int32)
    ok = ok[..., None]
    assert not (ok & (c >= w)).any()          # a vector is in or out whole
    return np.where(ok, np.asarray(row)[..., None] * w + c, -1) \
        .astype(np.int32)


def _sums(img, coef, tags):
    """The taps in order, tags (k, ...) -> pixels, each product and sum
    rounded to float32 (a tag of -1 reads the zero appended at the end)."""
    flat = np.append(img.ravel(), np.float32(0))
    acc = np.zeros(tags.shape[1:], np.float32)
    for k in range(coef.size):
        acc = acc + coef[k] * flat[tags[k]]
    return acc


def _cta(b, rows, strips, h):
    """CTA b: row block b // strips of strip b % strips."""
    b = b.astype(np.int32)
    rb = b // strips
    strip = b - rb * strips
    row0 = rb * rows
    return strip, rb, row0, np.minimum(rows, h - row0)


def _col_pass(b, img, es, res, writes, rows, strips, vec, coef):
    """Lanes at or past ceil(w / vec) return at once in every CTA: left
    out.  On the f32 scalar route a block whose inputs all fit in the rows
    in flight (NAIVE's one row) is issued in one batch and waited for once
    in the kernel: the same slots and the same taps as the steps below."""
    h, w = img.shape
    ksize = coef.size
    halo, depth = (ksize - 1) // 2, stencil_depth("cols", vec, es)
    slots = ksize + depth - 1
    early = vec * es >= 4                   # cp.async: lands when issued
    strip, rb, row0, nout = _cta(b, rows, strips, h)
    nin = nout + ksize - 1
    # odd row blocks stream up, but for inputs issued in one batch
    up = ((rb & 1).astype(bool) & (nin > depth))[:, None]
    gs = np.where(up, -1, 1)
    t = np.arange(min(THREADS, -(-w // vec)), dtype=np.int32)
    col = (strip[:, None] * THREADS + t) * vec           # (B, L)
    live = col < w                                        # others return
    g0 = np.where(up, (row0 + nout - 1 + halo)[:, None],
                  (row0 - halo)[:, None])             # input i: g0 + i gs
    o0 = np.where(up[:, 0], row0 + nout - 1, row0)        # output r: o0 + r gs
    ring = np.full((b.size, slots, t.size, vec), -2, np.int32)   # -2: unset
    c = col[:, None, :, None] + np.arange(vec, dtype=np.int32)
    taps = np.arange(ksize, dtype=np.int32)[None, :, None, None]
    stage = [None] * depth                                # registers

    def issue(i, d, slot, cta):
        g = g0 + i * gs
        got = _load(h, w, g, col, live & (g >= 0) & (g < h), vec)
        if early:
            ring[cta, slot] = got[cta]
        else:
            stage[d] = np.where(cta[:, None, None], got, stage[d]
                                if stage[d] is not None else -3)

    for d in range(depth):                                # the prologue
        issue(d, d, d, d < nin)
    s = 0                                                 # input row i's slot
    for i0 in range(0, int(nin.max()), depth):
        for d in range(depth):
            i = i0 + d
            act = i < nin                                 # CTAs still looping
            if not act.any():
                break
            if not early:
                ring[act, s] = stage[d][act]
            r = i - (ksize - 1)
            if r >= 0:
                m = act[:, None] & live
                got = np.empty((b.size, ksize, t.size, vec), np.int32)
                for cta_up in (False, True):          # the slots, by adds
                    sel = up[:, 0] == cta_up
                    q = s if cta_up else s - (ksize - 1)
                    q = q + slots if q < 0 else q
                    read = []
                    for _ in range(ksize):
                        read.append(q)
                        q += -1 if cta_up else 1
                        q = 0 if q == slots else slots - 1 if q < 0 else q
                    got[sel] = ring[sel][:, read]         # (B', k, L, vec)
                out_row = o0 + r * gs[:, 0]
                src = (out_row - halo)[:, None, None, None] + taps
                want = np.where((src >= 0) & (src < h), src * w + c, -1)
                assert not ((got != want) & m[:, None, :, None]).any()
                acc = _sums(img, coef, got.transpose(1, 0, 2, 3))
                _put(res, writes, out_row[:, None, None], c[:, 0], acc, m)
            n = s + depth
            issue(i + depth, d, n - slots if n >= slots else n,
                  act & (i + depth < nin))
            s = 0 if s + 1 == slots else s + 1


def _row_pass(b, img, es, res, writes, rows, strips, vec, coef):
    """Every lane loads; the taps are mirrored for lanes below min(256,
    w) only (the others have no column of the image in any strip)."""
    h, w = img.shape
    ksize = coef.size
    halo, depth = (ksize - 1) // 2, stencil_depth("rows", vec, es)
    slots = depth + 1
    early = vec * es >= 4
    hv = -(-halo // vec)                                  # halo vectors a side
    nv = THREADS + 2 * hv
    strip, _, row0, nout = _cta(b, rows, strips, h)
    t = np.arange(THREADS, dtype=np.int32)
    gv0 = (strip * THREADS - hv)[:, None]
    ca = (gv0 + t) * vec
    oka = (ca >= 0) & (ca < w)
    ht = np.arange(2 * hv, dtype=np.int32)                # halo threads
    cb = (gv0 + THREADS + ht) * vec
    okb = cb < w
    r0c = row0[:, None]
    # slot element j (of nv vec) holds column (strip 256 - hv) vec + j
    ring = np.full((b.size, slots, nv * vec), -2, np.int32)      # -2: unset
    ea = (t[:, None] * vec + np.arange(vec)).ravel()
    eb = ((THREADS + ht)[:, None] * vec + np.arange(vec)).ravel()
    stage = [None] * depth

    def issue(r, d, slot, cta):
        a = _load(h, w, r0c + r, ca, oka, vec).reshape(b.size, -1)
        hb = _load(h, w, r0c + r, cb, okb, vec).reshape(b.size, -1)
        if early:
            ring[np.ix_(cta, [slot], ea)] = a[cta][:, None]
            ring[np.ix_(cta, [slot], eb)] = hb[cta][:, None]
        else:
            stage[d] = (a, hb, cta)

    lanes = t[:min(THREADS, w)]
    c0 = (strip * THREADS * vec)[:, None] + lanes          # (B, L)
    c = c0[..., None] + THREADS * np.arange(vec, dtype=np.int32)
    live = c < w                                          # (B, L, vec)
    k = np.arange(ksize, dtype=np.int32)[:, None, None]
    elem = lanes[None, :, None] + THREADS * np.arange(vec)[None, None] \
        + k + hv * vec - halo                             # (k, L, vec)
    src = c[:, None] + k[None] - halo                     # (B, k, L, vec)
    for d in range(depth):                                # the prologue
        issue(d, d, d, d < nout)
    s = 0                                                 # row r's slot
    for r0 in range(0, int(nout.max()), depth):
        for d in range(depth):
            r = r0 + d
            act = r < nout
            if not act.any():
                break
            if not early:
                a, hb, cta = stage[d]
                assert (cta == act).all()
                ring[np.ix_(act, [s], ea)] = a[act][:, None]
                ring[np.ix_(act, [s], eb)] = hb[act][:, None]
            # __syncthreads()
            got = ring[:, s][:, elem]                     # (B, k, L, vec)
            row = (row0 + r)[:, None, None, None]
            want = np.where((src >= 0) & (src < w), row * w + src, -1)
            m = act[:, None, None] & live
            assert not ((got != want) & m[:, None]).any()
            acc = _sums(img, coef, got.transpose(1, 0, 2, 3))
            _put(res, writes, (row0 + r)[:, None, None], c, acc, m)
            issue(r + depth, d, s - 1 if s else slots - 1,
                  act & (r + depth < nout))
            s = 0 if s + 1 == slots else s + 1


def _put(res, writes, row, col, acc, m):
    m = np.broadcast_to(m if m.ndim == col.ndim else m[..., None],
                        col.shape)
    rr, cc = np.broadcast_to(row, col.shape)[m], col[m]
    res[rr, cc] = acc[m]
    np.add.at(writes, (rr, cc), 1)


@pytest.fixture
def mirror(monkeypatch):
    """The wrappers' kernel path on CPU tensors, the library replaced by
    the mirror (nothing is built or launched)."""
    m = _Mirror()
    monkeypatch.setattr(kernels, "use_plain",
                        lambda t: kernels._mode == "plain")
    monkeypatch.setattr(_build, "load", lambda name: types.SimpleNamespace(
        stencil_rows=lambda *a: m.stencil_rows(*a),
        stencil_cols=lambda *a: m.stencil_cols(*a)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    yield m


def _image(h, w, dtype, off, seed):
    """A seeded image ``off`` bytes past a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((h, w)).astype(np.float32)) \
        .to(DTYPES[dtype])
    es = x.element_size()
    buf = torch.empty(h * w + 32, dtype=x.dtype)
    base = (-buf.data_ptr() % 16) // es + off // es
    img = buf[base:base + h * w].view(h, w)
    img.copy_(x)
    assert img.data_ptr() % 16 == off
    return img


def _check_pass(mirror, name, x, taps, plan):
    got = getattr(st, name)(x, taps, plan=plan)
    assert mirror.calls[-1] == (name == "stencil_cols", plan.rows, plan.vec,
                                plan.grid)
    np.testing.assert_array_equal(mirror.writes, 1)       # each pixel once
    want = getattr(st, f"{name}_plain")(x, taps)
    assert torch.equal(got, want)
    return got


SHAPES = [(5, 3, 7), (37, 300, 3), (130, 70, 7), (40, 1040, 5),
          (33, 2064, 9), (64, 512, 51)]
# (shape, dtype, start): each small shape in both dtypes, on 16 bytes and
# one element past; the large image (the scalar route whatever its start)
# f32 on 16 bytes and bf16 off them
MIRROR_CASES = [(s, d, o) for s in SHAPES for d in DTYPES
                for o in ("on16", "off16")] \
    + [((10_000, 77, 63), "float32", "on16"),
       ((10_000, 77, 63), "bfloat16", "off16")]


@pytest.mark.parametrize("shape, dtype, start", MIRROR_CASES, ids=[
    f"{h}x{w}k{k}-{d}-{o}" for (h, w, k), d, o in MIRROR_CASES])
def test_mirror_equals_plain_under_every_policy(shape, dtype, start,
                                                mirror):
    """Both passes under each policy's plan for the image (``plan_for``,
    as ``ops.gaussian_blur`` plans), then (but for the large image) at
    lws 4, 8, 13 and 64 through the legaliser: each pixel written once, each tap on its pixel or a
    zero off the image, bit for bit the plain versions; an image one
    element past a 16-byte boundary ("off16") takes the scalar route."""
    h, w, k = shape
    es = DTYPES[dtype].itemsize
    off = 0 if start == "on16" else es
    img = _image(h, w, dtype, off, seed=h * w + k)
    taps = st.gaussian_kernel_1d(k, 1.0)
    plans = [plan_for("gaussian_blur", img, ksize=k, hw=H100, policy=p)[0]
             for p in POLICIES]
    if h * w < 100_000:                # the large image: the policies only
        plans += [stencil_plan_for_block(h, w, k, H100, lws, elem_bytes=es,
                                         aligned=off == 0)
                  for lws in (4, 8, 13, 64)]
    routes = set()
    for plan in plans:
        mid = _check_pass(mirror, "stencil_rows", img, taps, plan)
        _check_pass(mirror, "stencil_cols", mid, taps, plan)
        routes.add(plan.route)
    vector = off == 0 and (w * es) % 16 == 0 and \
        max(stencil_smem_bytes(q, k, 16 // es, es) for q in ("rows", "cols")) \
        <= H100.smem_per_block
    assert routes == ({"vector", "scalar"} if vector else {"scalar"})


def test_ops_blur_takes_the_kernel_path_of_its_plan(mirror):
    """``ops.gaussian_blur`` through the mirror: both passes launched once
    each under the image's own plan, the result the plain blur's."""
    img = _image(40, 1040, "float32", 0, seed=3)
    before = (st.stencil_rows.launches, st.stencil_cols.launches)
    got = ops.gaussian_blur(img, ksize=5, policy="fixed")
    assert (st.stencil_rows.launches, st.stencil_cols.launches) == \
        (before[0] + 1, before[1] + 1)
    plan = plan_for("gaussian_blur", img, ksize=5, hw=H100, policy="fixed")[0]
    assert [c[1:] for c in mirror.calls] == [(plan.rows, plan.vec,
                                              plan.grid)] * 2
    with kernels.force("plain"):
        want = ops.gaussian_blur(img, ksize=5, policy="fixed")
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["off16", "elem", "cover", "rows_not_whole"])
def test_wrappers_reject_a_plan_the_image_does_not_allow(case, mirror):
    img = _image(40, 1040, "float32", 0, seed=4)
    taps = st.gaussian_kernel_1d(5, 1.0)
    plan = plan_for("gaussian_blur", img, ksize=5, hw=H100, policy="fixed")[0]
    assert plan.route == "vector"
    with pytest.raises(ValueError):
        if case == "off16":
            st.stencil_rows(_image(40, 1040, "float32", 4, seed=4), taps,
                            plan=plan)
        elif case == "elem":
            st.stencil_rows(img.bfloat16(), taps, plan=plan)
        elif case == "cover":
            st.stencil_rows(_image(80, 1040, "float32", 0, seed=4), taps,
                            plan=plan)
        else:                          # rows of 4,164 bytes
            st.route(_image(40, 1041, "float32", 0, seed=4), plan)
    assert mirror.calls == []
