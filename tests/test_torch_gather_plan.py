"""The block-table gathers' plan and launch on the CPU.

  * ``plan_gather`` (Eq. 1 over the view's copy items) under the H100's
    registry entry at smollm-135m's serving shape and at (8, 4096, 8,
    128), pinned; the legaliser ``gather_plan_for_block``'s bounds and
    ``gather_width``'s choice;
  * a Python mirror of ``csrc/paged_gather.cu``'s map: thread t of T
    takes items t, t + T, ... (lws of them), item i -> logical page
    i / items-a-page (multiply-and-shift division, as the kernel's
    FastDiv) -> its table entry -> the physical flat block; the
    dequant gather's item -> its (position, group) row -> one scale.
    The mirror stands in for the C entry points, reading and writing the
    tensors' memory through the pointers the wrappers pass, so the
    wrappers' arguments are checked with it: every byte of the view is
    written exactly once, and the view equals the plain version's bit for
    bit, for every item width (copy 16, 8, 4, 2, 1 bytes; dequant 8, 4, 1
    codes into bfloat16 and 4, 1 into float32) and several ``lws``;
  * the wrappers' checks on a plan the tensors do not allow (meta
    tensors: nothing is built or launched).

The shapes' tables come from ``chip_smoke.py``'s ``gather_tables``, as
the card's checks draw them.

The CUDA kernels run only on the card: ``chip_smoke.py`` holds each
against its plain version there (``gather_shapes``).
"""

import ctypes
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.hw import GPU_REGISTRY
from repro_torch.core.mapper import (DEQUANT_WIDTHS, GATHER_THREADS,
                                     GATHER_WIDTHS, GatherPlan,
                                     gather_plan_for_block, gather_width,
                                     plan_gather)
from repro_torch.kernels import _build
from repro_torch.kernels import paged_gather as pg

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import gather_tables  # noqa: E402

H100 = GPU_REGISTRY["h100_sxm"]


# --------------------------------------------------------------------------- #
# the plan
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shape, es, width, gws, lws, grid", [
    ((8, 1024, 3, 64), 2, 16, 196_608, 1, 768),       # serving, bf16 copy
    ((8, 4096, 8, 128), 2, 16, 4_194_304, 16, 1024),  # large, bf16 copy
    ((8, 1024, 3, 64), 1, 8, 196_608, 1, 768),        # int8 -> bf16
    ((8, 4096, 8, 128), 1, 8, 4_194_304, 16, 1024),
    ((8, 1024, 3, 64), 1, 4, 393_216, 2, 768),        # int8 -> f32
    ((8, 4096, 8, 128), 1, 4, 8_388_608, 32, 1024),
])
def test_plan_gather_on_the_h100(shape, es, width, gws, lws, grid):
    """Copy items of 16 bytes, dequant items of the codes behind one
    16-byte store; ``lws = ceil(gws / 270,336)``, CTAs of 256 threads
    covering the view once, in one round at full residency."""
    size = int(np.prod(shape)) * es
    plan = plan_gather(size, width, H100)
    assert (plan.gws, plan.lws, plan.grid) == (gws, lws, grid)
    assert plan.threads == GATHER_THREADS and plan.rounds == 1
    assert plan.lws == -(-gws // H100.hp())


@pytest.mark.parametrize("lws", [0, 1, 3, 16, 1 << 20])
@pytest.mark.parametrize("size, width", [(3 * 2 ** 20, 16), (24, 8),
                                         (7, 1), (1000, 4)])
def test_gather_plan_for_block_bounds(size, width, lws):
    """The legaliser keeps ``lws`` in [1, ceil(gws / 256)] and the grid
    covering every item once, whatever ``lws`` a tuner proposes."""
    plan = gather_plan_for_block(size, width, H100, lws)
    gws = size // width
    assert plan.gws == gws and plan.width == width
    assert 1 <= plan.lws <= max(1, -(-gws // GATHER_THREADS))
    assert plan.lws == max(1, min(lws, -(-gws // GATHER_THREADS)))
    assert plan.grid == -(-gws // (GATHER_THREADS * plan.lws))
    assert (plan.grid - 1) * GATHER_THREADS * plan.lws < gws \
        <= plan.grid * GATHER_THREADS * plan.lws


@pytest.mark.parametrize("size, width", [(10, 4), (0, 1), (8, 0)])
def test_gather_plan_rejects_widths_that_do_not_divide(size, width):
    with pytest.raises(ValueError):
        gather_plan_for_block(size, width, H100, 1)


@pytest.mark.parametrize("unit, align, widths, want", [
    (6144, 256, GATHER_WIDTHS, 16), (6144, 2, GATHER_WIDTHS, 2),
    (12, 16, GATHER_WIDTHS, 4), (24, 16, GATHER_WIDTHS, 8),
    (6, 16, GATHER_WIDTHS, 2), (7, 16, GATHER_WIDTHS, 1),
    (64, 16, DEQUANT_WIDTHS[4], 4), (64, 16, DEQUANT_WIDTHS[2], 8),
    (100, 16, DEQUANT_WIDTHS[2], 4), (64, 2, DEQUANT_WIDTHS[2], 1),
    (64, 4, DEQUANT_WIDTHS[2], 4), (6, 16, DEQUANT_WIDTHS[2], 1),
    (100, 4, DEQUANT_WIDTHS[4], 4)])
def test_gather_width_is_the_widest_legal(unit, align, widths, want):
    assert gather_width(unit, align, widths) == want


def test_fast_div_is_floor_division():
    """The kernel's FastDiv, mirrored: exact for every n < 2^31."""
    rng = np.random.default_rng(0)
    n = np.concatenate([np.arange(4096), (1 << 31) - 1 - np.arange(64),
                        rng.integers(0, 1 << 31, 20_000)]).astype(np.uint64)
    for d in [1, 2, 3, 5, 7, 8, 12, 96, 384, 1000, 6144, 65_535, 65_537,
              (1 << 30) + 1, (1 << 31) - 1, 1 << 31]:
        np.testing.assert_array_equal(_div(n, d), n // np.uint64(d))


# --------------------------------------------------------------------------- #
# a mirror of csrc/paged_gather.cu, standing in for the C entry points
# --------------------------------------------------------------------------- #


def _fast_div(d):
    s = 0
    while (1 << s) < d:
        s += 1
    return ((((1 << s) - d) << 32) // d + 1), s


def _div(n, d):
    """n / d as the kernel's FastDiv computes it (n < 2^31)."""
    m, s = _fast_div(int(d))
    n = np.asarray(n, dtype=np.uint64)
    return (((n * np.uint64(m)) >> np.uint64(32)) + n) >> np.uint64(s)


def _memory(ptr, nbytes):
    return np.ctypeslib.as_array((ctypes.c_uint8 * nbytes).from_address(ptr))


def _items(gws, lws, grid):
    """Thread t of T = grid x 256 takes items t, t + T, ... (lws), each
    below gws; returns them in the order of (thread, step)."""
    t = np.arange(grid * GATHER_THREADS, dtype=np.int64)
    i = (t[:, None] + np.arange(lws)[None, :] * t.size).ravel()
    return i[i < gws].astype(np.uint64)


def _blocks(p, tables, b, nb, tw):
    """Logical pages p (b * nb + j) -> physical flat blocks."""
    row = _div(p, nb)
    pid = np.maximum(tables[(row * np.uint64(tw) + p - row * np.uint64(nb))
                            .astype(np.int64)], 0).astype(np.uint64)
    q = _div(pid, b)
    return (pid - q * np.uint64(b)) * np.uint64(nb) + q


class _Mirror:
    """The two C entry points, in Python: same arguments, same memory."""

    def __init__(self):
        self.writes = None
        self.calls = []

    def paged_gather(self, cache, tables, out, b, nb, tw, page_bytes, width,
                     lws, grid, stream):
        ipp = page_bytes // width
        gws = b * nb * ipp
        assert page_bytes % width == 0 and (cache | out) % width == 0
        assert grid * GATHER_THREADS * lws >= gws
        tab = _memory(tables, b * tw * 4).view(np.int32)
        i = _items(gws, lws, grid)
        p = _div(i, ipp)
        src = _blocks(p, tab, b, nb, tw) * np.uint64(ipp) + i \
            - p * np.uint64(ipp)
        e = np.arange(width, dtype=np.uint64)
        dst = (i[:, None] * np.uint64(width) + e).ravel().astype(np.int64)
        src = (src[:, None] * np.uint64(width) + e).ravel().astype(np.int64)
        n = gws * width
        self.writes = np.bincount(dst, minlength=n)
        _memory(out, n)[dst] = _memory(cache, n)[src]
        self.calls.append(("paged_gather", width, lws, grid))
        return 0

    def paged_dequant_gather(self, codes, scale, tables, out, b, nb, tw,
                             page, g, d, width, lws, grid, out_dtype, stream):
        ipp = page * g * d // width
        gws = b * nb * ipp
        es = 4 if out_dtype == 0 else 2
        assert width in DEQUANT_WIDTHS[es]
        assert d % width == 0 and codes % width == 0
        assert out % (width * es) == 0
        assert grid * GATHER_THREADS * lws >= gws
        tab = _memory(tables, b * tw * 4).view(np.int32)
        sc = _memory(scale, b * nb * g * 4).view(np.float32)
        i = _items(gws, lws, grid)
        p = _div(i, ipp)
        k = i - p * np.uint64(ipp)
        r = _div(k, d // width)
        grp = r - np.uint64(g) * _div(r, g)
        blk = _blocks(p, tab, b, nb, tw)
        e = np.arange(width, dtype=np.uint64)
        src = ((blk * np.uint64(ipp) + k)[:, None] * np.uint64(width) + e)
        dst = (i[:, None] * np.uint64(width) + e).ravel().astype(np.int64)
        n = gws * width
        x = _memory(codes, n).view(np.int8)[src.ravel().astype(np.int64)]
        s = sc[(blk * np.uint64(g) + grp).astype(np.int64)]
        dt = (torch.float32, torch.bfloat16)[out_dtype]
        s = torch.from_numpy(s).to(dt).float().repeat_interleave(width)
        vals = (torch.from_numpy(x).float() * s).to(dt)
        self.writes = np.bincount(dst, minlength=n)
        es = vals.element_size()
        view = _memory(out, n * es).view(np.uint16 if es == 2 else np.uint32)
        view[dst] = vals.view(torch.int16 if es == 2 else torch.int32) \
            .numpy().view(view.dtype)
        self.calls.append(("paged_dequant_gather", width, lws, grid))
        return 0


@pytest.fixture
def mirror(monkeypatch):
    """The wrappers' kernel path on CPU tensors, the library replaced by
    the mirror (nothing is built or launched)."""
    m = _Mirror()
    monkeypatch.setattr(kernels, "use_plain",
                        lambda t: kernels._mode == "plain")
    monkeypatch.setattr(_build, "load", lambda name: types.SimpleNamespace(
        paged_gather=lambda *a: m.paged_gather(*a),
        paged_dequant_gather=lambda *a: m.paged_dequant_gather(*a)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(pg, "detect", lambda device: H100)
    pg._auto_plan.cache_clear()
    yield m
    pg._auto_plan.cache_clear()


def _tables(rng, b, nb):
    """``chip_smoke.gather_tables``: ids drawn with repeats and -1, 2
    columns past nb."""
    return torch.from_numpy(gather_tables(rng, b, nb))


def _offset(x, nbytes):
    """``x``'s values in a contiguous slice ``nbytes`` past the start of
    a larger buffer."""
    es = x.element_size()
    buf = torch.empty(x.numel() + nbytes // es + 16, dtype=x.dtype)
    base = (-buf.data_ptr() % 16) // es          # the buffer's first 16 B
    out = buf[base + nbytes // es:][:x.numel()].view(x.shape)
    out.copy_(x)
    return out


# (B, T, G, D, page, dtype, bytes off 16) -> the copy's item width
COPY_CASES = [
    ((8, 64, 3, 64, 16), torch.bfloat16, 0, 16),
    ((2, 8, 1, 6, 1), torch.float32, 0, 8),
    ((2, 8, 1, 6, 1), torch.bfloat16, 0, 4),
    ((3, 64, 8, 100, 8), torch.bfloat16, 2, 2),
    ((2, 8, 1, 6, 1), torch.int8, 1, 1),
    ((4, 32, 1, 6, 32), torch.float32, 4, 4),
    ((1, 96, 8, 32, 32), torch.bfloat16, 0, 16),
]


@pytest.mark.parametrize("lws", [None, 1, 3, 16])
@pytest.mark.parametrize("case", COPY_CASES, ids=[
    f"{str(c[1]).split('.')[1]}-off{c[2]}-w{c[3]}" for c in COPY_CASES])
def test_copy_map_writes_every_byte_once(case, lws, mirror):
    """The copy under the wrapper's plan (None) or a legalised ``lws``:
    every byte of the view written once and the view equal to the plain
    version's, bit for bit; the width is the widest the page and the
    pointers allow."""
    (b, t, g, d, pb), dtype, off, width = case
    rng = np.random.default_rng(t + d)
    x = torch.from_numpy(rng.standard_normal((b, t, g, d))).to(dtype) \
        if dtype.is_floating_point else torch.from_numpy(
            rng.integers(-127, 128, (b, t, g, d)).astype(np.int8))
    cache = _offset(x, off)
    tables = _tables(rng, b, t // pb)
    size = x.numel() * x.element_size()
    plan = None if lws is None else gather_plan_for_block(size, width, H100,
                                                          lws)
    got = pg.paged_gather(cache, tables, pb, plan=plan)
    assert mirror.calls[-1][1] == width
    assert pg.paged_gather.last_plan.width == width
    assert pg.paged_gather.last_grid == (pg.paged_gather.last_plan.grid,)
    np.testing.assert_array_equal(mirror.writes, np.ones(size, np.int64))
    with kernels.force("plain"):
        want = pg.paged_gather(cache, tables, pb)
    assert torch.equal(got, want)


# (B, T, G, D, page), codes' bytes off 16 -> the item's codes for a
# bfloat16 and a float32 output
DEQUANT_CASES = [
    ((8, 64, 3, 64, 16), 0, 8, 4),
    ((2, 32, 2, 24, 16), 8, 8, 4),
    ((3, 64, 8, 100, 8), 0, 4, 4),
    ((1, 96, 8, 32, 32), 4, 4, 4),
    ((1, 96, 8, 32, 32), 2, 1, 1),
    ((2, 8, 1, 6, 1), 0, 1, 1),
    ((4, 32, 1, 6, 32), 1, 1, 1),
]


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lws", [None, 1, 5])
@pytest.mark.parametrize("case", DEQUANT_CASES, ids=[
    f"D{c[0][3]}-off{c[1]}" for c in DEQUANT_CASES])
def test_dequant_map_writes_every_value_once(case, lws, out, mirror):
    """The dequant gather: the codes behind one 16-byte store an item
    where D and the codes' pointer allow it, one scale an item (its
    (position, group) row), every output written once, equal to the
    plain version bit for bit."""
    (b, t, g, d, pb), off, w_bf16, w_f32 = case
    width = w_bf16 if out == torch.bfloat16 else w_f32
    rng = np.random.default_rng(t + d + 1)
    codes = _offset(torch.from_numpy(
        rng.integers(-127, 128, (b, t, g, d)).astype(np.int8)), off)
    scale = torch.from_numpy(rng.uniform(1e-3, 0.05, (b, t // pb, g))
                             .astype(np.float32))
    tables = _tables(rng, b, t // pb)
    plan = None if lws is None else gather_plan_for_block(codes.numel(),
                                                          width, H100, lws)
    got = pg.paged_dequant_gather(codes, scale, tables, pb, out_dtype=out,
                                  plan=plan)
    assert mirror.calls[-1][1] == width
    np.testing.assert_array_equal(mirror.writes,
                                  np.ones(codes.numel(), np.int64))
    with kernels.force("plain"):
        want = pg.paged_dequant_gather(codes, scale, tables, pb,
                                       out_dtype=out)
    assert got.dtype == out and torch.equal(got, want)


@pytest.mark.parametrize("width, out", [
    (w, out) for out in (torch.float32, torch.bfloat16)
    for w in DEQUANT_WIDTHS[out.itemsize]])
def test_dequant_map_at_every_plan_width(width, out, mirror):
    """Every legal item width of each output under a given plan (the
    tuner's space): at most the codes behind one 16-byte store."""
    b, t, g, d, pb = 2, 32, 2, 32, 16
    rng = np.random.default_rng(width)
    codes = torch.from_numpy(rng.integers(-127, 128, (b, t, g, d))
                             .astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-3, 0.05, (b, t // pb, g))
                             .astype(np.float32))
    tables = _tables(rng, b, t // pb)
    plan = gather_plan_for_block(codes.numel(), width, H100, 3)
    got = pg.paged_dequant_gather(codes, scale, tables, pb, out_dtype=out,
                                  plan=plan)
    assert mirror.calls[-1][1:] == (width, plan.lws, plan.grid)
    np.testing.assert_array_equal(mirror.writes,
                                  np.ones(codes.numel(), np.int64))
    with kernels.force("plain"):
        want = pg.paged_dequant_gather(codes, scale, tables, pb,
                                       out_dtype=out)
    assert torch.equal(got, want)


# --------------------------------------------------------------------------- #
# the wrappers' checks on a plan
# --------------------------------------------------------------------------- #


def _meta_pool(dtype=torch.bfloat16, shape=(2, 32, 2, 8)):
    b, t = shape[:2]
    return (torch.zeros(shape, dtype=dtype, device="meta"),
            torch.zeros(b, t // 16, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("case", ["width", "not_a_width", "items", "cover",
                                  "threads", "type", "dequant_width",
                                  "dequant_d", "dequant_items",
                                  "dequant_16", "dequant_f32_8"])
def test_gather_wrappers_reject_a_plan_the_tensors_do_not_allow(case):
    cache, tables = _meta_pool()
    size = cache.numel() * cache.element_size()      # pages of 512 bytes
    good = plan_gather(size, 16, H100)
    with pytest.raises(ValueError):
        if case == "width":          # 16 bytes on pages of 6
            c1, t1 = _meta_pool(shape=(2, 4, 1, 3))
            pg.paged_gather(c1, t1.new_zeros(2, 4), 1, plan=GatherPlan(
                width=16, gws=3, lws=1, threads=256, grid=1, rounds=1))
        elif case == "not_a_width":  # 32 divides the page, but is no width
            pg.paged_gather(cache, tables, 16, plan=gather_plan_for_block(
                size, 32, H100, 1))
        elif case == "items":        # the plan of another view
            pg.paged_gather(cache, tables, 16,
                            plan=plan_gather(2 * size, 16, H100))
        elif case == "cover":        # too few threads for the items
            pg.paged_gather(cache, tables, 16, plan=GatherPlan(
                width=16, gws=good.gws, lws=1, threads=256, grid=0,
                rounds=1))
        elif case == "threads":
            pg.paged_gather(cache, tables, 16, plan=GatherPlan(
                width=16, gws=good.gws, lws=good.lws, threads=128,
                grid=good.grid, rounds=1))
        elif case == "type":
            pg.paged_gather(cache, tables, 16, plan=(16, good.gws, 1, 256,
                                                     good.grid, 1))
        else:
            codes, tab = _meta_pool(torch.int8, (2, 32, 2, 12))
            sc = torch.zeros(2, 2, 2, device="meta")
            n = codes.numel()
            out = torch.bfloat16
            if case in ("dequant_16", "dequant_f32_8"):
                # D 32 takes both, but their stores pass 16 bytes
                codes, tab = _meta_pool(torch.int8, (2, 32, 2, 32))
                n = codes.numel()
                if case == "dequant_f32_8":
                    out = torch.float32
            plan = {"dequant_width": gather_plan_for_block(n, 2, H100, 1),
                    "dequant_d": gather_plan_for_block(n, 8, H100, 1),
                    "dequant_items": plan_gather(n // 2, 4, H100),
                    "dequant_16": gather_plan_for_block(n, 16, H100, 1),
                    "dequant_f32_8": gather_plan_for_block(n, 8, H100, 1),
                    }[case]
            pg.paged_dequant_gather(codes, sc, tab, 16, out_dtype=out,
                                    plan=plan)
