"""The split-KV decode sweep (``csrc/decode_sweep.cuh``) on the CPU: its
plan and a plain model of its schedule.

  * the mapper's split width W (``plan_decode_split``): a whole number of
    ``block_s`` and of pages, splits that cover the row, shared memory
    that fits, AUTO's grid covering the SMs when the row allows, NAIVE /
    FIXED / AUTO as specified, and wider splits on a card with fewer SMs;
  * a plain model of the kernel's schedule — each (row, group, split)
    CTA's positions cut into the kernel's chunks and lane groups, each
    group's partial (m, l, acc), the groups merged, then the live splits
    merged as the last CTA to finish does — held against the JAX
    package's Pallas kernels in interpret mode (``pallas_decode_attention``
    for contiguous rows, ``paged_decode_attention_pallas`` for the paged
    pool, fp and int8 codes), over ragged lengths 0, 1, T and T + 5 and
    splits past a row's length;
  * the wrappers on CPU tensors: the plain version whatever the split,
    no launch counted, and no call without a split; the merge's scratch
    kept per (device, stream); the split checks, run once per plan by
    the router; the router's split in the engine's report.

The CUDA kernels run only on the card: ``chip_smoke.py`` holds each
against its plain version there, at the serving shape and at the odd
shapes of its ``DECODE_SHAPES``.

Tolerance: atol = rtol = 1e-5 in float32 (summation order only).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.paged_decode_attention import paged_decode_attention_pallas
from repro.models.attention import pallas_decode_attention

from repro_torch.configs import get_config
from repro_torch.core.hw import GPU_REGISTRY, ceil_div, round_up
from repro_torch.core.mapper import (DECODE_THREADS, decode_chunk,
                                     decode_ctas_per_sm, decode_smem_bytes,
                                     decode_splits, plan_cache_block,
                                     plan_decode_split, plan_paged_block)
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.profiler import TraceStore, set_default_store
from repro_torch.serve import ServeEngine
from repro_torch.tuner import TuningCache as PortTuningCache
from repro_torch.tuner import set_default_cache

TOL = dict(atol=1e-5, rtol=1e-5)
H100 = GPU_REGISTRY["h100_sxm"]
CPU = GPU_REGISTRY["cpu"]


# --------------------------------------------------------------------------- #
# the plan
# --------------------------------------------------------------------------- #

@pytest.fixture(autouse=True)
def _memory_tuner():
    """The engine's TUNED plans from a memory-only cache and trace store:
    no test reads or writes the checkout's files."""
    set_default_cache(PortTuningCache(path=None))
    set_default_store(TraceStore(path=None))
    yield
    set_default_cache(None)
    set_default_store(None)



@pytest.mark.parametrize("t", [1, 17, 512, 1024, 4096, 32768])
@pytest.mark.parametrize("page", [None, 16, 32])
def test_split_plan_is_legal(t, page):
    """Every policy's W is a whole number of block_s (of pages on the
    paged path), at most the row rounded up to it; its splits cover the
    row; the sweep's shared memory fits the block and leaves room for a
    CTA on an SM."""
    for hw in (H100, CPU):
        for policy in ("naive", "fixed", "auto"):
            for rows in (1, 24, 256):
                if page is None:
                    bs = plan_cache_block(t, 64, hw, policy, 3)
                else:
                    bs = plan_paged_block(t, 64, page, hw, 3)
                w = plan_decode_split(t, rows, bs, 64, hw, policy, 3, page)
                n = decode_splits(t, w)
                assert w % bs == 0 and bs <= w <= round_up(t, bs)
                if page is not None:
                    assert w % page == 0
                assert (n - 1) * w < t <= n * w
                smem = decode_smem_bytes(64, 3, page)
                assert smem <= min(hw.smem_per_block, 48 * 1024)
                assert decode_ctas_per_sm(64, 3, hw, page) >= 1


def test_split_policies_differ():
    """NAIVE sweeps the row whole (one split), FIXED takes the JAX
    package's 512 positions, AUTO is Eq. 1: rows x T over the resident
    CTA slots (132 SMs x 4, the kernels' register bound, at the serving
    shape) rounded up to block_s."""
    t, rows = 4096, 24
    plans = {p: plan_decode_split(t, rows, 16, 64, H100, p, 3, 16)
             for p in ("naive", "fixed", "auto")}
    slots = H100.sm_count * decode_ctas_per_sm(64, 3, H100, 16)
    assert slots == 132 * 4
    assert plans == {"naive": 4096, "fixed": 512,
                     "auto": round_up(ceil_div(rows * t, slots), 16)}
    # the serving shape: 8 slots x 3 groups over a 1024 pool
    assert plan_decode_split(1024, 24, 16, 64, H100, "auto", 3, 16) == 48
    assert decode_splits(1024, 48) * 24 == 528 == slots
    # FIXED and AUTO never exceed the row
    assert plan_decode_split(100, 24, 16, 64, H100, "fixed", 3) == 112


@pytest.mark.parametrize("t", [256, 1024, 8192])
def test_auto_split_covers_the_sms(t):
    """AUTO's grid gives every SM a CTA when the row has enough blocks
    to cut (rows x ceil(T / block_s) at least the SM count)."""
    for hw in (H100, CPU):
        for rows in (3, 24, 96):
            bs = plan_paged_block(t, 64, 16, hw, 3)
            w = plan_decode_split(t, rows, bs, 64, hw, "auto", 3, 16)
            ctas = rows * decode_splits(t, w)
            if rows * ceil_div(t, bs) >= hw.sm_count:
                assert ctas >= hw.sm_count
            slots = hw.sm_count * decode_ctas_per_sm(64, 3, hw, 16)
            assert ctas <= max(slots + rows, rows * ceil_div(t, bs))


def test_split_reads_the_sm_count():
    """The plan reads ``sm_count``: a card with fewer SMs (or less shared
    memory an SM) gets wider splits for the same work."""
    small = dataclasses.replace(H100, sm_count=33)
    wide = plan_decode_split(4096, 24, 16, 64, small, "auto", 3, 16)
    narrow = plan_decode_split(4096, 24, 16, 64, H100, "auto", 3, 16)
    assert wide > narrow and wide % 16 == 0
    lean = dataclasses.replace(H100, smem_per_sm=70_000)
    assert decode_ctas_per_sm(64, 3, lean, 16) == 2
    assert plan_decode_split(4096, 24, 16, 64, lean, "auto", 3, 16) > narrow
    assert plan_decode_split(1024, 24, 16, 64, CPU, "auto", 3, 16) == 768


def test_decode_smem_follows_the_sweep_layout():
    """Ring of 4 stages of K and V rows (rows padded to 4 values) in the
    cache's dtype, on the paged path 5 page slots of 12 bytes and two
    scales beside each staged row, and the merge area that aliases them;
    a stage holds at most 32 positions and 4 KB of K, whatever block_s.
    The planner's count (no dtype) is the most over the three."""
    assert decode_chunk(64, 4) == 16 and decode_chunk(64, 2) == 32
    assert decode_chunk(128, 4) == 8 and decode_chunk(128, 2) == 16
    assert decode_chunk(6, 1) == 32
    # f32, D 64, 16 positions: 4 x 2 x 16 x 64 x 4 B
    assert decode_smem_bytes(64, 3, cache_bytes=4) == 32768
    # + 5 slots x 2 pages x 12 B + 4 stages x 16 rows x 8 B
    assert decode_smem_bytes(64, 3, 16, cache_bytes=4) == 32768 + 120 + 512
    # bf16: 32 positions of 128 B, 3 pages a chunk
    bf16 = 32768 + 180 + 1024
    assert decode_smem_bytes(64, 3, 16, cache_bytes=2) == bf16
    assert decode_smem_bytes(64, 3, 16) == bf16
    # int8 codes at D 64, R 8: 32 positions of 64 B against the merge
    # area, 8 groups of 16 lanes x 8 heads x (64 + 2) floats
    assert decode_smem_bytes(64, 8, 16, cache_bytes=1) == max(
        16384 + 180 + 1024, 4 * 8 * 8 * 66)
    # D 6 pads its rows to 8 values; lanes 2, groups 64
    assert decode_smem_bytes(6, 1, cache_bytes=4) == max(
        4 * 2 * 32 * 8 * 4, 4 * 1 * 64 * 10)
    for d in (1, 6, 64, 100, 128):
        for r in (1, 8):
            assert decode_smem_bytes(d, r, 1) < 48 * 1024


# --------------------------------------------------------------------------- #
# a plain model of the kernel's schedule
# --------------------------------------------------------------------------- #


def _partial(s, v):
    """(m, l, acc) of scores s (n, R) over values v (n, D); empty -> the
    identity (-inf, 0, 0)."""
    r, d = s.shape[1], v.shape[1]
    if s.shape[0] == 0:
        return (torch.full((r,), float("-inf"), dtype=torch.float64),
                torch.zeros(r, dtype=torch.float64),
                torch.zeros(r, d, dtype=torch.float64))
    m = s.amax(0)
    p = torch.exp(s - m)
    return m, p.sum(0), p.T @ v


def _merge(parts):
    """The kernel's merge: m* = max m_i, l = sum l_i e^(m_i - m*), acc =
    sum acc_i e^(m_i - m*); a part at m = -inf weighs 0."""
    ms = torch.stack([m for m, _, _ in parts])
    mx = ms.amax(0)
    w = torch.where(torch.isinf(ms), 0.0, torch.exp(ms - mx))
    l = sum(wi * li for wi, (_, li, _) in zip(w, parts))
    acc = sum(wi[:, None] * ai for wi, (_, _, ai) in zip(w, parts))
    return mx, l, acc


def split_schedule(q, k, v, clen, *, block_s, split, scale=None,
                   tables=None, page_block=None, k_scale=None, v_scale=None):
    """Model of ``decode_sweep::sweep``'s schedule in float64: CTA (b, g,
    s) sweeps positions [s W, min((s + 1) W, clen)) (clen clamped to
    T), in chunks of ``decode_chunk`` positions, position i of a chunk
    going to lane group i % (128 / lp); paged rows resolve each page
    through the table to its flat block (pid % B) nb + pid / B, int8
    codes dequantise by that block's group scale.  Each group's partial,
    the groups merged, then the live splits merged; clen 0 gives
    zeros."""
    b, t, g, d = k.shape
    r = q.shape[2]
    scale = d ** -0.5 if scale is None else scale
    es = k.element_size()
    chunk = decode_chunk(d, es)
    lanes = 1
    while lanes * 4 < d:
        lanes *= 2
    ng = DECODE_THREADS // lanes
    n_split = decode_splits(t, split)
    qf = q.double() * scale
    kf, vf = k.double(), v.double()
    out = torch.zeros(b, g, r, d, dtype=torch.float64)
    for bi in range(b):
        n = max(0, min(int(clen[bi]), t))
        pos = torch.arange(n)
        if tables is None:
            flat = bi * t + pos
        else:
            nb = t // page_block
            pid = tables[bi, pos // page_block].long().clamp_min(0)
            blk = (pid % b) * nb + pid // b
            flat = blk * page_block + pos % page_block
        for gi in range(g):
            kr = kf.reshape(b * t, g, d)[flat, gi]
            vr = vf.reshape(b * t, g, d)[flat, gi]
            if k_scale is not None:
                kr = kr * k_scale.reshape(-1, g)[flat // page_block, gi,
                                                 None].double()
                vr = vr * v_scale.reshape(-1, g)[flat // page_block, gi,
                                                 None].double()
            s_all = kr @ qf[bi, gi].T                       # (n, R)
            parts = []
            for sp in range(n_split):
                lo, hi = sp * split, min((sp + 1) * split, n)
                if lo >= hi:
                    continue                   # a split past clen: nothing
                rel = torch.arange(hi - lo)
                group = (rel % chunk) % ng
                parts.append(_merge([
                    _partial(s_all[lo:hi][group == i], vr[lo:hi][group == i])
                    for i in range(ng)]))
            if parts:
                _, l, acc = _merge(parts)
                out[bi, gi] = acc / l.clamp_min(1e-30)[:, None]
    return out.float()


def _tables(rng, b, t, pb, clen):
    nb = t // pb
    perm = list(rng.permutation(b * nb))
    tables = np.full((b, nb + 1), -1, np.int32)
    for i in range(b):
        for j in range(-(-min(int(clen[i]), t) // pb)):
            tables[i, j] = perm.pop()
    return tables


#: (B, T, G, R, D, page, block_s, split, lengths): lengths 0, 1, T, T + 5
#: and splits that start past a row's length
SCHEDULES = [
    (4, 64, 2, 2, 16, 16, 16, 16, (0, 1, 64, 69)),
    (4, 96, 1, 3, 32, 16, 32, 64, (96, 1, 0, 50)),
    (3, 128, 2, 1, 8, 8, 16, 48, (101, 128, 133)),
    (2, 64, 3, 4, 6, 16, 16, 64, (64, 9)),
]


@pytest.mark.parametrize("case", range(len(SCHEDULES)))
def test_split_schedule_matches_the_pallas_decode(case):
    """Contiguous rows: the schedule model equals the Pallas decode
    kernel (interpret, lengths clamped to T as the port's sweep takes
    them) and the plain version at any split."""
    b, t, g, r, d, _, bs, w, lens = SCHEDULES[case]
    rng = np.random.default_rng(case)
    q = rng.standard_normal((b, g, r, d)).astype(np.float32)
    k = rng.standard_normal((b, t, g, d)).astype(np.float32)
    v = rng.standard_normal((b, t, g, d)).astype(np.float32)
    clen = np.array(lens, np.int32)
    tq, tk, tv, tc = (torch.from_numpy(a) for a in (q, k, v, clen))
    got = split_schedule(tq, tk, tv, tc, block_s=bs, split=w).numpy()
    pal = np.asarray(pallas_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(np.minimum(clen, t)), block=bs, interpret=True))
    np.testing.assert_allclose(got, pal, **TOL)
    plain = da.decode_attention(tq, tk, tv, tc, block_s=bs, split=w)
    np.testing.assert_allclose(plain.numpy(), got, **TOL)
    assert not got[np.array(lens) == 0].any() and np.isfinite(got).all()


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("case", range(len(SCHEDULES)))
def test_split_schedule_matches_the_pallas_paged_decode(case, quant):
    """The paged pool (fp caches and int8 codes with per-(page, group)
    scales): the schedule model, pages resolved through the table,
    equals ``paged_decode_attention_pallas`` (interpret) and the plain
    version at any split."""
    b, t, g, r, d, pb, bs, w, lens = SCHEDULES[case]
    rng = np.random.default_rng(10 + case)
    clen = np.array(lens, np.int32)
    tables = _tables(rng, b, t, pb, clen)
    q = rng.standard_normal((b, g, r, d)).astype(np.float32)
    scales = {}
    if quant:
        k = rng.integers(-127, 128, (b, t, g, d)).astype(np.int8)
        v = rng.integers(-127, 128, (b, t, g, d)).astype(np.int8)
        for key in ("k_scale", "v_scale"):
            scales[key] = rng.uniform(0.001, 0.05,
                                      (b, t // pb, g)).astype(np.float32)
    else:
        k = rng.standard_normal((b, t, g, d)).astype(np.float32)
        v = rng.standard_normal((b, t, g, d)).astype(np.float32)
    ts = {key: torch.from_numpy(a) for key, a in scales.items()}
    tq, tk, tv, tt, tc = (torch.from_numpy(a)
                          for a in (q, k, v, tables, clen))
    got = split_schedule(tq, tk, tv, tc, block_s=bs, split=w, tables=tt,
                         page_block=pb, **ts).numpy()
    pal = np.asarray(paged_decode_attention_pallas(
        *(jnp.asarray(a) for a in (q, k, v, tables, clen)), page_block=pb,
        block_s=bs, interpret=True,
        **{key: jnp.asarray(a) for key, a in scales.items()}))
    np.testing.assert_allclose(got, pal, **TOL)
    plain = pda.paged_decode_attention(tq, tk, tv, tt, tc, page_block=pb,
                                       block_s=bs, split=w, **ts)
    np.testing.assert_allclose(plain.numpy(), got, **TOL)
    assert not got[np.array(lens) == 0].any() and np.isfinite(got).all()


def test_schedule_is_the_same_function_at_every_split():
    """One split (NAIVE), FIXED's 512 and AUTO's width give the same
    output up to the order of the sums."""
    b, t, g, r, d, pb = 3, 1024, 2, 3, 64, 16
    rng = np.random.default_rng(5)
    clen = torch.tensor([1024, 700, 3], dtype=torch.int32)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, g, r, d), (b, t, g, d), (b, t, g, d)))
    tables = torch.from_numpy(_tables(rng, b, t, pb, clen.numpy()))
    outs = [split_schedule(q, k, v, clen, block_s=16, split=w,
                           tables=tables, page_block=pb)
            for w in (plan_decode_split(t, b * g, 16, d, H100, p, r, pb)
                      for p in ("naive", "fixed", "auto"))]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), **TOL)


# --------------------------------------------------------------------------- #
# the wrappers and the engine
# --------------------------------------------------------------------------- #


def _launches():
    return (da.decode_attention.launches, pda.paged_decode_attention.launches,
            pda.paged_decode_attention.int8_launches)


@pytest.mark.parametrize("split", [None, 16, 64])
def test_cpu_tensors_take_the_plain_version_at_any_split(split):
    """On CPU tensors the wrappers run the plain version (which the
    split does not change) and count no launch."""
    rng = np.random.default_rng(1)
    b, t, g, r, d, pb = 2, 64, 2, 2, 16, 16
    clen = np.array([64, 5], np.int32)
    tables = _tables(rng, b, t, pb, clen)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((b, g, r, d), (b, t, g, d), (b, t, g, d)))
    tt, tc = torch.from_numpy(tables), torch.from_numpy(clen)
    codes = torch.zeros(k.shape, dtype=torch.int8)
    sc = torch.ones(b, t // pb, g)
    before = _launches()
    got = da.decode_attention(q, k, v, tc, block_s=16, split=split)
    want = da.decode_attention_plain(q, k, v, tc, block_s=16)
    assert torch.equal(got, want)
    got = pda.paged_decode_attention(q, k, v, tt, tc, page_block=pb,
                                     block_s=16, split=split)
    want = pda.paged_decode_attention_plain(q, k, v, tt, tc, page_block=pb,
                                            block_s=16)
    assert torch.equal(got, want)
    pda.paged_decode_attention(q, codes, codes, tt, tc, page_block=pb,
                               block_s=16, split=split, k_scale=sc,
                               v_scale=sc)
    assert _launches() == before


def test_split_checks_raise():
    """A split must be a whole number of block_s and cut the row into at
    most 65,535 splits (the grid's z extent)."""
    assert da.check_split(1024, 16, 32) == 32
    assert da.check_split(1000, 16, 2048) == 1
    for bad in (8, 24, 40):
        with pytest.raises(ValueError):
            da.check_split(1024, 16, bad)
    with pytest.raises(ValueError):
        da.check_split(16 * 65536, 16, 16)


def test_ops_decode_attention_plans_the_split_per_policy(monkeypatch):
    """``ops.decode_attention`` hands the kernel the policy's split:
    NAIVE the whole row, FIXED 512, AUTO Eq. 1."""
    seen = []
    real = da.decode_attention

    def spy(*a, **kw):
        seen.append((kw["block_s"], kw["split"]))
        return real(*a, **kw)

    monkeypatch.setattr(da, "decode_attention", spy)
    q = torch.zeros(4, 3, 16)
    k = torch.zeros(4, 3, 2048, 16)
    for policy in ("naive", "fixed", "auto"):
        ops.decode_attention(q, k, k, policy=policy, hw=H100)
    (nb, nw), (fb, fw), (ab, aw) = seen
    assert nw == 2048 and fw == 512 and (fb, nb) == (512, 16)
    assert aw == plan_decode_split(2048, 12, ab, 16, H100)


@pytest.mark.parametrize("opts", [{}, {"paged": False}],
                         ids=["fused", "contiguous"])
def test_engine_reports_the_split_it_ran(opts):
    """The router's plan carries the split; the engine records, per pool
    length, the split of the read it ran beside its block_s."""
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              dtype="float32")
    eng = ServeEngine(cfg, slots=2, max_len=64, device="cpu",
                      prefill_chunk=None, **opts)
    for n in (5, 40):
        eng.submit(list(range(1, n + 1)), max_new_tokens=3)
    rep = eng.run()
    fused = not opts
    blocks = rep.paged_decode_blocks if fused else rep.decode_blocks
    splits = rep.paged_decode_splits if fused else rep.decode_splits
    assert blocks and splits.keys() == blocks.keys()
    assert not (rep.decode_splits if fused else rep.paged_decode_splits)
    for kv_len, w in splits.items():
        assert w % blocks[kv_len] == 0
        da.check_split(kv_len, blocks[kv_len], w)
        # the router's plan for the bucket (TUNED, the engine's default)
        plan = eng.router.resolve(eng.router.bucket(kv_len))
        assert (blocks[kv_len], w) == (
            (plan.paged_decode_block, plan.paged_decode_split) if fused
            else (plan.decode_block, plan.decode_split))


def test_wrappers_require_the_split():
    """The split is the mapper's output, passed like ``block_s``: a
    wrapper given none raises instead of planning one itself."""
    q = torch.zeros(1, 1, 1, 16)
    k = torch.zeros(1, 32, 1, 16)
    clen = torch.ones(1, dtype=torch.int32)
    tables = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(TypeError):
        da.decode_attention(q, k, k, clen, block_s=16)
    with pytest.raises(TypeError):
        pda.paged_decode_attention(q, k, k, tables, clen, page_block=16,
                                   block_s=16)


def test_split_buffers_are_kept_per_stream(monkeypatch):
    """The merge's tickets (zeroed) and partials workspace are allocated
    once per (device, stream) and reallocated only when a launch needs
    more; another stream gets its own."""
    monkeypatch.setattr(da, "_SCRATCH", {})
    q = torch.zeros(8, 3, 3, 64)
    ws, tickets = da.split_buffers(q, 22, stream=7)
    assert ws.dtype == torch.float32 and tickets.dtype == torch.int32
    assert ws.numel() >= 8 * 3 * 22 * 3 * 66 and tickets.numel() >= 24
    assert not tickets.any()
    again = da.split_buffers(q, 4, stream=7)
    assert again[0] is ws and again[1] is tickets
    big = da.split_buffers(torch.zeros(8, 3, 8, 128), 528, stream=7)
    assert big[0].numel() >= 8 * 3 * 528 * 8 * 130 and big[1] is tickets
    other = da.split_buffers(q, 22, stream=9)
    assert other[0] is not big[0] and other[1] is not tickets


def test_router_checks_the_split_it_plans(monkeypatch):
    """The kernels' split checks run once per bucket plan, in the
    router's resolution (the tuner's decode plans): a split that is not
    a whole number of block_s is refused there, before any launch."""
    from repro_torch.serve import buckets
    from repro_torch.tuner import TuningCache, dispatch

    cfg = get_config("smollm-135m")
    router = buckets.BucketRouter(cfg, buckets.BucketSpec(), slots=8,
                                  hw=H100, page_block=16,
                                  cache=TuningCache(path=None))
    plan = router.resolve(buckets.Bucket(slots=8, kv_len=1024))
    assert plan.decode_split % plan.decode_block == 0
    assert plan.paged_decode_split % plan.paged_decode_block == 0
    monkeypatch.setattr(dispatch, "plan_decode_split",
                        lambda t, rows, block, *a, **kw: block + 8)
    fresh = buckets.BucketRouter(cfg, buckets.BucketSpec(), slots=8,
                                 hw=H100, page_block=16,
                                 cache=TuningCache(path=None))
    with pytest.raises(ValueError):
        fresh.resolve(buckets.Bucket(slots=8, kv_len=1024))
