"""nn_search's tensor-core kernel (``csrc/nn_search.cu``) on the CPU: a
plain model of its schedule, and its operands.

  * the model: the prep pass's norms (+inf past the refs, so a padded ref
    never wins) and K-major sources; the dots a K step at a time (float32
    as three TF32 products from the split halves, each step's partial
    added to an f32 sum); ``d^2 = (|q|^2 - 2 s) + |r|^2`` over the plan's
    query and ref tiles padded to whole tiles; each quad lane's running
    ``(min, argmin)`` over its columns of each ref tile of a split, in
    ascending order with a strict "<"; the quad's lexicographic minimum;
    the splits' partials merged in ascending order with a strict "<", as
    the last CTA of a query tile does.  Held against the JAX package's
    ``nn_search_pallas`` in interpret mode under each policy, on shapes
    that no tile divides and plans of several splits;
  * ties across a split boundary (exact copies of a ref at the end of one
    split and the start of the next, and at the end of the last), a
    negative ``d^2`` kept as it is, and padded refs that never win;
  * the prep pass's layout: the f32 split of Q and R against
    ``kernels/matmul.py::tf32_split_plain``, K padded with zeros, the
    bf16 copy or the inputs in place, and the norms;
  * 3xTF32 dots within ``NN_DIST_TOL`` of the float32 plain version where
    one TF32 product is not.

The CUDA kernels run only on the card: ``chip_smoke.py`` holds each
against its plain version there, with its own check of ties across
splits (``nn_split_ties``).

Tolerances: idx equal (seeded normal inputs have no near-ties at these
sizes; the built ties are exact); dist within ``NN_DIST_TOL`` = 2^-18 of
(max |q|^2 + max |r|^2), ``chip_smoke.py``'s tolerance: the cancellation
in ``|q|^2 - 2 q.r + |r|^2`` leaves an error of the norms' size.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.hw import TPU_REGISTRY
from repro.core.mapper import MappingPolicy as JaxPolicy
from repro.kernels.nn_search import nn_search_pallas

from repro_torch.core.hw import GPU_REGISTRY, round_up
from repro_torch.core.mapper import plan_nn
from repro_torch.kernels import nn_search as nn
from repro_torch.kernels.matmul import tf32_split_plain

TPU = TPU_REGISTRY["cpu_sim"]
H100 = GPU_REGISTRY["h100_sxm"]
POLICIES = ["naive", "fixed", "auto"]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
NN_DIST_TOL = 2.0 ** -18
F32 = np.float32


def _pair(a: np.ndarray, dtype: str):
    """The same values as a torch tensor and a JAX array in ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    t = torch.from_numpy(np.ascontiguousarray(a, F32)).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


def _tol(q: torch.Tensor, r: torch.Tensor) -> float:
    qf, rf = q.float(), r.float()
    return NN_DIST_TOL * float((qf * qf).sum(-1).max()
                               + (rf * rf).sum(-1).max())


def model(q: torch.Tensor, r: torch.Tensor, plan):
    """The kernel's schedule on the plain prep pass's operands:
    ``(idx, dist)`` as the product computes them."""
    (nq, d), nr = q.shape, r.shape[0]
    ws, norms = nn.prep(q, r, plan)
    mode, kp = nn.layout(q, r)
    nq_pad, nr_pad = plan.grid[0] * plan.bm, round_up(nr, plan.bn)
    qn = norms[:nq_pad].numpy()
    rn = norms[nq_pad:].numpy()
    assert rn.shape == (nr_pad,) and np.isinf(rn[nr:]).all()
    qs, rs = nn._sources(q, r, ws, kp)
    qs = [t.reshape(-1, kp).float().numpy() for t in
          (qs if mode == "split" else [qs])]
    rs = [t.reshape(-1, kp).float().numpy() for t in
          (rs if mode == "split" else [rs])]

    def rows(a, n):                     # zero rows past the tensor (TMA)
        return np.concatenate([a, np.zeros((n - a.shape[0], kp), F32)])
    qs = [rows(a, nq_pad) for a in qs]
    rs = [rows(a, nr_pad) for a in rs]
    # the dots, one K step of plan.bk at a time, partials summed in f32
    s = np.zeros((nq_pad, nr_pad), F32)
    for k0 in range(0, kp, plan.bk):
        cut = slice(k0, k0 + plan.bk)
        if mode == "split":
            (qb, qsm), (rb, rsm) = qs, rs
            part = (qsm[:, cut] @ rb[:, cut].T + qb[:, cut] @ rsm[:, cut].T
                    + qb[:, cut] @ rb[:, cut].T).astype(F32)
        else:
            part = (qs[0][:, cut] @ rs[0][:, cut].T).astype(F32)
        s = (s + part).astype(F32)
    with np.errstate(invalid="ignore"):
        d2 = ((qn[:, None] - F32(2) * s) + rn[None, :]).astype(F32)
    # each split: a lane's running min over its columns, then the quad's
    col = np.arange(nr_pad)
    lane = (col % plan.bn) % 8 // 2
    parts = []
    for sp in range(plan.grid[1]):
        in_split = (col >= sp * plan.split) & (col < (sp + 1) * plan.split)
        best = np.full(nq_pad, np.inf, F32)
        arg = np.zeros(nq_pad, np.int64)
        for q4 in range(4):
            cols = col[in_split & (lane == q4)]
            sub = d2[:, cols]
            first = np.argmin(sub, 1)             # ascending, strict "<"
            ld = sub[np.arange(nq_pad), first]
            li = np.where(ld < np.inf, cols[first], 0)
            ld = np.where(ld < np.inf, ld, np.inf)
            take = (ld < best) | ((ld == best) & (li < arg))
            best, arg = np.where(take, ld, best), np.where(take, li, arg)
        parts.append((best, arg))
    best = np.full(nq_pad, np.inf, F32)             # the last CTA's merge
    arg = np.zeros(nq_pad, np.int64)
    for pd, pi in parts:
        take = pd < best
        best, arg = np.where(take, pd, best), np.where(take, pi, arg)
    return arg[:nq].astype(np.int32), best[:nq]


# --------------------------------------------------------------------------- #
# the model against the Pallas kernel
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("nq,nr,d", [(130, 1000, 8), (37, 700, 40),
                                     (300, 1500, 36), (20, 300, 130)])
def test_schedule_matches_pallas(nq, nr, d, policy, dtype):
    rng = np.random.default_rng(nq + nr + d)
    q, jq = _pair(rng.standard_normal((nq, d)), dtype)
    r, jr = _pair(rng.standard_normal((nr, d)), dtype)
    plan = plan_nn(nq, nr, d, H100, policy, elem_bytes=q.element_size())
    assert plan.grid[1] > 1                       # several splits
    idx, dist = model(q, r, plan)
    jidx, jdist = nn_search_pallas(jq, jr, hw=TPU, policy=JaxPolicy(policy),
                                   interpret=True)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    np.testing.assert_allclose(dist, np.asarray(jdist), rtol=0,
                               atol=_tol(q, r))
    # the wrapper's own plain product, whole-matrix argmin: the same
    pidx, pdist = nn.product(q, r, *nn.prep(q, r, plan), plan)
    np.testing.assert_array_equal(idx, pidx.numpy())
    np.testing.assert_allclose(dist, pdist.numpy(), rtol=0, atol=_tol(q, r))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("policy", POLICIES)
def test_ties_across_splits_go_to_the_lowest_index(policy, dtype):
    """A ref copied exactly to the end of split 0 (W - 1), the start of
    split 1 (W) and the last ref, query 0 a small step from it; +e0 at
    W - 2 and -e0 at the last but one, the last query at the origin
    (both distances exactly 1)."""
    nq, nr, d = 150, 1500, 36
    rng = np.random.default_rng(7)
    refs = rng.standard_normal((nr, d)) + 8.0
    queries = rng.standard_normal((nq, d)) + 8.0
    es = DTYPES[dtype][0].itemsize
    plan = plan_nn(nq, nr, d, H100, policy, elem_bytes=es)
    w = plan.split
    assert plan.grid[1] >= 3 and nr - 2 >= 2 * w
    refs[[w, nr - 1]] = refs[w - 1]
    queries[0] = refs[w - 1] + 1e-3
    refs[[w - 2, nr - 2]] = 0.0
    refs[w - 2, 0], refs[nr - 2, 0] = 1.0, -1.0
    queries[-1] = 0.0
    (q, jq), (r, jr) = _pair(queries, dtype), _pair(refs, dtype)
    idx, dist = model(q, r, plan)
    assert [idx[0], idx[-1]] == [w - 1, w - 2]
    assert dist[-1] == 1.0
    jidx, _ = nn_search_pallas(jq, jr, hw=TPU, policy=JaxPolicy(policy),
                               interpret=True)
    assert [int(jidx[0]), int(jidx[-1])] == [w - 1, w - 2]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_negative_distance_is_kept(dtype):
    """Each ref as its own query: ``(|q|^2 - 2 s) + |r|^2`` rounds to a
    little above or below 0 and is returned as it is, not clamped."""
    rng = np.random.default_rng(3)
    r, _ = _pair(rng.standard_normal((400, 24)) * 30.0, dtype)
    plan = plan_nn(400, 400, 24, H100, "auto", elem_bytes=r.element_size())
    idx, dist = model(r, r, plan)
    np.testing.assert_array_equal(idx, np.arange(400))
    assert (dist < 0).any() and np.abs(dist).max() <= _tol(r, r)


@pytest.mark.parametrize("nr", [1, 5, 129, 300])
def test_padded_refs_never_win(nr):
    """Refs far from the origin, queries at it: a padded ref row (zeros
    from TMA, s = 0) would be nearest by its dots, but its |r|^2 is +inf."""
    rng = np.random.default_rng(nr)
    r = torch.from_numpy((rng.standard_normal((nr, 16)) + 10.0).astype(F32))
    q = torch.zeros(5, 16)
    plan = plan_nn(5, nr, 16, H100, "auto")
    assert nr % plan.bn                          # a ragged last ref tile
    idx, dist = model(q, r, plan)
    want = torch.argmin((r * r).sum(-1)).item()
    assert (idx == want).all() and np.isfinite(dist).all()


# --------------------------------------------------------------------------- #
# the prep pass's operands and the 3xTF32 dots
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype,d,mode", [("float32", 36, "split"),
                                          ("float32", 4, "split"),
                                          ("bfloat16", 36, "copy"),
                                          ("bfloat16", 128, "norms")])
def test_prep_layout(dtype, d, mode):
    """The sources the product's tensor maps read: for float32 Q big, Q
    small, R big, R small (rows, kp), each ``tf32_split_plain``'s half
    padded with zero K columns to 16-byte rows; for bf16 a padded copy,
    or the inputs in place; the norms with 0 past the queries and +inf
    past the refs, padded to whole tiles."""
    nq, nr = 70, 333
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(F32)) \
        .to(DTYPES[dtype][0])
    r = torch.from_numpy(rng.standard_normal((nr, d)).astype(F32)) \
        .to(DTYPES[dtype][0])
    plan = plan_nn(nq, nr, d, H100, "auto", elem_bytes=q.element_size())
    got_mode, kp = nn.layout(q, r)
    assert got_mode == mode and kp * q.element_size() % 16 == 0 and kp >= d
    ws, norms = nn.prep(q, r, plan)
    qs, rs = nn._sources(q, r, ws, kp)
    if mode == "norms":
        assert ws is None and qs is q and rs is r
    else:
        halves = 2 if mode == "split" else 1
        assert ws.numel() == halves * (nq + nr) * kp
        for src, t in ((qs, q), (rs, r)):
            want = tf32_split_plain(t) if mode == "split" else (t,)
            assert src.shape == (halves, t.shape[0], kp)
            for got, w in zip(src, want):
                assert torch.equal(got[:, :d], w) and not got[:, d:].any()
    nq_pad = plan.grid[0] * plan.bm
    qf, rf = q.float(), r.float()
    assert torch.equal(norms[:nq], (qf * qf).sum(-1))
    assert not norms[nq:nq_pad].any()
    assert torch.equal(norms[nq_pad:nq_pad + nr], (rf * rf).sum(-1))
    assert norms[nq_pad + nr:].numel() == round_up(nr, plan.bn) - nr
    assert torch.isinf(norms[nq_pad + nr:]).all()


def test_3xtf32_dots_hold_the_tolerance_where_one_tf32_product_does_not():
    """At d = 128 the three TF32 products of the split halves keep the
    distances within ``NN_DIST_TOL`` of the float32 plain version; the
    big halves' product alone (10 of 24 mantissa bits) does not."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((64, 128)).astype(F32))
    r = torch.from_numpy(rng.standard_normal((500, 128)).astype(F32))
    exact = (q.double() * q.double()).sum(-1)[:, None] \
        - 2.0 * q.double() @ r.double().T \
        + (r.double() * r.double()).sum(-1)[None, :]
    (qb, qs), (rb, rs) = tf32_split_plain(q), tf32_split_plain(r)
    qn, rn = (q * q).sum(-1), (r * r).sum(-1)

    def d2(s):
        return (qn[:, None] - 2.0 * s) + rn[None, :]
    three = d2(qs @ rb.T + qb @ rs.T + qb @ rb.T)
    one = d2(qb @ rb.T)
    tol = _tol(q, r)
    assert (three.double() - exact).abs().max() <= tol
    assert (one.double() - exact).abs().max() > tol
    # and the model of the kernel's steps stays within it
    plan = plan_nn(64, 500, 128, H100, "auto")
    _, dist = model(q, r, plan)
    np.testing.assert_allclose(dist, exact.min(-1).values.numpy(), rtol=0,
                               atol=tol)
