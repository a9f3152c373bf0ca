"""Mixture-of-Experts layer: capacity routing with sort-based dispatch.

The serving half of the JAX package's ``models/moe.py``: every token of a
call routes as ONE group (the reference's ``moe_groups`` 1) on one device,
so its ``ShardCtx``, the group split and the fp8 all-to-all (training and
expert-parallel levers) stay out.

Dispatch is sort-based: a stable sort of the flat expert ids, each slot's
position within its expert from ``searchsorted`` starts, then a scatter
into dense (E, C, d) buffers; overflow slots land in a trash row at
``E x C`` and are dropped.  Capacity is Eq. 1 over routed token slots
(``core.mapper.plan_moe_capacity``: ``gws = T x k`` slots over ``hp = E``
expert lanes), so ``C = min(capacity, T)`` depends on the call's own token
count: padded chunk tails and bucket padding take capacity as real tokens
do, as in the reference.  The expert products are batched GEMMs over the
whole buffer (``torch.bmm``, the reference's ``einsum``), empty slots
included.

Ties follow the reference: top-k by a stable descending sort (the lower
expert index wins, as ``jax.lax.top_k``), and the flat ids sorted stably
(``jnp.argsort``).  The combine gathers each token's k slots back into
(T, k, d) and sums them, so the result does not depend on the order of
atomic adds.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mapper import plan_moe_capacity

__all__ = ["moe_shapes", "route", "combine", "moe_mlp"]


def moe_shapes(cfg: ModelConfig) -> dict:
    """One layer's MoE tree as {name: (shape, init, scale)} (the
    reference's ``moe_specs``; ``layers.param_shapes`` stacks it)."""
    d, e, ff = cfg.d_model, cfg.moe_experts, cfg.moe_dff
    s = {"router": ((d, e), "normal", None),
         "w_gate": ((e, d, ff), "normal", None),
         "w_up": ((e, d, ff), "normal", None),
         "w_down": ((e, ff, d), "normal", None)}
    if cfg.moe_shared_experts:
        sf = cfg.moe_shared_experts * ff
        s["shared"] = {"w_gate": ((d, sf), "normal", None),
                       "w_up": ((d, sf), "normal", None),
                       "w_down": ((sf, d), "normal", None)}
    return s


def _act(g: torch.Tensor, u: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU, or the tanh GELU (``jax.nn.gelu``'s default) gate."""
    return (F.silu(g) if act == "swiglu"
            else F.gelu(g, approximate="tanh")) * u


def route(x: torch.Tensor, router: torch.Tensor, e: int, k: int, c: int):
    """Route ``x`` (t, d) to ``e`` experts of capacity ``c``, top ``k``.

    Returns (expert inputs (e, c, d), the combine state (dest, sorted
    token, sorted gate, keep, order), the Switch aux loss, the router
    probabilities (t, e) float32, the top-k expert ids (t, k))."""
    t, d = x.shape
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = gates[:, :k], eidx[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # Switch-style aux loss: E * sum_e f_e * p_e
    assign = torch.zeros((t, e), dtype=torch.float32, device=x.device)
    assign.scatter_(1, eidx, 1.0)
    aux = e * torch.sum((assign.mean(0) / k) * probs.mean(0))

    flat_e = eidx.reshape(-1)                               # (t*k,)
    se, order = torch.sort(flat_e, stable=True)
    stok = order // k
    sgate = gates.reshape(-1)[order]
    starts = torch.searchsorted(se, torch.arange(e, device=x.device))
    pos = torch.arange(t * k, device=x.device) - starts[se]
    keep = pos < c
    dest = torch.where(keep, se * c + pos, e * c)           # trash row

    buf = x.new_zeros((e * c + 1, d))
    buf[dest] = x[stok]
    return (buf[:e * c].view(e, c, d), (dest, stok, sgate, keep, order),
            aux, probs, eidx)


def combine(out_e: torch.Tensor, state, t: int, k: int,
            dtype: torch.dtype) -> torch.Tensor:
    """Each token's gated expert outputs summed (the reference's
    ``_combine_one_group``); dropped slots add zero."""
    dest, _, sgate, keep, order = state
    e_c, d = out_e.shape[0] * out_e.shape[1], out_e.shape[2]
    flat_out = torch.cat([out_e.reshape(e_c, d), out_e.new_zeros((1, d))])
    y_slots = flat_out[dest] * sgate[:, None].to(out_e.dtype)
    y_slots = torch.where(keep[:, None], y_slots, 0)
    y = torch.empty_like(y_slots)
    y[order] = y_slots                              # back to (token, rank)
    return y.view(t, k, d).sum(1).to(dtype)


def moe_mlp(params: dict, h: torch.Tensor, cfg: ModelConfig, *,
            capacity: Optional[int] = None):
    """Returns (output (B, S, d), the aux load-balance loss float32).

    All B x S tokens route as one group; ``capacity`` defaults to
    ``plan_moe_capacity(B x S, E, k)`` (AUTO) and is cut to the token
    count."""
    b, s, d = h.shape
    e, k = cfg.moe_experts, cfg.moe_topk
    t = b * s
    x = h.reshape(t, d)
    if capacity is None:
        capacity = plan_moe_capacity(t, e, k)
    c = min(capacity, t)

    expert_in, state, aux, _, _ = route(x, params["router"], e, k, c)
    g = torch.bmm(expert_in, params["w_gate"])
    u = torch.bmm(expert_in, params["w_up"])
    out_e = torch.bmm(_act(g, u, cfg.mlp_act), params["w_down"])
    y = combine(out_e, state, t, k, h.dtype)

    if "shared" in params:
        sp = params["shared"]
        hh = _act(x @ sp["w_gate"], x @ sp["w_up"], cfg.mlp_act)
        y = y + hh @ sp["w_down"]
    return y.view(b, s, d), aux
