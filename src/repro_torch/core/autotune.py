"""Local search around the Eq. 1 seed (the paper's §3: Eq. 1 is near-
but not always exactly optimal; "spawning more or less warps can bring
small benefits").

``refine_discrete`` probes a kernel's candidate decision values against
a cost callable, the seed first, and keeps the cheapest.  The tuner
(``repro_torch.tuner.dispatch``) runs it on a TUNED cache miss with the
kernel's roofline cost over ``GpuParams``; ``profiler.cost`` runs it a
second time over measured seconds.  ``refine_lws`` runs it on the Vortex
trace model (``core.tracesim``), the TUNED policy of ``simulate_policy``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

__all__ = ["RefineResult", "refine_discrete", "refine_lws"]


@dataclasses.dataclass(frozen=True)
class RefineResult:
    seed: int
    best: int
    seed_cost: float
    best_cost: float
    probes: int
    #: every (candidate, cost) pair probed, seed included, so a caller can
    #: rank the whole neighbourhood (profiler.cost keeps the roofline's
    #: top K before it measures) without probing again
    evaluations: Optional[tuple] = None

    @property
    def improvement(self) -> float:
        return self.seed_cost / self.best_cost if self.best_cost else 1.0

    def ranked(self) -> list:
        """Evaluations sorted by ascending cost (finite first)."""
        if not self.evaluations:
            return []
        return sorted(self.evaluations, key=lambda vc: vc[1])


def refine_discrete(
    seed: int,
    cost_fn: Callable[[int], float],
    candidates: Optional[Sequence[int]] = None,
    max_probes: int = 16,
) -> RefineResult:
    """Probe ``candidates`` (default: the seed's halvings and doublings,
    three each way) after the seed, at most ``max_probes`` in all, and
    keep the first of the cheapest."""
    if candidates is None:
        cands = {seed}
        v = seed
        for _ in range(3):
            v = max(1, v // 2)
            cands.add(v)
        v = seed
        for _ in range(3):
            v *= 2
            cands.add(v)
        candidates = sorted(cands)
    seed_cost = cost_fn(seed)
    best, best_cost, probes = seed, seed_cost, 1
    evals = [(seed, seed_cost)]
    for c in candidates:
        if probes >= max_probes:      # budget spent: no later probe possible
            break
        if c == seed:
            continue
        probes += 1
        cost = cost_fn(c)
        evals.append((c, cost))
        if cost < best_cost:
            best, best_cost = c, cost
    return RefineResult(seed=seed, best=best, seed_cost=seed_cost,
                        best_cost=best_cost, probes=probes,
                        evaluations=tuple(evals))


def refine_lws(w, cfg, max_probes: int = 16) -> RefineResult:
    """Refine Eq. 1's ``lws`` on the trace model (the "small benefits" of
    the paper's §3): ``w`` a ``core.workload.Workload``, ``cfg`` a
    ``core.hw.VortexParams``."""
    from repro_torch.core.mapper import resolve_lws
    from repro_torch.core.tracesim import simulate  # lazy: no cycle

    seed = resolve_lws(w.gws, cfg.hp)
    return refine_discrete(
        seed, lambda lws: float(simulate(w, cfg, lws).cycles),
        max_probes=max_probes,
    )
