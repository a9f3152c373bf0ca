"""Vortex execution-trace model — reproduces the paper's Fig. 1 regimes and
drives the Fig. 2 450-configuration validation sweep.

A copy of the JAX package's ``core/tracesim.py``, host arithmetic over
the port's own ``core.workload`` and ``core.mapper``.  The paper derives
its mapping rule from RTL execution traces (PC, thread mask, warp issue
timestamps); this models the *documented* behaviour of the traces
analytically:

  * the runtime spawns ``ceil(gws / lws)`` software work slots; the hardware
    holds ``hp = cores x warps x threads`` lanes; excess slots serialize into
    ``ceil(slots / hp)`` kernel **calls**, each paying a dispatch overhead
    (the inter-wavefront gaps of Fig. 1, "lws=1" row);
  * within a call, each warp issues ``instrs_per_iter x lws`` instructions
    through a single-issue port per core (warp interleave);
  * memory traffic shares the device-wide bandwidth;
  * partially-filled warps execute with a reduced thread mask (the
    ``lws=32/64`` rows of Fig. 1) — same cycles, fewer useful lanes.

The model's purpose is *ordinal* fidelity: the three regimes and their
relative costs, which is exactly what Eq. 1 exploits.  All constants are in
``hw.VortexParams``; ``profiler.calibrate.fit_tracesim`` anchors them to
measured records.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Optional

from repro_torch.core.hw import VortexParams, ceil_div
from repro_torch.core.mapper import Regime, classify_regime, resolve_lws
from repro_torch.core.workload import Workload

__all__ = [
    "TraceEvent",
    "SimResult",
    "simulate",
    "simulate_policy",
    "sweep_configs",
    "paper_config_grid",
]


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One issue-window of one warp — Fig. 1's plotted atoms."""

    t_start: int
    t_end: int
    call: int
    core: int
    warp: int
    section: str          # init | body | ret (the paper's tagged sections)
    thread_mask: int      # popcount of active threads
    threads: int          # warp width


@dataclasses.dataclass(frozen=True)
class SimResult:
    kernel: str
    cfg_tag: str
    lws: int
    cycles: int
    calls: int
    regime: Regime
    utilization: float
    events: Optional[list[TraceEvent]] = None


# init/ret section costs (cycles) observed as the prologue/epilogue
# wavefronts in the paper's Fig. 1 traces.  Small: Fig. 1's lws=1 trace shows
# the 16 sequential calls costing well under 2x the single-call mapping.
_INIT_CYCLES = 8
_RET_CYCLES = 4

# achieved memory bandwidth needs outstanding requests: each active thread
# sustains at most this many bytes/cycle (memory-level-parallelism model).
_BW_PER_THREAD = 1.0


def simulate(
    w: Workload,
    cfg: VortexParams,
    lws: int,
    trace: bool = False,
) -> SimResult:
    """Run the analytic execution model for one (kernel, hw, lws) point."""
    lws = max(1, lws)
    hp = cfg.hp
    slots = ceil_div(w.gws, lws)                 # software work slots (threads)
    calls = ceil_div(slots, hp)                  # sequential kernel calls
    regime = classify_regime(lws, w.gws, hp)

    events: list[TraceEvent] = [] if trace else None
    t = 0
    total_cycles = 0
    work_left = w.gws
    for call in range(calls):
        slots_this = min(slots - call * hp, hp)
        # distribute slots across cores round-robin (Vortex runtime splits
        # the workload equally across cores first, then warps, then threads)
        per_core = ceil_div(slots_this, cfg.cores)
        warps_per_core = ceil_div(per_core, cfg.threads)
        iters_this = min(work_left, slots_this * lws)
        work_left -= iters_this

        # Occupancy model (Hong & Kim style): per iteration round, a warp
        # issues instrs_per_iter cycles then stalls mem_latency on its loads;
        # the stall is hidden only by the other W-1 resident warps.  This is
        # where undersubscription (lws too large -> few warps per core)
        # hurts: one warp serializes issue + full memory latency, lws times.
        ipi = w.instrs_per_iter
        round_cycles = max(warps_per_core * ipi / cfg.issue_width,
                           ipi + cfg.mem_latency)
        issue = int(lws * round_cycles)
        # bandwidth-limited cycles: traffic over achieved bandwidth; achieved
        # bandwidth saturates only with enough outstanding threads (MLP).
        bw_eff = min(cfg.mem_bw_bytes_per_cycle, slots_this * _BW_PER_THREAD)
        mem = int(iters_this * w.bytes_per_iter / bw_eff)
        body = max(issue, mem, 1)
        call_cycles = cfg.call_overhead_cycles + _INIT_CYCLES + body + _RET_CYCLES
        if trace:
            for core in range(min(cfg.cores, max(1, ceil_div(slots_this, cfg.threads * cfg.warps)))):
                core_slots = min(max(slots_this - core * cfg.warps * cfg.threads, 0),
                                 cfg.warps * cfg.threads)
                for wp in range(ceil_div(core_slots, cfg.threads)):
                    mask = min(cfg.threads, core_slots - wp * cfg.threads)
                    t0 = t + cfg.call_overhead_cycles
                    events.append(TraceEvent(t0, t0 + _INIT_CYCLES, call, core, wp,
                                             "init", cfg.threads, cfg.threads))
                    events.append(TraceEvent(t0 + _INIT_CYCLES, t0 + _INIT_CYCLES + body,
                                             call, core, wp, "body", mask, cfg.threads))
                    events.append(TraceEvent(t0 + _INIT_CYCLES + body,
                                             t0 + _INIT_CYCLES + body + _RET_CYCLES,
                                             call, core, wp, "ret", cfg.threads, cfg.threads))
        t += call_cycles
        total_cycles += call_cycles

    # useful lane-cycles / provisioned lane-cycles
    util = w.gws * w.instrs_per_iter / max(total_cycles * cfg.cores * cfg.threads, 1)
    return SimResult(
        kernel=w.name, cfg_tag=cfg.tag, lws=lws, cycles=total_cycles,
        calls=calls, regime=regime, utilization=min(util, 1.0), events=events,
    )


def simulate_policy(w: Workload, cfg: VortexParams, policy: str,
                    trace: bool = False) -> SimResult:
    """naive -> lws=1; fixed -> lws=32; auto -> Eq. 1; tuned -> Eq. 1
    refined by ``core.autotune`` on this very simulator."""
    if policy == "naive":
        lws = 1
    elif policy == "fixed":
        lws = 32
    elif policy == "auto":
        lws = resolve_lws(w.gws, cfg.hp)
    elif policy == "tuned":
        from repro_torch.core.autotune import refine_lws  # lazy: no cycle
        lws = refine_lws(w, cfg).best
    else:
        raise ValueError(f"unknown policy {policy!r}")
    return simulate(w, cfg, lws, trace=trace)


# --------------------------------------------------------------------------- #
# The paper's 450-configuration sweep (1c2w2t ... 64c32w32t)
# --------------------------------------------------------------------------- #


def paper_config_grid() -> list[VortexParams]:
    """450 configurations spanning the paper's range.

    cores in 18 steps from 1..64 (incl. non-powers of two, as tape-outs use),
    warps and threads in {2,4,8,16,32}: 18 x 5 x 5 = 450.  Memory bandwidth
    scales with core count (each Vortex core adds a cache bank / mem port).
    """
    cores = [1, 2, 3, 4, 6, 8, 10, 12, 16, 20, 24, 28, 32, 40, 48, 56, 60, 64]
    wt = [2, 4, 8, 16, 32]
    cfgs = []
    for c, wps, th in itertools.product(cores, wt, wt):
        cfgs.append(VortexParams(
            cores=c, warps=wps, threads=th,
            mem_bw_bytes_per_cycle=4.0 * c,
        ))
    assert len(cfgs) == 450
    return cfgs


def sweep_configs(
    w: Workload,
    cfgs: Optional[list[VortexParams]] = None,
) -> Iterator[dict]:
    """Yield per-config {naive, fixed, auto} cycle counts and ratios —
    the raw data behind the paper's Fig. 2 violins."""
    for cfg in cfgs if cfgs is not None else paper_config_grid():
        ours = simulate_policy(w, cfg, "auto")
        naive = simulate_policy(w, cfg, "naive")
        fixed = simulate_policy(w, cfg, "fixed")
        yield {
            "kernel": w.name,
            "cfg": cfg.tag,
            "hp": cfg.hp,
            "auto_lws": ours.lws,
            "auto_cycles": ours.cycles,
            "naive_cycles": naive.cycles,
            "fixed_cycles": fixed.cycles,
            "ratio_naive": naive.cycles / ours.cycles,
            "ratio_fixed": fixed.cycles / ours.cycles,
            "regime": ours.regime.value,
        }
