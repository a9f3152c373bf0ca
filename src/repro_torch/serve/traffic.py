"""Synthetic serving traffic: Poisson arrivals, configurable length
distributions, open- and closed-loop driving (a copy of the JAX
package's ``serve/traffic.py`` without the shared-prefix mixes the radix
cache is measured on).

Open loop models an internet-facing frontend: arrivals are a Poisson
process at ``rate`` req/s and do not care how busy the engine is — the
queue absorbs bursts (the regime where TTFT tails and admission control
matter).  Closed loop models ``concurrency`` synchronous clients: a new
request arrives only when one completes — the regime that measures
steady-state throughput without unbounded queue growth.

Length distributions are ``(kind, a, b)`` triples:

    ("fixed",    n, _)      every draw is n
    ("uniform",  lo, hi)    integer uniform [lo, hi]
    ("lognormal", mu, sig)  round(exp(N(mu, sig))), clamped to >= 1

Everything is seeded and deterministic — the device-free benchmark and
the hypothesis tests replay identical traffic across engine variants.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Optional

from repro_torch.serve.scheduler import Request

__all__ = ["TrafficConfig", "sample_length", "synthesize", "drive"]


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """One synthetic traffic pattern (seeded, deterministic).

    Example::

        cfg = TrafficConfig(n_requests=16, rate=8.0, seed=1)
        report = drive(engine, cfg)
    """

    n_requests: int = 32
    rate: float = 8.0                       # open-loop arrivals/s
    prompt_dist: tuple = ("uniform", 4, 48)
    output_dist: tuple = ("uniform", 4, 16)
    mode: str = "open"                      # open | closed
    concurrency: int = 4                    # closed-loop clients
    vocab: int = 512
    seed: int = 0

    def __post_init__(self):
        if self.mode not in ("open", "closed"):
            raise ValueError(f"mode must be open|closed, got {self.mode!r}")
        if self.rate <= 0 or self.n_requests <= 0:
            raise ValueError("rate and n_requests must be positive")


def sample_length(dist: tuple, rng: random.Random) -> int:
    """Draw one length from a ``(kind, a, b)`` distribution triple.

    Example::

        >>> sample_length(("fixed", 8, 0), random.Random(0))
        8
    """
    kind, a, b = dist
    if kind == "fixed":
        return max(1, int(a))
    if kind == "uniform":
        return rng.randint(int(a), int(b))
    if kind == "lognormal":
        return max(1, round(math.exp(rng.gauss(float(a), float(b)))))
    raise ValueError(f"unknown length distribution {kind!r}")


def synthesize(cfg: TrafficConfig) -> list[Request]:
    """A deterministic request timeline.  Open loop stamps Poisson
    arrival times; closed loop stamps everything at t=0 and lets
    ``drive`` meter the release.

    Example::

        reqs = synthesize(TrafficConfig(n_requests=4, seed=7))
    """
    rng = random.Random(cfg.seed)
    t = 0.0
    out = []
    for _ in range(cfg.n_requests):
        if cfg.mode == "open":
            t += rng.expovariate(cfg.rate)
        plen = sample_length(cfg.prompt_dist, rng)
        olen = sample_length(cfg.output_dist, rng)
        prompt = [rng.randrange(1, cfg.vocab) for _ in range(plen)]
        out.append(Request(prompt=prompt, max_new_tokens=olen,
                           arrival=t if cfg.mode == "open" else 0.0))
    return out


def drive(engine, cfg: TrafficConfig,
          requests: Optional[list[Request]] = None):
    """Run one traffic pattern through an engine; returns its report.

    Open loop submits the whole timeline up front (the scheduler holds
    future arrivals until their timestamps).  Closed loop submits the
    first ``concurrency`` requests and releases one more per completion,
    timestamped at the completion instant.

    Example::

        report = drive(engine, TrafficConfig(n_requests=16, rate=8.0))
    """
    reqs = requests if requests is not None else synthesize(cfg)
    if cfg.mode == "open":
        for r in reqs:
            engine.submit(r)
        return engine.run()

    pending = list(reqs)

    def release_one(now):
        # a rejected submit must not cost the client: keep releasing
        # until one request is actually accepted (or the mix is drained)
        while pending:
            nxt = pending.pop(0)
            nxt.arrival = now
            engine.submit(nxt)
            if not nxt.rejected:
                return

    for _ in range(min(cfg.concurrency, len(pending))):
        release_one(0.0)

    def release_next(done_req, now):
        release_one(now)

    return engine.run(on_complete=release_next)
