"""Trace-driven traffic: seeded arrival synthesis + an async replay harness
(port of src/repro/serving/traffic.py; the same seed gives the same events
in both packages, drawn with numpy).

The serving stack is evaluated the way "Prefill/Decode-Aware Evaluation
of LLM Inference on Emerging AI Accelerators" (PAPERS.md) argues it must
be: not by one batch's throughput, but by GOODPUT UNDER SLO against a
realistic arrival process.  This module provides both halves:

* ``synthesize(TrafficConfig)`` turns per-tenant specs into one merged,
  time-ordered list of ``ArrivalEvent``s — seeded Poisson or bursty
  ON-OFF arrivals, uniform prompt/output length ranges, and per-tenant
  SHARED-PREFIX pools (every prompt of a tenant starts with one of its
  ``n_prefixes`` fixed prefixes, which is exactly the workload the radix
  prefix cache exists for).  Same config -> same trace, bit for bit: the
  generator draws from ``numpy`` Generators seeded per tenant, never
  from wall clock.

* ``await replay(frontend, events)`` replays a trace against an
  ``AsyncEngine`` as concurrent clients — one task per arrival, each
  submitting at its event time (``time_scale`` compresses the clock;
  ``0`` submits in trace order with no waiting, making the engine-side
  interleaving deterministic) and consuming its stream to the end — and
  returns a ``TrafficReport``: goodput-under-SLO, TTFT/TPOT
  percentiles, shed/defer rates, and preemption counts, read from the
  SAME metrics registry the engine serves (never a parallel tally).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.frontend import AsyncEngine
from repro_torch.serving.metrics import SLO, quantile
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import PRIORITY_STANDARD

__all__ = [
    "ArrivalEvent",
    "RequestResult",
    "TenantSpec",
    "TrafficConfig",
    "TrafficReport",
    "replay",
    "synthesize",
]


@dataclass(frozen=True)
class TenantSpec:
    """One traffic class: an arrival process plus a request shape.

    ``arrival="poisson"`` draws i.i.d. exponential gaps at ``rate_rps``.
    ``arrival="onoff"`` is the bursty twin: exponential ON/OFF dwell
    times (means ``on_s``/``off_s``) with Poisson arrivals at
    ``rate_rps`` DURING ON and silence during OFF — same mean shape,
    very different queue dynamics (the overload the admission controller
    exists for arrives in bursts, not smoothly).

    ``prompt_len``/``output_len`` are inclusive uniform ranges.  With
    ``shared_prefix_len > 0`` every prompt starts with one of the
    tenant's ``n_prefixes`` fixed token prefixes (drawn per request),
    modeling the shared system-prompt/RAG-template pools that make the
    radix prefix cache pay."""
    name: str
    rate_rps: float
    arrival: str = "poisson"            # poisson | onoff
    on_s: float = 1.0                   # mean ON dwell (onoff)
    off_s: float = 1.0                  # mean OFF dwell (onoff)
    prompt_len: Tuple[int, int] = (16, 64)
    output_len: Tuple[int, int] = (8, 32)
    shared_prefix_len: int = 0
    n_prefixes: int = 1
    priority: int = PRIORITY_STANDARD
    slo: Optional[SLO] = None

    def __post_init__(self):
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if self.arrival not in ("poisson", "onoff"):
            raise ValueError(f"arrival={self.arrival!r} "
                             "(expected 'poisson' or 'onoff')")
        if self.arrival == "onoff" and (self.on_s <= 0 or self.off_s <= 0):
            raise ValueError("onoff arrivals need on_s > 0 and off_s > 0")
        for fname in ("prompt_len", "output_len"):
            lo, hi = getattr(self, fname)
            if not (0 < lo <= hi):
                raise ValueError(f"{fname}={(lo, hi)} (need 0 < lo <= hi)")
        if self.shared_prefix_len < 0 or self.n_prefixes < 1:
            raise ValueError("shared_prefix_len >= 0 and n_prefixes >= 1")
        if self.shared_prefix_len >= self.prompt_len[0]:
            raise ValueError(
                f"shared_prefix_len={self.shared_prefix_len} must be < "
                f"min prompt_len={self.prompt_len[0]} (a prompt needs at "
                "least one non-shared token)")


@dataclass(frozen=True)
class TrafficConfig:
    tenants: Tuple[TenantSpec, ...]
    duration_s: float                   # trace horizon (arrival times < this)
    seed: int = 0
    vocab_size: int = 256

    def __post_init__(self):
        if not self.tenants:
            raise ValueError("TrafficConfig needs at least one tenant")
        if self.duration_s <= 0:
            raise ValueError(f"duration_s must be > 0, got {self.duration_s}")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        if self.vocab_size < 2:
            raise ValueError(f"vocab_size must be >= 2, got {self.vocab_size}")


@dataclass(frozen=True)
class ArrivalEvent:
    t: float                            # arrival instant (trace time, s)
    tenant: str
    prompt: np.ndarray                  # [T] int32
    max_new_tokens: int
    priority: int = PRIORITY_STANDARD
    slo: Optional[SLO] = None


def _arrival_times(spec: TenantSpec, duration_s: float,
                   rng: np.random.Generator) -> List[float]:
    """Seeded arrival instants in [0, duration_s) for one tenant."""
    times: List[float] = []
    t = 0.0
    if spec.arrival == "poisson":
        while True:
            t += float(rng.exponential(1.0 / spec.rate_rps))
            if t >= duration_s:
                return times
            times.append(t)
    # onoff: exponential dwell alternation, Poisson arrivals during ON
    while t < duration_s:
        on_end = t + float(rng.exponential(spec.on_s))
        while True:
            t += float(rng.exponential(1.0 / spec.rate_rps))
            if t >= min(on_end, duration_s):
                break
            times.append(t)
        t = max(t, on_end) + float(rng.exponential(spec.off_s))
    return times


def synthesize(cfg: TrafficConfig) -> List[ArrivalEvent]:
    """The trace: every tenant's arrivals merged into one time-ordered
    event list.  Deterministic — each tenant draws from its own
    ``default_rng((seed, tenant_index))`` stream, so adding a tenant
    never perturbs another's arrivals, and ties in ``t`` break by
    tenant order."""
    events: List[Tuple[float, int, ArrivalEvent]] = []
    for ti, spec in enumerate(cfg.tenants):
        rng = np.random.default_rng((cfg.seed, ti))
        prefixes = [rng.integers(0, cfg.vocab_size,
                                 (spec.shared_prefix_len,), dtype=np.int32)
                    for _ in range(spec.n_prefixes)] \
            if spec.shared_prefix_len > 0 else []
        for t in _arrival_times(spec, cfg.duration_s, rng):
            p_lo, p_hi = spec.prompt_len
            o_lo, o_hi = spec.output_len
            plen = int(rng.integers(p_lo, p_hi + 1))
            mnt = int(rng.integers(o_lo, o_hi + 1))
            if prefixes:
                pre = prefixes[int(rng.integers(0, len(prefixes)))]
                suffix = rng.integers(0, cfg.vocab_size,
                                      (plen - len(pre),), dtype=np.int32)
                prompt = np.concatenate([pre, suffix])
            else:
                prompt = rng.integers(0, cfg.vocab_size, (plen,),
                                      dtype=np.int32)
            events.append((t, ti, ArrivalEvent(
                t=t, tenant=spec.name, prompt=prompt, max_new_tokens=mnt,
                priority=spec.priority, slo=spec.slo)))
    events.sort(key=lambda e: (e[0], e[1]))
    return [ev for _, _, ev in events]


@dataclass(frozen=True)
class RequestResult:
    """One replayed request's outcome (engine-measured latencies)."""
    req_id: int
    tenant: str
    t_arrival: float                    # trace time of the arrival
    finish_reason: Optional[str]
    n_tokens: int
    ttft_s: float                       # NaN if no first token
    tpot_s: float                       # NaN if undefined
    priority: int
    had_slo: bool

    @property
    def served(self) -> bool:
        return self.finish_reason not in ("shed", "abort")


@dataclass(frozen=True)
class TrafficReport:
    """One replay's scorecard.  Latency percentiles are over SERVED
    requests (a shed request has no TTFT — its cost appears in
    ``shed_rate`` and in the goodput denominator instead); goodput and
    the violation counts come from the engine's ``serving_slo_*``
    counters, which ALSO count shed deadline-carrying requests as
    un-attained demand — shedding is never free, it only beats
    thrashing."""
    n_requests: int
    n_served: int
    n_shed: int
    n_deferred: int                     # submits that were ever parked
    n_preemptions: int
    slo_total: int
    slo_attained: int
    goodput: float                      # attained / total SLO demand
    ttft_p50_s: float
    ttft_p95_s: float
    tpot_p50_s: float
    tpot_p95_s: float
    total_tokens: int
    wall_s: float
    results: Tuple[RequestResult, ...]

    @property
    def shed_rate(self) -> float:
        return self.n_shed / self.n_requests if self.n_requests else 0.0

    def by_tenant(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for r in self.results:
            d = out.setdefault(r.tenant,
                               {"requests": 0, "served": 0, "shed": 0,
                                "tokens": 0})
            d["requests"] += 1
            d["served"] += r.served
            d["shed"] += r.finish_reason == "shed"
            d["tokens"] += r.n_tokens
        return out

    def render(self) -> str:
        lines = [
            f"requests={self.n_requests} served={self.n_served} "
            f"shed={self.n_shed} ({self.shed_rate:.1%}) "
            f"deferred={self.n_deferred} preemptions={self.n_preemptions}",
            f"goodput={self.goodput:.3f} "
            f"({self.slo_attained}/{self.slo_total} SLO demand attained)",
            f"ttft p50={self.ttft_p50_s * 1e3:.1f}ms "
            f"p95={self.ttft_p95_s * 1e3:.1f}ms | "
            f"tpot p50={self.tpot_p50_s * 1e3:.1f}ms "
            f"p95={self.tpot_p95_s * 1e3:.1f}ms",
            f"tokens={self.total_tokens} wall={self.wall_s:.2f}s",
        ]
        for name, d in sorted(self.by_tenant().items()):
            lines.append(f"  tenant {name}: {d['requests']} requests, "
                         f"{d['served']} served, {d['shed']} shed, "
                         f"{d['tokens']} tokens")
        return "\n".join(lines)


async def replay(frontend: AsyncEngine, events: Sequence[ArrivalEvent], *,
                 time_scale: float = 1.0,
                 sampling: Optional[SamplingParams] = None) -> TrafficReport:
    """Replay a trace as one client task per arrival.

    ``time_scale`` multiplies trace time: 1.0 replays in real time, 0.1
    ten-times compressed, ``0`` submits everything in trace order with
    no waiting — the engine sees the heaviest possible instantaneous
    load AND the submission order is exactly the trace order (each
    client posts to the mailbox before its first await), which is what
    makes zero-scale replays deterministic end to end.

    Greedy sampling by default (``sampling`` overrides per-trace); every
    client consumes its stream to the end, shed refusals included."""
    if time_scale < 0:
        raise ValueError(f"time_scale must be >= 0, got {time_scale}")
    sp = sampling if sampling is not None else SamplingParams()
    # counter snapshots: the report covers THIS replay's window, so a
    # warmup drain (or an earlier replay) on the same engine never
    # pollutes the scorecard
    eng = frontend.engine
    g0 = eng.goodput()
    preempt0 = int(eng.preemptions)
    deferred0 = int(eng.admission_deferred)
    t0 = time.monotonic()
    results: List[RequestResult] = []

    async def client(ev: ArrivalEvent) -> None:
        if time_scale > 0:
            delay = ev.t * time_scale - (time.monotonic() - t0)
            if delay > 0:
                await asyncio.sleep(delay)
        handle = await frontend.submit(
            ev.prompt, max_new_tokens=ev.max_new_tokens, sampling=sp,
            slo=ev.slo, priority=ev.priority)
        async for _ in handle:
            pass
        req = handle.request
        results.append(RequestResult(
            req_id=req.req_id, tenant=ev.tenant, t_arrival=ev.t,
            finish_reason=req.finish_reason, n_tokens=len(req.generated),
            ttft_s=req.ttft, tpot_s=req.tpot, priority=req.priority,
            had_slo=req.slo is not None))

    await asyncio.gather(*[client(ev) for ev in events])
    wall = time.monotonic() - t0
    results.sort(key=lambda r: r.req_id)

    g1 = eng.goodput()
    slo_total = int(g1["slo_total"] - g0["slo_total"])
    slo_attained = int(g1["slo_attained"] - g0["slo_attained"])
    served = [r for r in results if r.served]
    ttfts = [r.ttft_s for r in served]
    tpots = [r.tpot_s for r in served]
    return TrafficReport(
        n_requests=len(results),
        n_served=len(served),
        n_shed=sum(r.finish_reason == "shed" for r in results),
        n_deferred=int(eng.admission_deferred) - deferred0,
        n_preemptions=int(eng.preemptions) - preempt0,
        slo_total=slo_total,
        slo_attained=slo_attained,
        # same vacuous-1.0 convention as ``ServingEngine.goodput``
        goodput=slo_attained / slo_total if slo_total else 1.0,
        ttft_p50_s=quantile(ttfts, 0.50),
        ttft_p95_s=quantile(ttfts, 0.95),
        tpot_p50_s=quantile(tpots, 0.50),
        tpot_p95_s=quantile(tpots, 0.95),
        total_tokens=sum(r.n_tokens for r in results),
        wall_s=wall,
        results=tuple(results))
