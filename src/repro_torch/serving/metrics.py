"""Serving metrics: one registry of counters / gauges / histograms that
IS the engine's counter state.

HALO's argument is phase-aware ATTRIBUTION — which phase ran where, what
moved over the 2.5D link, what each choice cost — and before this module
that story lived in ~20 plain-int attributes scattered across the
engine, the executor, the host tier, and the prefix cache, each surfaced
through its own ad-hoc dict (``counts()``, ``spec_stats()``,
``HostTier.swap_out_bytes``, ...).  The registry unifies them: every one
of those attributes is now a PROPERTY over a named registry counter
(``counter_attr`` below), so the legacy dict APIs keep their exact keys
while ``MetricsRegistry.snapshot()`` / ``render()`` expose the same
numbers as one machine-readable surface — one source of truth, zero
drift between the views.

Three metric kinds, Prometheus semantics:

* **counter** — monotone lifetime total (``serving_preemptions_total``);
* **gauge** — point-in-time level (``serving_requests_active``);
* **histogram** — fixed cumulative buckets + sum + count
  (``serving_ttft_seconds``); buckets are chosen at first ``observe``
  and fixed for the metric's lifetime.

``enabled=False`` silences the *instrumentation* paths (``inc`` /
``set_gauge`` / ``observe``) so a registry handed to cold paths costs
one attribute test per call.  The *state-store* path used by
``counter_attr`` / ``gauge_attr`` properties is unconditional — those
attributes are engine state (preemption accounting, swap bytes), not
optional telemetry, and must stay correct regardless.

Host-only.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence

# default histogram ladder (seconds): spans sub-ms CPU ticks to the
# multi-second tail of a cold-compile tick
DEFAULT_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class _Histogram:
    """Fixed cumulative-bucket histogram (Prometheus ``le`` semantics)."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]):
        bs = tuple(float(b) for b in buckets)
        if not bs or list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"histogram buckets must be a non-empty "
                             f"sorted unique sequence, got {buckets!r}")
        self.buckets = bs
        self.counts = [0] * (len(bs) + 1)       # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        if math.isnan(v):
            return                              # NaN = undefined, not a sample
        i = 0
        for i, le in enumerate(self.buckets):   # noqa: B007
            if v <= le:
                break
        else:
            i = len(self.buckets)
        self.counts[i] += 1
        self.sum += v
        self.count += 1

    def snapshot(self) -> Dict[str, object]:
        cum, out = 0, []
        for le, c in zip(self.buckets, self.counts):
            cum += c
            out.append([le, cum])
        out.append([math.inf, self.count])
        return {"buckets": out, "sum": self.sum, "count": self.count}


class MetricsRegistry:
    """Named counters / gauges / fixed-bucket histograms.

    The engine constructs one per instance and stores ALL its lifetime
    counters in it (via ``counter_attr`` properties), so
    ``snapshot()``/``render()`` and the legacy ``counts()`` /
    ``spec_stats()`` dicts can never disagree.  Pass a shared registry
    to several components (engine -> executor / HostTier / PrefixCache)
    to aggregate them; pass a DEDICATED registry per engine — the
    engine's per-tick deltas assume nobody else moves its counters.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Histogram] = {}

    # -- instrumentation (no-ops when disabled) --------------------------------
    def inc(self, name: str, value: float = 1) -> None:
        if not self.enabled:
            return
        self._counters[name] = self._counters.get(name, 0) + value

    def set_gauge(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        self._gauges[name] = value

    def observe(self, name: str, value: float,
                buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS) -> None:
        if not self.enabled:
            return
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = _Histogram(buckets)
        h.observe(value)

    # -- state store (unconditional: backs counter_attr/gauge_attr) -----------
    def set_counter(self, name: str, value: float) -> None:
        self._counters[name] = value

    def force_gauge(self, name: str, value: float) -> None:
        self._gauges[name] = value

    # -- reads -----------------------------------------------------------------
    def counter(self, name: str) -> float:
        return self._counters.get(name, 0)

    def gauge(self, name: str) -> float:
        return self._gauges.get(name, 0)

    def values(self, names: Iterable[str]) -> Dict[str, float]:
        """Point snapshot of several counters (the tick-delta helper)."""
        return {n: self._counters.get(n, 0) for n in names}

    def snapshot(self) -> Dict[str, Dict]:
        """Nested plain-data dict (JSON-ready): counters, gauges, and
        histogram bucket tables, each keyed by metric name."""
        return {
            "counters": dict(sorted(self._counters.items())),
            "gauges": dict(sorted(self._gauges.items())),
            "histograms": {k: self._hists[k].snapshot()
                           for k in sorted(self._hists)},
        }

    def render(self) -> str:
        """Prometheus-style text exposition (one sample per line,
        ``# TYPE`` headers, histogram ``_bucket{le=...}``/``_sum``/
        ``_count`` expansion)."""
        lines: List[str] = []
        for name in sorted(self._counters):
            lines += [f"# TYPE {name} counter",
                      f"{name} {_fmt(self._counters[name])}"]
        for name in sorted(self._gauges):
            lines += [f"# TYPE {name} gauge",
                      f"{name} {_fmt(self._gauges[name])}"]
        for name in sorted(self._hists):
            h = self._hists[name]
            lines.append(f"# TYPE {name} histogram")
            cum = 0
            for le, c in zip(h.buckets, h.counts):
                cum += c
                lines.append(f'{name}_bucket{{le="{_fmt(le)}"}} {cum}')
            lines.append(f'{name}_bucket{{le="+Inf"}} {h.count}')
            lines += [f"{name}_sum {_fmt(h.sum)}",
                      f"{name}_count {h.count}"]
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def counter_attr(name: str) -> property:
    """A class attribute that stores an int/float counter IN the owner's
    ``self.metrics`` registry instead of the instance dict.

    This is how the legacy counter APIs became views over the registry
    without touching their call sites: ``self.preemptions = 0`` /
    ``+= 1`` route through here, ``counts()["swap_resumes"]`` and
    ``snapshot()["counters"]["serving_swap_resumes_total"]`` read the
    same cell.  The store path is unconditional (engine state, not
    optional telemetry — see module docstring)."""
    def fget(self):
        return self.metrics.counter(name)

    def fset(self, value):
        self.metrics.set_counter(name, value)

    return property(fget, fset, doc=f"view over registry counter {name!r}")


def gauge_attr(name: str) -> property:
    """``counter_attr`` for point-in-time levels (Prometheus gauges)."""
    def fget(self):
        return self.metrics.gauge(name)

    def fset(self, value):
        self.metrics.force_gauge(name, value)

    return property(fget, fset, doc=f"view over registry gauge {name!r}")


__all__ = [
    "DEFAULT_LATENCY_BUCKETS",
    "MetricsRegistry",
    "counter_attr",
    "gauge_attr",
]
