"""Request-lifecycle tracing: Chrome trace-event JSON over the tick loop
(port of src/repro/serving/tracing.py, same schema).

The engine's aggregate counters (serving/metrics.py) say WHAT happened;
a trace says WHEN and TO WHOM.  ``Tracer`` records the serving stack's
story as Chrome trace-event objects — the format Perfetto
(https://ui.perfetto.dev) and ``chrome://tracing`` load directly:

* **track 0 ("ticks")** — one complete ("X") event per engine tick,
  its args carrying the full ``TickRecord`` twin: phase groups, prefill
  tokens, preemptions, migrated pages/bytes (the 2.5D-link analogue),
  swap in/out bytes, new compiles, resident KV.  Summing a tick-arg
  across the track reproduces the registry total exactly.
* **track req_id + 1 (one per request)** — that request's lifecycle as
  an async "b"/"e" envelope (submit -> finish/shed/abort) containing "X"
  phase spans: ``queued``, ``prefill_chunk`` (args: take, offset),
  ``verify_window`` (drafted/accepted/emitted), ``decode``, ``swap_out``
  / ``swap_in`` (bytes), with instants ("i") for ``preempt``,
  ``first_token``, and ``compile``.

Costs nothing when off: every emitter early-returns on ``enabled`` (the
engine's call sites also guard, so span-argument work is skipped too),
``now()`` returns 0.0 without reading the clock, and the engine's token
streams and device work are the same with tracing on or off — the tracer
never touches device state and never synchronises, it only stamps host
clock readings the engine takes anyway or beside them.

On a CUDA device the kernels run asynchronously, so a span means device
time only where it ends at a synchronisation: the engine's spans end
after the one packed host transfer of their program call where the call
makes one (decode, verify windows, a prefill that completes a prompt)
and after the swap-out's one sync; otherwise they bound the host's
enqueue of the work.

Timestamps: the engine stamps events with ``time.monotonic()`` seconds
(``Request.t_submit`` etc. use the same clock); the tracer rebases to
its construction instant and converts to the format's microseconds.
Tests may inject a fake ``clock`` for deterministic timelines.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional

#: trace "process" id: one serving engine == one process row in Perfetto
PID = 1
#: thread id of the per-tick track; request req_id maps to tid req_id + 1
TICK_TID = 0


class Tracer:
    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        self.enabled = enabled
        self._clock = clock
        self._events: List[Dict[str, Any]] = []
        self._named_tids: set = set()
        self._t0 = clock() if enabled else 0.0
        if enabled:
            self._events.append({
                "ph": "M", "pid": PID, "name": "process_name",
                "args": {"name": "serving-engine"}})
            self._name_tid(TICK_TID, "ticks")

    # -- clock -----------------------------------------------------------------
    def now(self) -> float:
        """Engine-clock seconds (0.0 when disabled — callers guard on
        ``enabled`` before doing span-argument work anyway)."""
        return self._clock() if self.enabled else 0.0

    def _ts(self, t: float) -> float:
        """Seconds on the engine clock -> trace microseconds (>= 0:
        ``t_submit`` may predate a tracer attached mid-run)."""
        return max((t - self._t0) * 1e6, 0.0)

    def _name_tid(self, tid: int, name: str) -> None:
        if tid in self._named_tids:
            return
        self._named_tids.add(tid)
        self._events.append({
            "ph": "M", "pid": PID, "tid": tid, "name": "thread_name",
            "args": {"name": name}})

    def _req_tid(self, req_id: int) -> int:
        tid = req_id + 1
        self._name_tid(tid, f"req {req_id}")
        return tid

    # -- emitters ---------------------------------------------------------------
    def begin_request(self, req_id: int, t: float, **args: Any) -> None:
        """Open a request's lifecycle envelope (async "b"; closed by
        ``end_request`` at finish/abort)."""
        if not self.enabled:
            return
        self._events.append({
            "ph": "b", "cat": "request", "id": req_id, "pid": PID,
            "tid": self._req_tid(req_id), "ts": self._ts(t),
            "name": "request", "args": args})

    def end_request(self, req_id: int, t: float, **args: Any) -> None:
        if not self.enabled:
            return
        self._events.append({
            "ph": "e", "cat": "request", "id": req_id, "pid": PID,
            "tid": self._req_tid(req_id), "ts": self._ts(t),
            "name": "request", "args": args})

    def request_span(self, req_id: int, name: str, t0: float, t1: float,
                     **args: Any) -> None:
        """One complete ("X") phase span on the request's track."""
        if not self.enabled:
            return
        ts = self._ts(t0)
        self._events.append({
            "ph": "X", "cat": "phase", "pid": PID,
            "tid": self._req_tid(req_id), "ts": ts,
            "dur": max(self._ts(t1) - ts, 0.0), "name": name, "args": args})

    def tick_span(self, t0: float, t1: float, **args: Any) -> None:
        """One engine tick on the tick track; ``args`` carry the
        ``TickRecord`` twin the conservation tests sum over."""
        if not self.enabled:
            return
        ts = self._ts(t0)
        self._events.append({
            "ph": "X", "cat": "tick", "pid": PID, "tid": TICK_TID,
            "ts": ts, "dur": max(self._ts(t1) - ts, 0.0), "name": "tick",
            "args": args})

    def instant(self, name: str, t: float, req_id: Optional[int] = None,
                **args: Any) -> None:
        """Point event ("i"): preempt / first_token / compile / ...;
        lands on the request's track when ``req_id`` is given, else on
        the tick track."""
        if not self.enabled:
            return
        tid = TICK_TID if req_id is None else self._req_tid(req_id)
        self._events.append({
            "ph": "i", "cat": "instant", "s": "t", "pid": PID, "tid": tid,
            "ts": self._ts(t), "name": name, "args": args})

    # -- export ------------------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        """The recorded trace events (the live list — cheap; callers
        treat it as read-only)."""
        return self._events

    def to_json(self) -> Dict[str, Any]:
        """JSON-object-format Chrome trace (the shape Perfetto and
        ``chrome://tracing`` open directly)."""
        return {"traceEvents": self._events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


__all__ = ["PID", "TICK_TID", "Tracer"]
