"""Executor layer: the phase-program table and compile counting for the
serving engine (port of src/repro/serving/executor.py).

The EngineCore (``serving/engine.py``) is host-only — it plans ticks,
packs batches, and keeps request/page accounting.  The programs it runs
live HERE, keyed by (worker group, phase kind): the strategy table routes
each phase to a group, exactly as in the reference.  PyTorch runs eagerly,
so a program is the engine's bound ``_*_impl`` method itself; there is
nothing to trace or donate (the pool is updated in place).

Compile counting keeps its meaning: every phase call notes its (group,
kind, bucketed shape, all_greedy) key, and a first sighting counts.  Those
keys are the shapes a compiled runtime (CUDA graphs, a later step) would
capture, and a second wave of the same traffic adds ZERO — the guarantee
the bucket ladders exist to provide.

Only the colocated placement is ported; the disaggregated executor arrives
with ROADMAP queue A, item 9.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from repro_torch.serving.metrics import MetricsRegistry, counter_attr


class Executor:
    """Base executor: program table + compile accounting, no placement."""

    # the phase-program kinds the port serves: one-token decode and the
    # packed-stream prefill over the paged pool (``*_paged``) or the dense
    # arena, the dense arena's whole-prompt prefill, and over the pool the
    # padded [N, C] chunk prefill and the speculative verify window (the
    # dense arena's padded "chunk" is ROADMAP queue A, item 11)
    KINDS = frozenset({"whole", "decode", "packed", "decode_paged",
                       "packed_paged", "chunk_paged", "verify"})

    # lifetime counter in the metrics registry (the engine shares its own,
    # so counts()/snapshot() and this attribute read the same cell)
    compile_count = counter_attr("serving_compiles_total")

    def __init__(self, impls: Dict[str, Callable], *,
                 metrics: Optional[MetricsRegistry] = None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.impls = impls
        self._compile_keys: set = set()
        self.compile_count = 0           # distinct phase-program shapes
        self.tick_new_compiles = 0

    def program(self, group: str, kind: str) -> Callable:
        """The program for (worker group, phase kind): with one device
        every group runs the engine's own implementation."""
        if kind not in self.KINDS:
            raise NotImplementedError(f"phase program {kind!r}: later slice")
        return self.impls[kind]

    def note_compile(self, group: str, kind: str, shape: Tuple[int, ...],
                     all_greedy: bool) -> None:
        """Record one phase-program call's shape key; a first sighting
        counts as a compile."""
        key = (group, kind, shape, bool(all_greedy))
        if key not in self._compile_keys:
            self._compile_keys.add(key)
            self.compile_count += 1
            self.tick_new_compiles += 1

    def begin_tick(self) -> None:
        self.tick_new_compiles = 0


class ColocatedExecutor(Executor):
    """Default placement: one device runs every program."""


def make_executor(name: str, impls: Dict[str, Callable], *,
                  metrics: Optional[MetricsRegistry] = None) -> Executor:
    """ServeConfig.executor -> Executor instance."""
    if name == "colocated":
        return ColocatedExecutor(impls, metrics=metrics)
    if name == "disaggregated":
        raise NotImplementedError("executor='disaggregated': later slice "
                                  "(ROADMAP queue A, item 9)")
    raise ValueError(f"executor={name!r} (expected 'colocated' or "
                     "'disaggregated')")


__all__ = ["ColocatedExecutor", "Executor", "make_executor"]
