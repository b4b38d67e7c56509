"""Executor layer: the phase-program table, compile counting and device
placement for the serving engine (port of src/repro/serving/executor.py).

The EngineCore (``serving/engine.py``) is host-only — it plans ticks,
packs batches, and keeps request/page accounting.  The programs it runs
live HERE, keyed by (worker group, phase kind): the strategy table routes
each phase to a group, exactly as in the reference.  PyTorch runs eagerly,
so a program is the engine's bound ``_*_impl`` method itself; there is
nothing to trace or donate (the pool is updated in place).  Two
placements:

* ``ColocatedExecutor`` — every program runs on the engine's device (the
  default).
* ``DisaggregatedExecutor`` — the HALO shape: prefill-side programs
  (whole / packed / chunk prefill and the speculative verify window: the
  CiM-analogue GEMM phases) are pinned to the PREFILL device group and
  decode programs (the CiD-analogue GEMV phase) to the DECODE group
  (``launch/mesh.phase_device_groups``; pinning makes the group's first
  CUDA device the current one, ``torch.cuda.device``).  At each prefill ->
  decode handoff the engine reports the request's freshly-filled KV pages
  via ``record_handoff``; the executor accounts them as pages and bytes
  crossing the 2.5D interposer link, batched per tick.  With one device
  both groups are that device, so streams equal the colocated ones while
  the ownership accounting runs for real; a CPU engine pins nothing.

Compile counting keeps its meaning: every phase call notes its (group,
kind, bucketed shape, all_greedy) key, and a first sighting counts.  Those
keys are the shapes a compiled runtime (CUDA graphs, a later step) would
capture, and a second wave of the same traffic adds ZERO — the guarantee
the bucket ladders exist to provide.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.launch.mesh import phase_device_groups
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
    # phase classification: decode kinds run on the decode (CiD) side,
    # everything else — prefill chunks AND speculative verify windows
    # (k+1-token prefill-shaped GEMMs) — on the prefill (CiM) side
    DECODE_KINDS = frozenset({"decode", "decode_paged"})

    #: True iff KV ownership moves at the prefill -> decode handoff
    #: (the engine consults this before computing handoff footprints)
    migrates_kv: bool = False

    # lifetime counters in the metrics registry (the engine shares its
    # own, so counts()/snapshot() and these attributes read the same cells)
    compile_count = counter_attr("serving_compiles_total")
    migrated_pages = counter_attr("serving_migrated_pages_total")
    migrated_bytes = counter_attr("serving_migrated_bytes_total")
    migration_batches = counter_attr("serving_migration_batches_total")

    def __init__(self, impls: Dict[str, Callable], *,
                 metrics: Optional[MetricsRegistry] = None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.impls = impls
        self.programs: Dict[Tuple[str, str], Callable] = {}
        self._compile_keys: set = set()
        self.compile_count = 0           # distinct phase-program shapes
        self.tick_new_compiles = 0
        # migration counters (stay 0 forever on the colocated executor)
        self.migrated_pages = 0          # KV pages moved prefill -> decode
        self.migrated_bytes = 0          # the 2.5D-link byte analogue
        self.migration_batches = 0       # ticks with >= 1 handoff
        self.tick_migrated_pages = 0
        self.tick_migrated_bytes = 0

    # -- placement -------------------------------------------------------------
    def phase_of(self, kind: str) -> str:
        return "decode" if kind in self.DECODE_KINDS else "prefill"

    def device_for(self, kind: str) -> Optional[torch.device]:
        """Device the programs of ``kind`` are pinned to, or None for the
        engine's own (colocated)."""
        return None

    def program(self, group: str, kind: str) -> Callable:
        """The program for (worker group, phase kind): the engine's own
        implementation, pinned to ``device_for(kind)`` when the executor
        places phases on separate device groups."""
        if kind not in self.KINDS:
            raise NotImplementedError(f"phase program {kind!r}: later slice")
        key = (group, kind)
        if key not in self.programs:
            fn = self.impls[kind]
            dev = self.device_for(kind)
            if dev is not None and dev.type == "cuda":
                fn = _pin(fn, dev)
            self.programs[key] = fn
        return self.programs[key]

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
        self.tick_migrated_pages = 0
        self.tick_migrated_bytes = 0

    def record_handoff(self, pages: int, nbytes: int) -> None:
        """One request's prefill -> decode KV handoff (colocated: no
        ownership moves, nothing to record)."""

    def stats(self) -> Dict[str, int]:
        return {
            "compile_count": self.compile_count,
            "migrated_pages": self.migrated_pages,
            "migrated_bytes": self.migrated_bytes,
            "migration_batches": self.migration_batches,
        }


class ColocatedExecutor(Executor):
    """Default placement: one device runs every program."""


class DisaggregatedExecutor(Executor):
    """Prefill programs pinned to the prefill device group, decode
    programs to the decode group, with KV page ownership migrating at the
    prefill -> decode handoff (batched per tick — HALO's 2.5D link).

    ``devices`` overrides the (prefill_group, decode_group) split; by
    default ``phase_device_groups`` halves the visible CUDA devices (one
    card serves both groups, which keeps streams equal to the colocated
    ones while the ownership accounting still runs for real)."""

    migrates_kv = True

    def __init__(self, impls: Dict[str, Callable], *,
                 metrics: Optional[MetricsRegistry] = None,
                 devices: Optional[Tuple[List[Any], List[Any]]] = None):
        super().__init__(impls, metrics=metrics)
        groups = devices if devices is not None else phase_device_groups()
        self.prefill_devices, self.decode_devices = groups

    def device_for(self, kind: str) -> Optional[torch.device]:
        group = (self.decode_devices if self.phase_of(kind) == "decode"
                 else self.prefill_devices)
        return torch.device(group[0]) if group else None

    def record_handoff(self, pages: int, nbytes: int) -> None:
        if pages <= 0 and nbytes <= 0:
            return
        if not self.tick_migrated_pages and not self.tick_migrated_bytes:
            self.migration_batches += 1      # first handoff this tick
        self.tick_migrated_pages += pages
        self.tick_migrated_bytes += nbytes
        self.migrated_pages += pages
        self.migrated_bytes += nbytes

    def stats(self) -> Dict[str, int]:
        out = super().stats()
        out["prefill_devices"] = len(self.prefill_devices)
        out["decode_devices"] = len(self.decode_devices)
        return out


def _pin(fn: Callable, dev: torch.device) -> Callable:
    """Run ``fn`` with CUDA device ``dev`` current, so the tensors a
    program creates without a device land on its phase's group (the
    tensors it is given keep theirs)."""
    def run(*args, **kwargs):
        with torch.cuda.device(dev):
            return fn(*args, **kwargs)
    return run


def make_executor(name: str, impls: Dict[str, Callable], *,
                  metrics: Optional[MetricsRegistry] = None,
                  device=None) -> Executor:
    """ServeConfig.executor -> Executor instance.  ``device`` is the
    engine's: a CPU engine's groups are ``[cpu]``, a CUDA engine's the
    visible CUDA devices."""
    if name == "colocated":
        return ColocatedExecutor(impls, metrics=metrics)
    if name == "disaggregated":
        devices = None
        if device is not None and torch.device(device).type != "cuda":
            devices = phase_device_groups([torch.device(device)])
        return DisaggregatedExecutor(impls, metrics=metrics,
                                     devices=devices)
    raise ValueError(f"executor={name!r} (expected 'colocated' or "
                     "'disaggregated')")


__all__ = [
    "ColocatedExecutor",
    "DisaggregatedExecutor",
    "Executor",
    "make_executor",
]
