"""Serving datatypes: the host-only vocabulary shared by every layer.

The serving stack has three layers (see docs/serving.md
§Disaggregated serving):

  * **EngineCore** (``serving/engine.py``) — request lifecycle +
    ``PhaseScheduler`` driving; device-agnostic;
  * **Executor** (``serving/executor.py``) — the jitted program table,
    compile counting, and device placement (colocated or disaggregated
    prefill/decode device groups with KV-page migration);
  * **KV tiers** (``serving/kv_pool.py``) — the device ``PagePool`` plus
    an optional host-memory spill tier behind it.

These dataclasses are the contract between them — pure host types.
The port keeps every ``ServeConfig`` field of the reference; the engine
raises ``NotImplementedError`` for the options whose slice has not been
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, List, Optional

import numpy as np

from repro_torch.serving.metrics import SLO
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import (AdmissionConfig, PhaseAwareConfig,
                                           PRIORITY_STANDARD)
from repro_torch.serving.speculative import SpecConfig


class RequestState(Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    DONE = "done"


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray                  # [T] int32 (or [K, T])
    sampling: SamplingParams = field(default_factory=SamplingParams)
    # filled by the engine
    state: RequestState = RequestState.WAITING
    generated: List[Any] = field(default_factory=list)
    finish_reason: Optional[str] = None  # "length"|"eos"|"stop"|"abort"
    seed: int = 0                       # effective per-request PRNG seed
    slot: int = -1
    prompt_len: int = 0
    prefill_pos: int = 0                # prompt tokens already in the arena
    cached_tokens: int = 0              # prefix tokens attached from cache
    n_preempted: int = 0                # pool-exhaustion evictions survived
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    t_requeue: float = 0.0              # last preemption re-queue instant
    # latency deadlines for goodput accounting (serving/metrics.py);
    # None = best-effort, excluded from SLO attainment
    slo: Optional[SLO] = None
    # scheduling lane (scheduler.PRIORITY_*): prefill admission orders by
    # (priority, TTFT deadline, age) — see PhaseScheduler.plan_tick
    priority: int = PRIORITY_STANDARD
    # host-tier swap handle (set while the request's KV pages live in the
    # host spill pool between a swap-out preemption and its swap-in resume)
    swap: Optional[Any] = None

    @property
    def max_new_tokens(self) -> int:
        return self.sampling.max_new_tokens

    @property
    def eos_id(self) -> Optional[int]:
        return self.sampling.eos_id

    @property
    def ttft_deadline_s(self) -> float:
        """Absolute wall-clock instant the first token is due (``inf``
        for best-effort requests or an SLO with no TTFT term) — the EDF
        key ``PhaseScheduler.plan_tick`` orders prefill admission by,
        and the bound the admission controller projects against."""
        if self.slo is not None and self.slo.ttft_ms is not None:
            return self.t_submit + self.slo.ttft_ms / 1e3
        return float("inf")

    @property
    def ttft(self) -> float:
        """Time to first token; NaN for a request that never emitted one
        (max_new_tokens=0, aborted pre-first-token) — the old sentinel
        arithmetic returned a large negative number instead."""
        if self.t_first_token <= 0.0:
            return float("nan")
        return self.t_first_token - self.t_submit

    @property
    def tpot(self) -> float:
        """Time per output token after the first; NaN when undefined
        (no token ever emitted, or not yet finished)."""
        if self.t_first_token <= 0.0 or self.t_done <= 0.0:
            return float("nan")
        n = max(len(self.generated) - 1, 1)
        return (self.t_done - self.t_first_token) / n


@dataclass(frozen=True)
class RequestOutput:
    """One incremental slice of a request's token stream.

    ``step()`` returns one per request that advanced this tick (new
    tokens appended and/or the request finished); ``stream()`` yields
    them as they are produced.  ``new_token_ids`` holds only THIS
    step's tokens (ints, or per-codebook lists for multi-codebook
    heads); ``n_generated`` is the cumulative count.  ``finish_reason``
    is set on the final output: "length" (max_new_tokens or arena/pool
    length bound), "eos", "stop" (a ``SamplingParams.stop`` token), or
    "abort"."""
    req_id: int
    new_token_ids: List[Any]
    n_generated: int
    finished: bool
    finish_reason: Optional[str] = None


@dataclass
class TickRecord:
    """One engine tick as executed (mirrors the TickPlan it consumed)."""
    index: int
    prefill_reqs: List[int]
    prefill_tokens: int
    decode_reqs: List[int]
    prefill_group: str
    decode_group: str
    wall_s: float
    preemptions: int = 0                # pool evictions this tick (paged)
    kv_resident_bytes: int = 0          # allocated KV bytes after the tick
    spec_drafted: int = 0               # draft tokens verified this tick
    spec_accepted: int = 0              # draft tokens accepted this tick
    new_compiles: int = 0               # phase-program shapes first seen here
    # prefill -> decode KV migration (DisaggregatedExecutor: the 2.5D-link
    # analogue; one batch per tick covers every handoff the tick completed)
    migrated_pages: int = 0
    migrated_bytes: int = 0
    # host spill tier (swap preemption + prefix demote/promote)
    swap_out_bytes: int = 0             # device -> host bytes this tick
    swap_in_bytes: int = 0              # host -> device bytes this tick
    host_resident_pages: int = 0        # host-tier pages in use after tick

    @property
    def mixed(self) -> bool:
        """Both phases ran this tick (prefill/decode interleaving)."""
        return bool(self.prefill_reqs) and bool(self.decode_reqs)


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512                  # dense arena length (unused if paged)
    phase: PhaseAwareConfig = field(default_factory=PhaseAwareConfig)
    # DEPRECATED engine-wide sampling fields: sampling is per-request now
    # (``submit(..., sampling=SamplingParams(...))``).  These survive as
    # the default SamplingParams for submits that pass none — setting any
    # of them off-default warns at engine construction.
    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0                  # nucleus sampling (0 = off)
    seed: int = 0                       # base seed for derived request seeds
    # speculative decoding (serving/speculative.py, requires paged): a
    # drafter proposes up to k tokens per decode tick and one verify
    # window of the target model accepts/rejects them all at once
    speculative: Optional[SpecConfig] = None
    # paged KV arena (serving/kv_pool.py): capacity = n_pages * page_size
    # tokens PER POOL, not per slot — prompts/generations are bounded by
    # pool capacity rather than max_len
    paged: bool = False
    page_size: int = 16
    n_pages: int = 64
    # KV page dtype (paged only): "int8" stores GQA K/V pages and MLA
    # latent pages quantized per token; "int4" packs GQA K/V two nibbles
    # per byte (MLA latents stay int8 — see serving/kv_pool.py)
    kv_dtype: str = "f32"
    # weight dtype: "int8" runs quantize_params at engine build and serves
    # from {"q","scale"} leaves — decode-shaped matmuls then route through
    # the fused quantized Pallas GEMV (models/layers.matmul)
    weights_dtype: str = "f32"
    # radix prefix cache over the page pool (requires paged): shared-prompt
    # KV pages are reused copy-on-write instead of recomputed
    prefix_cache: bool = False
    # packed prefill: the tick's chunks run as ONE flat token stream with
    # per-segment metadata (models/transformer.forward_chunk_packed)
    # instead of a padded [N, C] batch — pad work drops from
    # N*C - sum(take) to the pack-alignment remainder, and the compiled
    # shape is keyed by ONE bucketed length instead of an (N, C) grid.
    # Applies to chunked attention-only single-codebook plans; everything
    # else falls back to the padded path.  Greedy streams are
    # bit-identical either way.
    packed_prefill: bool = True
    # executor: "colocated" (one device group runs every program — today's
    # behavior, the default) or "disaggregated" (prefill/verify programs
    # pinned to the prefill device group, decode programs to the decode
    # group, with KV pages migrating at the prefill->decode handoff —
    # serving/executor.py; greedy streams are bit-identical either way)
    executor: str = "colocated"
    # host-memory spill tier (paged only): pages per run the HostTier may
    # hold.  > 0 makes preemption SWAP a victim's KV pages to host memory
    # and resume by swapping them back in (zero re-prefilled tokens)
    # instead of recompute-on-resume, and lets evicted prefix-cache nodes
    # demote to host and promote on re-hit.  0 disables the tier
    # (recompute-on-resume, prefix eviction is terminal)
    host_spill_pages: int = 0
    # admission control (scheduler.AdmissionController): shed/defer work
    # at submit() when projected TTFT under current occupancy busts the
    # request's deadline, instead of admitting into preemption thrash.
    # None disables it (every submit is admitted)
    admission: Optional[AdmissionConfig] = None

    def __post_init__(self):
        if self.executor not in ("colocated", "disaggregated"):
            raise ValueError(f"executor={self.executor!r} (expected "
                             "'colocated' or 'disaggregated')")

    _LEGACY_SAMPLING_DEFAULTS = (True, 1.0, 0, 0.0)

    def legacy_sampling_overridden(self) -> bool:
        return ((self.greedy, self.temperature, self.top_k, self.top_p)
                != self._LEGACY_SAMPLING_DEFAULTS)

    def default_sampling(self) -> SamplingParams:
        """The deprecated engine-wide sampling fields as a per-request
        default.  ``greedy=True`` maps to temperature 0 (the new API's
        greedy); the legacy ``max(temperature, 1e-6)`` floor applies only
        inside this shim — ``SamplingParams(temperature=0)`` itself IS
        greedy, with no epsilon rewriting."""
        return SamplingParams(
            temperature=0.0 if self.greedy else max(self.temperature, 1e-6),
            top_k=self.top_k, top_p=self.top_p)


__all__ = [
    "Request",
    "RequestOutput",
    "RequestState",
    "ServeConfig",
    "TickRecord",
]
