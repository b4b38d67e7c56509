"""Serving engine: continuous batching that EXECUTES the phase scheduler's
plan (port of src/repro/serving/engine.py, over the paged pool or the dense
arena).

One engine tick = one ``PhaseScheduler.plan_tick`` executed verbatim:

  1. admit    — waiting requests claim free decode slots (a request whose
                KV was swapped to the host tier swaps back in first);
  2. prefill  — the plan's (request, n_tokens) chunks are laid out as ONE
                flat token stream (``pack_chunks``) and run through the
                prefill-group program, which writes K/V straight into the
                arena at each request's slot and offset (HALO's CiM -> CiD
                handoff).  Long prompts prefill across several ticks,
                interleaved with decode.  With ``prefill_chunk = 0`` each
                prompt prefills whole in one program instead (the dense
                arena only), its K/V spliced into its slot;
  3. decode   — one batched token step for every DECODING slot, sampled on
                the device, one [B] host transfer per tick.

The KV arena is either the dense per-slot arena [L, max_batch, max_len,
Hkv, D] (``paged=False``, the ``ServeConfig`` default: every slot pins
max_len positions, decode runs on all max_batch rows with per-slot
positions, and only the active slots write their K/V) or the block pool of
``serving/kv_pool.py`` (``paged=True``).  In the pool, capacity is a
POOL property, the scheduler admits prefill tokens only while free pages
cover them (decode's one-token growth is reserved first), and when the pool
runs out mid-decode the YOUNGEST page-holding request is preempted — its
pages return to the pool and it re-queues with its generated tokens folded
into the prompt (recompute-on-resume), so the oldest request always
finishes.  Decode attention runs in the paged (or dense) flash-decode
kernel, chunked prefill attention in the packed-prefill kernel and a
whole prompt above 2048 tokens in the flash-attention kernel; the arena is
updated in place.

An SSM plan (Mamba-2) keeps a conv window and an f32 recurrent state per
slot in the dense arena, prefills every prompt whole (its prefill runs the
SSD chunk kernel) and cannot use the paged pool, as in the reference.

On the paged pool, ``packed_prefill=False`` lays a tick's chunks out as a
padded [N, C] batch instead (``forward_chunk``, plain attention).

THE REQUEST API: ``submit(prompt, sampling=SamplingParams(...))`` carries
per-request temperature (0 = greedy) / top-k / top-p / seed / token budget
/ stop conditions.  Every program takes per-row [N] parameter tensors
(``_pack_params``: one upload per call), so one program serves a batch
mixing greedy and stochastic requests, still one host transfer per call; a
tick whose rows are all greedy keeps the argmax path (no sort, no draws).
A stochastic row's draws are a pure function of its seed and its emission
count (``sampling.row_keys``).  ``step()`` returns incremental
``RequestOutput``s, ``stream()`` / ``generate()`` are the streaming and
batch facades, ``abort(req_id)`` cancels a request at any stage (queued,
swapped out, prefilling, decoding) and ``metrics_snapshot()`` returns the
registry with the occupancy gauges refreshed.

PREFIX CACHE (``prefix_cache=True``, paged only): a radix index over
page-aligned token-block hashes (``serving/prefix_cache.py``) maps each
new prompt's longest cached prefix to physical pages; admission attaches
them to the slot's block tables (refcounted, no compute) and starts
prefill past them, and completed prefills publish their prompt pages.
Before any program writes a shared page the engine moves the slot to a
private copy (``KVPool.ensure_writable`` and one device page copy of
every leaf of the run, scale pages included).  Cached pages are evicted
LRU-first whenever live work needs pages, before any live request is
preempted.

SPECULATIVE DECODING (``speculative=SpecConfig(drafter="ngram")``, paged
only): every decode tick the n-gram drafter proposes up to k tokens per
decoding request, and ONE verify window of the target model (a padded
[N, k+1] chunk forward, logits at every position) accepts the longest
prefix agreeing with the target (greedy rows) or runs Leviathan rejection
sampling (stochastic rows), plus one correction or bonus token; the packed
[N, k+2] result crosses to the host once.  Rejected tokens' KV rolls back
via ``KVPool.truncate``.

THE HOST TIER (``host_spill_pages > 0``, paged only): ``HostTier`` holds
that many pages per run in host memory (pinned when the pool is on the
card).  A preemption victim's pages swap out to it — one ``index_select``
per leaf into pinned memory, one sync a swap — and swap back in at
re-admission, so the request resumes with zero recomputation (recompute
stays the fallback when the tier is full); with the prefix cache, evicted
blocks demote to the tier and promote back on a later hit instead of being
dropped.

EXECUTORS (``serving/executor.py``): ``colocated`` runs every program on
the engine's device; ``disaggregated`` pins prefill-side programs and
decode programs to separate device groups and prices every prefill ->
decode handoff as KV crossing the 2.5D link (``_record_handoff``).  With
one card both groups are that card, and streams equal the colocated ones.

SLO-AWARE ADMISSION (``admission=AdmissionConfig(...)``): ``submit(...,
slo=SLO(...), priority=PRIORITY_*)`` attaches TTFT/TPOT deadlines and a
scheduling lane.  Slots and the prefill budget go by (priority, TTFT
deadline, age); the ``AdmissionController`` refuses at submit a request
whose projected TTFT (the backlog in ticks times a fixed ``tick_cost_s``
or the live tick-wall EMA) busts its deadline — finish reason "shed" — and
parks best-effort requests over ``max_pending_tokens`` in ``deferred``
until the backlog drains.  Deadline-carrying requests count into the
``serving_slo_*`` counters at retirement (shed ones un-attained, aborted
ones not at all), which ``goodput()`` reads.  A ``Tracer`` passed at
construction records every request's lifecycle and every tick as Chrome
trace events (``serving/tracing.py``); disabled (the default) it reads no
clock and the engine's device work is unchanged.  ``serving/frontend.py``
(``AsyncEngine``) serves concurrent asyncio clients over one engine.

The host logic (admission, planning, packing, preemption, swapping,
retirement, counters) is the reference's, line for line where the slice
reaches it, so the tick log of this engine equals the reference engine's
on the same traffic.  ``ServeConfig`` options outside the slice raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import math
import time
import warnings
from collections import deque
from dataclasses import dataclass, replace
from typing import (Any, Callable, Deque, Dict, Iterator, List, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import (
    forward,
    forward_chunk,
    forward_chunk_packed,
    init_cache,
    prefill_into_arena,
    supports_chunked_prefill,
    supports_paged,
)
from repro_torch.serving.executor import make_executor
from repro_torch.serving.kv_pool import HostTier, KVPool
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.quantized_weights import quantize_params
from repro_torch.serving.metrics import (SLO, MetricsRegistry,
                                         counter_attr, gauge_attr,
                                         slo_attainment)
from repro_torch.serving.sampling import (SamplingParams, row_keys,
                                          sample_greedy, sample_tokens_rows,
                                          verify_draft, verify_draft_rows)
from repro_torch.serving.scheduler import (
    AdmissionController,
    PhaseScheduler,
    TickPlan,
    bucket_pow2 as _bucket,
    pack_chunks,
)
from repro_torch.serving.speculative import build_drafter
from repro_torch.serving.tracing import Tracer
from repro_torch.serving.types import (                      # noqa: F401
    Request,
    RequestOutput,
    RequestState,
    ServeConfig,
    TickRecord,
)

__all__ = [
    "Request", "RequestOutput", "RequestState", "ServeConfig",
    "ServingEngine", "TickRecord",
]


def _refused(cfg: ModelConfig, sc: ServeConfig) -> None:
    """The combinations the reference refuses for good, with its
    ``ValueError``s, in its order (src/repro/serving/engine.py:244-310)."""
    if sc.weights_dtype not in ("f32", "int8"):
        raise ValueError(f"weights_dtype={sc.weights_dtype!r} "
                         "(expected 'f32' or 'int8')")
    if sc.paged:
        if not supports_paged(cfg):
            raise ValueError(
                f"{cfg.name}: paged serving needs an all-attention plan "
                "(SSM / shared-attention runs keep the dense arena)")
        if sc.phase.prefill_chunk <= 0:
            raise ValueError("paged serving requires chunked prefill "
                             "(prefill_chunk > 0)")
    else:
        if sc.kv_dtype != "f32":
            raise ValueError(
                f"kv_dtype={sc.kv_dtype!r} requires paged=True (the "
                "dense engine stores the arena in the model dtype)")
        if sc.prefix_cache:
            raise ValueError("prefix_cache=True requires paged=True "
                             "(prefix reuse shares physical pages "
                             "through the block tables)")
    if sc.host_spill_pages < 0:
        raise ValueError(f"host_spill_pages={sc.host_spill_pages} < 0")
    if sc.host_spill_pages and not sc.paged:
        raise ValueError("host_spill_pages > 0 requires paged=True "
                         "(the spill tier stores device pool pages)")
    if sc.speculative is not None:
        if not sc.paged:
            raise ValueError(
                "speculative decoding requires paged=True (the "
                "draft/verify loop writes and rolls back through the "
                "paged arena's block tables)")
        if cfg.n_codebooks > 1:
            raise ValueError("speculative decoding does not support "
                             "multi-codebook heads")


def _unported(sc: ServeConfig, chunked: bool) -> Optional[str]:
    """The first ``ServeConfig`` option this slice does not serve, with the
    ROADMAP queue A item that brings it; None when every option is in.
    ``packed_prefill`` matters only to a chunked prefill: the reference
    reads it as ``packed_prefill and chunked``."""
    checks = [
        (not sc.packed_prefill and chunked and not sc.paged,
         "packed_prefill=False on the dense arena (the padded [N, C] "
         "prefill batch): item 11"),
        (sc.speculative is not None and sc.speculative.drafter == "model",
         "speculative drafter='model' (a draft model): item 7c"),
    ]
    for hit, what in checks:
        if hit:
            return what
    return None


@dataclass
class _SwapHandle:
    """Where a swapped-out request's KV lives while it waits in the queue
    (``Request.swap``): per-run host-tier page lists in block-table row
    order, plus the slot state a swap-in must restore verbatim."""
    length: int                       # logical tokens the pages back
    pages: List[List[int]]            # per run: host page ids, row order
    prefill_pos: int
    cached_tokens: int
    pos: int                          # slot_pos at swap-out (-1 mid-prefill)
    state: RequestState               # PREFILLING or DECODING


class ServingEngine:
    # Lifetime counters live in the METRICS REGISTRY (serving/metrics.py):
    # each attribute below is a view over one named registry cell, so the
    # dict APIs (counts()) and MetricsRegistry.snapshot() / render() can
    # never disagree.  The executor, HostTier and PrefixCache share the
    # same registry.
    host_transfers = counter_attr("serving_host_transfers_total")
    aborted = counter_attr("serving_aborted_total")
    admission_shed = counter_attr("serving_admission_shed_total")
    admission_deferred = counter_attr("serving_admission_deferred_total")
    preemptions = counter_attr("serving_preemptions_total")
    swap_outs = counter_attr("serving_swap_outs_total")
    swap_resumes = counter_attr("serving_swap_resumes_total")
    recompute_preemptions = counter_attr("serving_recompute_preemptions_total")
    prefill_tokens_executed = counter_attr("serving_prefill_tokens_total")
    cow_copies = counter_attr("serving_cow_copies_total")
    cache_evicted_pages = counter_attr("serving_cache_evicted_pages_total")
    spec_windows = counter_attr("serving_spec_windows_total")
    spec_drafted = counter_attr("serving_spec_drafted_total")
    spec_accepted = counter_attr("serving_spec_accepted_total")
    decode_tokens_emitted = counter_attr("serving_decode_tokens_total")
    decode_slot_ticks = counter_attr("serving_decode_slot_ticks_total")
    prefill_launches = counter_attr("serving_prefill_launches_total")
    prefill_rows_executed = counter_attr("serving_prefill_rows_total")
    kv_resident_peak = gauge_attr("serving_kv_resident_peak_bytes")
    _n_ticks = counter_attr("serving_ticks_total")
    _n_prefill_ticks = counter_attr("serving_prefill_ticks_total")
    _n_decode_ticks = counter_attr("serving_decode_ticks_total")
    _n_mixed_ticks = counter_attr("serving_mixed_ticks_total")

    # the counters step() diffs to fill each TickRecord's per-tick fields
    _TICK_DELTA_KEYS = ("serving_preemptions_total",
                        "serving_spec_drafted_total",
                        "serving_spec_accepted_total",
                        "serving_swap_out_bytes_total",
                        "serving_swap_in_bytes_total")

    def __init__(self, cfg: ModelConfig, params: Any, sc: ServeConfig,
                 *, device=None, tracer: Optional[Tracer] = None):
        """``params`` must already live on ``device`` (``cuda`` unless the
        caller passes another, e.g. ``device="cpu"``).  Pass
        ``tracer=Tracer()`` to record the Chrome trace timeline (off by
        default)."""
        _refused(cfg, sc)
        chunked = supports_chunked_prefill(cfg) and sc.phase.prefill_chunk > 0
        what = _unported(sc, chunked)
        if what is not None:
            raise NotImplementedError(
                f"ServeConfig {what} of ROADMAP queue A (later slice)")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.metrics = MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.cfg = cfg
        if sc.weights_dtype == "int8":
            # serving quantizes EVERY matmul leaf (min_size=0): HALO's CiD
            # computes int8 end to end, and decode-shaped products read the
            # int8 bytes in the GEMV kernel (models/layers.matmul)
            params = quantize_params(params, min_size=0)
        self.params = params
        self.sc = sc
        if sc.legacy_sampling_overridden():
            warnings.warn(
                "ServeConfig's engine-wide sampling fields (greedy/"
                "temperature/top_k/top_p) are deprecated: pass per-request "
                "SamplingParams via submit(..., sampling=...).  The values "
                "given are used as the default SamplingParams for submits "
                "that pass none.", DeprecationWarning, stacklevel=2)
        self._default_sampling = sc.default_sampling()
        self.scheduler = PhaseScheduler(sc.phase)
        B, S = sc.max_batch, sc.max_len
        self.paged = sc.paged
        self.pool: Optional[KVPool] = None
        if sc.paged:
            self.pool = KVPool(cfg, n_slots=B, n_pages=sc.n_pages,
                               page_size=sc.page_size, kv_dtype=sc.kv_dtype,
                               device=self.device)
            self.cache = self.pool.caches
        else:
            self.cache = init_cache(cfg, B, S, self.device)
        # host-memory spill tier (tiered KV): preemption swaps pages out
        # instead of recomputing, prefix-cache evictions demote to host
        self.host_tier: Optional[HostTier] = (
            HostTier(self.pool, sc.host_spill_pages, metrics=self.metrics)
            if sc.paged and sc.host_spill_pages > 0 else None)
        self.prefix: Optional[PrefixCache] = None
        if sc.paged and sc.prefix_cache:
            tiered = self.host_tier is not None
            self.prefix = PrefixCache(
                sc.page_size, self.pool.shareable_capacity(),
                demote=self._demote_pages if tiered else None,
                promote=self._promote_pages if tiered else None,
                discard=self._discard_host_pages if tiered else None,
                metrics=self.metrics)
        self.spec = sc.speculative
        self.drafter = None
        if self.spec is not None:
            self.drafter = build_drafter(self.spec)
            # rings bound rollback: a draft written at position p >= R
            # would overwrite live history at p - R that a rejection cannot
            # restore — speculation stops there (KVPool.rollback_bound)
            self._rollback_bound = self.pool.rollback_bound()
        # the dense arena pins its full footprint up front; the split
        # prices a slot's handoff as the reference's does: seq-axis leaves
        # ([L, B, S, ...]) per token, recurrent-state leaves (SSM conv and
        # state) per slot
        self._dense_kv_bytes = 0
        self._dense_token_bytes = 0
        self._dense_state_bytes = 0
        if not sc.paged:
            for c in self.cache:
                for leaf in c.values():
                    nbytes = leaf.numel() * leaf.element_size()
                    self._dense_kv_bytes += nbytes
                    if (leaf.ndim >= 3 and leaf.shape[1] == B
                            and leaf.shape[2] == S):
                        self._dense_token_bytes += nbytes // (B * S)
                    else:
                        self._dense_state_bytes += nbytes // B
        self.slot_pos = np.full((B,), -1, np.int64)     # next write position
        self.slot_req: List[Optional[Request]] = [None] * B
        self.queue: List[Request] = []
        self.done: List[Request] = []
        # admission control (ServeConfig.admission): submit() consults the
        # controller against the live backlog — shed requests retire
        # immediately (finish_reason "shed"), deferred ones park here and
        # are reconsidered at every step() until the backlog has room
        self.admission: Optional[AdmissionController] = (
            AdmissionController(sc.admission, sc.phase)
            if sc.admission is not None else None)
        self.deferred: List[Request] = []
        # live seconds-per-tick estimate (EMA over TickRecord.wall_s) the
        # controller projects TTFT with when no fixed tick_cost_s is set
        self._tick_wall_ema = 0.0
        self._tick_wall_n = 0
        # bounded record of recent ticks; occupancy uses running counters
        self.tick_log: Deque[TickRecord] = deque(maxlen=65_536)
        # baseline for TickRecord's registry deltas, carried ACROSS ticks
        self._tick_delta_base = self.metrics.values(self._TICK_DELTA_KEYS)
        self._n_ticks = 0
        self._n_prefill_ticks = 0
        self._n_decode_ticks = 0
        self._n_mixed_ticks = 0
        self.host_transfers = 0          # device->host syncs (see _to_host)
        self.aborted = 0                 # requests cancelled via abort()
        self.admission_shed = 0          # submits refused by admission
        self.admission_deferred = 0      # submits parked by the backlog cap
        self.preemptions = 0             # lifetime pool evictions
        self.kv_resident_peak = 0        # peak allocated KV bytes
        # tiered-KV counters: how preemptions resumed (swap vs recompute)
        self.swap_outs = 0               # victims whose pages went to host
        self.swap_resumes = 0            # swapped requests resumed from host
        self.recompute_preemptions = 0   # fell back to recompute-on-resume
        self.prefill_tokens_executed = 0  # chunk tokens actually computed
        self.cow_copies = 0              # device page copies (COW)
        self.cache_evicted_pages = 0     # pages reclaimed from the cache
        self.spec_windows = 0            # verify windows executed
        self.spec_drafted = 0            # draft tokens verified
        self.spec_accepted = 0           # draft tokens accepted
        self.decode_tokens_emitted = 0
        self.decode_slot_ticks = 0       # (request, tick) decode occupancies
        self._next_id = 0
        self.chunked = chunked
        self._packed = sc.packed_prefill and chunked
        self.prefill_launches = 0        # prefill phase-program calls
        self.prefill_rows_executed = 0   # token rows computed (incl. pad)
        self.executor = make_executor(sc.executor, {
            "whole": self._prefill_whole_impl,
            "decode": self._decode_impl,
            "packed": self._prefill_packed_impl,
            "decode_paged": self._decode_paged_impl,
            "packed_paged": self._prefill_packed_paged_impl,
            "chunk_paged": self._prefill_chunk_paged_impl,
            "verify": self._verify_impl,
        }, metrics=self.metrics, device=self.device)

    # -- program table (owned by the executor) ---------------------------------
    @property
    def compile_count(self) -> int:
        return self.executor.compile_count

    def _program(self, group: str, kind: str) -> Callable:
        return self.executor.program(group, kind)

    def _note_compile(self, group: str, kind: str, shape: Tuple[int, ...],
                      all_greedy: bool) -> None:
        before = self.executor.compile_count
        self.executor.note_compile(group, kind, shape, all_greedy)
        if self.tracer.enabled and self.executor.compile_count > before:
            self.tracer.instant("compile", self.tracer.now(), group=group,
                                kind=kind, shape=list(shape),
                                all_greedy=bool(all_greedy))

    # -- phase programs ---------------------------------------------------------
    def _sample(self, logits, temps, top_ks, top_ps, seeds, counters,
                all_greedy):
        """logits [N, 1, V] -> int32 tokens [N] (the reference's
        ``_sample``).  Per-row sampling params ([N] tensors); a row with
        temperature <= 0 is greedy, so one program serves mixed batches.
        An all-greedy call takes the argmax alone: no sort, no draws."""
        if all_greedy:
            return sample_greedy(logits)
        return sample_tokens_rows(logits[:, -1], temps, top_ks, top_ps,
                                  row_keys(seeds, counters))

    @torch.inference_mode()
    def _prefill_whole_impl(self, params, tokens, slot, cache, temps,
                            top_ks, top_ps, seeds, counters, all_greedy):
        """Whole-prompt prefill of one request (tokens [1, T]) with its K/V
        spliced into arena slot ``slot``.  Returns [1] int32 tokens."""
        logits, cache = prefill_into_arena(params, self.cfg,
                                           {"tokens": tokens}, slot, cache)
        return self._sample(logits, temps, top_ks, top_ps, seeds, counters,
                            all_greedy), cache

    @torch.inference_mode()
    def _prefill_packed_impl(self, params, tokens, starts, offsets, lengths,
                             slots, cache, temps, top_ks, top_ps, seeds,
                             counters, all_greedy):
        """Packed-stream chunk prefill into the dense arena: the tick's
        chunks as one flat [T] token stream.  Returns [N] int32 tokens."""
        logits, cache = forward_chunk_packed(
            params, self.cfg, tokens, starts, offsets, lengths, slots,
            cache, pack_align=self.sc.phase.pack_align)
        return self._sample(logits, temps, top_ks, top_ps, seeds, counters,
                            all_greedy), cache

    @torch.inference_mode()
    def _decode_impl(self, params, tokens, cache, pos, slot_mask, temps,
                     top_ks, top_ps, seeds, counters, all_greedy):
        """One-token decode over the dense arena, all max_batch rows.  The
        reference merges old and new arena over the whole arena with
        ``where(slot_mask, new, old)``; here only the ``slot_mask`` rows
        write their K/V, in place, so idle slots' rows are never touched
        (and nothing of the arena's size is copied)."""
        logits, cache, _ = forward(params, self.cfg, {"tokens": tokens},
                                   phase="decode", cache=cache, pos=pos,
                                   slot_mask=slot_mask)
        return self._sample(logits, temps, top_ks, top_ps, seeds, counters,
                            all_greedy), cache

    @torch.inference_mode()
    def _prefill_packed_paged_impl(self, params, tokens, starts, offsets,
                                   lengths, slots, cache, block_tables,
                                   temps, top_ks, top_ps, seeds, counters,
                                   all_greedy):
        """Packed-stream chunk prefill into the page pool: the tick's chunks
        as one flat [T] token stream — one launch per layer, one shape key
        per bucketed T.  Returns [N] int32 tokens (row i samples chunk i)."""
        logits, cache = forward_chunk_packed(
            params, self.cfg, tokens, starts, offsets, lengths, slots,
            cache, block_tables=block_tables,
            pack_align=self.sc.phase.pack_align)
        return self._sample(logits, temps, top_ks, top_ps, seeds, counters,
                            all_greedy), cache

    @torch.inference_mode()
    def _prefill_chunk_paged_impl(self, params, tokens, offsets, lengths,
                                  slots, cache, block_tables, temps, top_ks,
                                  top_ps, seeds, counters, all_greedy):
        """Padded [N, C] chunk prefill into the page pool (block-table
        scatter).  Returns [N] int32 tokens (row i samples chunk i)."""
        logits, cache = forward_chunk(params, self.cfg, tokens, offsets,
                                      lengths, slots, cache,
                                      block_tables=block_tables)
        return self._sample(logits, temps, top_ks, top_ps, seeds, counters,
                            all_greedy), cache

    @torch.inference_mode()
    def _verify_impl(self, params, tokens, offsets, lengths, slots, cache,
                     block_tables, draft, temps, top_ks, top_ps, seeds,
                     counters, all_greedy):
        """Speculative verify: ONE chunk forward of the target model over
        each row's [last_committed, d_1, .., d_k] window against the pool
        (K/V written like any prefill chunk), logits at EVERY window
        position, accept/resample on the device with per-row params
        (greedy rows accept the argmax prefix, stochastic rows run
        Leviathan rejection sampling with their own keys).  Returns one
        packed [N, C+1] int32 array — C candidate tokens plus the emission
        count — so the host reads the tick's result in one transfer."""
        logits, cache = forward_chunk(params, self.cfg, tokens, offsets,
                                      lengths, slots, cache,
                                      block_tables=block_tables,
                                      return_all_logits=True)
        if all_greedy:
            toks, n_emit = verify_draft(logits, draft, lengths - 1)
        else:
            toks, n_emit = verify_draft_rows(
                logits, draft, lengths - 1, temps, top_ks, top_ps,
                row_keys(seeds, counters))
        return torch.cat([toks, n_emit[:, None]], dim=1), cache

    @torch.inference_mode()
    def _decode_paged_impl(self, params, tokens, cache, pos, block_tables,
                           temps, top_ks, top_ps, seeds, counters,
                           all_greedy):
        """One-token decode over the page pool.  Inactive rows carry
        all-sentinel block-table rows, so their K/V writes drop."""
        logits, cache, _ = forward(params, self.cfg, {"tokens": tokens},
                                   phase="decode", cache=cache, pos=pos,
                                   block_tables=block_tables)
        return self._sample(logits, temps, top_ks, top_ps, seeds, counters,
                            all_greedy), cache

    # -- public API -----------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None, *,
               sampling: Optional[SamplingParams] = None,
               slo: Optional[SLO] = None,
               priority: Optional[int] = None) -> Request:
        """Queue one request.

        ``sampling`` carries the per-request parameters (temperature 0 is
        greedy); omitted, the ``ServeConfig`` defaults apply.
        ``max_new_tokens`` / ``eos_id`` override the corresponding
        ``sampling`` fields when given.  ``slo`` attaches TTFT/TPOT
        deadlines (``SLO``, milliseconds): the request counts into the
        ``serving_slo_*`` attainment counters at retirement, and its TTFT
        deadline steers prefill ordering (EDF within a priority class) and,
        with ``ServeConfig.admission`` set, the admission decision.
        ``priority`` is a ``scheduler.PRIORITY_*`` lane (default STANDARD):
        slot admission and the prefill budget serve lower values first.

        With admission control on, the returned ``Request`` may come back
        ALREADY RETIRED (``finish_reason == "shed"``) or parked in
        ``self.deferred`` (a best-effort request over the pending-token
        cap; it joins the queue once the backlog drains)."""
        sp = sampling if sampling is not None else self._default_sampling
        if max_new_tokens is not None:
            sp = replace(sp, max_new_tokens=max_new_tokens)
        if eos_id is not None:
            sp = replace(sp, eos_id=eos_id)
        req = Request(self._next_id, np.asarray(prompt, np.int32), sp)
        req.seed = sp.seed if sp.seed is not None else (
            (self.sc.seed * 2654435761 + req.req_id + 1) & 0x7FFFFFFF)
        req.prompt_len = int(req.prompt.shape[-1])
        if self.paged:
            # capacity is a POOL property: a prompt fits iff the pool can
            # hold it (+ 1 decode position) when running alone
            if not self.pool.fits(req.prompt_len + 1):
                raise ValueError(
                    f"prompt of {req.prompt_len} tokens cannot fit the "
                    f"paged pool ({self.pool.n_pages} pages x "
                    f"{self.pool.page_size} = {self.pool.capacity} tokens)")
        elif req.prompt_len >= self.sc.max_len:
            raise ValueError(
                f"prompt of {req.prompt_len} tokens does not fit "
                f"max_len={self.sc.max_len} (need >= 1 decode position)")
        if slo is not None and not isinstance(slo, SLO):
            raise TypeError(f"slo={slo!r} (expected repro_torch.serving."
                            "metrics.SLO)")
        req.slo = slo
        if priority is not None:
            req.priority = int(priority)
        req.t_submit = time.monotonic()
        self._next_id += 1
        if self.tracer.enabled:
            self.tracer.begin_request(req.req_id, req.t_submit,
                                      prompt_len=req.prompt_len)
        if self.admission is not None:
            decision = self.admission.decide(
                req.prompt_len,
                ttft_deadline_s=(slo.ttft_ms / 1e3
                                 if slo is not None and slo.ttft_ms is not None
                                 else math.inf),
                backlog_tokens=self._pending_prefill_tokens(),
                decode_backlog_tokens=self._pending_decode_tokens(),
                n_live=(len(self.queue) + len(self.deferred)
                        + sum(r is not None for r in self.slot_req)),
                ema_value=self._tick_wall_ema,
                ema_ticks=self._tick_wall_n)
            if decision == "shed":
                return self._shed(req)
            if decision == "defer":
                self.admission_deferred += 1
                self.deferred.append(req)
                return req
        self.queue.append(req)
        return req

    def _shed(self, req: Request) -> Request:
        """Refuse ``req`` at admission: retired immediately with
        finish_reason "shed" (it never holds a slot or a page).  Unlike an
        abort (the client's choice, excluded from goodput), a shed
        deadline-carrying request counts into ``serving_slo_requests_total``
        un-attained (its NaN TTFT fails the bound), so ``goodput()`` is
        measured over ALL submitted SLO demand."""
        self.admission_shed += 1
        req.state = RequestState.DONE
        req.finish_reason = "shed"
        req.t_done = time.monotonic()
        self._account_latency(req)
        if self.tracer.enabled:
            self.tracer.end_request(req.req_id, req.t_done, reason="shed",
                                    generated=0)
        self.done.append(req)
        return req

    def _pending_prefill_tokens(self, include_deferred: bool = True) -> int:
        """Queued-but-uncomputed prefill tokens: the backlog a new prompt
        must wait behind — the admission controller's projection input
        and the structural ``max_pending_tokens`` cap's measure."""
        pend = sum(max(r.prompt_len - r.prefill_pos, 0) for r in self.queue)
        if include_deferred:
            pend += sum(max(r.prompt_len - r.prefill_pos, 0)
                        for r in self.deferred)
        pend += sum(max(self._effective_len(r) - r.prefill_pos, 0)
                    for r in self.slot_req
                    if r is not None and r.state == RequestState.PREFILLING)
        return pend

    def _pending_decode_tokens(self, include_deferred: bool = True) -> int:
        """Remaining generation budget over every live request — the
        decode-side queueing a new prompt waits behind (drains at
        ``max_decode_batch`` tokens per tick)."""
        rem = sum(max(r.max_new_tokens - len(r.generated), 0)
                  for r in self.queue)
        if include_deferred:
            rem += sum(max(r.max_new_tokens - len(r.generated), 0)
                       for r in self.deferred)
        rem += sum(max(r.max_new_tokens - len(r.generated), 0)
                   for r in self.slot_req if r is not None)
        return rem

    def _reconsider_deferred(self) -> None:
        """Re-evaluate deferred requests against the current backlog;
        admitted ones join the queue tail in deferral order.  Deferral is
        only structural (a best-effort request over the pending-token cap),
        so every deferred request re-enters as soon as enough backlog
        drains: no starvation."""
        if not self.deferred or self.admission is None:
            return
        backlog = self._pending_prefill_tokens(include_deferred=False)
        n_live = (len(self.queue)
                  + sum(r is not None for r in self.slot_req))
        still = []
        for req in self.deferred:
            # decode backlog omitted: a best-effort request has no deadline
            # to project against
            decision = self.admission.decide(
                req.prompt_len, ttft_deadline_s=math.inf,
                backlog_tokens=backlog, n_live=n_live,
                ema_value=self._tick_wall_ema, ema_ticks=self._tick_wall_n)
            if decision == "admit":
                self.queue.append(req)
                backlog += max(req.prompt_len - req.prefill_pos, 0)
                n_live += 1
            else:
                still.append(req)
        self.deferred = still

    @property
    def tick_wall_ema(self) -> float:
        """EMA of ``TickRecord.wall_s`` over ticks that compiled nothing
        (0.0 until the first such tick) — the live tick-cost estimate
        admission projections use."""
        return self._tick_wall_ema

    def abort(self, req_id: int) -> Optional[RequestOutput]:
        """Cancel a request at ANY lifecycle stage.

        WAITING: dequeued (a swapped-out request's host pages are freed);
        deferred by admission: removed from ``deferred``.
        PREFILLING / DECODING (speculative verify state included): its slot
        is vacated — its pool references (owned and prefix-cache-attached
        pages) and drafter state are released; pages the prefix cache
        pinned stay cached.  Returns the terminal ``RequestOutput``
        (finish_reason "abort"), or None for an unknown or finished id.
        Tokens already generated remain on the Request."""
        req = None
        for i, r in enumerate(self.queue):
            if r.req_id == req_id:
                req = self.queue.pop(i)
                if req.swap is not None:    # swapped-out KV dies with it
                    for r_idx, host_pages in enumerate(req.swap.pages):
                        self.host_tier.release(r_idx, host_pages)
                    req.swap = None
                break
        if req is None:
            # deferred (admission-parked) requests hold no slot, pages or
            # swap state — cancellation is pure list removal
            for i, r in enumerate(self.deferred):
                if r.req_id == req_id:
                    req = self.deferred.pop(i)
                    break
        if req is None:
            for r in self.slot_req:
                if r is not None and r.req_id == req_id:
                    req = r
                    if self.drafter is not None:
                        self.drafter.release(r.slot)
                    if self.paged:
                        self.pool.release(r.slot)
                    self.slot_req[r.slot] = None
                    self.slot_pos[r.slot] = -1
                    r.slot = -1
                    break
        if req is None:
            return None
        self.aborted += 1
        req.state = RequestState.DONE
        req.finish_reason = "abort"
        req.t_done = time.monotonic()
        # aborts are client cancellations, not serving failures: they are
        # EXCLUDED from SLO attainment
        if self.tracer.enabled:
            self.tracer.end_request(req.req_id, req.t_done, reason="abort",
                                    generated=len(req.generated))
        self.done.append(req)
        return RequestOutput(req_id=req.req_id, new_token_ids=[],
                             n_generated=len(req.generated), finished=True,
                             finish_reason="abort")

    # -- helpers ----------------------------------------------------------------
    def _to_host(self, arr: torch.Tensor) -> np.ndarray:
        """The engine's single device->host transfer point: one token array
        per phase-program call."""
        self.host_transfers += 1
        return arr.cpu().numpy()

    def _pack_params(self, rows: Sequence[Tuple[int, Request]], n: int):
        """Per-request sampling params as [n] tensors for one program call
        (the reference's ``_pack_params``).  ``rows`` maps row index ->
        request (a packed-batch index for prefill and verify, the SLOT for
        dense decode); unmapped rows are greedy placeholders.  The counter
        is the index of the token being sampled (tokens emitted so far).
        Returns the five tensors — from ONE upload, or None each when every
        row is greedy (the argmax path reads none) — and ``all_greedy``."""
        packed = np.zeros((5, n), np.float64)
        all_greedy = True
        for i, r in rows:
            sp = r.sampling
            packed[:, i] = (np.float32(sp.temperature), sp.top_k,
                            np.float32(sp.top_p), r.seed, len(r.generated))
            all_greedy = all_greedy and sp.greedy
        if all_greedy:
            return (None,) * 5, True
        t = self._tensor(packed)
        return (t[0].float(), t[1].long(), t[2].float(), t[3].long(),
                t[4].long()), False

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self) -> List[Request]:
        admitted = []
        free = self._free_slots()
        # SLO-aware slot order: (class, TTFT deadline, age) — stable, and
        # for all-default submissions exactly FIFO by req_id
        if self.queue:
            self.queue.sort(
                key=lambda r: (r.priority, r.ttft_deadline_s, r.req_id))
        while free and self.queue:
            req = self.queue[0]
            if req.swap is not None:
                # swap-resume: the head's KV lives in the host tier; it
                # re-enters only when its device pages fit again, and on
                # failure the head WAITS (a lone request always fits the
                # pool and cached pages are always reclaimable)
                if not self._try_swap_in(req, free[0]):
                    break
                self.queue.pop(0)
                free.pop(0)
                admitted.append(req)
                continue
            self.queue.pop(0)
            slot = free.pop(0)
            req.slot = slot
            req.state = RequestState.PREFILLING
            self.slot_req[slot] = req
            self._try_prefix_attach(req)
            admitted.append(req)
        if self.tracer.enabled and admitted:
            t = self.tracer.now()
            for req in admitted:
                self.tracer.request_span(
                    req.req_id, "queued", req.t_requeue or req.t_submit, t,
                    cached_tokens=req.cached_tokens,
                    n_preempted=req.n_preempted)
        return admitted

    def _by_id(self) -> Dict[int, Request]:
        return {r.req_id: r for r in self.slot_req if r is not None}

    # -- prefix cache ------------------------------------------------------------
    def _try_prefix_attach(self, req: Request) -> None:
        """Admission-time prefix lookup: point the slot's leading block-
        table rows at the longest cached prefix (shared, refcounted) and
        start prefill past it.  The match is capped at len - 1 so at
        least one token remains to prefill — the prompt's last-token
        logits seed decoding."""
        if self.prefix is None:
            return
        tokens = self._effective_tokens(req)
        matched, pages = self.prefix.match(
            tokens, max_tokens=int(tokens.shape[-1]) - 1)
        if matched <= 0:
            return
        self.pool.attach(req.slot, pages, matched)
        req.prefill_pos = matched
        req.cached_tokens = matched

    def _publish_prefix(self, req: Request) -> None:
        """Publish a freshly-prefilled request's PROMPT pages into the
        cache.  A sliding-window run's pages are position-pure only while
        the prefilled length has not wrapped its ring; once it has, the
        prefix is unpublishable."""
        if self.prefix is None:
            return
        if self._effective_len(req) > self.pool.shareable_capacity():
            return
        prompt = self._effective_tokens(req)[..., :req.prompt_len]
        self.prefix.insert(prompt, self.pool, req.slot)

    def _reclaim_cache(self, n_pages: int) -> int:
        """Evict LRU cached blocks until at least ``n_pages`` pages are
        actually FREE again (blocks still pinned by live slots are
        skipped).  Cached pages are reclaimable capacity: this always runs
        before any live request is preempted."""
        if self.prefix is None:
            return 0
        freed = self.prefix.evict(self.pool, max(n_pages, 1))
        self.cache_evicted_pages += freed
        return freed

    @torch.inference_mode()
    def _copy_pages(self, copies) -> None:
        """Mirror ``KVPool.ensure_writable``'s accounting on the device:
        page ``old``'s rows move to ``new`` in EVERY leaf of run ``r``'s
        pool (K, V and, quantized, their scale pages), in place, before the
        writer's program launches.  Pool leaves are [L, n_pages, P, ...]:
        pages live on axis 1."""
        by_run: Dict[int, Tuple[List[int], List[int]]] = {}
        for r, old, new in copies:
            olds, news = by_run.setdefault(r, ([], []))
            olds.append(old)
            news.append(new)
        for r, (olds, news) in by_run.items():
            src = torch.tensor(olds, device=self.device)
            dst = torch.tensor(news, device=self.device)
            for leaf in self.cache[r].values():
                leaf.index_copy_(1, dst, leaf.index_select(1, src))
        self.cow_copies += len(copies)

    def _ensure_writable(self, slot: int, start: int, end: int) -> bool:
        """COW every shared page a write to [start, end) would dirty,
        reclaiming cached pages for copy targets if needed.  False if
        copy targets remain unavailable (caller preempts or defers)."""
        copies = self.pool.ensure_writable(slot, start, end)
        if copies is None:
            # reclaim exactly the copy-target deficit (a multi-page chunk
            # may need several targets per run)
            self._reclaim_cache(self.pool.cow_deficit(slot, start, end))
            copies = self.pool.ensure_writable(slot, start, end)
        if copies is None:
            return False
        self._copy_pages(copies)
        return True

    # -- recompute-on-resume -----------------------------------------------------
    def _effective_tokens(self, req: Request) -> np.ndarray:
        """The token stream a (re)prefill must process: the prompt, plus —
        after a preemption — everything already generated."""
        if not req.generated:
            return req.prompt
        return np.concatenate(
            [req.prompt, np.asarray(req.generated, np.int32)])

    def _effective_len(self, req: Request) -> int:
        return req.prompt_len + len(req.generated)

    def _preempt(self, req: Request) -> None:
        """Evict ``req`` from its slot: pages back to the pool, request back
        to WAITING (age-ordered).  With a host tier the victim's KV swaps
        out (exact page copies, resumed with zero recomputation); without
        one, or when the tier is full, it resumes by recompute."""
        assert self.paged and req.slot >= 0
        if self.drafter is not None:
            self.drafter.release(req.slot)
        if not self._swap_out(req):
            req.prefill_pos = 0
            req.cached_tokens = 0       # re-matched at re-admission
            self.recompute_preemptions += 1
        self.pool.release(req.slot)
        self.slot_req[req.slot] = None
        self.slot_pos[req.slot] = -1
        req.slot = -1
        req.state = RequestState.WAITING
        req.n_preempted += 1
        self.preemptions += 1
        req.t_requeue = time.monotonic()    # the next queued span starts here
        if self.tracer.enabled:
            self.tracer.instant("preempt", req.t_requeue, req_id=req.req_id,
                                swapped=req.swap is not None)
        # keep the queue age-ordered: the re-queued victim outranks later
        # submissions
        i = 0
        while i < len(self.queue) and self.queue[i].req_id < req.req_id:
            i += 1
        self.queue.insert(i, req)

    def _preemption_victim(self, needy: Request) -> Request:
        """Youngest slot-holding request whose eviction frees pages (or
        ``needy`` itself if nobody else holds any) — the oldest request is
        never chosen over an older needy one, so it always completes."""
        holders = sorted((r for r in self.slot_req if r is not None),
                         key=lambda r: r.req_id, reverse=True)
        for r in holders:
            if r is needy:
                continue
            if r.req_id > needy.req_id and self.pool.len_of(r.slot) > 0:
                return r
        return needy

    def _break_prefill_stall(self) -> None:
        """Deadlock breaker: PREFILLING requests exist but the tick planned
        NOTHING — mid-prefill requests hold every page between them.  Evict
        the youngest page holder (never the oldest)."""
        if not any(r is not None and r.state == RequestState.PREFILLING
                   for r in self.slot_req):
            return
        # cached pages yield before any live request does
        if self._reclaim_cache(1):
            return
        holders = [r for r in self.slot_req
                   if r is not None and self.pool.len_of(r.slot) > 0]
        if not holders:
            return
        victim = max(holders, key=lambda r: r.req_id)
        oldest = min((r for r in self.slot_req if r is not None),
                     key=lambda r: r.req_id)
        if victim is not oldest:
            self._preempt(victim)

    # -- tiered KV (host spill) --------------------------------------------------
    @torch.inference_mode()
    def _pages_to_host(self, r: int, dev_pages: Sequence[int],
                       host_pages: Sequence[int]) -> None:
        """Device pages of run ``r`` -> host pages, row for row, every leaf:
        one ``index_select`` per leaf, then asynchronous copies into the
        pinned store on the engine's stream (the caller syncs once)."""
        idx = torch.tensor(list(dev_pages), dtype=torch.long,
                           device=self.device)
        self.host_tier.store_pages(
            r, host_pages, {k: leaf.index_select(1, idx)
                            for k, leaf in self.cache[r].items()})

    @torch.inference_mode()
    def _pages_to_device(self, r: int, host_pages: Sequence[int],
                         dev_pages: Sequence[int]) -> None:
        """Host pages of run ``r`` -> device pages, row for row, every leaf:
        asynchronous uploads from the pinned store, then one ``index_copy_``
        per leaf into the pool, in place."""
        idx = torch.tensor(list(dev_pages), dtype=torch.long,
                           device=self.device)
        for k, vals in self.host_tier.load_pages(r, host_pages,
                                                 self.device).items():
            self.cache[r][k].index_copy_(1, idx, vals)

    def _sync(self) -> None:
        """Wait for the engine's stream (a swap's one sync)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _read_page(self, r: int, page: int) -> Dict[str, torch.Tensor]:
        """One device page across every layer, copied to host tensors —
        pool leaves are [L, n_pages, P, ...], so each leaf yields
        [L, P, ...].  (The engine moves pages in batches,
        ``_pages_to_host`` / ``_pages_to_device``; this reads one for a
        check.)"""
        return {k: leaf[:, page].to("cpu", copy=True)
                for k, leaf in self.cache[r].items()}

    def _swap_out(self, req: Request) -> bool:
        """Copy a preemption victim's device pages into the host tier and
        hang a ``_SwapHandle`` off the request.  All-or-nothing: False (no
        state change) when the tier is absent, the slot holds nothing, or
        host pages run short — the caller then falls back to
        recompute-on-resume."""
        if self.host_tier is None:
            return False
        length = self.pool.len_of(req.slot)
        if length <= 0:
            return False
        pools = self.pool.pools
        need = [p.pages_of(length) for p in pools]
        if any(self.host_tier.free_pages(r) < n for r, n in enumerate(need)):
            return False
        t_sw0, b0 = self.tracer.now(), self.host_tier.swap_out_bytes
        pages: List[List[int]] = []
        for r, p in enumerate(pools):
            host = self.host_tier.alloc(r, need[r])
            assert host is not None     # free_pages checked per run above
            self._pages_to_host(r, [int(q) for q in p.table[req.slot,
                                                           :need[r]]], host)
            pages.append(host)
        self._sync()
        req.swap = _SwapHandle(
            length=length, pages=pages, prefill_pos=req.prefill_pos,
            cached_tokens=req.cached_tokens,
            pos=int(self.slot_pos[req.slot]), state=req.state)
        self.swap_outs += 1
        if self.tracer.enabled:
            # ends after the swap's one sync: the copies' device time
            self.tracer.request_span(
                req.req_id, "swap_out", t_sw0, self.tracer.now(),
                bytes=self.host_tier.swap_out_bytes - b0, tokens=length)
        return True

    def _try_swap_in(self, req: Request, slot: int) -> bool:
        """Restore a swapped-out request into ``slot``: regrow its device
        pages (reclaiming cached pages on a shortfall), upload the host
        copies row for row, and resume EXACTLY where it left off — the
        swap path re-prefills zero tokens.  False leaves the request at
        the queue head with its handle intact."""
        h = req.swap
        if not self.pool.grow(slot, h.length):
            deficit = max(p.pages_of(h.length) - p.free_pages()
                          for p in self.pool.pools)
            self._reclaim_cache(deficit)
            if not self.pool.grow(slot, h.length):
                return False
        t_sw0, b0 = self.tracer.now(), self.host_tier.swap_in_bytes
        req.slot = slot
        self.slot_req[slot] = req
        for r, p in enumerate(self.pool.pools):
            self._pages_to_device(r, h.pages[r],
                                  [int(q) for q in p.table[slot,
                                                           :len(h.pages[r])]])
            self.host_tier.release(r, h.pages[r])
        req.prefill_pos = h.prefill_pos
        req.cached_tokens = h.cached_tokens
        req.state = h.state
        self.slot_pos[slot] = h.pos     # -1 for a mid-prefill swap
        req.swap = None
        self.swap_resumes += 1
        if self.tracer.enabled:
            # the uploads are stream-ordered, not waited for: the span
            # bounds their enqueue
            self.tracer.request_span(
                req.req_id, "swap_in", t_sw0, self.tracer.now(),
                bytes=self.host_tier.swap_in_bytes - b0, tokens=h.length)
        return True

    def _demote_pages(self, dev_pages: List[int]) -> Optional[List[int]]:
        """PrefixCache demote callback: copy one cached block (one device
        page PER RUN) into the host tier.  All-or-nothing; None makes the
        cache hard-drop the block instead."""
        host: List[int] = []
        for r, q in enumerate(dev_pages):
            got = self.host_tier.alloc(r, 1)
            if got is None:
                for rr, hp in enumerate(host):
                    self.host_tier.release(rr, [hp])
                return None
            host.append(got[0])
            self._pages_to_host(r, [int(q)], got)
        self._sync()
        return host

    def _promote_pages(self, host_pages: List[int]) -> Optional[List[int]]:
        """PrefixCache promote callback: re-materialise a demoted block on
        device — fresh externally-owned pages (``alloc_external``) — and
        free the host copies.  None when any run's free list is empty
        (partial hit)."""
        if any(not p.free for p in self.pool.pools):
            return None
        dev: List[int] = []
        for r, hp in enumerate(host_pages):
            q = self.pool.pools[r].alloc_external()
            assert q is not None        # free list checked above
            self._pages_to_device(r, [hp], [q])
            self.host_tier.release(r, [hp])
            dev.append(q)
        return dev

    def _discard_host_pages(self, host_pages: List[int]) -> None:
        """PrefixCache discard callback: a demoted block died (evicted
        subtree / re-published over) — drop its host copies."""
        for r, hp in enumerate(host_pages):
            self.host_tier.release(r, [hp])

    # -- prefill -> decode handoff (the 2.5D-link analogue) ----------------------
    def _record_handoff(self, req: Request) -> None:
        """Price the KV a prefill -> decode handoff moves across HALO's
        2.5D interposer link (CiM prefill stack -> CiD decode stack).
        Only NEWLY-built state moves — prefix-cache hits are already
        decode-side resident.  Colocated executors have no link: no-op."""
        if not self.executor.migrates_kv:
            return
        eff = self._effective_len(req)
        if self.paged:
            pages = nbytes = 0
            for r, p in enumerate(self.pool.pools):
                n = max(p.pages_of(eff) - p.pages_of(req.cached_tokens), 0)
                pages += n
                nbytes += n * self.pool.page_bytes(r)
        else:
            pages = 0
            nbytes = eff * self._dense_token_bytes + self._dense_state_bytes
        self.executor.record_handoff(pages, nbytes)

    def _append_token(self, req: Request, tok) -> None:
        req.generated.append(int(np.asarray(tok).reshape(-1)[0]))

    def _start_decoding(self, req: Request, tok) -> None:
        self._publish_prefix(req)       # prompt pages complete & unwrapped
        self.slot_pos[req.slot] = self._effective_len(req)
        self._record_handoff(req)       # KV crosses the phase boundary here
        if req.sampling.max_new_tokens == 0 and not req.generated:
            # prefill-only request: the seeding sample is discarded
            req.finish_reason = "length"
            self._retire(req)
            return
        self._append_token(req, tok)
        if req.t_first_token == 0.0:    # a resumed prefill keeps its TTFT
            req.t_first_token = time.monotonic()
            if self.tracer.enabled:
                self.tracer.instant("first_token", req.t_first_token,
                                    req_id=req.req_id)
        req.state = RequestState.DECODING
        if self._finished(req):
            self._retire(req)

    def _stream_reason(self, req: Request) -> Optional[str]:
        """Token-stream termination only (max_new / eos / stop) — what a
        verify window's emission loop may stop on.  The position bound is
        not checked here: a window commits its slot_pos jump before the
        tokens append, so mid-emission it would fire early."""
        if len(req.generated) >= req.max_new_tokens:
            return "length"
        if req.generated:
            last = req.generated[-1]
            if req.eos_id is not None and last == req.eos_id:
                return "eos"
            if last in req.sampling.stop:
                return "stop"
        return None

    def _finished(self, req: Request) -> bool:
        reason = self._stream_reason(req)
        if reason is None:
            limit = self.pool.length_bound if self.paged else self.sc.max_len
            if self.slot_pos[req.slot] >= limit - 1:
                reason = "length"       # arena/pool position bound
        if reason is None:
            return False
        req.finish_reason = reason
        return True

    def _retire(self, req: Request) -> None:
        req.state = RequestState.DONE
        req.t_done = time.monotonic()
        self._account_latency(req)
        if self.tracer.enabled:
            self.tracer.end_request(req.req_id, req.t_done,
                                    reason=req.finish_reason,
                                    generated=len(req.generated),
                                    n_preempted=req.n_preempted)
        if self.drafter is not None:
            self.drafter.release(req.slot)
        if self.paged:
            self.pool.release(req.slot)
        self.slot_req[req.slot] = None
        self.slot_pos[req.slot] = -1
        self.done.append(req)

    def _account_latency(self, req: Request) -> None:
        """Retirement-time latency/SLO bookkeeping: TTFT/TPOT histogram
        samples (NaN = never emitted — skipped by ``observe``) and, for
        requests submitted with deadlines, the ``serving_slo_*``
        attainment counters behind ``goodput()``.  Aborted requests never
        reach here (see ``abort``): goodput measures served requests."""
        m = self.metrics
        m.observe("serving_ttft_seconds", req.ttft)
        m.observe("serving_tpot_seconds", req.tpot)
        if req.slo is None:
            return
        ok, ttft_ok, tpot_ok = slo_attainment(req.ttft, req.tpot, req.slo)
        m.inc("serving_slo_requests_total")
        if ok:
            m.inc("serving_slo_attained_total")
        if not ttft_ok:
            m.inc("serving_slo_ttft_violations_total")
        if not tpot_ok:
            m.inc("serving_slo_tpot_violations_total")

    def _grow_for_decode(self, r: Request) -> bool:
        """Secure this tick's one-token write for ``r``: grow the slot by
        one position and COW any shared page that position lands in.
        Exhaustion order: reclaim cached pages first, preempt the youngest
        page holder only after the cache is dry.  False iff ``r`` itself
        was evicted."""
        pos = int(self.slot_pos[r.slot])
        while True:
            if self.pool.grow(r.slot, pos + 1):
                if self._ensure_writable(r.slot, pos, pos + 1):
                    return True
                # grown but no COW target: roll back before freeing pages
                self.pool.shrink(r.slot, pos)
            elif self._reclaim_cache(1):
                continue
            victim = self._preemption_victim(r)
            self._preempt(victim)
            if victim is r:
                return False

    # -- phase execution --------------------------------------------------------
    def _run_prefill_tick(self, plan: TickPlan) -> None:
        """Execute the plan's prefill chunks on the planned worker group."""
        reqs = self._by_id()
        chunks = [(reqs[rid], take) for rid, take in plan.prefill_chunks
                  if rid in reqs and take > 0]
        if not chunks:
            return
        if not self.chunked:
            # atomic whole-prompt prefill, one program per request, its K/V
            # spliced into the request's arena slot
            self._prefill_progress = True
            for req, take in chunks:
                tokens = self._tensor(req.prompt[None])
                pp, all_greedy = self._pack_params([(0, req)], 1)
                tw0 = self.tracer.now()
                self._note_compile(plan.prefill_group, "whole",
                                   (req.prompt_len,), all_greedy)
                toks, self.cache = self._program(plan.prefill_group,
                                                 "whole")(
                    self.params, tokens, req.slot, self.cache, *pp,
                    all_greedy)
                sampled = self._to_host(toks)
                if self.tracer.enabled:
                    self.tracer.request_span(
                        req.req_id, "prefill_chunk", tw0, self.tracer.now(),
                        take=req.prompt_len, offset=0)
                req.prefill_pos = req.prompt_len
                self.prefill_tokens_executed += req.prompt_len
                self.prefill_launches += 1
                self.prefill_rows_executed += req.prompt_len
                self._start_decoding(req, sampled[0])
            return
        if self.paged:
            # claim the chunks' pages; the scheduler planned against the
            # pool headroom, so this succeeds — trim defensively if a
            # same-tick race says otherwise.  Any SHARED page the chunk
            # would dirty is copied first; without a copy target even
            # after reclaiming cached pages, the chunk rolls back and
            # waits for a later tick
            claimed = []
            for req, take in chunks:
                take = min(take, self.pool.max_grow_tokens(req.slot))
                if take <= 0 or not self.pool.grow(req.slot,
                                                   req.prefill_pos + take):
                    continue
                if not self._ensure_writable(req.slot, req.prefill_pos,
                                             req.prefill_pos + take):
                    self.pool.shrink(req.slot, req.prefill_pos)
                    continue
                claimed.append((req, take))
            chunks = claimed
            if not chunks:
                return
        self._prefill_progress = True
        tp0 = self.tracer.now()
        if self._packed:
            toks = self._launch_packed_prefill(plan, chunks)
        else:
            toks = self._launch_padded_prefill(plan, chunks)
        self.prefill_tokens_executed += sum(take for _, take in chunks)
        self.prefill_launches += 1
        # one transfer per tick, made only when a chunk completes its
        # prompt (the sampled token seeds its decoding)
        sampled = (self._to_host(toks) if any(
            req.prefill_pos + take >= self._effective_len(req)
            for req, take in chunks) else None)
        if self.tracer.enabled:
            tp1 = self.tracer.now()     # one launch serves every chunk
            for req, take in chunks:
                self.tracer.request_span(req.req_id, "prefill_chunk",
                                         tp0, tp1, take=take,
                                         offset=req.prefill_pos)
        for i, (req, take) in enumerate(chunks):
            req.prefill_pos += take
            if req.prefill_pos >= self._effective_len(req):
                self._start_decoding(req, sampled[i])

    def _launch_padded_prefill(self, plan: TickPlan, chunks) -> Any:
        """The tick's chunks as one padded [N, C] batch over the page pool
        (pow2 buckets bound the shapes).  Row i samples chunk i."""
        N = _bucket(len(chunks), self.sc.max_batch)
        C = _bucket(max(take for _, take in chunks),
                    self.sc.phase.prefill_chunk)
        tokens = np.zeros((N, C), np.int32)
        offs = np.zeros((N,), np.int32)
        lens = np.zeros((N,), np.int32)
        slots = np.full((N,), self.sc.max_batch, np.int32)  # pad rows: drop
        for i, (req, take) in enumerate(chunks):
            sl = slice(req.prefill_pos, req.prefill_pos + take)
            tokens[i, :take] = self._effective_tokens(req)[sl]
            offs[i] = req.prefill_pos
            lens[i] = take
            slots[i] = req.slot
        pp, all_greedy = self._pack_params(
            [(i, req) for i, (req, _) in enumerate(chunks)], N)
        self.prefill_rows_executed += N * C
        self._note_compile(plan.prefill_group, "chunk_paged", (N, C),
                           all_greedy)
        toks, self.cache = self._program(plan.prefill_group, "chunk_paged")(
            self.params, self._tensor(tokens), self._tensor(offs),
            self._tensor(lens), self._tensor(slots), self.cache,
            self.pool.block_tables(upto=int((offs + lens).max())),
            *pp, all_greedy)
        return toks

    def _launch_packed_prefill(self, plan: TickPlan, chunks) -> Any:
        """The tick's chunks as ONE flat [T] token stream: chunk i occupies
        ``[starts[i], starts[i] + take)``, T is the bucketed packed length,
        and pad segments carry start sentinel T and slot sentinel
        max_batch.  The segment metadata is always max_batch wide, so only
        the stream length changes the shape key."""
        packed = pack_chunks([(req.req_id, take) for req, take in chunks],
                             align=self.sc.phase.pack_align)
        T = packed.length
        Nb = self.sc.max_batch
        tokens = np.zeros((T,), np.int32)
        starts = np.full((Nb,), T, np.int32)    # pad segments: empty tail
        offs = np.zeros((Nb,), np.int32)
        lens = np.zeros((Nb,), np.int32)
        slots = np.full((Nb,), self.sc.max_batch, np.int32)
        for i, (req, take) in enumerate(chunks):
            s = packed.starts[i]
            sl = slice(req.prefill_pos, req.prefill_pos + take)
            tokens[s:s + take] = self._effective_tokens(req)[sl]
            starts[i] = s
            offs[i] = req.prefill_pos
            lens[i] = take
            slots[i] = req.slot
        pp, all_greedy = self._pack_params(
            [(i, req) for i, (req, _) in enumerate(chunks)], Nb)
        self.prefill_rows_executed += T
        args = (self.params, self._tensor(tokens), self._tensor(starts),
                self._tensor(offs), self._tensor(lens), self._tensor(slots),
                self.cache)
        if self.paged:
            self._note_compile(plan.prefill_group, "packed_paged", (T, Nb),
                               all_greedy)
            toks, self.cache = self._program(plan.prefill_group,
                                             "packed_paged")(
                *args, self.pool.block_tables(), *pp, all_greedy)
        else:
            self._note_compile(plan.prefill_group, "packed", (T, Nb),
                               all_greedy)
            toks, self.cache = self._program(plan.prefill_group, "packed")(
                *args, *pp, all_greedy)
        return toks

    # -- speculative draft/verify ------------------------------------------------
    def _spec_budget(self, r: Request) -> int:
        """Largest draft window this tick could commit AND roll back for
        ``r``, before any drafter runs: the ring rollback bound, the pool
        length bound, the remaining token budget (a window emits up to
        k+1 tokens), and the pages the pool can grant without preempting
        anyone (speculation is opportunistic — the one-token decode path
        owns the preemption machinery)."""
        pos = int(self.slot_pos[r.slot])
        return min(
            self.spec.k,
            self._rollback_bound - pos - 1,
            self.pool.length_bound - pos - 2,
            r.max_new_tokens - len(r.generated) - 1,
            self.pool.max_grow_tokens(r.slot) - 1,
        )

    def _run_verify_tick(self, plan: TickPlan,
                         rows: List[Tuple[Request, np.ndarray]]) -> None:
        """Execute the tick's verify windows as ONE padded batch on the
        verify worker group and commit the results: accepted drafts + one
        correction/bonus token per row, with the rejected tail's KV rolled
        back via ``KVPool.truncate``."""
        kmax = max(int(d.shape[-1]) for _, d in rows)
        N = _bucket(len(rows), self.sc.max_batch)
        C = _bucket(kmax + 1, self.spec.k + 1)
        tokens = np.zeros((N, C), np.int32)
        draft = np.zeros((N, C - 1), np.int32)
        offs = np.zeros((N,), np.int32)
        lens = np.zeros((N,), np.int32)
        slots = np.full((N,), self.sc.max_batch, np.int32)  # pad rows: drop
        for i, (r, d) in enumerate(rows):
            kd = int(d.shape[-1])
            tokens[i, 0] = r.generated[-1]
            tokens[i, 1:1 + kd] = d
            draft[i, :kd] = d
            offs[i] = self.slot_pos[r.slot]
            lens[i] = kd + 1
            slots[i] = r.slot
        pp, all_greedy = self._pack_params(
            [(i, r) for i, (r, _) in enumerate(rows)], N)
        tv0 = self.tracer.now()
        self._note_compile(plan.verify_group, "verify", (N, C), all_greedy)
        out, self.cache = self._program(plan.verify_group, "verify")(
            self.params, self._tensor(tokens), self._tensor(offs),
            self._tensor(lens), self._tensor(slots), self.cache,
            self.pool.block_tables(upto=int((offs + lens).max())),
            self._tensor(draft), *pp, all_greedy)
        packed = self._to_host(out)                 # [N, C+1], one transfer
        tv1 = self.tracer.now()
        for i, (r, d) in enumerate(rows):
            kd = int(d.shape[-1])
            n_emit = int(packed[i, -1])
            accepted = n_emit - 1
            self.decode_slot_ticks += 1
            self.spec_windows += 1
            self.spec_drafted += kd
            self.spec_accepted += accepted
            # the window inputs [gen[-1], d_1..d_acc] are committed; the
            # final emitted token is fed next tick; the rejected tail
            # (positions past pos + acc + 1) rolls back
            new_pos = int(self.slot_pos[r.slot]) + accepted + 1
            self.pool.truncate(r.slot, new_pos)
            self.slot_pos[r.slot] = new_pos
            appended = 0
            for t in packed[i, :n_emit]:
                self._append_token(r, t)
                self.decode_tokens_emitted += 1
                appended += 1
                if self._stream_reason(r) is not None:  # eos / max_new clip
                    break
            if self.tracer.enabled:
                self.tracer.request_span(r.req_id, "verify_window", tv0, tv1,
                                         drafted=kd, accepted=accepted,
                                         emitted=appended)
            self.drafter.observe(r.slot, r.req_id, self._effective_len(r))
            if self._finished(r):
                self._retire(r)

    def _plan_speculation(self, active: List[Request]
                          ) -> Tuple[List[Tuple[Request, np.ndarray]],
                                     List[Request]]:
        """Partition this tick's decode occupants into verify rows (the
        drafter proposed something usable, window pages secured, shared
        pages COW'd) and plain one-token decoders (everything else)."""
        budgets: Dict[int, int] = {}
        plain: List[Request] = []
        candidates: List[Request] = []
        for r in sorted(active, key=lambda r: r.req_id):
            budgets[r.req_id] = self._spec_budget(r)
            (candidates if budgets[r.req_id] >= 1 else plain).append(r)
        proposals = self.drafter.propose_batch(
            [(r.slot, r.req_id, self._effective_tokens(r))
             for r in candidates],
            self.spec.k) if candidates else {}
        rows: List[Tuple[Request, np.ndarray]] = []
        for r in candidates:
            d = proposals.get(r.slot)
            kd = min(budgets[r.req_id], int(d.shape[-1])) \
                if d is not None else 0
            if kd < 1:
                plain.append(r)
                continue
            d = np.asarray(d[:kd], np.int32)
            pos = int(self.slot_pos[r.slot])
            if not self.pool.grow(r.slot, pos + kd + 1):
                plain.append(r)                     # raced: fall back
                continue
            if not self._ensure_writable(r.slot, pos, pos + kd + 1):
                self.pool.shrink(r.slot, pos)       # roll the claim back
                plain.append(r)
                continue
            rows.append((r, d))
        return rows, plain

    def _run_decode_tick(self, plan: TickPlan) -> None:
        reqs = self._by_id()
        active = [reqs[rid] for rid in plan.decode_reqs
                  if rid in reqs and reqs[rid].state == RequestState.DECODING]
        if self.spec is not None and active:
            rows, active = self._plan_speculation(active)
            if rows:
                self._run_verify_tick(plan, rows)
        if self.paged and active:
            # each decode write may cross into a fresh page (or, shared-
            # prefix, into a page another request still reads — COW);
            # grow oldest-first and, when the pool is out, reclaim cached
            # pages first and only then PREEMPT the youngest page holder
            # (it re-queues for recompute)
            survivors = []
            for r in sorted(active, key=lambda r: r.req_id):
                if r.state != RequestState.DECODING or r.slot < 0:
                    continue                        # evicted earlier this loop
                if self._grow_for_decode(r):
                    survivors.append(r)
            active = survivors
        if not active:
            return
        if self.paged:
            # the pool addresses KV through the CALL's block tables, so the
            # decode batch compacts: active slots map to rows
            # 0..len(active) and the row count rounds up the pow2 ladder
            nb = _bucket(len(active), self.sc.max_batch)
            tokens = np.zeros((nb, 1), np.int32)
            pos = np.zeros((nb,), np.int32)
            for i, r in enumerate(active):
                tokens[i, 0] = r.generated[-1]
                pos[i] = self.slot_pos[r.slot]
            pp, all_greedy = self._pack_params(
                [(i, r) for i, r in enumerate(active)], nb)
            td0 = self.tracer.now()
            self._note_compile(plan.decode_group, "decode_paged", (nb,),
                               all_greedy)
            # pad rows carry all-sentinel block-table rows: their writes
            # drop
            toks, self.cache = self._program(plan.decode_group,
                                             "decode_paged")(
                self.params, self._tensor(tokens), self.cache,
                self._tensor(pos),
                self.pool.block_tables(rows=[r.slot for r in active], n=nb),
                *pp, all_greedy)
            emitted = list(enumerate(active))
        else:
            # the dense arena is slot-indexed, so the batch stays [B], with
            # per-slot positions (idle slots at 0) and only active slots
            # writing their K/V
            B = self.sc.max_batch
            tokens = np.zeros((B, 1), np.int32)
            mask = np.zeros((B,), bool)
            for r in active:
                tokens[r.slot, 0] = r.generated[-1]
                mask[r.slot] = True
            pos = np.where(self.slot_pos >= 0, self.slot_pos,
                           0).astype(np.int32)
            pp, all_greedy = self._pack_params(
                [(r.slot, r) for r in active], B)
            td0 = self.tracer.now()
            self._note_compile(plan.decode_group, "decode", (B,), all_greedy)
            toks, self.cache = self._program(plan.decode_group, "decode")(
                self.params, self._tensor(tokens), self.cache,
                self._tensor(pos), self._tensor(mask), *pp, all_greedy)
            emitted = [(r.slot, r) for r in active]
        sampled = self._to_host(toks)               # one transfer per tick
        td1 = self.tracer.now()
        for row, r in emitted:
            self._append_token(r, sampled[row])
            self.decode_tokens_emitted += 1
            self.decode_slot_ticks += 1
            self.slot_pos[r.slot] += 1
            if self.tracer.enabled:
                self.tracer.request_span(r.req_id, "decode", td0, td1,
                                         tokens=1)
            if self._finished(r):
                self._retire(r)

    # -- tick loop ---------------------------------------------------------------
    def step(self) -> List[RequestOutput]:
        """One engine tick: plan (scheduler) -> execute -> report.

        Returns one incremental ``RequestOutput`` per request that ADVANCED
        this tick (new tokens and/or finished), ordered by req_id."""
        t0 = time.monotonic()
        self.executor.begin_tick()
        self._prefill_progress = False
        # deferred submits re-enter as soon as the backlog has room —
        # BEFORE this tick's admission so they compete for freed slots
        self._reconsider_deferred()
        counts0 = {r.req_id: len(r.generated) for r in self.queue}
        counts0.update({r.req_id: len(r.generated)
                        for r in self.slot_req if r is not None})
        done0 = len(self.done)
        self._admit()
        # entries carry (priority, TTFT deadline) so plan_tick orders the
        # prefill budget by class, then EDF, then age
        prefilling = sorted(
            ((r.req_id, self._effective_len(r) - r.prefill_pos,
              self.chunked, r.prefill_pos, r.priority, r.ttft_deadline_s)
             for r in self.slot_req
             if r is not None and r.state == RequestState.PREFILLING),
            key=lambda e: e[0])
        decoding = [r.req_id for r in self.slot_req
                    if r is not None and r.state == RequestState.DECODING]
        spec_k = self.spec.k if self.spec is not None else 0
        if self.paged:
            # token-level admission: prefill work is planned against the
            # pool's free pages, with this tick's decode growth reserved (a
            # verify window grows by up to k+1 tokens)
            headroom = self.pool.headroom_pages(
                [self.pool.len_of(r.slot) for r in self.slot_req
                 if r is not None and r.state == RequestState.DECODING],
                growth=spec_k + 1)
            plan = self.scheduler.plan_tick(
                prefilling, decoding, free_pages=headroom,
                page_size=self.sc.page_size,
                capacity=self.pool.widest_capacity(), spec_k=spec_k)
        else:
            plan = self.scheduler.plan_tick(prefilling, decoding,
                                            spec_k=spec_k)
        if plan.prefill_chunks:
            self._run_prefill_tick(plan)
        if plan.decode_reqs:
            self._run_decode_tick(plan)
        if self.paged and not plan.decode_reqs and not self._prefill_progress:
            self._break_prefill_stall()
        resident = self.pool.resident_bytes() if self.paged else 0
        self.kv_resident_peak = max(self.kv_resident_peak, resident)
        cur = self.metrics.values(self._TICK_DELTA_KEYS)
        delta = {k: cur[k] - self._tick_delta_base[k] for k in cur}
        self._tick_delta_base = cur
        rec = TickRecord(
            index=self._n_ticks,
            prefill_reqs=list(plan.prefill_reqs),
            prefill_tokens=plan.prefill_tokens,
            decode_reqs=list(plan.decode_reqs),
            prefill_group=plan.prefill_group,
            decode_group=plan.decode_group,
            wall_s=time.monotonic() - t0,
            preemptions=int(delta["serving_preemptions_total"]),
            kv_resident_bytes=resident,
            spec_drafted=int(delta["serving_spec_drafted_total"]),
            spec_accepted=int(delta["serving_spec_accepted_total"]),
            new_compiles=self.executor.tick_new_compiles,
            migrated_pages=self.executor.tick_migrated_pages,
            migrated_bytes=self.executor.tick_migrated_bytes,
            swap_out_bytes=int(delta["serving_swap_out_bytes_total"]),
            swap_in_bytes=int(delta["serving_swap_in_bytes_total"]),
            host_resident_pages=(self.host_tier.used_pages()
                                 if self.host_tier is not None else 0))
        self.metrics.observe("serving_tick_wall_seconds", rec.wall_s)
        # tick-cost EMA for admission TTFT projections (alpha 0.2); ticks
        # that met a new program shape are left out, as in the reference
        if rec.new_compiles == 0:
            self._tick_wall_n += 1
            self._tick_wall_ema = (rec.wall_s if self._tick_wall_n == 1 else
                                   0.8 * self._tick_wall_ema
                                   + 0.2 * rec.wall_s)
        if self.tracer.enabled:
            # the TickRecord twin: summing an arg across the tick track
            # reproduces the registry total
            self.tracer.tick_span(
                t0, t0 + rec.wall_s, index=rec.index,
                prefill_reqs=list(rec.prefill_reqs),
                prefill_tokens=rec.prefill_tokens,
                decode_reqs=list(rec.decode_reqs),
                prefill_group=rec.prefill_group or "",
                decode_group=rec.decode_group or "",
                preemptions=rec.preemptions,
                kv_resident_bytes=rec.kv_resident_bytes,
                spec_drafted=rec.spec_drafted,
                spec_accepted=rec.spec_accepted,
                new_compiles=rec.new_compiles,
                migrated_pages=rec.migrated_pages,
                migrated_bytes=rec.migrated_bytes,
                swap_out_bytes=rec.swap_out_bytes,
                swap_in_bytes=rec.swap_in_bytes,
                host_resident_pages=rec.host_resident_pages)
        self.tick_log.append(rec)
        self._n_ticks += 1
        self._n_prefill_ticks += bool(rec.prefill_reqs)
        self._n_decode_ticks += bool(rec.decode_reqs)
        self._n_mixed_ticks += rec.mixed
        # incremental outputs: live slot holders + requests retired this
        # tick + requests preempted back to the queue after gaining tokens
        touched = [r for r in self.slot_req if r is not None]
        touched += self.done[done0:]
        touched += [r for r in self.queue
                    if len(r.generated) > counts0.get(r.req_id, 0)]
        outputs: List[RequestOutput] = []
        for r in sorted(touched, key=lambda r: r.req_id):
            n0 = counts0.get(r.req_id, 0)
            finished = r.state == RequestState.DONE
            if len(r.generated) > n0 or finished:
                outputs.append(RequestOutput(
                    req_id=r.req_id,
                    new_token_ids=list(r.generated[n0:]),
                    n_generated=len(r.generated),
                    finished=finished,
                    finish_reason=r.finish_reason if finished else None))
        return outputs

    def counts(self) -> Dict[str, int]:
        """Queue/slot/done occupancy plus the lifetime migration, tiered-KV
        and admission counters and SLO attainment — every value is a view
        over the metrics registry (or derived from one)."""
        tier = self.host_tier
        g = self.goodput()
        return {"queued": len(self.queue),
                "deferred": len(self.deferred),
                "active": sum(r is not None for r in self.slot_req),
                "done": len(self.done),
                "shed": self.admission_shed,
                "migrated_pages": self.executor.migrated_pages,
                "migrated_bytes": self.executor.migrated_bytes,
                "swap_out_bytes": tier.swap_out_bytes if tier else 0,
                "swap_in_bytes": tier.swap_in_bytes if tier else 0,
                "swap_resumes": self.swap_resumes,
                "recompute_preemptions": self.recompute_preemptions,
                "host_resident_pages": tier.used_pages() if tier else 0,
                "slo_total": g["slo_total"],
                "slo_attained": g["slo_attained"],
                "goodput": g["goodput"]}

    def goodput(self) -> Dict[str, float]:
        """SLO attainment over retired requests submitted with deadlines
        (``submit(..., slo=SLO(...))``); aborted requests are excluded,
        shed ones count un-attained.  ``goodput`` is the attained fraction
        — 1.0 vacuously when no request carried an SLO.  The per-axis
        violation counts say WHICH deadline was missed."""
        m = self.metrics
        total = int(m.counter("serving_slo_requests_total"))
        attained = int(m.counter("serving_slo_attained_total"))
        return {
            "slo_total": total,
            "slo_attained": attained,
            "ttft_violations":
                int(m.counter("serving_slo_ttft_violations_total")),
            "tpot_violations":
                int(m.counter("serving_slo_tpot_violations_total")),
            "goodput": attained / total if total else 1.0,
        }

    def metrics_snapshot(self) -> Dict[str, Dict]:
        """The full registry snapshot (counters / gauges / histograms)
        with the point-in-time occupancy gauges refreshed first — the
        machine-readable superset of ``counts()`` / ``spec_stats()`` /
        ``prefix_stats()``."""
        m = self.metrics
        m.set_gauge("serving_requests_queued", len(self.queue))
        m.set_gauge("serving_requests_active",
                    sum(r is not None for r in self.slot_req))
        m.set_gauge("serving_requests_done", len(self.done))
        m.set_gauge("serving_kv_resident_bytes",
                    self.pool.resident_bytes() if self.paged else 0)
        m.set_gauge("serving_host_resident_pages",
                    self.host_tier.used_pages()
                    if self.host_tier is not None else 0)
        return m.snapshot()

    def _live(self) -> bool:
        """Requests still owed service: queued, deferred, or in a slot."""
        return bool(self.queue or self.deferred
                    or any(r is not None for r in self.slot_req))

    def _check_drained(self, ticks: int, max_ticks: int) -> None:
        """Fail LOUDLY when the tick budget runs out with live requests,
        with the counts, the per-state breakdown and the last tick record.
        Admission outcomes are their OWN buckets — ``deferred`` (parked
        outside the queue, still owed service) and the ``shed`` tally — so
        an admission stall reads differently from a scheduling stall."""
        if ticks >= max_ticks and self._live():
            c = self.counts()
            states: Dict[str, int] = {}
            for r in list(self.queue) + [r for r in self.slot_req
                                         if r is not None]:
                states[r.state.value] = states.get(r.state.value, 0) + 1
            if self.deferred:
                states["deferred"] = len(self.deferred)
            last = self.tick_log[-1] if self.tick_log else None
            raise RuntimeError(
                f"max_ticks={max_ticks} exhausted with live requests "
                f"({c['queued']} queued, {c['deferred']} deferred, "
                f"{c['active']} active, {c['done']} done of which "
                f"{c['shed']} shed; states={states}, "
                f"preemptions={self.preemptions}) — the engine did not "
                f"drain; raise max_ticks or check for a scheduling stall. "
                f"counts={c} last_tick={last}")

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        ticks = 0
        while self._live() and ticks < max_ticks:
            self.step()
            ticks += 1
        self._check_drained(ticks, max_ticks)
        return self.done

    def stream(self, max_ticks: int = 10_000) -> Iterator[RequestOutput]:
        """Run the tick loop, yielding each ``RequestOutput`` as soon as
        its tick produced it — tokens are observable while OTHER requests
        are still prefilling or decoding.  ``submit()`` and ``abort()``
        may be called from the consuming loop (an abort's terminal output
        is returned by ``abort`` itself, not re-yielded here)."""
        ticks = 0
        while self._live() and ticks < max_ticks:
            yield from self.step()
            ticks += 1
        self._check_drained(ticks, max_ticks)

    def generate(self, prompts: Sequence[np.ndarray],
                 sampling: Union[SamplingParams, Sequence[SamplingParams],
                                 None] = None,
                 max_ticks: int = 10_000) -> List[Request]:
        """Batch facade: submit every prompt, drain, and return the finished
        ``Request``s in submission order."""
        if sampling is None or isinstance(sampling, SamplingParams):
            sampling = [sampling] * len(prompts)
        if len(sampling) != len(prompts):
            raise ValueError(f"got {len(list(sampling))} SamplingParams for "
                             f"{len(prompts)} prompts")
        reqs = [self.submit(p, sampling=sp)
                for p, sp in zip(prompts, sampling)]
        self.run_until_drained(max_ticks)
        return reqs

    # -- metrics ------------------------------------------------------------------
    @property
    def n_ticks(self) -> int:
        return self._n_ticks

    def kv_bytes(self) -> Dict[str, int]:
        """KV memory accounting: reserved bytes, bytes backing live tokens
        now, and the high-water mark across ticks (the dense arena pins its
        whole footprint, so all three are its size)."""
        if self.paged:
            return {"reserved": self.pool.total_bytes(),
                    "resident": self.pool.resident_bytes(),
                    "peak_resident": self.kv_resident_peak}
        return {"reserved": self._dense_kv_bytes,
                "resident": self._dense_kv_bytes,
                "peak_resident": self._dense_kv_bytes}

    def prefix_stats(self) -> Dict[str, float]:
        """Prefix-cache effectiveness: hit rate, tokens served from cache
        vs prefill tokens actually computed, COW copies, evictions.
        Zeros when the cache is off (the comparison baseline)."""
        out = {
            "prefill_tokens_executed": float(self.prefill_tokens_executed),
            "cow_copies": float(self.cow_copies),
            "cache_evicted_pages": float(self.cache_evicted_pages),
            "hit_rate": 0.0,
            "hit_tokens": 0.0,
            "cached_pages": 0.0,
        }
        if self.prefix is not None:
            s = self.prefix.stats()
            out["hit_rate"] = float(s["hit_rate"])
            out["hit_tokens"] = float(s["hit_tokens"])
            out["cached_pages"] = float(s["cached_pages"])
        return out

    def spec_stats(self) -> Dict[str, float]:
        """Speculative-decoding effectiveness: ``acceptance_rate`` =
        accepted / drafted; ``tokens_per_tick`` = tokens emitted per
        (request, decode-tick) occupancy — 1.0 exactly without
        speculation, > 1 as soon as any draft survives verification."""
        return {
            "windows": float(self.spec_windows),
            "drafted": float(self.spec_drafted),
            "accepted": float(self.spec_accepted),
            "acceptance_rate": self.spec_accepted / max(self.spec_drafted, 1),
            "decode_tokens": float(self.decode_tokens_emitted),
            "tokens_per_tick": (self.decode_tokens_emitted
                                / max(self.decode_slot_ticks, 1)),
        }

    def phase_occupancy(self) -> Dict[str, float]:
        """Fractions of ticks running prefill / decode / both."""
        n = max(self._n_ticks, 1)
        return {
            "prefill": self._n_prefill_ticks / n,
            "decode": self._n_decode_ticks / n,
            "mixed": self._n_mixed_ticks / n,
        }
