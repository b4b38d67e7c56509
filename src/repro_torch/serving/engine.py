"""Serving engine: continuous batching that EXECUTES the phase scheduler's
plan (port of the greedy, packed-prefill path of
src/repro/serving/engine.py, over the paged pool or the dense arena).

One engine tick = one ``PhaseScheduler.plan_tick`` executed verbatim:

  1. admit    — waiting requests claim free decode slots;
  2. prefill  — the plan's (request, n_tokens) chunks are laid out as ONE
                flat token stream (``pack_chunks``) and run through the
                prefill-group program, which writes K/V straight into the
                arena at each request's slot and offset (HALO's CiM -> CiD
                handoff).  Long prompts prefill across several ticks,
                interleaved with decode.  With ``prefill_chunk = 0`` each
                prompt prefills whole in one program instead (the dense
                arena only), its K/V spliced into its slot;
  3. decode   — one batched token step for every DECODING slot, greedy
                argmax on the device, one [B] host transfer per tick.

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

The host logic (admission, planning, packing, preemption, retirement,
counters) is the reference's, line for line where the slice reaches it, so
the tick log of this engine equals the reference engine's on the same
traffic.  ``ServeConfig`` options outside the slice raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import time
import warnings
from collections import deque
from dataclasses import replace
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import (
    forward,
    forward_chunk_packed,
    init_cache,
    prefill_into_arena,
    supports_chunked_prefill,
    supports_paged,
)
from repro_torch.serving.executor import make_executor
from repro_torch.serving.kv_pool import KVPool
from repro_torch.serving.quantized_weights import quantize_params
from repro_torch.serving.metrics import (MetricsRegistry, counter_attr,
                                         gauge_attr)
from repro_torch.serving.sampling import (SamplingParams, require_greedy,
                                          sample_greedy)
from repro_torch.serving.scheduler import (
    PhaseScheduler,
    TickPlan,
    bucket_pow2 as _bucket,
    pack_chunks,
)
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
    if sc.speculative is not None and not sc.paged:
        raise ValueError(
            "speculative decoding requires paged=True (the "
            "draft/verify loop writes and rolls back through the "
            "paged arena's block tables)")


def _unported(sc: ServeConfig, chunked: bool) -> Optional[str]:
    """The first ``ServeConfig`` option this slice does not serve, with the
    ROADMAP queue A item that brings it; None when every option is in.
    ``packed_prefill`` matters only to a chunked prefill: the reference
    reads it as ``packed_prefill and chunked``."""
    checks = [
        (not sc.packed_prefill and chunked,
         "packed_prefill=False (the padded [N, C] prefill batch): item 11"),
        (sc.prefix_cache, "prefix_cache=True: item 7"),
        (sc.speculative is not None, "speculative decoding: item 7"),
        (sc.host_spill_pages > 0, "host_spill_pages > 0 (host tier): item 9"),
        (not sc.default_sampling().greedy,
         "a stochastic default sampling (greedy=False): item 8"),
        (sc.executor == "disaggregated", "executor='disaggregated': item 9"),
        (sc.admission is not None, "admission control: item 10"),
    ]
    for hit, what in checks:
        if hit:
            return what
    return None


class ServingEngine:
    # Lifetime counters live in the METRICS REGISTRY (serving/metrics.py):
    # each attribute below is a view over one named registry cell, so the
    # dict APIs (counts()) and MetricsRegistry.snapshot() / render() can
    # never disagree.
    host_transfers = counter_attr("serving_host_transfers_total")
    preemptions = counter_attr("serving_preemptions_total")
    recompute_preemptions = counter_attr("serving_recompute_preemptions_total")
    prefill_tokens_executed = counter_attr("serving_prefill_tokens_total")
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
    _TICK_DELTA_KEYS = ("serving_preemptions_total",)

    def __init__(self, cfg: ModelConfig, params: Any, sc: ServeConfig,
                 *, device=None):
        """``params`` must already live on ``device`` (``cuda`` unless the
        caller passes another, e.g. ``device="cpu"``)."""
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
        # bounded record of recent ticks; occupancy uses running counters
        self.tick_log: Deque[TickRecord] = deque(maxlen=65_536)
        # baseline for TickRecord's registry deltas, carried ACROSS ticks
        self._tick_delta_base = self.metrics.values(self._TICK_DELTA_KEYS)
        self._n_ticks = 0
        self._n_prefill_ticks = 0
        self._n_decode_ticks = 0
        self._n_mixed_ticks = 0
        self.host_transfers = 0          # device->host syncs (see _to_host)
        self.preemptions = 0             # lifetime pool evictions
        self.kv_resident_peak = 0        # peak allocated KV bytes
        self.recompute_preemptions = 0   # every preemption recomputes here
        self.prefill_tokens_executed = 0  # chunk tokens actually computed
        self.decode_tokens_emitted = 0
        self.decode_slot_ticks = 0       # (request, tick) decode occupancies
        self._next_id = 0
        self.chunked = chunked
        self.prefill_launches = 0        # prefill phase-program calls
        self.prefill_rows_executed = 0   # token rows computed (incl. pad)
        self.executor = make_executor(sc.executor, {
            "whole": self._prefill_whole_impl,
            "decode": self._decode_impl,
            "packed": self._prefill_packed_impl,
            "decode_paged": self._decode_paged_impl,
            "packed_paged": self._prefill_packed_paged_impl,
        }, metrics=self.metrics)

    # -- program table (owned by the executor) ---------------------------------
    @property
    def compile_count(self) -> int:
        return self.executor.compile_count

    def _program(self, group: str, kind: str) -> Callable:
        return self.executor.program(group, kind)

    def _note_compile(self, group: str, kind: str, shape: Tuple[int, ...],
                      all_greedy: bool) -> None:
        self.executor.note_compile(group, kind, shape, all_greedy)

    # -- phase programs ---------------------------------------------------------
    @torch.inference_mode()
    def _prefill_whole_impl(self, params, tokens, slot, cache, all_greedy):
        """Whole-prompt prefill of one request (tokens [1, T]) with its K/V
        spliced into arena slot ``slot``.  Returns [1] int32 tokens."""
        logits, cache = prefill_into_arena(params, self.cfg,
                                           {"tokens": tokens}, slot, cache)
        return sample_greedy(logits), cache

    @torch.inference_mode()
    def _prefill_packed_impl(self, params, tokens, starts, offsets, lengths,
                             slots, cache, all_greedy):
        """Packed-stream chunk prefill into the dense arena: the tick's
        chunks as one flat [T] token stream.  Returns [N] int32 tokens."""
        logits, cache = forward_chunk_packed(
            params, self.cfg, tokens, starts, offsets, lengths, slots,
            cache, pack_align=self.sc.phase.pack_align)
        return sample_greedy(logits), cache

    @torch.inference_mode()
    def _decode_impl(self, params, tokens, cache, pos, slot_mask,
                     all_greedy):
        """One-token decode over the dense arena, all max_batch rows.  The
        reference merges old and new arena over the whole arena with
        ``where(slot_mask, new, old)``; here only the ``slot_mask`` rows
        write their K/V, in place, so idle slots' rows are never touched
        (and nothing of the arena's size is copied)."""
        logits, cache, _ = forward(params, self.cfg, {"tokens": tokens},
                                   phase="decode", cache=cache, pos=pos,
                                   slot_mask=slot_mask)
        return sample_greedy(logits), cache

    @torch.inference_mode()
    def _prefill_packed_paged_impl(self, params, tokens, starts, offsets,
                                   lengths, slots, cache, block_tables,
                                   all_greedy):
        """Packed-stream chunk prefill into the page pool: the tick's chunks
        as one flat [T] token stream — one launch per layer, one shape key
        per bucketed T.  Returns [N] int32 tokens (row i samples chunk i)."""
        logits, cache = forward_chunk_packed(
            params, self.cfg, tokens, starts, offsets, lengths, slots,
            cache, block_tables=block_tables,
            pack_align=self.sc.phase.pack_align)
        return sample_greedy(logits), cache

    @torch.inference_mode()
    def _decode_paged_impl(self, params, tokens, cache, pos, block_tables,
                           all_greedy):
        """One-token decode over the page pool.  Inactive rows carry
        all-sentinel block-table rows, so their K/V writes drop."""
        logits, cache, _ = forward(params, self.cfg, {"tokens": tokens},
                                   phase="decode", cache=cache, pos=pos,
                                   block_tables=block_tables)
        return sample_greedy(logits), cache

    # -- public API -----------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None, *,
               sampling: Optional[SamplingParams] = None) -> Request:
        """Queue one request (greedy sampling only in this slice).

        ``sampling`` carries the per-request parameters; omitted, the
        ``ServeConfig`` defaults apply.  ``max_new_tokens`` / ``eos_id``
        override the corresponding ``sampling`` fields when given."""
        sp = sampling if sampling is not None else self._default_sampling
        if max_new_tokens is not None:
            sp = replace(sp, max_new_tokens=max_new_tokens)
        if eos_id is not None:
            sp = replace(sp, eos_id=eos_id)
        require_greedy(sp)
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
        req.t_submit = time.monotonic()
        self._next_id += 1
        self.queue.append(req)
        return req

    # -- helpers ----------------------------------------------------------------
    def _to_host(self, arr: torch.Tensor) -> np.ndarray:
        """The engine's single device->host transfer point: one token array
        per phase-program call."""
        self.host_transfers += 1
        return arr.cpu().numpy()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self) -> List[Request]:
        admitted = []
        free = self._free_slots()
        # the queue is age-ordered (submit appends, _preempt inserts by
        # req_id), so slots go FIFO
        while free and self.queue:
            req = self.queue.pop(0)
            slot = free.pop(0)
            req.slot = slot
            req.state = RequestState.PREFILLING
            self.slot_req[slot] = req
            admitted.append(req)
        return admitted

    def _by_id(self) -> Dict[int, Request]:
        return {r.req_id: r for r in self.slot_req if r is not None}

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
        to WAITING (age-ordered), resumed by recompute."""
        assert self.paged and req.slot >= 0
        req.prefill_pos = 0
        self.recompute_preemptions += 1
        self.pool.release(req.slot)
        self.slot_req[req.slot] = None
        self.slot_pos[req.slot] = -1
        req.slot = -1
        req.state = RequestState.WAITING
        req.n_preempted += 1
        self.preemptions += 1
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
        holders = [r for r in self.slot_req
                   if r is not None and self.pool.len_of(r.slot) > 0]
        if not holders:
            return
        victim = max(holders, key=lambda r: r.req_id)
        oldest = min((r for r in self.slot_req if r is not None),
                     key=lambda r: r.req_id)
        if victim is not oldest:
            self._preempt(victim)

    def _append_token(self, req: Request, tok) -> None:
        req.generated.append(int(np.asarray(tok).reshape(-1)[0]))

    def _start_decoding(self, req: Request, tok) -> None:
        self.slot_pos[req.slot] = self._effective_len(req)
        if req.sampling.max_new_tokens == 0 and not req.generated:
            # prefill-only request: the seeding sample is discarded
            req.finish_reason = "length"
            self._retire(req)
            return
        self._append_token(req, tok)
        if req.t_first_token == 0.0:    # a resumed prefill keeps its TTFT
            req.t_first_token = time.monotonic()
        req.state = RequestState.DECODING
        if self._finished(req):
            self._retire(req)

    def _stream_reason(self, req: Request) -> Optional[str]:
        """Token-stream termination only (max_new / eos / stop)."""
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
        self.metrics.observe("serving_ttft_seconds", req.ttft)
        self.metrics.observe("serving_tpot_seconds", req.tpot)
        if self.paged:
            self.pool.release(req.slot)
        self.slot_req[req.slot] = None
        self.slot_pos[req.slot] = -1
        self.done.append(req)

    def _grow_for_decode(self, r: Request) -> bool:
        """Secure this tick's one-token write for ``r``; on exhaustion
        preempt the youngest page holder.  False iff ``r`` itself was
        evicted."""
        pos = int(self.slot_pos[r.slot])
        while True:
            if self.pool.grow(r.slot, pos + 1):
                return True
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
                self._note_compile(plan.prefill_group, "whole",
                                   (req.prompt_len,), True)
                toks, self.cache = self._program(plan.prefill_group,
                                                 "whole")(
                    self.params, tokens, req.slot, self.cache, True)
                req.prefill_pos = req.prompt_len
                self.prefill_tokens_executed += req.prompt_len
                self.prefill_launches += 1
                self.prefill_rows_executed += req.prompt_len
                self._start_decoding(req, self._to_host(toks)[0])
            return
        if self.paged:
            # claim the chunks' pages; the scheduler planned against the
            # pool headroom, so this succeeds — trim defensively if a
            # same-tick race says otherwise
            claimed = []
            for req, take in chunks:
                take = min(take, self.pool.max_grow_tokens(req.slot))
                if take <= 0 or not self.pool.grow(req.slot,
                                                   req.prefill_pos + take):
                    continue
                claimed.append((req, take))
            chunks = claimed
            if not chunks:
                return
        self._prefill_progress = True
        toks = self._launch_packed_prefill(plan, chunks)
        self.prefill_tokens_executed += sum(take for _, take in chunks)
        self.prefill_launches += 1
        sampled = None
        for i, (req, take) in enumerate(chunks):
            req.prefill_pos += take
            if req.prefill_pos >= self._effective_len(req):
                if sampled is None:
                    sampled = self._to_host(toks)   # one transfer per tick
                self._start_decoding(req, sampled[i])

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
        all_greedy = True
        self.prefill_rows_executed += T
        args = (self.params, self._tensor(tokens), self._tensor(starts),
                self._tensor(offs), self._tensor(lens), self._tensor(slots),
                self.cache)
        if self.paged:
            self._note_compile(plan.prefill_group, "packed_paged", (T, Nb),
                               all_greedy)
            toks, self.cache = self._program(plan.prefill_group,
                                             "packed_paged")(
                *args, self.pool.block_tables(), all_greedy)
        else:
            self._note_compile(plan.prefill_group, "packed", (T, Nb),
                               all_greedy)
            toks, self.cache = self._program(plan.prefill_group, "packed")(
                *args, all_greedy)
        return toks

    def _run_decode_tick(self, plan: TickPlan) -> None:
        reqs = self._by_id()
        active = [reqs[rid] for rid in plan.decode_reqs
                  if rid in reqs and reqs[rid].state == RequestState.DECODING]
        if self.paged and active:
            # each decode write may cross into a fresh page; grow
            # oldest-first and, when the pool is out, PREEMPT the youngest
            # page holder (it re-queues for recompute)
            survivors = []
            for r in sorted(active, key=lambda r: r.req_id):
                if r.state != RequestState.DECODING or r.slot < 0:
                    continue                        # evicted earlier this loop
                if self._grow_for_decode(r):
                    survivors.append(r)
            active = survivors
        if not active:
            return
        all_greedy = True
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
            self._note_compile(plan.decode_group, "decode_paged", (nb,),
                               all_greedy)
            # pad rows carry all-sentinel block-table rows: their writes
            # drop
            toks, self.cache = self._program(plan.decode_group,
                                             "decode_paged")(
                self.params, self._tensor(tokens), self.cache,
                self._tensor(pos),
                self.pool.block_tables(rows=[r.slot for r in active], n=nb),
                all_greedy)
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
            self._note_compile(plan.decode_group, "decode", (B,), all_greedy)
            toks, self.cache = self._program(plan.decode_group, "decode")(
                self.params, self._tensor(tokens), self.cache,
                self._tensor(pos), self._tensor(mask), all_greedy)
            emitted = [(r.slot, r) for r in active]
        sampled = self._to_host(toks)               # one transfer per tick
        for row, r in emitted:
            self._append_token(r, sampled[row])
            self.decode_tokens_emitted += 1
            self.decode_slot_ticks += 1
            self.slot_pos[r.slot] += 1
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
        counts0 = {r.req_id: len(r.generated) for r in self.queue}
        counts0.update({r.req_id: len(r.generated)
                        for r in self.slot_req if r is not None})
        done0 = len(self.done)
        self._admit()
        prefilling = sorted(
            ((r.req_id, self._effective_len(r) - r.prefill_pos,
              self.chunked, r.prefill_pos)
             for r in self.slot_req
             if r is not None and r.state == RequestState.PREFILLING),
            key=lambda e: e[0])
        decoding = [r.req_id for r in self.slot_req
                    if r is not None and r.state == RequestState.DECODING]
        if self.paged:
            # token-level admission: prefill work is planned against the
            # pool's free pages, with this tick's decode growth reserved
            headroom = self.pool.headroom_pages(
                [self.pool.len_of(r.slot) for r in self.slot_req
                 if r is not None and r.state == RequestState.DECODING],
                growth=1)
            plan = self.scheduler.plan_tick(
                prefilling, decoding, free_pages=headroom,
                page_size=self.sc.page_size,
                capacity=self.pool.widest_capacity(), spec_k=0)
        else:
            plan = self.scheduler.plan_tick(prefilling, decoding, spec_k=0)
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
            new_compiles=self.executor.tick_new_compiles)
        self.metrics.observe("serving_tick_wall_seconds", rec.wall_s)
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
        """Queue/slot/done occupancy plus the lifetime counters — every
        value is a view over the metrics registry (or derived from one).
        The reference's keys for what this slice does not have (SLO
        goodput, deferral, shedding, migration, host swap) are left out."""
        return {"queued": len(self.queue),
                "active": sum(r is not None for r in self.slot_req),
                "done": len(self.done),
                "recompute_preemptions": self.recompute_preemptions}

    def _live(self) -> bool:
        return bool(self.queue or any(r is not None for r in self.slot_req))

    def _check_drained(self, ticks: int, max_ticks: int) -> None:
        """Fail LOUDLY when the tick budget runs out with live requests."""
        if ticks >= max_ticks and self._live():
            c = self.counts()
            last = self.tick_log[-1] if self.tick_log else None
            raise RuntimeError(
                f"max_ticks={max_ticks} exhausted with live requests "
                f"({c['queued']} queued, {c['active']} active, {c['done']} "
                f"done; preemptions={self.preemptions}) — the engine did not "
                f"drain. counts={c} last_tick={last}")

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        ticks = 0
        while self._live() and ticks < max_ticks:
            self.step()
            ticks += 1
        self._check_drained(ticks, max_ticks)
        return self.done

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

    def phase_occupancy(self) -> Dict[str, float]:
        """Fractions of ticks running prefill / decode / both."""
        n = max(self._n_ticks, 1)
        return {
            "prefill": self._n_prefill_ticks / n,
            "decode": self._n_decode_ticks / n,
            "mixed": self._n_mixed_ticks / n,
        }
