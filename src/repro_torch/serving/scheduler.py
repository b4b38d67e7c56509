"""Phase-aware scheduling: HALO's mapping strategy as a serving policy.

HALO's core contribution is that prefill and decode want DIFFERENT hardware
(CiM for compute-bound GEMMs, CiD for memory-bound GEMVs) and a phase-aware
mapper that routes each phase to its engine.  The TPU-cluster analogue is
PHASE DISAGGREGATION: a prefill worker group runs the compute-optimized
program (flash GEMM kernels, TP-heavy sharding, big batch-of-tokens), a
decode worker group runs the bandwidth-optimized program (int8 weight
streaming GEMVs, sequence-sharded KV caches), and finished prefills hand
their KV cache across (HALO's 2.5D interposer hop = the ICI/DCN transfer).

``PhaseScheduler.plan_tick`` decides, per tick, which group works on what —
and the engine EXECUTES that plan: ``TickPlan.prefill_chunks`` names the
exact (request, token-count) prefill work of the tick, ``decode_reqs`` the
decode occupants, and the two ``*_group`` fields select which worker
group's compiled program serves each phase, mirroring Table II of the
paper:

  halo      prefill -> prefill-group, decode -> decode-group (phase-aware)
  cent      everything on the decode-style group (fully CiD analogue)
  attacc    attention on the decode group, the rest on the prefill group —
            modeled at whole-phase granularity as: both phases run the
            prefill-group's programs.

Continuous batching (decode slots freed by finished requests are refilled
immediately) and chunked prefill (long prompts processed in
``prefill_chunk``-sized pieces under a per-tick token budget, so decode
ticks interleave — the TTFT/TPOT trade-off) are both planned here and
carried out by ``ServingEngine.step``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

# Priority classes (smaller = more urgent).  A class is a COARSE lane:
# the scheduler orders prefill work by (class, TTFT deadline, age), so an
# interactive request always outranks a batch one, and within a class the
# earliest deadline goes first (EDF) with age as the deterministic tie
# break.  These are plain ints (not an Enum) so they sort, serialize, and
# default naturally in dataclasses and trace JSON.
PRIORITY_INTERACTIVE = 0
PRIORITY_STANDARD = 1
PRIORITY_BATCH = 2


def pages_for(length: int, page_size: int, capacity: int) -> int:
    """Physical pages holding a sequence of ``length`` tokens, ring-clamped
    to ``capacity`` logical entries.

    Lives here (pure Python, no jax) so both the scheduler's token-level
    admission and ``kv_pool.PagePool``'s accounting share ONE definition —
    the two diverging is exactly the sliding-window mis-charge bug this
    module used to have (an unclamped ``ceil(cur_len / page_size)`` charged
    ring runs pages they reuse forever).
    """
    return -(-min(max(length, 0), capacity) // page_size)


def bucket_pow2(n: int, cap: int = 0) -> int:
    """Round up to a power of two (optionally capped) — the engine and
    the model drafter bucket their packed-batch shapes through this so
    the number of compiled program shapes stays bounded."""
    b = 1
    while b < n:
        b *= 2
    return max(1, min(b, cap)) if cap else b


def align_up(n: int, align: int) -> int:
    return -(-max(n, 0) // max(align, 1)) * max(align, 1)


def bucket_tokens(n: int, align: int = 1) -> int:
    """``bucket_pow2`` with a half-octave step: round ``n`` up to the
    nearest of ``..., 16, 24, 32, 48, 64, 96, 128, ...`` whose value is a
    multiple of ``align``.  The packed prefill stream buckets its length
    through this — two compiled shapes per octave instead of one keeps
    the pow2 ladder's bounded-shape-count guarantee while halving the
    worst-case bucket tail (a 40-token pack runs 48 rows, not 64)."""
    b = bucket_pow2(n)
    mid = (3 * b) // 4
    if 0 < n <= mid and mid % max(align, 1) == 0:
        return mid
    return b


@dataclass(frozen=True)
class PackedPrefill:
    """One tick's prefill chunks laid out as a single flat token stream.

    Segment ``i`` (the chunk of request ``req_ids[i]``) occupies stream
    positions ``[starts[i], starts[i] + takes[i])``; segment starts are
    aligned to ``align`` (a pow2 tile size, so a Pallas q-tile never
    straddles two segments) and the stream length is rounded up the pow2
    bucket ladder — mixed chunk lengths hit a bounded set of compiled
    shapes instead of one shape per length mix.
    """
    req_ids: Tuple[int, ...]
    takes: Tuple[int, ...]
    starts: Tuple[int, ...]
    align: int
    length: int                        # bucketed flat stream length

    @property
    def total_tokens(self) -> int:
        return sum(self.takes)

    @property
    def padded_tokens(self) -> int:
        """Stream positions carrying no real token (alignment gaps +
        the pow2 bucket tail) — the packed path's waste metric; the
        padded-batch layout wastes ``N*C - total`` instead."""
        return self.length - self.total_tokens


def pack_chunks(chunks: Sequence[Tuple[int, int]], *,
                align: int = 8) -> "PackedPrefill":
    """Pack (req_id, n_tokens) prefill chunks into one flat stream.

    Every chunk keeps its tokens contiguous; each segment start is
    aligned up to ``align`` and the total stream length is bucketed to
    the pow2 ladder.  Token conservation (no drop, no duplicate, no
    overlap) is the invariant tests/test_packed_prefill.py fuzzes.
    """
    if align < 1 or (align & (align - 1)) != 0:
        raise ValueError(f"pack align must be a power of two, got {align}")
    req_ids, takes, starts = [], [], []
    cur = 0
    for rid, take in chunks:
        if take <= 0:
            continue
        req_ids.append(rid)
        takes.append(int(take))
        starts.append(cur)
        cur = align_up(cur + int(take), align)
    length = max(bucket_tokens(cur, align), align) if cur else align
    return PackedPrefill(req_ids=tuple(req_ids), takes=tuple(takes),
                         starts=tuple(starts), align=align, length=length)


@dataclass(frozen=True)
class PhaseAwareConfig:
    strategy: str = "halo"             # halo | cent | attacc
    max_decode_batch: int = 8          # decode slots (continuous batching)
    max_prefill_tokens: int = 8192     # per prefill tick (chunked prefill)
    prefill_chunk: int = 2048          # <= 0: whole-prompt (unchunked)
    pack_align: int = 8                # packed-prefill segment alignment (pow2)

    def __post_init__(self):
        if self.max_prefill_tokens < 1:
            # a zero budget plans no prefill work at all: every request
            # would sit PREFILLING forever and the engine would spin
            raise ValueError(
                f"max_prefill_tokens must be >= 1, got "
                f"{self.max_prefill_tokens}")
        if self.max_decode_batch < 1:
            raise ValueError(
                f"max_decode_batch must be >= 1, got {self.max_decode_batch}")
        if self.pack_align < 1 or (self.pack_align & (self.pack_align - 1)):
            raise ValueError(
                f"pack_align must be a power of two >= 1, got "
                f"{self.pack_align}")


@dataclass
class TickPlan:
    prefill_reqs: List[int] = field(default_factory=list)   # request ids
    decode_reqs: List[int] = field(default_factory=list)
    # (req_id, n_tokens) prefill work this tick, aligned with prefill_reqs
    prefill_chunks: List[Tuple[int, int]] = field(default_factory=list)
    # which worker group executes each phase this tick
    prefill_group: str = "prefill"
    decode_group: str = "decode"
    # speculative decoding: decode occupants whose drafter proposed tokens
    # run a VERIFY window this tick — a k+1-token prefill-shaped batch
    # that belongs on the compute-bound (CiM) group, while the drafting
    # itself stays a memory-bound decode op on the CiD group
    spec_k: int = 0
    verify_group: str = "prefill"
    # flat-stream layout of prefill_chunks (packed prefill path); None
    # when the tick plans no prefill work
    packed: Optional[PackedPrefill] = None

    @property
    def prefill_tokens(self) -> int:
        return sum(t for _, t in self.prefill_chunks)


class PhaseScheduler:
    """Pure decision logic (no jax) — unit-testable."""

    def __init__(self, cfg: PhaseAwareConfig):
        self.cfg = cfg

    def groups_for(self) -> Tuple[str, str]:
        s = self.cfg.strategy
        if s == "halo":
            return "prefill", "decode"
        if s == "cent":                 # everything on the CiD-analogue
            return "decode", "decode"
        if s == "attacc":               # decode mostly on the CiM-analogue
            return "prefill", "prefill"
        raise ValueError(s)

    def plan_tick(self, waiting: Sequence[tuple], decoding: List[int], *,
                  free_pages: Optional[int] = None,
                  page_size: int = 0,
                  capacity: Optional[int] = None,
                  spec_k: int = 0) -> TickPlan:
        """waiting: [(req_id, remaining_prompt_tokens[, chunkable[,
        cur_len[, priority[, ttft_deadline]]]])]; decoding: [req_id].

        Greedy: fill decode slots first (latency), then admit prefill work
        up to the token budget.  Chunkable requests take at most
        ``prefill_chunk`` tokens per tick; non-chunkable ones (SSM /
        shared-attention plans, whose recurrent state cannot resume
        mid-prompt) are scheduled atomically as one whole-prompt chunk.

        SLO-AWARE ORDERING: prefill admission walks ``waiting`` in
        ``(priority, ttft_deadline, req_id)`` order — priority classes
        first (``PRIORITY_INTERACTIVE`` outranks ``PRIORITY_BATCH``),
        earliest-TTFT-deadline first within a class (EDF: the request
        closest to busting its deadline gets the tick's prefill budget),
        age (req_id) as the deterministic tie break.  Entries that omit
        the two trailing fields default to ``PRIORITY_STANDARD`` with no
        deadline, which makes the order degrade to the pre-SLO pure age
        order — existing callers see identical plans.

        TOKEN-LEVEL ADMISSION (paged arena): with ``free_pages`` /
        ``page_size`` set, prefill work is additionally admitted only
        while the pool's free pages cover it — each chunk is clipped to
        the tokens its request's remaining page headroom can hold, given
        its current arena length ``cur_len`` (a partially-filled last page
        still has room; a fresh page is charged the moment a chunk
        crosses into it).  The engine reserves this tick's decode-growth
        pages before calling, so prefill can never starve decode of its
        one-token writes.

        ``capacity`` is the logical span of the pool's WIDEST run (the
        engine passes ``max(p.capacity for p in pools)``): page charges are
        ring-clamped with the same ``pages_for`` rule ``PagePool`` uses, so
        a sliding-window request whose ``cur_len`` exceeds its ring span is
        charged ZERO fresh pages for growth (the ring reuses its pages
        forever).  Charging by the widest run is a safe upper bound for
        every narrower run — page growth is monotone in capacity — while
        ``free_pages`` is already the min across runs.  Tokens already in
        the arena at admission (a prefix-cache hit attaches shared pages
        before the request ever reaches this planner) never appear in
        ``remaining``, so cached work is admitted at zero token/page cost.

        SPECULATIVE DECODING (``spec_k`` > 0): each decode occupant may
        run a verify window this tick — a (spec_k + 1)-token
        prefill-shaped batch charged like a mini prefill chunk.  The
        engine reserves the page coverage for those windows BEFORE
        computing ``free_pages`` (``KVPool.headroom_pages(growth =
        spec_k + 1)``), so the admission arithmetic here is unchanged;
        this planner stamps the plan with the window size and routes
        verification to the compute-bound (CiM-analogue) worker group —
        verifying k+1 tokens is small-batch prefill work — while draft
        steps remain decode ops on the CiD-analogue group.
        """
        pg, dg = self.groups_for()
        plan = TickPlan(prefill_group=pg, decode_group=dg,
                        spec_k=max(spec_k, 0), verify_group=pg)
        plan.decode_reqs = decoding[: self.cfg.max_decode_batch]
        budget = self.cfg.max_prefill_tokens
        free_slots = self.cfg.max_decode_batch - len(plan.decode_reqs)
        pages_left = free_pages
        ordered = sorted(
            waiting,
            key=lambda e: (e[4] if len(e) > 4 else PRIORITY_STANDARD,
                           e[5] if len(e) > 5 else math.inf,
                           e[0]))
        for entry in ordered:
            rid, remaining = entry[0], entry[1]
            chunkable = entry[2] if len(entry) > 2 else True
            cur_len = entry[3] if len(entry) > 3 else 0
            if free_slots <= 0 and budget <= 0:
                break
            if chunkable:
                take = min(remaining, self.cfg.prefill_chunk, max(budget, 0))
            else:
                # atomic: whole prompt or nothing.  The first atomic prompt
                # may exceed the budget (it cannot be split), but a spent
                # budget admits no further ones — otherwise a queue of long
                # SSM prompts would serialize ahead of the tick's decode
                # phase, exactly the head-of-line blocking the budget exists
                # to prevent.
                take = remaining if budget > 0 else 0
            if pages_left is not None and page_size > 0 and take > 0:
                cap = capacity if capacity is not None else cur_len + take
                used = pages_for(cur_len, page_size, cap)
                width = pages_for(cap, page_size, cap)
                if used + pages_left >= width:
                    # the free pages reach the run's full width: the ring
                    # (or the request's final pages) covers ANY growth
                    coverable = take
                else:
                    # tokens coverable = tail of the current (clamped) page
                    # + free pages
                    clamped = min(max(cur_len, 0), cap)
                    coverable = (used + pages_left) * page_size - clamped
                if not chunkable and coverable < take:
                    take = 0                             # atomic: all or none
                take = min(take, coverable)
            if take <= 0:
                break
            plan.prefill_reqs.append(rid)
            plan.prefill_chunks.append((rid, take))
            budget -= take
            if pages_left is not None and page_size > 0:
                cap = capacity if capacity is not None else cur_len + take
                pages_left -= (pages_for(cur_len + take, page_size, cap)
                               - pages_for(cur_len, page_size, cap))
            if take >= remaining:
                free_slots -= 1        # request becomes a decode occupant
        if plan.prefill_chunks:
            # flat-stream layout for the packed prefill path: differing
            # chunk lengths share ONE kernel launch instead of padding
            # to a common [N, C] rectangle
            plan.packed = pack_chunks(plan.prefill_chunks,
                                      align=self.cfg.pack_align)
        return plan


@dataclass(frozen=True)
class AdmissionConfig:
    """Policy knobs for shed-before-thrash admission control.

    Under overload the engine's failure mode is PREEMPTION THRASH: every
    admitted request evicts another's KV pages, recompute-on-resume burns
    the prefill budget, and NOBODY meets their deadline.  The admission
    controller refuses work at ``submit()`` time instead — a request whose
    projected TTFT already busts its deadline is turned away while the
    pages it would have churned keep serving requests that can still win.
    Goodput-under-SLO goes UP by serving fewer requests.

    ``tick_cost_s``: fixed seconds-per-tick for the TTFT projection.
    ``None`` uses the engine's live tick-wall EMA (production); a fixed
    value makes every admission decision a pure function of queue
    occupancy — deterministic across runs/machines, which the
    async-vs-sync identity tests and the committed bench baseline need.

    ``margin`` scales the deadline before comparison (>1 sheds earlier,
    <1 later).  ``min_ema_ticks``: below this many observed ticks the EMA
    is noise — admit optimistically rather than shed on a cold start.

    ``max_pending_tokens`` is a STRUCTURAL backpressure cap on queued-but
    -unstarted prefill tokens, independent of any deadline: best-effort
    requests (no SLO) are deferred — parked and retried each tick — once
    the backlog exceeds it, rather than piling onto the queue; a prompt
    that ALONE exceeds the cap is shed outright (it could never start).
    """
    enabled: bool = True
    margin: float = 1.0
    tick_cost_s: Optional[float] = None
    min_ema_ticks: int = 2
    max_pending_tokens: Optional[int] = None

    def __post_init__(self):
        if self.margin <= 0:
            raise ValueError(f"margin must be > 0, got {self.margin}")
        if self.tick_cost_s is not None and self.tick_cost_s <= 0:
            raise ValueError(
                f"tick_cost_s must be > 0, got {self.tick_cost_s}")
        if self.min_ema_ticks < 0:
            raise ValueError(
                f"min_ema_ticks must be >= 0, got {self.min_ema_ticks}")
        if self.max_pending_tokens is not None and self.max_pending_tokens < 1:
            raise ValueError(
                f"max_pending_tokens must be >= 1, got "
                f"{self.max_pending_tokens}")


class AdmissionController:
    """Stateless admit/defer/shed decisions (the engine owns the EMA).

    Pure host logic like ``PhaseScheduler`` — every decision is a
    function of its arguments, so unit tests need no engine and the
    deterministic mode (fixed ``tick_cost_s``) is reproducible by
    construction.
    """

    def __init__(self, cfg: AdmissionConfig, sched_cfg: PhaseAwareConfig):
        self.cfg = cfg
        self.sched = sched_cfg

    def resolve_tick_cost(self, ema_value: float,
                          ema_ticks: int) -> Optional[float]:
        """Seconds-per-tick to project with: the configured fixed cost,
        else the live EMA once it has seen enough ticks, else ``None``
        (no usable estimate — admit optimistically)."""
        if self.cfg.tick_cost_s is not None:
            return self.cfg.tick_cost_s
        if ema_ticks >= max(self.cfg.min_ema_ticks, 1) and ema_value > 0:
            return ema_value
        return None

    def project_ttft_s(self, prompt_len: int, *, backlog_tokens: int,
                       decode_backlog_tokens: int = 0, n_live: int = 0,
                       tick_cost_s: float) -> float:
        """Projected time-to-first-token under CURRENT occupancy.

        Three queueing terms, all in ticks: (a) prefill-budget ticks to
        chew through the prefill backlog ahead of this prompt plus the
        prompt itself (``max_prefill_tokens`` per tick); (b) decode
        backlog — every live/queued request's REMAINING generation
        budget drains at ``max_decode_batch`` tokens per tick, and a
        prompt behind a deep queue waits for those generations whether
        or not a slot is nominally free (this term is what keeps the
        controller honest under sustained overload — slot count alone
        underprices queueing by the whole generation length); (c) slot
        pressure — each live request beyond the decode-slot count adds
        one more tick.  This deliberately ignores page pressure and
        chunking detail: it is an admission ESTIMATE, not a simulation,
        and erring simple keeps it monotone in occupancy (more load
        never projects a lower TTFT).
        """
        work = max(backlog_tokens, 0) + max(prompt_len, 0)
        prefill_ticks = -(-work // self.sched.max_prefill_tokens)
        decode_ticks = -(-max(decode_backlog_tokens, 0)
                         // self.sched.max_decode_batch)
        slot_wait = max(0, n_live + 1 - self.sched.max_decode_batch)
        return (prefill_ticks + decode_ticks + slot_wait) * tick_cost_s

    def decide(self, prompt_len: int, *, ttft_deadline_s: float = math.inf,
               backlog_tokens: int = 0, decode_backlog_tokens: int = 0,
               n_live: int = 0,
               ema_value: float = 0.0, ema_ticks: int = 0) -> str:
        """One of ``"admit"`` / ``"defer"`` / ``"shed"``.

        Shed beats defer for deadline-carrying requests: parking a
        request whose deadline is already lost just converts a fast
        refusal into a slow violation.  Best-effort requests have no
        deadline to lose, so the structural cap defers them instead.
        """
        if not self.cfg.enabled:
            return "admit"
        cap = self.cfg.max_pending_tokens
        if cap is not None:
            if prompt_len > cap:
                return "shed"          # could never start, even alone
            if backlog_tokens + prompt_len > cap:
                return "shed" if math.isfinite(ttft_deadline_s) else "defer"
        if math.isfinite(ttft_deadline_s):
            cost = self.resolve_tick_cost(ema_value, ema_ticks)
            if cost is not None:
                projected = self.project_ttft_s(
                    prompt_len, backlog_tokens=backlog_tokens,
                    decode_backlog_tokens=decode_backlog_tokens,
                    n_live=n_live, tick_cost_s=cost)
                if projected > self.cfg.margin * ttft_deadline_s:
                    return "shed"
        return "admit"
