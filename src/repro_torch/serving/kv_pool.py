"""Paged KV arena: a fixed block pool replaces the dense per-slot cache
(port of src/repro/serving/kv_pool.py).

A pool of ``n_pages`` pages of ``page_size`` tokens per attention run
(``[L, n_pages, page_size, Hkv, Dh]``) is shared by every slot; each
slot's logical positions map onto physical pages through a per-slot block
table.  Capacity is a POOL property: the same pool serves one long request
or many short ones, the scheduler admits prefill work token by token
against the free-page count, and the engine preempts the youngest request
when decode outgrows the pool.

Two layers:

* ``PagePool`` — host-side accounting for ONE pool, a verbatim copy of the
  reference: free list, per-slot block tables, per-page refcounts, grow /
  shrink / release, attach / retain / copy-on-write, and the invariants
  the tests check.
* ``KVPool`` — one ``PagePool`` + one page tensor pair per attention run,
  ZERO-initialized on the device (an uninitialized page could hold NaNs;
  the kernels mask unwritten entries, and zeros keep even a masked read
  finite).  The model updates the pages in place.  ``kv_dtype`` "int8"
  stores int8 pages, "int4" packed nibble pairs at half the head width,
  both beside one f32 scale page per (position, kv head).  It also
  carries the prefix cache's sharing queries (``shareable_capacity``,
  ``prefix_pages``, per-run ``attach`` / ``retain`` / ``release_ref``),
  copy-on-write across runs (``cow_deficit``, ``ensure_writable``) and
  speculative rollback (``truncate``, ``rollback_bound``).
* ``HostTier`` — the host-memory spill pool behind the device pool: per
  run, one host tensor per leaf (K/V and, quantized, their scale pages),
  pinned when the pool lives on the card, with the reference's free-list
  accounting and swap byte counters.  Pages move in batches
  (``store_pages`` / ``load_pages``: asynchronous copies on the engine's
  stream); the engine (``_swap_out``, ``_try_swap_in``, the prefix
  cache's demote/promote callbacks) decides which.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import build_plan, cache_len
from repro_torch.serving.metrics import MetricsRegistry, counter_attr
from repro_torch.serving.scheduler import pages_for


class PagePool:
    """Host-side page accounting for one fixed pool of ``n_pages`` pages.

    Tracks, per slot: the logical length and the block table row mapping
    logical page ``i`` to a physical page (the sentinel ``n_pages`` means
    "never allocated" — device scatters through it drop, gathers clamp and
    mask).  Pages carry a REFCOUNT: a page may back the same logical range
    of several slots at once (shared-prefix reuse) and may additionally be
    pinned by an external holder (the radix prefix cache) via
    ``retain``/``release_ref``.  A page returns to the free list only when
    its last reference drops; a writer about to dirty a shared page must
    go through ``cow`` first.  Pure Python/numpy; every mutation preserves
    the pool invariants (refcount conservation: ref == table references +
    external references; no free-while-referenced; no double assignment)
    that tests/test_kv_pool.py property-checks under arbitrary
    interleavings.
    """

    def __init__(self, n_pages: int, page_size: int, n_slots: int,
                 capacity: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError(f"need n_pages >= 1 and page_size >= 1, got "
                             f"{n_pages}/{page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.n_slots = n_slots
        # logical entries a slot can address (ring length R, or the full
        # pool span for position-indexed runs)
        self.capacity = capacity
        self.width = pages_for(capacity, page_size, capacity)
        self.free: List[int] = list(range(n_pages - 1, -1, -1))
        self.table = np.full((n_slots, self.width), n_pages, np.int32)
        self.lens = np.zeros((n_slots,), np.int64)
        # ref[p] = block-table rows pointing at p + external (cache) holds;
        # external is tracked separately so conservation is checkable
        self.ref = np.zeros((n_pages,), np.int32)
        self.external = np.zeros((n_pages,), np.int32)

    # -- queries ---------------------------------------------------------------
    def pages_of(self, length: int) -> int:
        return pages_for(length, self.page_size, self.capacity)

    def pages_needed(self, slot: int, new_len: int) -> int:
        return max(self.pages_of(new_len) - self.pages_of(int(self.lens[slot])),
                   0)

    def free_pages(self) -> int:
        return len(self.free)

    def used_pages(self) -> int:
        return self.n_pages - len(self.free)

    def is_shared(self, page: int) -> bool:
        """True iff ``page`` has more than one reference (another slot's
        table row, or the prefix cache) — a writer must COW it first."""
        return int(self.ref[page]) > 1

    def rows_touched(self, start: int, end: int) -> List[int]:
        """Block-table rows a write to logical positions [start, end)
        lands in (ring mapping: entry = pos % capacity).  A write range
        spanning the whole ring touches every row."""
        if end - start >= self.capacity:
            return list(range(self.width))
        rows, pos = [], start
        while pos < end:
            e = pos % self.capacity
            rows.append(e // self.page_size)
            # hop to the next page boundary OR the ring wrap, whichever
            # comes first (a ring span that is not a page multiple wraps
            # mid-page: positions on both sides land in different rows)
            pos += min(self.page_size - (e % self.page_size),
                       self.capacity - e)
        return sorted(set(rows))

    # -- mutations ---------------------------------------------------------------
    def _alloc(self) -> int:
        p = self.free.pop()
        assert self.ref[p] == 0, "free page had live references"
        self.ref[p] = 1
        return p

    def _decref(self, page: int) -> None:
        self.ref[page] -= 1
        assert self.ref[page] >= 0, "refcount underflow"
        if self.ref[page] == 0:
            self.free.append(int(page))

    def alloc_external(self) -> Optional[int]:
        """Allocate one free page owned by an EXTERNAL holder from birth
        (the prefix cache's host-tier PROMOTE path: a demoted block's KV
        is uploaded into a page no block table references yet).  The page
        starts at ref=1 external=1 — conservation (``ref == table_refs +
        external``) holds immediately — and frees through the usual
        ``release_ref``.  Returns None when the free list is empty."""
        if not self.free:
            return None
        p = self._alloc()
        self.external[p] += 1
        return p

    def grow(self, slot: int, new_len: int) -> bool:
        """Allocate the pages taking ``slot`` to ``new_len`` logical tokens.
        All-or-nothing: returns False (state unchanged) if the pool cannot
        cover it."""
        cur = int(self.lens[slot])
        if new_len < cur:
            raise ValueError(f"grow: new_len {new_len} < current {cur}")
        have = self.pages_of(cur)
        need = self.pages_of(new_len) - have
        if need > len(self.free):
            return False
        for j in range(need):
            self.table[slot, have + j] = self._alloc()
        self.lens[slot] = new_len
        return True

    def attach(self, slot: int, pages: Sequence[int], new_len: int) -> None:
        """Point an EMPTY slot's leading table rows at existing pages
        (shared-prefix reuse): each page gains a table reference, no page
        is allocated.  ``pages`` must exactly cover ``new_len`` tokens."""
        if int(self.lens[slot]) != 0:
            raise ValueError(f"attach: slot {slot} is not empty "
                             f"(len {int(self.lens[slot])})")
        if len(pages) != self.pages_of(new_len):
            raise ValueError(
                f"attach: {len(pages)} pages cannot back {new_len} tokens "
                f"(need {self.pages_of(new_len)})")
        for i, p in enumerate(pages):
            if not (0 <= p < self.n_pages) or self.ref[p] < 1:
                raise ValueError(f"attach: page {p} is not live")
            self.table[slot, i] = p
            self.ref[p] += 1
        self.lens[slot] = new_len

    def cow(self, slot: int, row: int) -> Optional[tuple]:
        """Copy-on-write the shared page behind ``table[slot, row]``: move
        the row to a freshly-allocated page and drop the old reference.
        Returns (old_page, new_page) for the caller's device copy, None if
        the page was exclusive (nothing to do).  Raises IndexError if the
        free list cannot supply the copy target — callers check
        ``free_pages()`` (or evict) first."""
        old = int(self.table[slot, row])
        if old >= self.n_pages or not self.is_shared(old):
            return None
        if not self.free:
            raise IndexError("cow: no free page for the copy target")
        new = self._alloc()
        self.table[slot, row] = new
        self.ref[old] -= 1              # > 0 by is_shared: never frees here
        return (old, new)

    def shrink(self, slot: int, new_len: int) -> None:
        """Drop the slot's references beyond ``new_len`` (rollback /
        partial free).  A page another slot or the prefix cache still
        references survives; exclusive pages return to the free list."""
        cur = int(self.lens[slot])
        if new_len > cur:
            raise ValueError(f"shrink: new_len {new_len} > current {cur}")
        keep = self.pages_of(new_len)
        for i in range(keep, self.pages_of(cur)):
            self._decref(int(self.table[slot, i]))
            self.table[slot, i] = self.n_pages
        self.lens[slot] = new_len

    def release(self, slot: int) -> None:
        """Drop every reference the slot holds (request done / preempted)."""
        self.shrink(slot, 0)

    # -- external (prefix cache) references ---------------------------------------
    def retain(self, page: int) -> None:
        """Pin a live page from outside the block tables (prefix cache)."""
        if not (0 <= page < self.n_pages) or self.ref[page] < 1:
            raise ValueError(f"retain: page {page} is not live")
        self.ref[page] += 1
        self.external[page] += 1

    def release_ref(self, page: int) -> None:
        """Drop one external reference; frees the page at refcount zero."""
        if self.external[page] < 1:
            raise ValueError(f"release_ref: page {page} has no external ref")
        self.external[page] -= 1
        self._decref(int(page))

    # -- invariants (asserted by the property tests) -----------------------------
    def check_invariants(self) -> None:
        table_refs = np.zeros((self.n_pages,), np.int64)
        for row in self.table:
            for p in row:
                if p < self.n_pages:
                    table_refs[p] += 1
        live = self.ref > 0
        assert (self.ref == table_refs + self.external).all(), \
            "refcount conservation violated (ref != table + external)"
        assert not (set(np.nonzero(live)[0].tolist()) & set(self.free)), \
            "page both referenced and free"
        assert len(self.free) == int((~live).sum()), \
            "free list does not match zero-ref pages"
        assert len(set(self.free)) == len(self.free), "free list duplicates"
        for s in range(self.n_slots):
            assert self.pages_of(int(self.lens[s])) == int(
                (self.table[s] < self.n_pages).sum()), "table/len mismatch"


class KVPool:
    """Device page tensors + per-run ``PagePool`` accounting for a model.

    ``caches`` is a list aligned with ``build_plan(cfg)``: per run a dict
    of zero-initialized tensors on ``device`` — ``{"k", "v"}`` of ``[L,
    n_pages, P, Hkv, Dh]`` in the model dtype for ``kv_dtype="f32"``; int8
    ``k``/``v`` of that shape plus f32 ``k_scale``/``v_scale`` of ``[L,
    n_pages, P, Hkv]`` for "int8"; uint8 ``k``/``v`` of ``[L, n_pages, P,
    Hkv, Dh // 2]`` (two nibbles per byte; uint8 against int8 is also how
    the model tells int4 from int8) plus the same scale pages for "int4".
    The block tables stay host-side (numpy) and are shipped per call as
    int32 tensors.
    """

    def __init__(self, cfg: ModelConfig, n_slots: int, n_pages: int,
                 page_size: int, kv_dtype: str = "f32", *, device):
        plan = build_plan(cfg)
        if not all(run.kind == "attn" for run in plan):
            raise ValueError(
                "paged KV arena requires an all-attention plan; got kinds "
                f"{[r.kind for r in plan]}")
        if kv_dtype not in ("f32", "int8", "int4"):
            raise ValueError(f"kv_dtype must be 'f32', 'int8' or 'int4', "
                             f"got {kv_dtype!r}")
        if kv_dtype == "int4" and cfg.d_head % 2:
            raise ValueError(f"kv_dtype='int4' packs head-dim pairs; "
                             f"d_head={cfg.d_head} is odd")
        self.cfg = cfg
        self.device = torch.device(device)
        self.n_slots = n_slots
        self.n_pages = n_pages
        self.page_size = page_size
        self.kv_dtype = kv_dtype
        # a position-indexed (full-attention) run can address the whole
        # pool from one slot: that IS the length bound; an all-ring plan
        # bounds nothing (rings reuse their pages forever)
        self.capacity = n_pages * page_size
        self.length_bound = (self.capacity
                             if any(r.window == 0 for r in plan)
                             else (1 << 62))
        self.plan = plan
        self.pools: List[PagePool] = []
        self.caches: List[Dict[str, torch.Tensor]] = []
        dtype, width = {"f32": (torch_dtype(cfg.dtype), cfg.d_head),
                        "int8": (torch.int8, cfg.d_head),
                        "int4": (torch.uint8, cfg.d_head // 2)}[kv_dtype]
        for run in plan:
            R = cache_len(run, self.capacity)
            self.pools.append(PagePool(n_pages, page_size, n_slots, R))
            shape = (run.n_layers, n_pages, page_size, cfg.n_kv_heads)
            cache = {name: torch.zeros((*shape, width), dtype=dtype,
                                       device=self.device)
                     for name in ("k", "v")}
            if kv_dtype != "f32":
                for name in ("k_scale", "v_scale"):
                    cache[name] = torch.zeros(shape, dtype=torch.float32,
                                              device=self.device)
            self.caches.append(cache)
        self._page_bytes = [
            sum(leaf.numel() * leaf.element_size() // n_pages
                for leaf in c.values())
            for c in self.caches]

    # -- capacity queries ---------------------------------------------------------
    def fits(self, total_len: int) -> bool:
        """Can the pool EVER hold a request of ``total_len`` tokens (prompt +
        generation), assuming it runs alone?"""
        if total_len > self.length_bound:
            return False
        return all(p.pages_of(total_len) <= p.n_pages for p in self.pools)

    def free_pages(self) -> int:
        """Binding free-page count (min across runs)."""
        return min(p.free_pages() for p in self.pools)

    def headroom_pages(self, decode_lens: Sequence[int],
                       growth: int = 1) -> int:
        """Free pages available to NEW prefill work after reserving the
        growth this tick's decode writes need (``growth`` tokens per listed
        slot length).  Min across runs; floored at 0."""
        room = None
        for p in self.pools:
            reserve = sum(p.pages_of(l + growth) - p.pages_of(l)
                          for l in decode_lens)
            r = p.free_pages() - reserve
            room = r if room is None else min(room, r)
        return max(room or 0, 0)

    def len_of(self, slot: int) -> int:
        return int(self.pools[0].lens[slot])

    def max_grow_tokens(self, slot: int) -> int:
        """Largest token growth ``grow(slot, len + t)`` can grant right now
        (min across runs); a run whose current + free pages reach its full
        width is never binding."""
        room = None
        for p in self.pools:
            cur = int(p.lens[slot])
            held = p.pages_of(cur)
            if held + p.free_pages() >= p.width:
                continue
            cov = (held + p.free_pages()) * p.page_size - cur
            room = cov if room is None else min(room, cov)
        return self.capacity if room is None else max(room, 0)

    # -- prefix-sharing queries ----------------------------------------------------
    def shareable_capacity(self) -> int:
        """Longest prefix (tokens) whose pages are position-pure in EVERY
        run: up to the narrowest ring span, logical page ``i`` is table row
        ``i`` for all runs, so one per-run page list describes the prefix.
        Beyond a run's ring span the ring has wrapped and its pages mix
        positions — those are never shared."""
        return min(p.capacity for p in self.pools)

    def widest_capacity(self) -> int:
        """Logical span of the widest run — the scheduler's conservative
        page-charge basis (see ``PhaseScheduler.plan_tick``)."""
        return max(p.capacity for p in self.pools)

    def prefix_pages(self, slot: int, n_tokens: int) -> List[List[int]]:
        """Per-run physical pages backing the slot's first ``n_tokens``
        tokens (``n_tokens`` page-aligned, within ``shareable_capacity``)."""
        if n_tokens % self.page_size or n_tokens > self.shareable_capacity():
            raise ValueError(f"prefix of {n_tokens} tokens is not "
                             "page-aligned/shareable")
        n = n_tokens // self.page_size
        return [[int(q) for q in p.table[slot, :n]] for p in self.pools]

    # -- mutations ---------------------------------------------------------------
    def grow(self, slot: int, new_len: int) -> bool:
        """Grow ``slot`` to ``new_len`` logical tokens in EVERY run's pool —
        all-or-nothing (partial successes roll back)."""
        done: List[PagePool] = []
        prev = [int(p.lens[slot]) for p in self.pools]
        for p, old in zip(self.pools, prev):
            if not p.grow(slot, new_len):
                for q, o in zip(done, prev):
                    q.shrink(slot, o)
                return False
            done.append(p)
        return True

    def attach(self, slot: int, pages: Sequence[Sequence[int]],
               new_len: int) -> None:
        """Point an empty slot at cached prefix pages (one page list per
        run) — shared, refcounted, no allocation.  ``new_len`` must be
        page-aligned and within ``shareable_capacity``."""
        if new_len % self.page_size or new_len > self.shareable_capacity():
            raise ValueError(f"attach of {new_len} tokens is not "
                             "page-aligned/shareable")
        for p, pp in zip(self.pools, pages):
            p.attach(slot, pp, new_len)

    def _shared_rows(self, p: PagePool, slot: int, start: int,
                     end: int) -> List[int]:
        """Rows of ``slot`` a write to [start, end) dirties whose page is
        allocated and shared."""
        return [row for row in p.rows_touched(start, end)
                if int(p.table[slot, row]) < p.n_pages
                and p.is_shared(int(p.table[slot, row]))]

    def cow_deficit(self, slot: int, start: int, end: int) -> int:
        """Free pages still missing before ``ensure_writable(slot, start,
        end)`` could supply every COW copy target (max across runs; 0 when
        it would succeed right now)."""
        deficit = 0
        for p in self.pools:
            need = len(self._shared_rows(p, slot, start, end))
            deficit = max(deficit, need - p.free_pages())
        return max(deficit, 0)

    def ensure_writable(self, slot: int, start: int, end: int
                        ) -> Optional[List[tuple]]:
        """Copy-on-write every SHARED page a write to logical positions
        [start, end) of ``slot`` would dirty, across all runs.  Returns
        [(run, old_page, new_page)] — the caller must mirror each entry
        with a device page copy BEFORE launching the write — or None,
        state unchanged, if some run's free list cannot supply its copy
        targets (the caller evicts/preempts and retries)."""
        planned: List[tuple] = []                 # (run, pool, row)
        for r, p in enumerate(self.pools):
            rows = self._shared_rows(p, slot, start, end)
            if len(rows) > p.free_pages():
                return None                       # nothing mutated yet
            planned.extend((r, p, row) for row in rows)
        copies: List[tuple] = []
        for r, p, row in planned:
            moved = p.cow(slot, row)
            assert moved is not None
            copies.append((r, *moved))
        return copies

    def shrink(self, slot: int, new_len: int) -> None:
        """Drop every run's references beyond ``new_len``."""
        for p in self.pools:
            p.shrink(slot, new_len)

    def truncate(self, slot: int, new_len: int) -> int:
        """Roll ``slot`` back to ``new_len`` logical tokens — the
        speculative-decode rejection path.  Per run: pages that backed ONLY
        the rejected tail return to the free list; pages still referenced
        (another slot sharing the prefix, a prefix-cache pin) survive with
        their references intact, and a page holding both kept and rejected
        tokens is kept whole (its stale entries past ``new_len`` are masked
        by position on every read path and overwritten in place by the
        accepted continuation).  Returns pages freed across runs."""
        if new_len > self.len_of(slot):
            raise ValueError(f"truncate: new_len {new_len} > current "
                             f"{self.len_of(slot)}")
        before = sum(p.free_pages() for p in self.pools)
        self.shrink(slot, new_len)
        return sum(p.free_pages() for p in self.pools) - before

    def rollback_bound(self) -> int:
        """Highest position (exclusive) through which speculative writes can
        still be rolled back: a ring (sliding-window) run's entry at ``p %
        R`` holds live position ``p - R`` once ``p >= R``, which a rejected
        draft would destroy, so speculation stops at the narrowest ring
        span.  Position-indexed runs mask stale entries by length: any
        position the pool can address is rollback-safe."""
        bounds = [p.capacity for p, run in zip(self.pools, self.plan)
                  if run.window > 0]
        return min(bounds) if bounds else self.length_bound

    def release(self, slot: int) -> None:
        for p in self.pools:
            p.release(slot)

    # -- external (prefix cache) references ---------------------------------------
    def retain(self, run: int, page: int) -> None:
        self.pools[run].retain(page)

    def release_ref(self, run: int, page: int) -> None:
        self.pools[run].release_ref(page)

    # -- device-facing views --------------------------------------------------------
    def block_tables(self, *, rows: Optional[Sequence[int]] = None,
                     n: int = 0, upto: Optional[int] = None
                     ) -> List[torch.Tensor]:
        """Per-run ``[n_slots, W_r]`` int32 block tables on the pool's device.

        ``rows`` selects a COMPACTED view instead: row i of the returned
        tables is slot ``rows[i]``'s table, padded with all-sentinel rows
        up to ``max(n, len(rows))`` — the engine's bucketed decode batch,
        whose pad rows' writes drop and reads mask out.

        ``upto`` keeps only the leading columns that positions below
        ``upto`` map to (``pages_of(upto)`` per run): a call whose rows
        read and write no position at or past ``upto`` finds every other
        column of its rows unallocated, so the narrower table addresses
        the same pages and gathers ``upto`` tokens of history instead of
        the pool's whole span."""
        out = []
        for p in self.pools:
            t = p.table
            if upto is not None:
                t = t[:, :max(p.pages_of(upto), 1)]
            if rows is not None:
                full = t
                t = np.full((max(n, len(rows)), full.shape[1]), p.n_pages,
                            full.dtype)
                if rows:
                    t[:len(rows)] = full[list(rows)]
            out.append(torch.from_numpy(np.array(t, np.int32)).to(
                self.device))
        return out

    # -- accounting ---------------------------------------------------------------
    def page_bytes(self, r: int) -> int:
        """Bytes of device memory one physical page of run ``r`` holds
        (across all layers, K and V, scale pages included)."""
        return self._page_bytes[r]

    def resident_bytes(self) -> int:
        """KV bytes resident = allocated pages x page bytes."""
        return sum(self.pools[r].used_pages() * self._page_bytes[r]
                   for r in range(len(self.pools)))

    def total_bytes(self) -> int:
        return sum(b * self.n_pages for b in self._page_bytes)


def _stretches(pages: Sequence[int]) -> List[Tuple[int, int, int]]:
    """(i, first, n) for each maximal stretch ``pages[i:i+n] == first,
    first+1, ..``: one copy per stretch of consecutive host pages."""
    out: List[Tuple[int, int, int]] = []
    for i, p in enumerate(pages):
        if out and out[-1][1] + out[-1][2] == p:
            out[-1] = (out[-1][0], out[-1][1], out[-1][2] + 1)
        else:
            out.append((i, int(p), 1))
    return out


class HostTier:
    """Host-memory spill pool behind the device page pool — the second
    level of the KV hierarchy (port of the reference's ``HostTier``; HALO
    reading: capacity memory behind the CiD banks).

    Holds ``n_pages`` host pages PER RUN, each mirroring the run's device
    page layout (every leaf — K/V and their scale pages — at the same
    dtype, page axis first: leaf ``[L, n_dev, P, ...]`` -> host ``[n_pages,
    L, P, ...]``, so one page is one contiguous block), in pinned memory
    when the pool lives on the card.  Two users:

    * **preemption swap**: the engine copies a victim's device pages here
      (``ServingEngine._swap_out``) and uploads them back at re-admission;
    * **prefix demote/promote**: evicted prefix-cache blocks park their
      page contents here and re-promote to a fresh device page on the next
      hit (``PrefixCache`` callbacks).

    Batched copies (``store_pages`` / ``load_pages``) run asynchronously
    on the engine's stream, one copy per stretch of consecutive host
    pages; device-side copies are stream-ordered, so a store into a page
    an earlier upload still reads waits its turn.  A store from host
    memory (``store``, or ``store_pages`` from CPU tensors) first waits for
    the last upload, so it never overtakes one.
    """

    # swap byte totals live in the metrics registry (the engine passes its
    # own, making these attributes views over the same cells counts() and
    # MetricsRegistry.snapshot() report)
    swap_out_bytes = counter_attr("serving_swap_out_bytes_total")
    swap_in_bytes = counter_attr("serving_swap_in_bytes_total")

    def __init__(self, pool: KVPool, n_pages: int, *,
                 metrics: Optional[MetricsRegistry] = None):
        if n_pages < 1:
            raise ValueError(f"HostTier needs n_pages >= 1, got {n_pages}")
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.n_pages = n_pages
        self.n_runs = len(pool.caches)
        self._page_bytes = [pool.page_bytes(r) for r in range(self.n_runs)]
        self.pinned = pool.device.type == "cuda"
        self._store: List[Dict[str, torch.Tensor]] = [
            {k: torch.zeros((n_pages, leaf.shape[0]) + tuple(leaf.shape[2:]),
                            dtype=leaf.dtype, pin_memory=self.pinned)
             for k, leaf in cache.items()}
            for cache in pool.caches]
        self.free: List[List[int]] = [
            list(range(n_pages - 1, -1, -1)) for _ in range(self.n_runs)]
        # the last upload that reads the store (a CUDA event), if any
        self._upload: Optional[Any] = None
        # byte counters (device->host is "swap out", host->device "swap in")
        self.swap_out_bytes = 0
        self.swap_in_bytes = 0

    # -- queries ---------------------------------------------------------------
    def free_pages(self, run: Optional[int] = None) -> int:
        """Free host pages of one run, or the binding min across runs."""
        if run is not None:
            return len(self.free[run])
        return min(len(f) for f in self.free)

    def used_pages(self) -> int:
        """Host pages in use, summed across runs (the residency metric)."""
        return sum(self.n_pages - len(f) for f in self.free)

    def resident_bytes(self) -> int:
        return sum((self.n_pages - len(f)) * b
                   for f, b in zip(self.free, self._page_bytes))

    def host_bytes(self) -> int:
        """Bytes of host memory the store holds (pinned on the card)."""
        return sum(t.numel() * t.element_size()
                   for st in self._store for t in st.values())

    # -- allocation ------------------------------------------------------------
    def alloc(self, run: int, n: int) -> Optional[List[int]]:
        """Claim ``n`` host pages of ``run`` — all-or-nothing."""
        if n > len(self.free[run]):
            return None
        return [self.free[run].pop() for _ in range(n)]

    def release(self, run: int, pages: Sequence[int]) -> None:
        for p in pages:
            assert 0 <= p < self.n_pages and p not in self.free[run], \
                f"HostTier.release: page {p} of run {run} is not in use"
            self.free[run].append(int(p))

    # -- page contents ---------------------------------------------------------
    def _await_uploads(self) -> None:
        if self._upload is not None:
            self._upload.synchronize()
            self._upload = None

    def store(self, run: int, page: int, data: Dict[str, Any]) -> None:
        """Copy one page's contents ({leaf: [L, P, ...]}, host or device)
        into host page ``page`` of ``run``."""
        self._await_uploads()
        for k, v in data.items():
            self._store[run][k][page].copy_(torch.as_tensor(v))
        self.swap_out_bytes += self._page_bytes[run]

    def load(self, run: int, page: int) -> Dict[str, torch.Tensor]:
        """Contents of host page ``page`` of ``run`` ({leaf: [L, P, ...]}
        views — the caller uploads before the page is reused)."""
        self.swap_in_bytes += self._page_bytes[run]
        return {k: v[page] for k, v in self._store[run].items()}

    def store_pages(self, run: int, pages: Sequence[int],
                    data: Dict[str, torch.Tensor]) -> None:
        """Copy ``len(pages)`` pages ({leaf: [L, n, P, ...]}, the device
        pages gathered in row order) into host pages ``pages`` of ``run``:
        asynchronous from the card into pinned memory (the caller syncs
        once for the batch)."""
        for k, v in data.items():
            src = v.movedim(1, 0).contiguous()   # one block per page
            if src.device.type == "cpu":
                self._await_uploads()
            dst = self._store[run][k]
            for i, first, n in _stretches(pages):
                dst[first:first + n].copy_(src[i:i + n],
                                           non_blocking=self.pinned)
        self.swap_out_bytes += len(pages) * self._page_bytes[run]

    def load_pages(self, run: int, pages: Sequence[int],
                   device) -> Dict[str, torch.Tensor]:
        """Host pages ``pages`` of ``run`` on ``device`` ({leaf: [L, n, P,
        ...]}, row order): asynchronous uploads from pinned memory."""
        device = torch.device(device)
        out = {}
        for k, v in self._store[run].items():
            dst = torch.empty((len(pages),) + tuple(v.shape[1:]),
                              dtype=v.dtype, device=device)
            for i, first, n in _stretches(pages):
                dst[i:i + n].copy_(v[first:first + n],
                                   non_blocking=self.pinned)
            out[k] = dst.movedim(0, 1)
        if device.type == "cuda":
            self._upload = torch.cuda.Event()
            self._upload.record(torch.cuda.current_stream(device))
        self.swap_in_bytes += len(pages) * self._page_bytes[run]
        return out

    # -- invariants -------------------------------------------------------------
    def check_invariants(self) -> None:
        for r, f in enumerate(self.free):
            assert len(set(f)) == len(f), f"run {r}: free-list duplicates"
            assert all(0 <= p < self.n_pages for p in f), \
                f"run {r}: free list out of range"

    def stats(self) -> Dict[str, Any]:
        return {
            "n_pages": self.n_pages,
            "free_pages": self.free_pages(),
            "used_pages": self.used_pages(),
            "resident_bytes": self.resident_bytes(),
            "swap_out_bytes": self.swap_out_bytes,
            "swap_in_bytes": self.swap_in_bytes,
        }
