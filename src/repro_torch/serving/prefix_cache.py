"""Radix prefix cache: shared-prefix KV reuse over the paged pool (port of
src/repro/serving/prefix_cache.py).

Requests that share a long system prompt rebuild identical KV pages in
prefill.  The paged pool's block tables (row -> physical page) are the
indirection that SHARES those pages instead: a new request whose prompt
starts with an already-served prefix points its leading table rows at the
cached pages (refcounted, ``PagePool.attach``) and starts prefilling past
them.  The kernels need no change: paged decode (B1, B4), packed prefill
(B2) and ``attn_chunk_paged`` already gather every page through the table.

Structure: a radix tree over PAGE-ALIGNED token blocks.  A node at depth
``i`` keys the hash chain of blocks ``0..i`` (``blake2b(parent_digest ||
block_tokens)``) and stores ONE physical page per attention run — valid
because sharing is clamped to ``KVPool.shareable_capacity()`` (the
narrowest ring span), inside which logical page ``i`` is table row ``i``
for every run.  Each stored page holds one cache reference
(``PagePool.retain``) so it survives its publisher's retirement; eviction
is leaf-first LRU and drops that reference (``release_ref``), freeing the
page only when no request still shares it — cached pages are reclaimable
capacity, evicted before any live request is preempted.

With a host tier (the engine wires ``demote`` / ``promote`` / ``discard``
callbacks when ``ServeConfig.host_spill_pages > 0``), eviction DEMOTES a
block — its page contents move to host memory and the node stays in the
tree — and a later match through it PROMOTES it back onto fresh device
pages; without one, eviction drops.

Pure host-side indexing: device pages are never touched here, only
refcounts and table rows move (the callbacks copy page contents).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.kv_pool import KVPool
from repro_torch.serving.metrics import MetricsRegistry, counter_attr


def _block_digest(parent: bytes, block: np.ndarray) -> bytes:
    return hashlib.blake2b(parent + np.ascontiguousarray(block).tobytes(),
                           digest_size=16).digest()


@dataclass
class _Node:
    digest: bytes
    parent: Optional["_Node"]
    pages: List[int]                      # one physical page per run
    children: Dict[bytes, "_Node"] = field(default_factory=dict)
    last_used: int = 0
    # host-tier residency: a DEMOTED node holds no device pages
    # (``pages == []``) but parks its KV in host pages, one per run —
    # promoted back to fresh device pages on the next match through it
    host_pages: Optional[List[int]] = None

    @property
    def is_leaf(self) -> bool:
        return not self.children

    @property
    def resident(self) -> bool:
        return bool(self.pages)


class PrefixCache:
    """Radix index from page-aligned token-block hash chains to the
    per-run physical pages holding their KV.

    * ``match(tokens)`` — longest cached prefix (whole blocks only) and
      the per-run page lists to ``KVPool.attach``;
    * ``insert(tokens, pool, slot)`` — publish a slot's prompt pages
      (deduplicating against what is already cached; new pages gain a
      cache reference);
    * ``evict(pool, n_pages)`` — leaf-first LRU release of at least
      ``n_pages`` per-run pages back toward the free lists.

    TIERED EVICTION (``demote``/``promote``/``discard`` callbacks wired
    by the engine when a ``HostTier`` exists): eviction DEMOTES a block —
    its page contents move to host memory and the node stays in the tree
    — instead of dropping it, and a later ``match`` walking through a
    demoted node PROMOTES it back onto fresh device pages
    (``PagePool.alloc_external``), preserving the hit.  Demotion is
    bottom-up (the resident frontier peels first), promotion top-down
    along the match walk, so a resident node never sits below a demoted
    ancestor.  Hard-dropping stays the fallback whenever the host tier
    is full or absent.  Callback contracts:

      demote(device_pages)  -> host page list, or None (tier full);
                               the cache then releases the device refs
      promote(host_pages)   -> fresh device page list (external-ref'd,
                               contents uploaded, host pages freed), or
                               None (no free device page right now)
      discard(host_pages)   -> free the host pages (node truly dying)
    """

    # hit counters live in the metrics registry (the engine passes its
    # own, so prefix_stats() and MetricsRegistry.snapshot() read the
    # same cells — serving/metrics.py)
    hits = counter_attr("serving_prefix_hits_total")
    hit_tokens = counter_attr("serving_prefix_hit_tokens_total")

    def __init__(self, page_size: int, max_tokens: int, *,
                 demote: Optional[Callable] = None,
                 promote: Optional[Callable] = None,
                 discard: Optional[Callable] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.page_size = page_size
        # sharing is only position-pure up to the narrowest ring span
        self.max_blocks = max_tokens // page_size
        self._root = _Node(b"root", None, [])
        self._clock = 0
        self._n_nodes = 0
        self._demote = demote
        self._promote = promote
        self._discard = discard
        # stats (benchmarks / tests)
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0
        self.demoted_blocks = 0
        self.promoted_blocks = 0

    # -- internals ---------------------------------------------------------------
    def _blocks(self, tokens: np.ndarray) -> List[np.ndarray]:
        """Whole page-sized blocks of the token stream, clamped to the
        shareable span."""
        P = self.page_size
        n = min(int(tokens.shape[-1]) // P, self.max_blocks)
        return [tokens[..., i * P:(i + 1) * P] for i in range(n)]

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        while node is not self._root:
            node.last_used = self._clock
            node = node.parent

    # -- queries -----------------------------------------------------------------
    def __len__(self) -> int:
        return self._n_nodes

    def cached_pages(self) -> int:
        """Total per-run DEVICE page references the cache currently pins
        (demoted nodes hold none)."""
        total, stack = 0, list(self._root.children.values())
        while stack:
            n = stack.pop()
            total += len(n.pages)
            stack.extend(n.children.values())
        return total

    def demoted_nodes(self) -> int:
        """Blocks currently parked in the host tier."""
        total, stack = 0, list(self._root.children.values())
        while stack:
            n = stack.pop()
            total += n.host_pages is not None
            stack.extend(n.children.values())
        return total

    def match(self, tokens: np.ndarray, *, max_tokens: Optional[int] = None
              ) -> Tuple[int, List[List[int]]]:
        """Longest cached prefix of ``tokens``: returns (matched_tokens,
        per-run page lists aligned with ``KVPool.pools``).  Only whole
        blocks match; ``max_tokens`` additionally caps the walk (the
        engine passes len - 1 so at least one token remains to prefill —
        logits of the last prompt token seed decoding).  A DEMOTED node
        on the walk is promoted back to device pages first; if no device
        page is free for it the match stops at the last resident node —
        a partial hit instead of a lost one."""
        self.lookups += 1
        blocks = self._blocks(tokens)
        if max_tokens is not None:
            blocks = blocks[: max_tokens // self.page_size]
        node, digest = self._root, self._root.digest
        path: List[_Node] = []
        for blk in blocks:
            digest = _block_digest(node.digest, blk)
            child = node.children.get(digest)
            if child is None:
                break
            if not child.resident:
                pages = (self._promote(child.host_pages)
                         if self._promote is not None else None)
                if pages is None:
                    break                 # no device page free: partial hit
                child.pages = list(pages)
                child.host_pages = None
                self.promoted_blocks += 1
            path.append(child)
            node = child
        if not path:
            return 0, []
        self._touch(path[-1])
        self.hits += 1
        self.hit_tokens += len(path) * self.page_size
        n_runs = len(path[-1].pages)
        pages = [[n.pages[r] for n in path] for r in range(n_runs)]
        return len(path) * self.page_size, pages

    # -- mutations ---------------------------------------------------------------
    def insert(self, tokens: np.ndarray, pool: KVPool, slot: int) -> int:
        """Publish the prompt pages of ``slot`` (which holds ``tokens``
        fully prefilled) into the cache.  Blocks already cached are
        deduplicated — the existing pages stay canonical and the slot's
        duplicates are NOT retained (they free with the slot).  Returns
        the number of newly-cached blocks."""
        blocks = self._blocks(tokens)
        if not blocks:
            return 0
        per_run = pool.prefix_pages(slot, len(blocks) * self.page_size)
        node, added = self._root, 0
        for i, blk in enumerate(blocks):
            digest = _block_digest(node.digest, blk)
            child = node.children.get(digest)
            if child is None:
                pages = [per_run[r][i] for r in range(len(per_run))]
                for r, p in enumerate(pages):
                    pool.retain(r, p)
                child = _Node(digest, node, pages)
                node.children[digest] = child
                self._n_nodes += 1
                added += 1
            elif not child.resident:
                # re-publish over a demoted node: the slot just prefilled
                # this very block, so retain ITS page and retire the host
                # copy — a free promotion (no upload needed)
                pages = [per_run[r][i] for r in range(len(per_run))]
                for r, p in enumerate(pages):
                    pool.retain(r, p)
                if child.host_pages is not None and self._discard is not None:
                    self._discard(child.host_pages)
                child.host_pages = None
                child.pages = pages
                self.promoted_blocks += 1
            node = child
        self._touch(node)
        self.inserted_blocks += added
        return added

    def evict(self, pool: KVPool, n_pages: int) -> int:
        """Leaf-first LRU eviction of blocks whose pages would actually
        FREE (cache-only references): demote (host tier wired) or drop
        them until at least ``n_pages`` pages returned to the free lists,
        or no evictable node remains.  Returns pages freed.  Blocks still
        pinned by a live slot are skipped — evicting them releases
        nothing NOW and permanently destroys future hits (one transient
        exhaustion must not flush the whole cache).  Only the RESIDENT
        FRONTIER is evictable — a resident node with no resident
        descendants; its descendants (all demoted) key through it but
        survive on host — so device chains peel from the tip, bottom-up.
        """
        freed = 0
        while freed < n_pages:
            # one tree walk per batch, LRU order (a page lives in at most
            # one node, so dropping a leaf never un-frees another's pages;
            # the outer loop re-collects parents whose subtree just went
            # fully demoted)
            leaves = sorted(self._evictable_leaves(pool),
                            key=lambda n: n.last_used)
            if not leaves:
                break
            for leaf in leaves:
                freed += (self._demote_node(leaf, pool)
                          if self._demote is not None
                          else self._drop(leaf, pool))
                if freed >= n_pages:
                    break
        return freed

    def _demote_node(self, node: _Node, pool: KVPool) -> int:
        """Move one block's pages to the host tier (node survives); hard
        drop if the tier declines.  Returns device pages freed."""
        host = self._demote(list(node.pages))
        if host is None:
            return self._drop(node, pool)           # host tier full
        freed = 0
        for r, q in enumerate(node.pages):
            freed += int(pool.pools[r].ref[q]) == 1  # last reference
            pool.release_ref(r, q)
        node.pages = []
        node.host_pages = list(host)
        self.demoted_blocks += 1
        return freed

    def _drop(self, node: _Node, pool: KVPool) -> int:
        """Evict one node AND its subtree terminally; returns how many
        device pages actually freed.  Descendants (demoted blocks under
        an evicted frontier node, or whole chains on ``flush``) die with
        it — they key through its digest, and their host copies are
        discarded back to the tier."""
        freed = 0
        for child in list(node.children.values()):
            freed += self._drop(child, pool)
        if node.host_pages is not None:
            if self._discard is not None:
                self._discard(node.host_pages)
            node.host_pages = None
        for r, q in enumerate(node.pages):
            freed += int(pool.pools[r].ref[q]) == 1    # last reference
            pool.release_ref(r, q)
        del node.parent.children[node.digest]
        self._n_nodes -= 1
        self.evicted_blocks += 1
        return freed

    def _evictable_leaves(self, freeing_in: Optional[KVPool] = None
                          ) -> List[_Node]:
        """The resident frontier: resident nodes with no resident
        descendants (plain leaves when nothing is demoted).  With
        ``freeing_in``, only those whose release would free at least one
        page of that pool."""
        out: List[_Node] = []

        def visit(n: _Node) -> bool:
            sub_resident = False
            for c in n.children.values():
                sub_resident = visit(c) or sub_resident
            if n.resident and not sub_resident:
                if freeing_in is None or any(
                        int(freeing_in.pools[r].ref[q]) == 1
                        for r, q in enumerate(n.pages)):
                    out.append(n)
            return n.resident or sub_resident

        for c in self._root.children.values():
            visit(c)
        return out

    def flush(self, pool: KVPool) -> int:
        """Drop EVERY cached block unconditionally (shutdown / tests):
        pinned pages lose their cache reference but free only when their
        live sharers release too; demoted blocks' host pages are
        discarded.  Returns device pages freed."""
        freed = 0
        for child in list(self._root.children.values()):
            freed += self._drop(child, pool)
        return freed

    def stats(self) -> Dict[str, float]:
        return {
            "nodes": self._n_nodes,
            "cached_pages": self.cached_pages(),
            "demoted_nodes": self.demoted_nodes(),
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": self.hits / max(self.lookups, 1),
            "hit_tokens": self.hit_tokens,
            "inserted_blocks": self.inserted_blocks,
            "evicted_blocks": self.evicted_blocks,
            "demoted_blocks": self.demoted_blocks,
            "promoted_blocks": self.promoted_blocks,
        }
