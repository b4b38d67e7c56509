"""Speculative decoding: the configuration and the model-free drafter
(port of src/repro/serving/speculative.py, its n-gram branch).

Every decode tick a drafter proposes up to k tokens per decoding request
and ONE verify window of the target model — a (k+1)-token chunk forward
over [last_committed, d_1, .., d_k] against the paged pool, logits at
every window position (``engine._verify_impl``) — accepts the longest
prefix that agrees with the target's argmax and emits one correction or
bonus token on top (``sampling.verify_draft``).  Rejected tokens' KV rolls
back with ``KVPool.truncate``.  Greedy streams are the same with
speculation on or off; only the number of ticks changes.

``NGramDrafter`` is prompt-lookup decoding: it proposes the continuation
of the most recent earlier occurrence of the stream's own trailing n-gram.
No weights, no device work.  The reference's small-model drafter
(``ModelDrafter``, its own paged pool and draft model) is ROADMAP queue A,
item 7c: its tests draft with qwen3-1.7b, which the port does not register
yet, and ``build_drafter`` raises for it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs (``ServeConfig(speculative=...)``).

    ``k`` drafts per verify window: each decode tick emits between 1 and
    k+1 tokens per request.  Larger k amortizes more per-tick latency but
    wastes more verify compute at low acceptance — see docs/serving.md
    §Speculative decoding for acceptance-rate-vs-k guidance.
    """
    k: int = 4                        # draft tokens per verify window
    drafter: str = "ngram"            # "ngram" | "model"
    # n-gram (prompt-lookup) drafter: longest suffix n-gram tried first,
    # matched against only the trailing ngram_search tokens of the stream
    # (bounds the per-tick host scan; recent context is where the loops
    # speculation feeds on live anyway)
    ngram_max: int = 3
    ngram_min: int = 1
    ngram_search: int = 512
    # small-model drafter
    draft_arch: Optional[str] = None  # config id, e.g. "qwen3-1.7b"
    draft_seed: int = 0
    draft_n_pages: int = 0            # 0: target pool's n_pages
    draft_page_size: int = 0          # 0: target pool's page_size
    # per-tick cap on the drafter's catch-up prefill: a slot further
    # behind than this prefills one bounded chunk per tick (no drafting
    # until caught up) instead of one unbounded — and uncharged — prompt-
    # sized chunk in the middle of a latency-sensitive decode tick
    draft_chunk: int = 256

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")
        if self.drafter not in ("ngram", "model"):
            raise ValueError(f"drafter must be 'ngram' or 'model', got "
                             f"{self.drafter!r}")
        if self.drafter == "model" and not self.draft_arch:
            raise ValueError("drafter='model' requires draft_arch")
        if self.ngram_min < 1 or self.ngram_max < self.ngram_min:
            raise ValueError(f"need 1 <= ngram_min <= ngram_max, got "
                             f"{self.ngram_min}/{self.ngram_max}")


class NGramDrafter:
    """Model-free prompt-lookup drafter.

    Proposes the k tokens that followed the most recent earlier occurrence
    of the stream's own trailing n-gram (longest n first).  Pure host-side
    numpy over the committed token stream — no weights, no device work,
    no state beyond the stream itself, so ``observe``/``release`` are
    no-ops.  Returns an empty proposal when no n-gram recurs; the engine
    then falls back to the ordinary one-token decode for that request.
    """

    def __init__(self, spec: SpecConfig):
        self.spec = spec
        self.proposed = 0                       # stats: tokens proposed

    def _propose_one(self, ctx: np.ndarray, k: int) -> np.ndarray:
        ctx = ctx[..., -self.spec.ngram_search:]
        T = int(ctx.shape[-1])
        for n in range(min(self.spec.ngram_max, T - 1),
                       self.spec.ngram_min - 1, -1):
            pat = ctx[-n:]
            # candidate starts i < T - n (the suffix itself is excluded and
            # at least one continuation token exists)
            win = np.lib.stride_tricks.sliding_window_view(ctx, n)
            hits = np.nonzero((win[: T - n] == pat).all(axis=-1))[0]
            if hits.size:
                i = int(hits[-1])               # most recent occurrence
                out = ctx[i + n: i + n + k]
                self.proposed += int(out.shape[-1])
                return np.asarray(out, np.int32)
        return np.zeros((0,), np.int32)

    def propose_batch(self, items: Sequence[Tuple[int, int, np.ndarray]],
                      k: int) -> Dict[int, np.ndarray]:
        """items: [(slot, req_id, ctx)] -> {slot: drafts [<=k]}."""
        return {slot: d for slot, _, ctx in items
                if (d := self._propose_one(ctx, k)).size}

    def observe(self, slot: int, req_id: int, ctx_len: int) -> None:
        pass

    def release(self, slot: int) -> None:
        pass


def build_drafter(spec: SpecConfig) -> NGramDrafter:
    """Drafter factory for the engine: the n-gram drafter.  The reference's
    model drafter (``drafter="model"``) is ROADMAP queue A, item 7c."""
    if spec.drafter != "ngram":
        raise NotImplementedError(
            "speculative drafter='model' (a draft model with its own paged "
            "pool): ROADMAP queue A, item 7c")
    return NGramDrafter(spec)
