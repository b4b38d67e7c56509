"""Speculative-decoding configuration.

Only the ``SpecConfig`` dataclass is ported so far, so that
``ServeConfig.speculative`` exists; the drafters and the verify loop arrive
with ROADMAP queue A, item 7, and the engine raises until then.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


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
