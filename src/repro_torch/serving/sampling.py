"""Token sampling for the serving engine (port of src/repro/serving/sampling.py).

Sampling is PER REQUEST: ``SamplingParams`` is the request-level knob set
(temperature — 0 means greedy — top-k, top-p, seed, token budget and stop
conditions).  This slice ports the greedy lane: ``torch.argmax``, like
``jnp.argmax``, returns the FIRST maximal index, so ties break the same way
as in the reference — for one sampled token (``sample_greedy``) and for a
speculative verify window (``verify_draft``).  Stochastic rows (temperature
> 0) and Leviathan rejection sampling arrive with ROADMAP queue A, item 8.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling and termination parameters (``submit``).

    ``temperature == 0`` means GREEDY — there is no separate ``greedy``
    flag (the old engine-wide ``greedy`` + ``max(temperature, 1e-6)``
    duality is gone).  ``seed=None`` lets the engine derive a
    deterministic per-request seed from ``ServeConfig.seed`` and the
    request id; setting it makes the request's stochastic stream
    reproducible independent of batch composition.  ``stop`` is extra
    stop-token ids beyond ``eos_id`` (finish_reason "stop" vs "eos").
    """
    temperature: float = 0.0            # 0 => greedy (argmax)
    top_k: int = 0                      # 0 => off
    top_p: float = 0.0                  # 0 or >= 1 => off
    seed: Optional[int] = None          # None => engine-derived
    max_new_tokens: int = 32            # 0 is legal: prefill only
    eos_id: Optional[int] = None
    stop: Tuple[int, ...] = field(default_factory=tuple)

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0 (0 = greedy), "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got {self.top_k}")
        if not 0.0 <= self.top_p <= 1.0:
            raise ValueError(f"top_p must be in [0, 1] (0 or 1 = off), "
                             f"got {self.top_p}")
        if self.max_new_tokens < 0:
            raise ValueError(f"max_new_tokens must be >= 0, "
                             f"got {self.max_new_tokens}")
        object.__setattr__(self, "stop",
                           tuple(int(t) for t in self.stop))

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits [N, 1, V] -> int32 tokens [N]: the argmax of each row's last
    position."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def require_greedy(sp: SamplingParams) -> None:
    if not sp.greedy:
        raise NotImplementedError(
            "stochastic sampling (temperature > 0): later slice "
            "(ROADMAP queue A, item 8)")


def verify_draft(logits: torch.Tensor, draft: torch.Tensor,
                 draft_len: torch.Tensor, *, greedy: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy accept over a speculative draft window (the reference's
    ``verify_draft``, src/repro/serving/sampling.py:145, greedy lane).

    logits:    [N, C, V] target logits at every window position; window
               inputs are [last_committed, d_1, .., d_K], so position j
               predicts the token AFTER d_j.
    draft:     [N, C-1] int32 proposed tokens (padding past a row's
               draft_len is never read).
    draft_len: [N] valid draft tokens per row (<= C-1).

    Returns (tokens [N, C] int32, n_emitted [N] int32): row n commits
    ``tokens[n, :n_emitted[n]]`` — the target's argmax stream up to and
    including the first position whose argmax disagrees with the draft
    (the correction), or every draft plus the bonus when all agree."""
    if not greedy:
        raise NotImplementedError(
            "stochastic verification (temperature > 0): later slice "
            "(ROADMAP queue A, item 8)")
    K = logits.shape[1] - 1
    j = torch.arange(K, device=logits.device)
    within = j[None, :] < draft_len.to(logits.device).long()[:, None]
    tgt = torch.argmax(logits, dim=-1).to(torch.int32)            # [N, C]
    match = (tgt[:, :K] == draft.to(torch.int32)) & within
    acc = torch.cumprod(match.to(torch.int32), dim=-1).sum(dim=-1)
    return tgt, (acc + 1).to(torch.int32)
