"""Token sampling for the serving engine (port of src/repro/serving/sampling.py).

Sampling is PER REQUEST: ``SamplingParams`` is the request-level knob set
(temperature — 0 means greedy — top-k, top-p, seed, token budget and stop
conditions).  This slice ports the greedy lane: ``torch.argmax``, like
``jnp.argmax``, returns the FIRST maximal index, so ties break the same way
as in the reference.  Stochastic rows (temperature > 0) arrive with ROADMAP
queue A, item 8.
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
