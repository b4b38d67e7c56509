"""Token sampling for the serving engine (port of src/repro/serving/sampling.py).

Sampling is PER REQUEST: ``SamplingParams`` is the request-level knob set
(temperature — 0 means greedy — top-k, top-p, seed, token budget and stop
conditions), and the vectorized entry points (``sample_tokens_rows`` /
``verify_draft_rows``) take per-row ``[B]`` parameter tensors plus per-row
keys, so one program serves a batch mixing greedy and stochastic requests —
still one host transfer per program call.  A greedy row is exactly
``argmax`` (``torch.argmax``, like ``jnp.argmax``, returns the FIRST
maximal index), so a mixed batch's greedy rows are bit-identical to an
all-greedy run; the engine's all-greedy ticks call ``sample_greedy`` /
greedy ``verify_draft`` and never sort or draw.

The randomness source is a COUNTER-BASED HASH, not a generator: a row's key
is a 32-bit mix of (its request's seed, the tokens it has emitted so far)
(``row_keys``), and every random number a draw needs is a further mix of
(key, stream, element index) computed with integer tensor ops on the
logits' device (``random_bits``).  A request's draws are then a pure
function of its seed and its emission count, whatever batch, slot or
preemption it rides through — the property the reference gets from
``fold_in(PRNGKey(seed), counter)`` — with no per-row host work and no
generator state, and the bits are the same on the CPU and on the card.
Every value is a 32-bit lane held in int64 and masked, and every
multiplier is below 2^31, so a product stays below 2^63: signed 64-bit
overflow and arithmetic right shifts never occur.  Categorical draws
are Gumbel-max (``argmax(logits + g)``, g = -log(-log(u))), as
``jax.random.categorical`` draws them; the bits are not JAX's threefry, so
the port is held to the reference in distribution, not bit for bit.

``verify_draft`` is the speculative-decoding acceptance rule: greedy
acceptance keeps the longest draft prefix the target's argmax agrees with
plus one correction or bonus token; stochastic verification is Leviathan
rejection sampling against the point-mass proposal of the deterministic
drafters — draft token d is accepted with probability p(d) under the
filtered target distribution, and a rejection resamples from p with d
removed, which keeps the emission distribution exactly p.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
_M32 = 0xFFFFFFFF

# stream indices of the draws one key feeds (``random_bits``)
STREAM_SAMPLE = 0       # sample_tokens_rows: one Gumbel per vocabulary entry
STREAM_ACCEPT = 1       # verify: one uniform per draft position
STREAM_RESIDUAL = 2     # verify: one Gumbel per (draft position, entry)
STREAM_BONUS = 3        # verify: one Gumbel per vocabulary entry


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


# ---------------------------------------------------------------------------
# the counter-based hash (32-bit lanes in int64)
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32) and an odd constant
    below 2^31: the product stays below 2^63."""
    return (x * c) & _M32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (a bijection with full avalanche: xor-shift,
    multiply, xor-shift, multiply, xor-shift; the multipliers are 31-bit,
    from the hash-prospector search)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x21F0AAAD)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x735A2D97)
    return h ^ (h >> 15)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """A new key per element from ``keys`` and non-negative ``data`` (an
    int, or a tensor broadcast against ``keys``), both in [0, 2^32)."""
    if isinstance(data, int):            # no tensor, no host-device copy
        return _mix32(keys ^ (((data + 1) * 0x61C88647) & _M32))
    return _mix32(keys ^ _mul32((data.to(torch.int64) + 1) & _M32,
                                0x61C88647))


def row_keys(seeds, counters) -> torch.Tensor:
    """Per-row keys from [B] seeds and [B] counters (int64 [B] in
    [0, 2^32)): a pure function of (seed, tokens emitted so far), so a
    request draws the same randomness whatever batch it lands in, whichever
    slot it occupies, and however often it is preempted."""
    seeds = torch.as_tensor(seeds).to(torch.int64) & _M32
    counters = torch.as_tensor(counters, device=seeds.device)
    return fold_in(_mix32(seeds ^ 0x5BD1E995), counters.to(torch.int64)
                   & _M32)


@functools.lru_cache(maxsize=16)
def _index_mix(n: int, device: torch.device) -> torch.Tensor:
    """(i + 1) * 0x27D4EB2F mod 2^32 for i < n: the per-element half of
    ``random_bits``, the same for every key, so made once per size."""
    return _mul32(torch.arange(1, n + 1, dtype=torch.int64, device=device),
                  0x27D4EB2F)


def random_bits(keys: torch.Tensor, stream: int, shape,
                index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 [*keys.shape, *shape] of 32 random bits: element i of row r is
    a hash of (keys[r], stream, i), i its flat index within ``shape``.
    With ``index`` (1-D flat indices), only those elements:
    [*keys.shape, len(index)], the same bits as at those positions of the
    full draw."""
    shape = tuple(shape)
    if index is None:
        n = 1
        for s in shape:
            n *= s
        mix = _index_mix(n, keys.device).reshape(shape)
    else:
        mix = _mul32(index.to(device=keys.device, dtype=torch.int64) + 1,
                     0x27D4EB2F)
    k = fold_in(keys, stream).reshape(keys.shape + (1,) * mix.ndim)
    return _mix32(k ^ mix)


def uniform(keys: torch.Tensor, stream: int, shape,
            index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 uniforms in (0, 1): the top 23 bits plus a half, exact in f32 on
    every device."""
    bits = random_bits(keys, stream, shape, index) >> 9
    return (bits.to(torch.float32) + 0.5) * (2.0 ** -23)


def gumbel(keys: torch.Tensor, stream: int, shape,
           index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u))."""
    return -torch.log(-torch.log(uniform(keys, stream, shape, index)))


# ---------------------------------------------------------------------------
# filters and the scalar entry points
# ---------------------------------------------------------------------------


def _filter_logits_rows(scaled: torch.Tensor, top_k: torch.Tensor,
                        top_p: torch.Tensor) -> torch.Tensor:
    """Per-row top-k / nucleus truncation: ``scaled`` is [B, ..., V],
    ``top_k`` / ``top_p`` broadcast over its leading dims (shape
    [B, 1..., 1]).  One full descending sort serves both filters; a STABLE
    sort keeps ``lax.top_k``'s order among equal logits (lower index
    first), so the kept set — the first k ranks, then the minimal nucleus
    prefix whose mass strictly before each candidate is below top_p —
    equals the reference's, ties included.  Kept values are scattered into
    a NEG_INF field."""
    V = scaled.shape[-1]
    vals, idx = torch.sort(scaled, dim=-1, descending=True, stable=True)
    rank = torch.arange(V, device=scaled.device)
    kk = torch.where(top_k > 0, torch.clamp(top_k, max=V),
                     torch.full_like(top_k, V))
    keep = rank < kk
    probs = torch.softmax(torch.where(keep, vals, NEG_INF), dim=-1)
    p_on = (top_p > 0.0) & (top_p < 1.0)
    keep = keep & (~p_on | ((torch.cumsum(probs, dim=-1) - probs) < top_p))
    vals = torch.where(keep, vals, NEG_INF)
    return torch.full_like(scaled, NEG_INF).scatter(-1, idx, vals)


def _filter_logits(scaled: torch.Tensor, top_k: int,
                   top_p: float) -> torch.Tensor:
    """Scalar-parameter top-k and/or nucleus truncation (the reference's
    ``_filter_logits``): the per-row filter with one parameter pair."""
    lead = (1,) * (scaled.ndim - 1) + (1,)
    return _filter_logits_rows(
        scaled,
        torch.full(lead, int(top_k or 0), dtype=torch.int64,
                   device=scaled.device),
        torch.full(lead, float(top_p or 0.0), dtype=torch.float32,
                   device=scaled.device))


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits [N, 1, V] -> int32 tokens [N]: the argmax of each row's last
    position."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def _scalar_rows(logits: torch.Tensor, temperature: float, top_k: int,
                 top_p: float, key):
    """Per-row parameters and keys for a scalar-parameter call over
    ``logits`` [N, ..., V]: row n draws with ``fold_in(key, n)``."""
    N, dev = logits.shape[0], logits.device
    key = torch.as_tensor(key, dtype=torch.int64, device=dev) & _M32
    keys = fold_in(key.reshape(()), torch.arange(N, device=dev))
    return (torch.full((N,), float(temperature), device=dev),
            torch.full((N,), int(top_k or 0), dtype=torch.int64, device=dev),
            torch.full((N,), float(top_p or 0.0), device=dev), keys)


def sample_tokens(logits: torch.Tensor, *, greedy: bool = True,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 0.0, key=None) -> torch.Tensor:
    """logits [..., V] float -> int32 token ids [...].

    greedy: argmax (deterministic, key unused).  Otherwise Gumbel-max
    sampling at ``temperature`` with optional top-k and/or top-p
    truncation; ``key`` (an integer key, e.g. one of ``row_keys``)
    required."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if key is None:
        raise ValueError("non-greedy sampling requires a randomness key")
    flat = logits.reshape(-1, logits.shape[-1])
    t, k, p, keys = _scalar_rows(flat, max(temperature, 1e-6), top_k,
                                 top_p, key)
    return sample_tokens_rows(flat, t, k, p, keys).reshape(logits.shape[:-1])


# ---------------------------------------------------------------------------
# vectorized per-row entry points (the engine's programs call these)
# ---------------------------------------------------------------------------


def perturbed_scores(logits: torch.Tensor, temperature, top_k, top_p,
                     keys) -> torch.Tensor:
    """The f32 scores whose argmax is each row's draw: a greedy row's
    logits as they are, a stochastic row's filtered, temperature-scaled
    logits plus its Gumbel noise.  logits [B, ..., V]; [B] parameters and
    keys."""
    B = logits.shape[0]
    lead = (B,) + (1,) * (logits.ndim - 1)
    t = torch.as_tensor(temperature, device=logits.device).to(
        torch.float32).reshape(lead)
    k = torch.as_tensor(top_k, device=logits.device).to(
        torch.int64).reshape(lead)
    p = torch.as_tensor(top_p, device=logits.device).to(
        torch.float32).reshape(lead)
    lg = logits.to(torch.float32)
    filt = _filter_logits_rows(lg / torch.clamp(t, min=1e-6), k, p)
    g = gumbel(keys, STREAM_SAMPLE, logits.shape[1:])
    return torch.where(t <= 0.0, lg, filt + g)


def sample_tokens_rows(logits: torch.Tensor, temperature, top_k, top_p,
                       keys) -> torch.Tensor:
    """Vectorized per-row sampling: logits [B, ..., V] -> int32 [B, ...].

    ``temperature`` / ``top_k`` / ``top_p`` are [B] per-row parameters and
    ``keys`` is [B] per-row keys (``row_keys``).  A row with temperature
    <= 0 is GREEDY — plain argmax, its draws never used — so one program
    serves a batch mixing greedy and stochastic requests and the greedy
    rows are bit-identical to an all-greedy batch."""
    return torch.argmax(perturbed_scores(logits, temperature, top_k, top_p,
                                         keys), dim=-1).to(torch.int32)


def verify_draft(logits: torch.Tensor, draft: torch.Tensor,
                 draft_len: torch.Tensor, *, greedy: bool = True,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 0.0, key=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized accept/resample over a speculative draft window (the
    reference's ``verify_draft``, src/repro/serving/sampling.py:145).

    logits:    [N, C, V] target logits at every window position; window
               inputs are [last_committed, d_1, .., d_K], so position j
               predicts the token AFTER d_j.
    draft:     [N, C-1] int32 proposed tokens (padding past a row's
               draft_len is never read).
    draft_len: [N] valid draft tokens per row (<= C-1).

    Returns (tokens [N, C] int32, n_emitted [N] int32): row n commits
    ``tokens[n, :n_emitted[n]]`` — its accepted draft prefix plus ONE extra
    token (the correction at the first rejection, or the bonus after a
    fully-accepted window).  Greedy: the target's argmax stream up to and
    including the first position whose argmax disagrees with the draft.
    Stochastic: Leviathan rejection sampling with row n keyed by
    ``fold_in(key, n)``; ``key`` required."""
    if greedy:
        K = logits.shape[1] - 1
        j = torch.arange(K, device=logits.device)
        within = j[None, :] < draft_len.to(logits.device).long()[:, None]
        tgt = torch.argmax(logits, dim=-1).to(torch.int32)        # [N, C]
        match = (tgt[:, :K] == draft.to(torch.int32)) & within
        acc = torch.cumprod(match.to(torch.int32), dim=-1).sum(dim=-1)
        return tgt, (acc + 1).to(torch.int32)
    if key is None:
        raise ValueError("stochastic verification requires a randomness key")
    t, k, p, keys = _scalar_rows(logits, max(temperature, 1e-6), top_k,
                                 top_p, key)
    return verify_draft_rows(logits, draft, draft_len, t, k, p, keys)


def verify_draft_rows(logits: torch.Tensor, draft: torch.Tensor,
                      draft_len: torch.Tensor, temperature, top_k, top_p,
                      keys) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row accept/resample over a draft window: ``verify_draft``'s
    contract with per-row ``temperature`` / ``top_k`` / ``top_p`` [N] and
    per-row ``keys``.  A row with temperature <= 0 verifies GREEDILY —
    bit-identical to its non-speculative greedy decode — so a mixed batch
    verifies in one program; stochastic rows accept d_j with probability
    p_j(d_j) (uniform of stream ``STREAM_ACCEPT`` at index j), resample a
    rejection at j from p_j with d_j removed (Gumbel of
    ``STREAM_RESIDUAL``) and draw the bonus from the last window position
    (``STREAM_BONUS``)."""
    N, C, V = logits.shape
    K = C - 1
    dev = logits.device
    draft_len = draft_len.to(dev).long()
    draft = draft.to(dev).long()
    t = torch.as_tensor(temperature, device=dev).to(torch.float32)
    j = torch.arange(K, device=dev)
    within = j[None, :] < draft_len[:, None]                      # [N, K]

    # greedy lane: accept while the target argmax agrees with the draft
    tgt = torch.argmax(logits, dim=-1).to(torch.int32)            # [N, C]
    g_match = (tgt[:, :K].long() == draft) & within
    g_acc = torch.cumprod(g_match.long(), dim=-1).sum(dim=-1)

    # stochastic lane (computed for every row, selected per row below)
    scaled = logits.to(torch.float32) / torch.clamp(t, min=1e-6)[:, None,
                                                                 None]
    logp = torch.log_softmax(_filter_logits_rows(
        scaled, torch.as_tensor(top_k, device=dev).long()[:, None, None],
        torch.as_tensor(top_p, device=dev).to(torch.float32)[:, None, None]),
        dim=-1)
    p = torch.exp(logp)                                           # [N, C, V]
    p_d = torch.gather(p[:, :K], -1, draft[..., None])[..., 0]    # [N, K]
    u = uniform(keys, STREAM_ACCEPT, (K,))
    s_match = (u < p_d) & within
    s_acc = torch.cumprod(s_match.long(), dim=-1).sum(dim=-1)
    vocab = torch.arange(V, device=dev)
    res_logp = torch.where(vocab[None, None, :] == draft[..., None],
                           NEG_INF, logp[:, :K])
    res = torch.argmax(res_logp + gumbel(keys, STREAM_RESIDUAL, (K, V)),
                       dim=-1)                                    # [N, K]
    # (a pad row's draft_len is -1: its result is discarded)
    bonus_logp = torch.gather(logp, 1, torch.clamp(draft_len, min=0)[
        :, None, None].expand(N, 1, V))[:, 0]                    # [N, V]
    bonus = torch.argmax(bonus_logp + gumbel(keys, STREAM_BONUS, (V,)),
                         dim=-1)
    res_at_acc = torch.gather(res, 1,
                              torch.clamp(s_acc, 0, max(K - 1, 0))[:, None]
                              )[:, 0] if K else bonus
    extra = torch.where(s_acc < draft_len, res_at_acc, bonus)     # [N]
    jj = torch.arange(C, device=dev)
    draft_pad = torch.cat([draft, torch.zeros((N, 1), dtype=torch.long,
                                              device=dev)], dim=1)
    s_tokens = torch.where(jj[None, :] < s_acc[:, None], draft_pad,
                           torch.where(jj[None, :] == s_acc[:, None],
                                       extra[:, None], 0))

    greedy_row = t <= 0.0                                         # [N]
    acc = torch.where(greedy_row, g_acc, s_acc)
    tokens = torch.where(greedy_row[:, None], tgt.long(), s_tokens)
    return tokens.to(torch.int32), (acc + 1).to(torch.int32)
