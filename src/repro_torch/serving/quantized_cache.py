"""Quantized KV pages — the paper-faithful decode memory format (port of
the quantizers of src/repro/serving/quantized_cache.py).

HALO's CiD computes int8 end to end (paper §IV-A, §V-A).  KV pages are
stored int8 with one f32 scale per (position, kv head), or as packed int4
— two nibbles per byte at half the head width, the same scale pages.
Scales are per token, so a page write stays one-slot local.

The dense-arena helpers of the reference (``init_quantized_cache``,
``quantized_cache_specs``) arrive with the dense arena (ROADMAP queue A,
item 11); the paged pools are built by ``serving/kv_pool.py``.
"""

from __future__ import annotations

import torch


def quantize_token(x: torch.Tensor, dim: int = -1):
    """Symmetric int8 per-vector quantization along ``dim``.
    Returns (q int8, scale f32 with ``dim`` removed)."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim)
    scale = amax.clamp(min=1e-8) / 127.0
    q = torch.round(xf / scale.unsqueeze(dim)).clamp_(-127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dim: int = -1) -> torch.Tensor:
    return q.float() * scale.float().unsqueeze(dim)


def quantize_token_int4(x: torch.Tensor, dim: int = -1):
    """Symmetric int4 per-vector quantization along ``dim``.
    Returns (q int8 in [-7, 7], scale f32 with ``dim`` removed) — pack the
    values with ``pack_int4`` for storage."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim)
    scale = amax.clamp(min=1e-8) / 7.0
    q = torch.round(xf / scale.unsqueeze(dim)).clamp_(-7, 7)
    return q.to(torch.int8), scale


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (int8 in [-8, 7]) pairwise along the last dim:
    [..., D] -> uint8 [..., D//2], element 2i in the low nibble and 2i+1 in
    the high nibble.  D must be even."""
    if q.shape[-1] % 2:
        raise ValueError(f"odd last dim {q.shape[-1]} cannot pack")
    lo = q[..., 0::2].to(torch.int16) & 0xF
    hi = q[..., 1::2].to(torch.int16) & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(b: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: uint8 [..., D//2] -> int8 [..., D] with
    explicit sign extension (nibbles >= 8 are negative)."""
    w = b.to(torch.int16)
    lo = w & 0xF
    hi = w >> 4
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1).to(torch.int8)
    return out.reshape(*b.shape[:-1], 2 * b.shape[-1])
