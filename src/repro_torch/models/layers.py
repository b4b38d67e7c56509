"""Shared model primitives (port of src/repro/models/layers.py).

Parameters are plain nested dicts of tensors in the reference's pytree
layout.  Norms, RoPE and softmax compute in f32; matmuls accumulate in f32
and cast back to the activation dtype.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as _kops

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name (``ModelConfig.dtype``) as a torch dtype."""
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# init helpers (same shapes and scales as the reference; the numbers differ,
# since torch.Generator and jax.random draw differently)
# ---------------------------------------------------------------------------

def dense_init(out: torch.Tensor, generator: torch.Generator,
               scale: Optional[float] = None) -> torch.Tensor:
    """Fill ``out`` [in, out_dim] in place: truncated normal on [-3, 3]
    times 1/sqrt(fan-in), drawn in f32 and cast (llama-style)."""
    if scale is None:
        scale = 1.0 / math.sqrt(out.shape[0])
    w = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    out.copy_(w.mul_(scale))
    return out


def embed_init(out: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill ``out`` in place: normal times 0.02, drawn in f32 and cast."""
    w = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    torch.nn.init.normal_(w, 0.0, 1.0, generator=generator)
    out.copy_(w.mul_(0.02))
    return out


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(params, x, eps: float = 1e-5, *, gemma_style: bool = False):
    """RMSNorm in f32.  gemma_style uses (1 + scale) parameterization."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    scale = params["scale"].float()
    if gemma_style:
        scale = 1.0 + scale
    return (xf * scale).to(dt)


def head_rmsnorm(scale, x, eps: float = 1e-5):
    """Per-head RMSNorm over the last (head) dim — qwen3 qk_norm."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta, device=None) -> torch.Tensor:
    """Inverse frequencies [dim//2] (f32).  ``theta`` stays a Python number:
    a tensor made from it would be a host-to-device copy, and so a stream
    sync, on every call."""
    exponent = torch.arange(0, dim, 2, dtype=torch.float32,
                            device=device) / dim
    return 1.0 / (float(theta) ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta) -> torch.Tensor:
    """Rotary embedding on x [..., T, H, D] at positions [..., T]; rotates
    the pairs (x[2i], x[2i+1]) — the interleaved convention."""
    dt = x.dtype
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)                  # [d/2]
    ang = positions[..., None].float() * inv                     # [..., T, d/2]
    ang = ang[..., None, :]                                      # [..., T, 1, d/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.float()
    x1 = xf[..., 0::2]
    x2 = xf[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(x.shape).to(dt)


# ---------------------------------------------------------------------------
# FFN (SwiGLU)
# ---------------------------------------------------------------------------

def ffn(params, x, act: str = "silu"):
    """SiLU-gated FFN (the GeGLU variant arrives with gemma's slice)."""
    if act != "silu":
        raise NotImplementedError(f"ffn act={act!r}: later slice "
                                  "(ROADMAP queue A, item 11)")
    g = matmul(x, params["wi_gate"])
    u = matmul(x, params["wi_up"])
    h = F.silu(g) * u
    return matmul(h.to(x.dtype), params["wo"])


# ---------------------------------------------------------------------------
# matmul with f32 accumulation
# ---------------------------------------------------------------------------

# Decode-shaped quantized matmuls (token dim <= this) take the int8 GEMV
# kernel (kernels/gemv_cid.py), so the weight bytes cross device memory at
# int8 width with the dequant in the kernel's epilogue — HALO's CiD decode
# mapping.  The threshold catches decode (T = 1) and verify windows, not
# prefill chunks, which dequantize and take the library GEMM (CiM).
GEMV_TOKEN_DIM_MAX = 8

# route counter: one per call that takes the GEMV route (the reference
# counts traces of its jitted programs; this eager port counts calls).
# Tests assert decode under int8 weights goes through the kernel.
_gemv_routes = 0


def gemv_route_count() -> int:
    return _gemv_routes


def reset_gemv_route_count() -> None:
    global _gemv_routes
    _gemv_routes = 0


def matmul(x, w):
    """x @ w with f32 accumulation, result in x.dtype.

    ``w`` may be an int8 weight-only-quantized leaf {"q","scale"}
    (serving/quantized_weights.py).  Calls whose token dim is at most
    ``GEMV_TOKEN_DIM_MAX`` take the int8 GEMV kernel on the int8 bytes;
    larger ones dequantize to x's dtype and take ``torch.matmul`` (the
    reference leaves that product to XLA's einsum, not to a kernel).

    f32 runs in full f32 (TF32 is off, see ``repro_torch/__init__``).  bf16
    products accumulate in f32 inside the GEMM with reduced-precision
    reductions off, and round once on output — the reference's
    ``preferred_element_type=f32`` then ``astype``."""
    global _gemv_routes
    if isinstance(w, dict):
        q, scale = w["q"], w["scale"]
        if (q.ndim == 2 and x.ndim >= 2
                and x.shape[-2] <= GEMV_TOKEN_DIM_MAX):
            _gemv_routes += 1
            lead = x.shape[:-1]
            out = _kops.gemv(x.reshape(-1, x.shape[-1]).contiguous(), q,
                             scale.float())
            return out.reshape(*lead, q.shape[-1]).to(x.dtype)
        w = (q.float() * scale.float()[..., None, :]).to(x.dtype)
    return torch.matmul(x, w.to(x.dtype))


def matmul_f32(x, w):
    """x @ w with an f32 result (the LM head: the reference keeps logits in
    f32, ``preferred_element_type=f32`` with no cast back)."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.is_cuda:
        # bf16 operands, f32 accumulation and f32 output in one GEMM
        lead = x.shape[:-1]
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*lead, w.shape[-1])
    return torch.matmul(x.float(), w.float())
