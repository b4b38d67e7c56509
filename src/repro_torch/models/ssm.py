"""Mamba-2 (SSD — state-space duality) block (port of
src/repro/models/ssm.py).

Prefill runs the chunked SSD algorithm: inside each chunk the hand-written
SSD chunk kernel (``kernels/ops.ssd_chunk``, B7) on the card, or its plain
version on the CPU; the inter-chunk recurrence over nc states stays in
PyTorch.  Decode is the one-token recurrent state update, elementwise and
GEMV-shaped, in PyTorch.  The recurrent state [B, H, P, N] takes the place
of the KV cache and does not grow with the sequence.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops as _kops
from repro_torch.models.layers import dense_init, matmul

Params = Dict[str, Any]


def ssm_init(d_model: int, s: SSMConfig, dtype, generator: torch.Generator,
             device) -> Params:
    """One block's parameters, drawn from ``generator`` on ``device`` with
    the reference's layout and scales (src/repro/models/ssm.py:24):
    fan-in truncated-normal projections, 0.1-normal conv taps, zero conv
    bias, A_log = log(linspace(1, 16)), D = 1, dt_bias = softplus^-1 of a
    log-uniform draw in [1e-3, 1e-1], unit norm."""
    di = s.d_inner(d_model)
    nh = s.n_heads(d_model)
    conv_dim = di + 2 * s.n_groups * s.d_state
    in_dim = 2 * di + 2 * s.n_groups * s.d_state + nh          # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=device)

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    conv_w = torch.randn((s.d_conv, conv_dim), generator=generator, **f32)
    u = torch.rand((nh,), generator=generator, **f32)
    dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return {
        "in_proj": dense_init(empty(d_model, in_dim), generator),
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "norm_scale": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": dense_init(empty(di, d_model), generator),
    }


def _split_proj(proj, d_model: int, s: SSMConfig):
    di = s.d_inner(d_model)
    gn = s.n_groups * s.d_state
    z = proj[..., :di]
    x = proj[..., di: 2 * di]
    Bm = proj[..., 2 * di: 2 * di + gn]
    Cm = proj[..., 2 * di + gn: 2 * di + 2 * gn]
    dt = proj[..., 2 * di + 2 * gn:]
    return z, x, Bm, Cm, dt


def _softplus(x):
    """``jax.nn.softplus``.  torch's returns x itself above its threshold of
    20, where log1p(exp(x)) - x < 2.1e-9, below half an f32 ulp of x."""
    return F.softplus(x)


def _gated_out(params, y, z, eps: float = 1e-5):
    dt = y.dtype
    g = y * F.silu(z.float()).to(dt)
    gf = g.float()
    var = (gf * gf).mean(dim=-1, keepdim=True)
    gf = gf * torch.rsqrt(var + eps) * params["norm_scale"].float()
    return matmul(gf.to(dt), params["out_proj"])


def _causal_conv(xbc, conv_w, conv_b, d_conv: int):
    """Depthwise causal conv along T.  xbc: [B,T,C]; conv_w: [K,C].  The
    reference's unrolled sum of K shifted products in f32 (no library
    convolution, which would take cuDNN's TF32 on the card)."""
    T = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, d_conv - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for k in range(d_conv):
        out = out + pad[:, k: k + T].float() * conv_w[k].float()
    out = out + conv_b.float()
    return F.silu(out).to(xbc.dtype)


def _segsum(dA):
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} dA[..., k] (j<=i),
    -inf above the diagonal."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=dA.device).tril()
    return torch.where(mask, diff, -math.inf)


def _cat(parts, dim: int):
    """``torch.cat`` that hands a single part back as it is, uncopied."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def ssd_chunked(x, dt, A, Bm, Cm, D, chunk: int, initial_state=None):
    """Chunked SSD.  x:[B,T,H,P] dt:[B,T,H] A:[H] Bm/Cm:[B,T,G,N] D:[H].

    Returns (y [B,T,H,P] f32, final_state [B,H,P,N] f32).  The intra-chunk
    part runs per B/C group in ``ops.ssd_chunk`` over the batch's chunks
    stacked [B*nc, ...]; the inter-chunk recurrence and the contribution of
    each chunk's incoming state are the reference's, in f32.  Like the
    reference (which asserts it), T must be a multiple of ``chunk``."""
    Bsz, T, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if T % chunk:
        raise ValueError(f"ssd_chunked: T={T} is not a multiple of the "
                         f"chunk {chunk} (the reference asserts T % chunk "
                         "== 0)")
    nc = T // chunk
    rep = H // G
    dtf = dt.float()
    A = A.float()
    # the kernel's layout: x [B*nc, H, Q, P], dt [B*nc, H, Q], B/C [B*nc, Q, N]
    xk = x.reshape(Bsz * nc, chunk, H, P).transpose(1, 2).contiguous()
    dtk = dtf.reshape(Bsz * nc, chunk, H).transpose(1, 2).contiguous()
    groups = [slice(g * rep, (g + 1) * rep) for g in range(G)]
    outs = [_kops.ssd_chunk(
        xk[:, hs].contiguous(), dtk[:, hs].contiguous(), A[hs].contiguous(),
        Bm[:, :, g].reshape(Bsz * nc, chunk, N).contiguous(),
        Cm[:, :, g].reshape(Bsz * nc, chunk, N).contiguous())
        for g, hs in enumerate(groups)]
    y_diag = _cat([o[0] for o in outs], dim=1)                  # [B*nc,H,Q,P]
    S_chunk = _cat([o[1] for o in outs], dim=1)                 # [B*nc,H,N,P]
    y_diag = y_diag.reshape(Bsz, nc, H, chunk, P)
    S_chunk = S_chunk.reshape(Bsz, nc, H, N, P).transpose(-1, -2)

    # inter-chunk recurrence over nc states
    dAc = (dtf * A).reshape(Bsz, nc, chunk, H)
    dA_cs = torch.cumsum(dAc, dim=2)                            # [B,nc,Q,H]
    chunk_decay = torch.exp(dAc.sum(dim=2))                     # [B,nc,H]
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                         device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + S_chunk[:, c]
    prev_states = torch.stack(prev, dim=1)                      # [B,nc,H,P,N]

    # inter-chunk contribution: y_off[q, h, p] = C_q . prev[h, p] decay_q
    Cc = Cm.float().reshape(Bsz, nc, chunk, G, N)
    y_off = _cat([torch.einsum("bcqn,bchpn->bcqhp", Cc[:, :, :, g],
                               prev_states[:, :, hs])
                  for g, hs in enumerate(groups)], dim=3)       # [B,nc,Q,H,P]
    y_off = y_off * torch.exp(dA_cs)[..., None]

    y = (y_diag.permute(0, 1, 3, 2, 4) + y_off).reshape(Bsz, T, H, P)
    y = y + x.float() * D.float()[None, None, :, None]
    return y, state


# ---------------------------------------------------------------------------
# block-level apply
# ---------------------------------------------------------------------------

def ssm_prefill(params, h, d_model: int, s: SSMConfig):
    """Full-sequence SSD block.  h: [B,T,d_model] -> (out, (conv_state,
    ssm_state)), conv_state [B, d_conv-1, conv_dim] in h's dtype (left
    zero-padded when T < d_conv - 1), ssm_state [B,H,P,N] f32.  (The
    reference's ``pad_mask`` is left out: nothing in either package passes
    one.)"""
    Bsz, T, _ = h.shape
    di = s.d_inner(d_model)
    nh = s.n_heads(d_model)
    proj = matmul(h, params["in_proj"])
    z, x, Bm, Cm, dt = _split_proj(proj, d_model, s)
    xbc = torch.cat([x, Bm, Cm], dim=-1)
    if T >= s.d_conv - 1:
        conv_state = xbc[:, T - (s.d_conv - 1):]
    else:
        conv_state = F.pad(xbc, (0, 0, s.d_conv - 1 - T, 0))
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"], s.d_conv)
    gn = s.n_groups * s.d_state
    x = xbc[..., :di].reshape(Bsz, T, nh, s.head_dim)
    Bm = xbc[..., di: di + gn].reshape(Bsz, T, s.n_groups, s.d_state)
    Cm = xbc[..., di + gn:].reshape(Bsz, T, s.n_groups, s.d_state)
    A = -torch.exp(params["A_log"].float())
    dt = _softplus(dt.float() + params["dt_bias"].float())
    y, state = ssd_chunked(x, dt, A, Bm, Cm, params["D"],
                           min(s.chunk_size, T))
    y = y.reshape(Bsz, T, di).to(h.dtype)
    out = _gated_out(params, y, z)
    return out, (conv_state, state)


def ssm_decode(params, h, conv_state, ssm_state, d_model: int, s: SSMConfig):
    """Single-token recurrent update.

    h: [B,1,d_model]; conv_state: [B, d_conv-1, conv_dim]; ssm_state:
    [B,H,P,N] f32.  Returns (out, new_conv_state, new_ssm_state), new
    tensors (the caller decides where they land)."""
    Bsz = h.shape[0]
    di = s.d_inner(d_model)
    nh = s.n_heads(d_model)
    gn = s.n_groups * s.d_state
    proj = matmul(h, params["in_proj"])[:, 0]                   # [B, in_dim]
    z, x, Bm, Cm, dt = _split_proj(proj, d_model, s)
    xbc = torch.cat([x, Bm, Cm], dim=-1)                        # [B, conv_dim]
    # causal conv via the rolling state
    window = torch.cat([conv_state, xbc[:, None, :]], dim=1)    # [B,K,C]
    new_conv_state = window[:, 1:, :]
    conv_out = torch.einsum("bkc,kc->bc", window.float(),
                            params["conv_w"].float())
    conv_out = F.silu(conv_out + params["conv_b"].float())
    x = conv_out[:, :di].reshape(Bsz, nh, s.head_dim)
    Bv = conv_out[:, di: di + gn].reshape(Bsz, s.n_groups, s.d_state)
    Cv = conv_out[:, di + gn:].reshape(Bsz, s.n_groups, s.d_state)
    rep = nh // s.n_groups
    Bv = Bv.repeat_interleave(rep, dim=1)                       # [B,H,N]
    Cv = Cv.repeat_interleave(rep, dim=1)
    A = -torch.exp(params["A_log"].float())
    dt = _softplus(dt.float() + params["dt_bias"].float())      # [B,H]
    dA = torch.exp(dt * A[None, :])                             # [B,H]
    # state update: s = s*dA + dt * x (x) B   (elementwise + outer product)
    upd = torch.einsum("bh,bhp,bhn->bhpn", dt, x, Bv)
    new_state = ssm_state * dA[..., None, None] + upd
    # y = C . s + D * x     (GEMV over N)
    y = torch.einsum("bhpn,bhn->bhp", new_state, Cv)
    y = y + x * params["D"].float()[None, :, None]
    y = y.reshape(Bsz, 1, di).to(h.dtype)
    out = _gated_out(params, y, z[:, None, :])
    return out, new_conv_state, new_state
