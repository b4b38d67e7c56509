"""B7's two routes on the CPU: which route ``ssd_scan.route`` names for a
dtype, head dim, state width and alignment, that the route codes are the
C header's and the wrapper counts launches by route, and the arithmetic of
the tensor-core route — each f32 operand split into three bf16 pieces, dt
folded into G', the states as (B o w)^T x — emulated in PyTorch and held
against the JAX package's Pallas ``ssd_chunk`` (interpret mode) under the
card's worst-case bound (``chip_smoke.ssd_tolerance``, unchanged).  The
kernel itself runs only on the card (``chip_smoke.py``).

Inputs are bf16 x, B and C and f32 dt and A, drawn with numpy from a seed,
dt and A made as ``ssm_prefill`` makes them; the Pallas kernel gets the
same values widened to f32."""

import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build, ssd_scan

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,P,N,aligned,want", [
    (BF16, 64, 128, True, "mma"),        # mamba2's prefill
    (BF16, 64, 256, True, "mma"), (BF16, 64, 8, True, "mma"),
    (BF16, 64, 24, True, "mma"),         # N a multiple of 8, not of 16
    (BF16, 64, 100, True, "tile"),       # rows of 200 bytes: no 16-byte pieces
    (BF16, 64, 264, True, "tile"),       # wider than the route's 256
    (BF16, 64, 128, False, "tile"),      # a base off 16 bytes
    (BF16, 32, 128, True, "tile"), (BF16, 16, 64, True, "tile"),
    (F32, 64, 128, True, "tile"), (F32, 16, 16, True, "tile"),
    (F32, 32, 128, True, "tile")])
def test_ssd_route(dtype, P, N, aligned, want):
    """bf16 at P = 64 with N <= 256 a multiple of 8 and aligned bases runs
    on the tensor cores; f32 (the tile keeps the reference's f32 sums), the
    head dims 16 and 32 and every other bf16 input on the CUDA-core
    tile."""
    assert ssd_scan.route(dtype, P, N, aligned) == want
    if aligned:
        assert ssd_scan.route(dtype, P, N) == want


def test_ssd_route_codes_and_counts():
    """The wrapper passes its route as ``csrc/common.cuh``'s code (the
    tensor-core route takes ROUTE_WGMMA's), the C entry point launches that
    route or refuses, and the wrapper counts each route."""
    text = (_build.CSRC / "common.cuh").read_text()
    m = re.search(r"enum \{ ROUTE_TILE = (\d+), ROUTE_WGMMA = (\d+) \};", text)
    assert ssd_scan.ROUTE_CODES == {"tile": int(m[1]), "mma": int(m[2])}
    src = (_build.CSRC / "ssd_chunk.cu").read_text()
    assert "constexpr int ROUTE_MMA = ROUTE_WGMMA;" in src
    assert set(ssd_scan.ssd_chunk.routes) == {"mma", "tile"}
    assert isinstance(ssd_scan.ssd_chunk.launches, int)


def test_route_constants_mirror_the_c_source():
    """The route's head dim and widest state are the kernel's."""
    src = (_build.CSRC / "ssd_chunk.cu").read_text()
    assert int(re.search(r"constexpr int kP = (\d+);", src)[1]) \
        == ssd_scan._MMA_HEAD_DIM
    assert int(re.search(r"constexpr int kMaxN = (\d+);", src)[1]) \
        == ssd_scan._MAX_N
    assert "N % 8 != 0 || N > kMaxN" in src


# -- the tensor-core route's arithmetic, emulated ---------------------------------

def _softplus(x):
    return np.logaddexp(x, 0.0).astype(np.float32)


def _inputs(seed, nc, H, Q, P, N, span=None):
    """bf16-exact x, B, C (as f32 numpy), f32 dt and A as ``ssm_prefill``
    makes them; with ``span`` each (chunk, head)'s dt is scaled so that its
    cs spans exactly ``span``."""
    rng = np.random.default_rng(seed)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(BF16).float().numpy()
    x = bf16(rng.standard_normal((nc, H, Q, P)))
    dt_bias = np.log(np.expm1(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                                                 H)))).astype(np.float32)
    dt = _softplus(rng.standard_normal((nc, H, Q)) + dt_bias[None, :, None])
    A = -np.exp(np.log(np.linspace(1.0, 16.0, H))).astype(np.float32)
    if span is not None:
        dt = (dt * (span / (dt.sum(-1, keepdims=True)
                            * np.abs(A)[None, :, None]))).astype(np.float32)
    B = bf16(rng.standard_normal((nc, Q, N)))
    C = bf16(rng.standard_normal((nc, Q, N)))
    return x, dt, A, B, C


def _split3(v):
    """v = hi + mid + lo, each a bf16 value: the route's split of an f32
    operand, rounding to nearest even as the kernel's cvt does."""
    hi = v.to(BF16).float()
    r = v - hi
    mid = r.to(BF16).float()
    r = r - mid
    return hi, mid, r.to(BF16).float()


def _route_emulation(x, dt, A, Bm, Cm, pieces=3):
    """The tensor-core route's arithmetic in f32: cs = cumsum(dt A); C B^T
    of exact bf16 products; G' = (C B^T exp(cs_i - cs_j)) dt_j at and below
    the diagonal; y = sum over the split pieces of G' x; w = exp(cs_last -
    cs) dt; states = sum over the pieces of (B o w)^T x.  ``pieces`` < 3
    keeps only the leading pieces (hi: one bf16 product)."""
    dA = dt * A[None, :, None]
    cs = torch.cumsum(dA, dim=-1)                                  # [nc,H,Q]
    Q = x.shape[2]
    cb = (Cm @ Bm.transpose(-1, -2))[:, None]                      # [nc,1,Q,Q]
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    e = torch.exp(torch.where(tri, cs[..., :, None] - cs[..., None, :],
                              -float("inf")))
    g = (cb * e) * dt[..., None, :]                                # [nc,H,Q,Q]
    y = sum(p @ x for p in _split3(g)[:pieces])
    w = torch.exp(cs[..., -1:] - cs) * dt                          # [nc,H,Q]
    bw = Bm[:, None] * w[..., None]                                # [nc,H,Q,N]
    states = sum(p.transpose(-1, -2) @ x for p in _split3(bw)[:pieces])
    return y, states


def _pallas(x, dt, A, B, C):
    H = x.shape[1]
    y, st = jops.ssd_chunk(*map(jnp.asarray, (x, dt, A, B, C)),
                           bh=min(4, H), interpret=True)
    return torch.from_numpy(np.array(y)), torch.from_numpy(np.array(st))


def _bound_holds(got, want, args):
    tol, A = chip_smoke.ssd_tolerance(torch, *args)
    err, ok, _ = chip_smoke.close(torch, chip_smoke.flat(got),
                                  chip_smoke.flat(want), "float32", A, tol)
    return ok


@pytest.mark.parametrize("nc", [1, 3])
@pytest.mark.parametrize("Q", [24, 32, 64])
def test_split_products_match_pallas(nc, Q):
    """The three-piece products agree with the Pallas kernel's f32
    arithmetic within the card's worst-case bound at mamba2's P and N; one
    bf16 product (hi alone) does not."""
    H, P, N = 4, 64, 128
    args = [torch.from_numpy(a) for a in _inputs(nc * 100 + Q, nc, H, Q,
                                                  P, N)]
    want = _pallas(*args)
    got = _route_emulation(*args)
    assert all(g.dtype == torch.float32 for g in got)
    assert _bound_holds(got, want, args)
    assert not _bound_holds(_route_emulation(*args, pieces=1), want, args)


@pytest.mark.parametrize("span", [100.0, 400.0])
def test_split_products_hold_where_cs_spans_far(span):
    """A large |dt A| drives cs far from 0 (exp(cs_i - cs_j) underflows
    below the diagonal, the states weigh only the chunk's last positions):
    the emulation still agrees within the bound."""
    args = [torch.from_numpy(a) for a in _inputs(int(span), 2, 4, 64, 64,
                                                  128, span=span)]
    S = (args[1] * args[2].abs()[None, :, None]).sum(-1)
    assert torch.allclose(S, torch.full_like(S, span), rtol=1e-4)
    assert _bound_holds(_route_emulation(*args), _pallas(*args), args)


def test_split3_is_exact():
    """hi + mid + lo reproduces every f32 value of the operands' range
    exactly: the split loses nothing."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.standard_normal(100000)
                          * np.exp(rng.uniform(-30, 30, 100000)))
                         .astype(np.float32))
    hi, mid, lo = _split3(v)
    assert torch.equal((hi + mid) + lo, v)
    for p in (hi, mid, lo):
        assert torch.equal(p.to(BF16).float(), p)
