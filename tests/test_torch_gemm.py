"""B8, the prefill GEMM of HALO's CiM path, on the CPU: the port's
``ops.matmul`` (its plain version here) against the JAX ``ops.matmul`` (the
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it) on
the same numpy inputs; the reference's block contract; the dispatch.

Tolerance: ``chip_smoke.py``'s per-element bound for B8, the one the card's
kernel is held to: |err| <= 2^-7 |ref| (bf16 only) + (2K + 2) 2^-24 A, with
A = |x| @ |w|.  Both sides sum K exact products in f32 (bf16 products are
exact in f32) and round once to x's dtype."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import gemm_cim, ops, ref

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# the JAX test's shapes and blocks (tests/test_kernels.py:26-31)
SHAPES = [(256, 512, 256), (512, 1024, 512), (128, 256, 384),
          (256, 2048, 128)]
BLOCKS = dict(bm=128, bn=128, bk=256)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(M, K, N, dtype, seed):
    """The same x [M,K] and w [K,N] for both packages: standard normal f32
    from numpy, rounded to ``dtype`` (nearest even) on each side."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return ((jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)),
            (torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)))


def _jax_result(jx, jw, **blocks):
    out = jops.matmul(jx, jw, **blocks)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _within(got, want, args, dtype):
    tol, A = chip_smoke.tolerance(torch, "matmul", args, {}, dtype)
    return chip_smoke.close(torch, got, want, dtype, A, tol)[1]


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_matches_pallas(M, K, N, dtype):
    (jx, jw), (x, w) = _inputs(M, K, N, dtype, seed=M + K + N)
    want = _jax_result(jx, jw, **BLOCKS)
    got = ops.matmul(x, w, **BLOCKS)
    assert got.dtype == x.dtype and got.shape == (M, N)
    assert _within(got, want, (x, w), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_block_invariance(dtype):
    """As the JAX test: the result does not depend on the tiling — the
    port's at two block settings is the same tensor, and within the bound
    of the Pallas kernel's at each."""
    (jx, jw), (x, w) = _inputs(256, 512, 256, dtype, seed=1)
    a = ops.matmul(x, w, bm=256, bn=256, bk=512)
    b = ops.matmul(x, w, bm=64, bn=64, bk=128)
    assert torch.equal(a, b)
    for blocks in (dict(bm=256, bn=256, bk=512), dict(bm=64, bn=64, bk=128)):
        assert _within(a, _jax_result(jx, jw, **blocks), (x, w), dtype)


@pytest.mark.parametrize("M,K,N,blocks", [
    (300, 512, 256, {}),                          # M: 256 does not divide 300
    (256, 600, 256, {}),                          # K: 512 does not divide 600
    (256, 512, 320, {}),                          # N: 256 does not divide 320
    (256, 512, 256, dict(bm=96, bn=128, bk=128)),
])
def test_both_refuse_blocks_that_do_not_divide(M, K, N, blocks):
    (jx, jw), (x, w) = _inputs(M, K, N, "float32", seed=2)
    with pytest.raises(AssertionError):
        jops.matmul(jx, jw, **blocks)
    with pytest.raises(ValueError, match="do not divide"):
        ops.matmul(x, w, **blocks)


def test_blocks_are_clipped_to_the_dims():
    """A dim smaller than its block takes the whole dim, as in the
    reference: M = 37 and K = 40 (no multiple of 16) compute."""
    (jx, jw), (x, w) = _inputs(37, 40, 24, "float32", seed=3)
    assert gemm_cim.check_blocks(x, w, 256, 256, 512) == (37, 24, 40)
    assert _within(ops.matmul(x, w), _jax_result(jx, jw), (x, w), "float32")


def test_cuda_tensors_never_reach_the_plain_version(monkeypatch):
    """On a CUDA tensor the dispatcher calls the kernel wrapper, never
    ``matmul_ref`` (``_on_cpu`` answers False as for a CUDA tensor; the
    wrapper is swapped for a recorder); the real wrapper refuses a CPU
    tensor without counting a launch."""
    calls = []
    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops._gemm, "matmul",
                        lambda x, w, **k: calls.append(k))
    monkeypatch.setattr(ref, "matmul_ref", None)
    _, (x, w) = _inputs(64, 32, 16, "bfloat16", seed=4)
    ops.matmul(x, w, bk=16)
    assert calls == [dict(bm=256, bn=256, bk=16)]
    monkeypatch.undo()
    n0 = gemm_cim.matmul.launches
    with pytest.raises(ValueError, match="CUDA"):
        gemm_cim.matmul(x, w)
    assert gemm_cim.matmul.launches == n0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bound_fails_a_dropped_k_tile(dtype):
    """The bound that passes the Pallas kernel's result fails one that left
    out a 32-row tile of K (rows 32..63 of 2048)."""
    (jx, jw), (x, w) = _inputs(256, 2048, 128, dtype, seed=5)
    want = _jax_result(jx, jw, **BLOCKS)
    dropped = x.clone()
    dropped[:, 32:64] = 0
    assert _within(ops.matmul(x, w, **BLOCKS), want, (x, w), dtype)
    assert not _within(ops.matmul(dropped, w, **BLOCKS), want, (x, w),
                       dtype)
