"""The plain versions of the dense-arena kernels against the JAX package on
the CPU, in f32: ``flash_attention_ref`` (B5) against the Pallas
``flash_attention`` run in interpret mode and against the reference's
``flash_attention_ref`` at prompt lengths no tile divides, and
``decode_attention_ref`` (B6) against the Pallas ``decode_attention`` in
interpret mode at a cache length its tile does not divide, with every
entry past a row's length poisoned as in ``tests/test_kernels.py``.

Tolerance: |err| <= 1e-5 + 1e-5 |ref|.  Both sides compute in f32 (the
interpret-mode kernels and the references with f32 accumulation) and
differ only in the order of their sums: per element at most a few f32
roundings of values of order one.  On the CUDA card the kernels are held
against these same plain versions by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(B, H, Hkv, T, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, T, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, D)).astype(np.float32))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 96),
                                           (False, 0)])
@pytest.mark.parametrize("H,Hkv", [(4, 2), (4, 4)])
def test_flash_plain_matches_pallas(H, Hkv, causal, window):
    """T a multiple of the Pallas tiles (64): GQA and MHA, causal with and
    without a sliding window, and non-causal."""
    q, k, v = _qkv(2, H, Hkv, 256, 16, seed=H + Hkv + window)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, bq=64, bk=64))
    got = ops.flash_attention(*_torch(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("T,window", [(333, 0), (600, 0), (600, 130)])
def test_flash_plain_matches_reference_at_ragged_lengths(T, window):
    """Prompt lengths that no tile of either side divides (the plain
    version walks 256-query blocks), against the reference's own plain
    version."""
    q, k, v = _qkv(1, 8, 2, T, 16, seed=T + window)
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, window))
    got = ops.flash_attention(*_torch(q, k, v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_plain_builds_no_square_scores(monkeypatch):
    """Each query block of at most 256 rows meets only the keys some query
    of it can see (causal: those before its end; windowed: at most 256 +
    window of them), so at T = 1000 no score tensor is [.., T, T]."""
    seen = []
    einsum = torch.einsum

    def spy(eq, *xs):
        out = einsum(eq, *xs)
        if eq.startswith("bhgqd,bhkd"):
            seen.append(tuple(out.shape[-2:]))
        return out

    monkeypatch.setattr(torch, "einsum", spy)
    q, k, v = _torch(*_qkv(1, 4, 2, 1000, 16, seed=0))
    ref.flash_attention_ref(q, k, v, causal=True, window=0)
    assert seen == [(256, 256), (256, 512), (256, 768), (232, 1000)]
    seen.clear()
    ref.flash_attention_ref(q, k, v, causal=True, window=64)
    assert all(m <= 256 + 64 for _, m in seen)


# lengths at the edges of the card's walk at D = 16 (csrc/decode_split.cuh):
# 1, one stage (32 tokens in f32, 64 in bf16) +-1, one split (a multiple of
# the 128- or 256-token quantum) +-1, and the whole arena
_EDGE_LENGTHS = (1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256, 257)


@pytest.mark.parametrize("S,H,Hkv,lengths", [
    pytest.param(300, 4, 2, None, id="300-4-2"),
    pytest.param(300, 4, 4, None, id="300-4-4"),
    pytest.param(77, 8, 1, None, id="77-8-1"),
    pytest.param(261, 4, 1, _EDGE_LENGTHS + (261,), id="261-4-1-edges"),
    pytest.param(261, 4, 4, _EDGE_LENGTHS + (261,), id="261-4-4-edges")])
def test_decode_plain_matches_pallas(S, H, Hkv, lengths):
    """A cache length the Pallas tile (128) does not divide; lengths 1, a
    ragged value and S, or the walk's edge lengths; every entry at or past
    a row's length poisoned with +-99, which must not move the output."""
    D = 16
    lengths = np.array(lengths or (1, S // 2 + 3, S), np.int32)
    B = len(lengths)
    rng = np.random.default_rng(S + H + Hkv)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    want = np.asarray(jops.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lengths), bs=128))
    pk, pv = kc.copy(), vc.copy()
    for b, n in enumerate(lengths):
        pk[b, n:] = 99.0 if b % 2 else -99.0
        pv[b, n:] = -99.0 if b % 2 else 99.0
    got = ops.decode_attention(*_torch(q, pk, pv, lengths))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # non-finite rows past the lengths are masked as well
    pk[0, 1:], pv[0, 1:] = np.nan, np.inf
    got = ops.decode_attention(*_torch(q, pk, pv, lengths))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_decode_plain_matches_reference_at_every_length():
    """lengths 1..S over one cache, against the reference's plain
    version."""
    S, H, Hkv, D = 40, 4, 2, 16
    rng = np.random.default_rng(1)
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    kc = rng.standard_normal((S, S, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((S, S, Hkv, D)).astype(np.float32)
    lengths = np.arange(1, S + 1, dtype=np.int32)
    want = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lengths)))
    got = ops.decode_attention(*_torch(q, kc, vc, lengths))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cuda_tensors_never_reach_the_plain_versions(monkeypatch):
    """On CUDA tensors the dispatchers call the kernel wrappers, never the
    plain versions (the wrappers are swapped for recorders, and
    ``_on_cpu`` is made to answer False as it does for a CUDA tensor)."""
    calls = []
    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops._fa, "flash_attention",
                        lambda *a, **k: calls.append("B5"))
    monkeypatch.setattr(ops._da, "decode_attention",
                        lambda *a, **k: calls.append("B6"))
    monkeypatch.setattr(ref, "flash_attention_ref", None)
    monkeypatch.setattr(ref, "decode_attention_ref", None)
    q, k, v = _torch(*_qkv(1, 4, 2, 8, 16, seed=0))
    ops.flash_attention(q, k, v)
    ops.decode_attention(q[:, :, 0], k.transpose(1, 2), v.transpose(1, 2),
                         torch.ones(1, dtype=torch.int32))
    assert calls == ["B5", "B6"]
