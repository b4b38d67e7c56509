"""The port's model primitives against the JAX package's on the CPU:
rmsnorm, head_rmsnorm, rope, the SiLU-gated FFN, the f32-accumulating
matmul (dense and int8-quantized weights) and the qkv projection (qk-norm on and off).  Inputs are drawn with
numpy; everything is f32; atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jl
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl

ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("gemma_style", [False, True])
def test_rmsnorm(gemma_style):
    rng = _rng(1)
    xj, xt = _both(rng.standard_normal((2, 5, 32)).astype(np.float32))
    sj, st = _both(rng.standard_normal(32).astype(np.float32))
    _close(tl.rmsnorm({"scale": st}, xt, 1e-6, gemma_style=gemma_style),
           jl.rmsnorm({"scale": sj}, xj, 1e-6, gemma_style=gemma_style))


def test_head_rmsnorm():
    rng = _rng(2)
    xj, xt = _both(rng.standard_normal((2, 3, 4, 16)).astype(np.float32))
    sj, st = _both(rng.standard_normal(16).astype(np.float32))
    _close(tl.head_rmsnorm(st, xt), jl.head_rmsnorm(sj, xj))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(theta):
    rng = _rng(3)
    xj, xt = _both(rng.standard_normal((2, 6, 4, 16)).astype(np.float32))
    pj, pt = _both(rng.integers(0, 5000, (2, 6)).astype(np.int32))
    _close(tl.rope_freqs(16, theta), jl.rope_freqs(16, theta))
    _close(tl.apply_rope(xt, pt, theta), jl.apply_rope(xj, pj, theta))


def test_ffn():
    rng = _rng(4)
    d, f = 32, 64
    w = {k: rng.standard_normal(s).astype(np.float32) / np.sqrt(s[0])
         for k, s in (("wi_gate", (d, f)), ("wi_up", (d, f)), ("wo", (f, d)))}
    xj, xt = _both(rng.standard_normal((2, 3, d)).astype(np.float32))
    _close(tl.ffn({k: torch.from_numpy(v) for k, v in w.items()}, xt),
           jl.ffn({k: jnp.asarray(v) for k, v in w.items()}, xj))
    with pytest.raises(NotImplementedError):
        tl.ffn({}, xt, act="gelu")


def test_matmul():
    rng = _rng(5)
    xj, xt = _both(rng.standard_normal((3, 7, 48)).astype(np.float32))
    wj, wt = _both(rng.standard_normal((48, 24)).astype(np.float32))
    _close(tl.matmul(xt, wt), jl.matmul(xj, wj))
    # an int8 {"q","scale"} leaf: the dequantized product at this token dim
    qj = {"q": jnp.clip(jnp.round(wj * 40), -127, 127).astype(jnp.int8),
          "scale": jnp.asarray(rng.uniform(0.01, 0.05, 24), jnp.float32)}
    qt = {k: torch.from_numpy(np.array(v)) for k, v in qj.items()}
    _close(tl.matmul(xt, qt), jl.matmul(xj, qj))


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 1)])
def test_project_qkv(H, Hkv, qk_norm):
    rng = _rng(6 + H + Hkv)
    d, D = 32, 16
    p = {"wq": rng.standard_normal((d, H * D)),
         "wk": rng.standard_normal((d, Hkv * D)),
         "wv": rng.standard_normal((d, Hkv * D)),
         "q_norm": 1.0 + 0.1 * rng.standard_normal(D),
         "k_norm": 1.0 + 0.1 * rng.standard_normal(D)}
    p = {k: (v / np.sqrt(d) if k.startswith("w") else v).astype(np.float32)
         for k, v in p.items()}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 5)).astype(np.int32)
    want = jattn._project_qkv({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), H, Hkv, D, jnp.asarray(pos),
                              10_000.0, qk_norm)
    got = tattn._project_qkv({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), H, Hkv, D,
                             torch.from_numpy(pos), 10_000.0, qk_norm)
    for g, w in zip(got, want):
        _close(g, w)


def test_dense_init_scales():
    """Same init scales as the reference (the numbers differ: torch and
    jax.random draw differently): fan-in truncated normal, 0.02 embed."""
    g = torch.Generator().manual_seed(0)
    w = tl.dense_init(torch.empty(256, 512), g)
    wj = np.asarray(jl.dense_init(jax.random.PRNGKey(0), 256, 512,
                                  jnp.float32))
    assert w.abs().max() <= 3.0 / np.sqrt(256) + 1e-6
    assert abs(float(w.std()) - wj.std()) < 0.01 * wj.std()
    e = tl.embed_init(torch.empty(512, 256), g)
    ej = np.asarray(jl.embed_init(jax.random.PRNGKey(1), 512, 256,
                                  jnp.float32))
    assert abs(float(e.std()) - ej.std()) < 0.01 * ej.std()
