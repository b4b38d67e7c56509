"""The port's kernel layer on the CPU: the plain PyTorch versions of paged
decode attention and packed prefill attention against the JAX package's
Pallas kernels (interpret mode) and pure-JAX references, and the
dispatcher's device rule.  Inputs are drawn with numpy and handed to both
sides; everything is f32."""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import \
    paged_decode_attention as jax_paged_decode
from repro.kernels.flash_attention import \
    packed_prefill_attention as jax_packed_prefill
from repro.models.attention import _packed_attention_jax
from repro.models.attention import make_packed_segs as jax_make_packed_segs
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import decode_attention as cuda_decode
from repro_torch.kernels import flash_attention as cuda_prefill


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- paged decode attention ------------------------------------------------------

def _decode_case(rng, H, Hkv, D, P, lengths=None):
    """Ragged lengths over a shared pool (by default W P, 2 P + 1 and 3 over
    5 pages a row), one sentinel page inside a row's length, unused pages
    (including the one a sentinel clamps to) and the rows past each length
    poisoned with NaN."""
    if lengths is None:
        B, W, n_pages = 3, 5, 20
        lengths = np.array([W * P, 2 * P + 1, 3], np.int32)
    else:
        lengths = np.array(lengths, np.int32)
        B, W = len(lengths), -(-int(lengths.max()) // P) + 1
        n_pages = sum(-(-int(n) // P) for n in lengths) + 4
    order = list(rng.permutation(n_pages - 1))
    bt = np.full((B, W), n_pages, np.int32)
    kp = rng.standard_normal((n_pages, P, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((n_pages, P, Hkv, D)).astype(np.float32)
    for b in range(B):
        for i in range(-(-int(lengths[b]) // P)):
            bt[b, i] = order.pop()
    bt[0, 2] = n_pages                        # skipped whole
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    poisoned_k, poisoned_v = kp.copy(), vp.copy()
    used = set(bt.ravel().tolist())
    for p in range(n_pages):
        if p not in used:
            poisoned_k[p] = np.nan
            poisoned_v[p] = np.nan
    for b in range(B):
        n = int(lengths[b])
        last = bt[b, (n - 1) // P]
        if n % P and last < n_pages:
            poisoned_k[last, n % P:] = np.nan
            poisoned_v[last, n % P:] = np.nan
    return q, kp, vp, poisoned_k, poisoned_v, bt, lengths


# lengths at the edges of the card's walk (csrc/decode_split.cuh), longest
# first (the sentinel page sits inside it): stages of 32/64 tokens +-1,
# splits of 128/256 +-1, lengths ending inside a 16-token page
_EDGE_LENGTHS = (300, 1, 31, 33, 63, 65, 127, 129, 255, 257)


@pytest.mark.parametrize("P,lengths", [
    pytest.param(4, None, id="4"), pytest.param(8, None, id="8"),
    pytest.param(16, _EDGE_LENGTHS, id="16-edges")])
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 1), (8, 2)])
def test_paged_decode_ref_matches_pallas(H, Hkv, D, P, lengths):
    rng = np.random.default_rng(H * 1000 + Hkv * 100 + D + P)
    q, kp, vp, pk, pv, bt, lengths = _decode_case(rng, H, Hkv, D, P, lengths)
    want = np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lengths), interpret=True))
    got = ref.paged_decode_attention_ref(_t(q), _t(kp), _t(vp), _t(bt),
                                         _t(lengths)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # NaN on every masked row and unused page changes nothing
    poisoned = ref.paged_decode_attention_ref(_t(q), _t(pk), _t(pv), _t(bt),
                                              _t(lengths)).numpy()
    assert np.isfinite(poisoned).all()
    np.testing.assert_allclose(poisoned, got, atol=1e-6, rtol=0)


# -- packed prefill attention ----------------------------------------------------

def _align_up(x, a):
    return -(-x // a) * a


def _prefill_case(rng, segs, Hkv, G, D, P, W, n_pages, align):
    """segs: (take, offset, pages) per segment; a segment with take 0 is a
    pad segment (start == T, all-sentinel row)."""
    H = Hkv * G
    starts, cur = [], 0
    for take, _, _ in segs:
        starts.append(cur)
        cur = _align_up(cur + take, align)
    T = max(cur, align) + align                # rows past every segment
    starts = np.array(starts, np.int32)
    starts[[i for i, s in enumerate(segs) if s[0] == 0]] = T
    offs = np.array([o for _, o, _ in segs], np.int32)
    lens = np.array([t for t, _, _ in segs], np.int32)
    bt = np.full((len(segs), W), n_pages, np.int32)
    for i, (_, _, pgs) in enumerate(segs):
        bt[i, :len(pgs)] = pgs
    arrays = dict(
        q=rng.standard_normal((T, H, D)), kn=rng.standard_normal((T, Hkv, D)),
        vn=rng.standard_normal((T, Hkv, D)),
        kp=rng.standard_normal((n_pages, P, Hkv, D)),
        vp=rng.standard_normal((n_pages, P, Hkv, D)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return arrays, bt, starts, offs, lens, T, H


def _jax_prev_pos(bt, offs, ring, P, n_pages):
    """History positions exactly as attention.py:697-703 builds them."""
    S = bt.shape[1] * P
    s_idx = np.arange(S, dtype=np.int32)
    prev_pos = offs[:, None] - 1 - ((offs[:, None] - 1 - s_idx) % ring)
    prev_pos = np.where(s_idx[None, :] < ring, prev_pos, -1)
    return np.where(np.repeat(bt >= n_pages, P, axis=1), -1, prev_pos)


def _port_ref(a, bt, starts, offs, lens, ring, window):
    return ref.packed_prefill_attention_ref(
        _t(a["q"]), _t(a["kn"]), _t(a["vn"]), _t(a["kp"]), _t(a["vp"]),
        _t(bt), _t(starts), _t(offs), _t(lens), ring=ring,
        window=window).numpy()


def test_packed_prefill_ref_matches_pallas():
    """Multi-segment stream with history, a wrapped sliding-window ring and
    an all-sentinel pad segment (the case of test_packed_prefill.py), held
    on the rows of real segments."""
    rng = np.random.default_rng(1)
    Hkv, G, D, P, W, n_pages = 2, 2, 16, 8, 4, 16
    ring, window, bq = 16, 16, 8
    segs = [(6, 21, [2, 3, 4, 5]), (11, 18, [7, 8, 9, 10]), (0, 0, [])]
    a, bt, starts, offs, lens, T, H = _prefill_case(
        rng, segs, Hkv, G, D, P, W, n_pages, bq)
    want = np.asarray(jax_packed_prefill(
        *(jnp.asarray(a[k]) for k in ("q", "kn", "vn", "kp", "vp")),
        jnp.asarray(bt), jnp.asarray(starts), jnp.asarray(offs),
        jnp.asarray(lens), ring=ring, window=window, bq=bq, interpret=True))
    got = _port_ref(a, bt, starts, offs, lens, ring, window)
    valid = np.asarray(jax_make_packed_segs(
        starts, offs, lens, np.arange(len(segs), dtype=np.int32), T).valid)
    np.testing.assert_allclose(got[valid], want[valid], atol=2e-5, rtol=0)
    assert not got[~valid].any()               # rows outside segments: zero


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("Hkv,G", [(2, 2), (1, 4), (4, 1)])
def test_packed_prefill_ref_unaligned_stream(Hkv, G, window):
    """A pack_align=8 stream whose segments start at no 16- or 64-token
    tile boundary — the layout the Pallas kernel cannot take (its query
    tiles must not straddle segments) and the Hopper kernel must.  Held
    against the pure-JAX ``_packed_attention_jax`` on every real row."""
    rng = np.random.default_rng(10 * Hkv + G + window)
    D, P, W, n_pages = 16, 8, 6, 32
    ring = n_pages * P
    # takes 5, 11, 19, 3 at starts 0, 8, 24, 48; histories 0, 13, 40, 7
    segs = [(5, 0, [0]), (11, 13, [1, 2, 3]), (19, 40, [4, 5, 6, 7, 8, 9]),
            (3, 7, [10, 11]), (0, 0, [])]
    a, bt, starts, offs, lens, T, H = _prefill_case(
        rng, segs, Hkv, G, D, P, W, n_pages, 8)
    assert list(starts[:4]) == [0, 8, 24, 48]
    seg = jax_make_packed_segs(starts, offs, lens,
                               np.arange(len(segs), dtype=np.int32), T)
    pages = np.clip(bt, 0, n_pages - 1)
    S = W * P
    prev_k = jnp.asarray(a["kp"][pages].reshape(len(segs), S, Hkv, D))
    prev_v = jnp.asarray(a["vp"][pages].reshape(len(segs), S, Hkv, D))
    want = np.asarray(_packed_attention_jax(
        jnp.asarray(a["q"]), jnp.asarray(a["kn"]), jnp.asarray(a["vn"]),
        prev_k, prev_v, jnp.asarray(_jax_prev_pos(bt, offs, ring, P, n_pages)),
        seg, n_heads=H, n_kv_heads=Hkv, d_head=D, window=jnp.int32(window),
        softcap=0.0)).reshape(T, H, D)
    got = _port_ref(a, bt, starts, offs, lens, ring, window)
    valid = np.asarray(seg.valid)
    np.testing.assert_allclose(got[valid], want[valid], atol=2e-5, rtol=0)


# -- the dispatcher and the wrappers' guards -------------------------------------

def test_ops_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(3)
    q, kp, vp, _, _, bt, lengths = _decode_case(rng, 4, 2, 16, 4)
    args = (_t(q), _t(kp), _t(vp), _t(bt), _t(lengths))
    torch.testing.assert_close(ops.paged_decode_attention(*args),
                               ref.paged_decode_attention_ref(*args),
                               atol=0, rtol=0)
    a, bt, starts, offs, lens, _, _ = _prefill_case(
        rng, [(5, 3, [0, 1]), (0, 0, [])], 2, 2, 16, 4, 3, 8, 8)
    pargs = (_t(a["q"]), _t(a["kn"]), _t(a["vn"]), _t(a["kp"]), _t(a["vp"]),
             _t(bt), _t(starts), _t(offs), _t(lens))
    torch.testing.assert_close(
        ops.packed_prefill_attention(*pargs, ring=32),
        ref.packed_prefill_attention_ref(*pargs, ring=32), atol=0, rtol=0)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors or raise: nothing falls
    back to the plain version, and nothing is counted as a launch."""
    rng = np.random.default_rng(4)
    q, kp, vp, _, _, bt, lengths = _decode_case(rng, 4, 2, 16, 4)
    n0 = cuda_decode.paged_decode_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        cuda_decode.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                           _t(lengths))
    assert cuda_decode.paged_decode_attention.launches == n0
    a, bt, starts, offs, lens, _, _ = _prefill_case(
        rng, [(5, 3, [0, 1])], 2, 2, 16, 4, 3, 8, 8)
    n0 = cuda_prefill.packed_prefill_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        cuda_prefill.packed_prefill_attention(
            _t(a["q"]), _t(a["kn"]), _t(a["vn"]), _t(a["kp"]), _t(a["vp"]),
            _t(bt), _t(starts), _t(offs), _t(lens), ring=32)
    assert cuda_prefill.packed_prefill_attention.launches == n0


def test_ops_refuse_other_devices():
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.paged_decode_attention(torch.zeros((1, 4, 16), device="meta"),
                                   None, None, None, None)


@pytest.mark.parametrize("bad", ["device", "dtype", "contiguous"])
def test_check_tensors_refuses(bad):
    x = torch.zeros((4, 8))
    y = {"device": torch.zeros((4, 8), device="meta"),
         "dtype": torch.zeros((4, 8), dtype=torch.float64),
         "contiguous": torch.zeros((8, 4)).t()}[bad]
    with pytest.raises(ValueError):
        _build.check_tensors("k", [x, y], torch.float32, x.device)


def test_build_is_keyed_by_the_sources():
    """The library path carries a digest of every source and the flags, so
    an edited source is rebuilt rather than loaded stale."""
    path = _build._so_path("paged_decode_attention")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("paged_decode_attention-")
    assert _build._digest() in path.name
    assert set(_build.SIGNATURES) == set(_build.KERNELS)
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()


# -- the two routes of the prefill kernels ---------------------------------------

@pytest.mark.parametrize("dtype,head_dim,page_size,want", [
    (torch.bfloat16, 64, 8, "wgmma"), (torch.bfloat16, 128, 8, "wgmma"),
    (torch.bfloat16, 128, 16, "wgmma"), (torch.bfloat16, 128, 8192, "wgmma"),
    (torch.bfloat16, 128, 12, "tile"), (torch.bfloat16, 16, 8, "tile"),
    (torch.float32, 16, 8, "tile"), (torch.float32, 64, 8, "tile"),
    (torch.float32, 128, 16, "tile")])
def test_prefill_route_by_dtype_and_head_dim(dtype, head_dim, page_size,
                                             want):
    """bf16 at head dim 64 and 128 (every full-width main path) runs on the
    tensor cores, over pool pages of a multiple of 8 tokens (one TMA box is
    at least 8 rows); f32 (no IEEE tensor-core mode), the reduced configs'
    head dim 16 and other page sizes on the CUDA-core tile.  Both wrappers
    count each route."""
    assert cuda_prefill.route(dtype, head_dim, page_size) == want
    if page_size == 8:                  # B5 has no pages: the default
        assert cuda_prefill.route(dtype, head_dim) == want
    for fn in (cuda_prefill.flash_attention,
               cuda_prefill.packed_prefill_attention):
        assert set(fn.routes) == {"wgmma", "tile"}


@pytest.mark.parametrize("offset,bad", [
    (0, False), (2, True), (8, True), (14, True), (16, False), (48, False),
    (4096 + 6, True)])
def test_tensor_core_route_alignment_rule(offset, bad):
    """TMA needs 16-byte aligned base addresses: the rule as arithmetic on
    an address, and the wrappers' check on a bf16 view that starts
    ``offset`` bytes into an aligned buffer."""
    assert cuda_prefill.misaligned(offset) is bad
    buf = torch.zeros(4096, dtype=torch.bfloat16)
    first = (-buf.data_ptr() % cuda_prefill.ALIGN) // 2   # aligned element
    view = buf[first + offset // 2:]
    if bad:
        with pytest.raises(ValueError, match="aligned"):
            cuda_prefill.check_aligned("k", [buf[first:], view])
    else:
        cuda_prefill.check_aligned("k", [buf[first:], view])


def test_route_codes_match_the_c_header():
    """The wrapper passes its route to the C entry point as the code that
    ``csrc/common.cuh`` gives it."""
    text = (_build.CSRC / "common.cuh").read_text()
    m = re.search(r"enum \{ ROUTE_TILE = (\d+), ROUTE_WGMMA = (\d+) \};", text)
    assert cuda_prefill.ROUTE_CODES == {"tile": int(m[1]), "wgmma": int(m[2])}


@pytest.mark.parametrize("name", _build.KERNELS)
def test_signature_matches_the_c_entry_point(name):
    """Each ctypes signature has one argument per parameter of its C entry
    point, of the parameter's kind: int, float or a pointer."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src, re.S)
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    kinds = [ctypes.c_int if p.split()[0] == "int"
             else ctypes.c_float if p.split()[0] == "float"
             else ctypes.c_void_p if "*" in p else None for p in params]
    assert kinds == _build.SIGNATURES[name], params


def test_ptxas_report_parsed_per_kernel():
    """Registers, stack and spills of each kernel in an ``nvcc -Xptxas -v``
    report; a device function (no register line) is not a kernel."""
    text = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    8 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 360 bytes cmem[0]
ptxas info    : Function properties for _Z6helperv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 153 registers, used 1 barriers, 384 bytes cmem[0]
"""
    assert _build.parse_ptxas(text) == [
        dict(kernel="_Z3fooPf", stack=8, spill_stores=16, spill_loads=12,
             registers=255),
        dict(kernel="_Z3barv", stack=0, spill_stores=0, spill_loads=0,
             registers=153)]
    assert "-v" in _build.NVCC_FLAGS     # every build keeps its report
