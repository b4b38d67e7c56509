"""``chip_smoke.py`` and the port's CLI on the CPU: the smoke script
refuses to run without a card or without the port beside it, its roofline
bounds count exactly the work the inputs need, and ``launch/serve.py``
serves on the plain path when asked for the CPU."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


def test_smoke_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_smoke_needs_the_port_beside_it(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke, "SRC", tmp_path / "src")
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_decode_bound_counts_live_tokens(monkeypatch):
    """Bytes: q in, out back, and K and V of every token before its length
    on an allocated page (the sentinel page inside row 1 is not read)."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    H, Hkv, D, B, ctx = 8, 2, 16, 2, 100
    q, k, v, bt, lengths = chip_smoke.decode_inputs(torch, H, Hkv, D, B, ctx,
                                                    torch.float32, seed=0)
    assert lengths.tolist() == [100, 63]
    P = chip_smoke.PAGE
    tokens = 100 + (63 - P)                       # row 1 skips its page 1
    entries = math.ceil(100 / P) + math.ceil(63 / P)
    nbytes = 2 * B * H * D * 4 + 2 * tokens * Hkv * D * 4 + 4 * (entries + B)
    ms, by = chip_smoke.decode_cost(q, k, v, bt, lengths)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)


def test_prefill_bound_counts_visible_pairs(monkeypatch):
    """Operations: each real query against its segment's history and the
    causal part of its own chunk; pad segments and stream tail excluded."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    H, Hkv, D, ctx = 4, 2, 16, 64
    args, kw = chip_smoke.prefill_inputs(torch, H, Hkv, D, ctx,
                                         torch.float32, seed=0)
    lens, offs = [203, 77, 130, 45], [64, 37, 61, 0]
    pairs = sum(n * o + n * (n + 1) // 2 for n, o in zip(lens, offs))
    N, W = args[5].shape
    nbytes = (sum(lens) * (2 * H + 2 * Hkv) * D * 4
              + 2 * sum(offs) * Hkv * D * 4 + 4 * N * (3 + W))
    flops = 4.0 * pairs * H * D
    t_ops = flops / chip_smoke.PEAK_FLOPS["float32"] * 1e3
    t_bytes = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert t_ops > t_bytes
    ms, by = chip_smoke.prefill_cost(args, kw)
    assert by == "operations" and ms == pytest.approx(t_ops)
    # the plain version masks every NaN-poisoned slot the inputs carry
    from repro_torch.kernels import ref
    out = ref.packed_prefill_attention_ref(*args, **kw)
    assert torch.isfinite(out.float()).all()


@pytest.mark.parametrize("name,H,Hkv", [
    ("paged_decode_attention", 32, 8), ("paged_decode_attention", 32, 32),
    ("packed_prefill_attention", 32, 8)])
def test_bf16_tolerance_fails_a_dropped_tile(monkeypatch, name, H, Hkv):
    """The bf16 check passes the plain version run with unrounded (f32)
    softmax weights, which differs from the bf16 one by p rounding alone,
    and fails a result that skipped two pages (32 keys): of every
    sequence's 1963-token walk in decode, of the 4096-token history of the
    first segment in prefill, whose stream also holds rows that see only a
    few keys."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    from repro_torch.kernels import ref
    if name == "paged_decode_attention":
        plain, kw = ref.paged_decode_attention_ref, {}
        args = chip_smoke.decode_inputs(torch, H, Hkv, 128, 4, 1963,
                                        torch.bfloat16, seed=3)
        bt_at, rows, n_pages = 3, slice(None), args[1].shape[0]
    else:
        plain = ref.packed_prefill_attention_ref
        args, kw = chip_smoke.prefill_inputs(torch, H, Hkv, 128, 4096,
                                             torch.bfloat16, seed=3)
        bt_at, rows, n_pages = 5, 0, args[3].shape[0]
    want = plain(*args, **kw)
    abs_ctx = chip_smoke.abs_context(plain, name, args, kw)
    f32 = [x.float() if x.is_floating_point() else x for x in args]
    f32_p = plain(*f32, **kw).to(torch.bfloat16)
    assert chip_smoke.close(torch, f32_p, want, "bfloat16", abs_ctx)[1]
    dropped = list(args)
    dropped[bt_at] = args[bt_at].clone()
    dropped[bt_at][rows, 40:42] = n_pages       # sentinel: never read
    got = plain(*dropped, **kw)
    assert not chip_smoke.close(torch, got, want, "bfloat16", abs_ctx)[1]


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "20",
                       "--max-new", "5", "--prefill-chunk", "8",
                       "--page-size", "8", "--n-pages", "16"]) == 0
    out = capsys.readouterr().out
    assert "requests=3 tokens=15" in out
    assert "paged_decode_attention=0 packed_prefill_attention=0" in out
    assert np.isfinite(float(out.split("TTFT p50=")[1].split("ms")[0]))
    # the dense arena with whole-prompt prefill, above the 2048-token
    # threshold of the flash-attention route
    assert serve.main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu",
                       "--requests", "2", "--prompt-len", "2100",
                       "--max-new", "4", "--no-paged", "--max-len", "2176",
                       "--prefill-chunk", "0"]) == 0
    out = capsys.readouterr().out
    assert "chunk=0 requests=2 tokens=8" in out
    assert "kv=dense[4x2176]" in out
    assert "flash_attention=0 decode_attention=0" in out
    assert np.isfinite(float(out.split("TTFT p50=")[1].split("ms")[0]))


def test_gemv_bound_counts_weight_bytes(monkeypatch):
    """Bytes: the int8 weight once, its f32 scales, x in and out back; the
    operations at x's type are far below that."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    M, K, N = 4, 1100, 300
    x, w, scale = chip_smoke.gemv_inputs(torch, M, K, N, torch.bfloat16, 0)
    assert w.dtype == torch.int8 and scale.dtype == torch.float32
    nbytes = K * N + 4 * N + (M * K + M * N) * 2
    ms, by = chip_smoke.gemv_cost(x, w, scale)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)


def test_q4_bound_counts_packed_bytes(monkeypatch):
    """B1's live tokens at D/2 packed bytes plus a 4-byte scale per token
    and kv head a side; masked rows carry NaN scales the plain version
    never lets through."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    H, Hkv, D, B, ctx = 8, 2, 16, 2, 100
    args = chip_smoke.q4_inputs(torch, H, Hkv, D, B, ctx, torch.float32, 0)
    q, kp, ks, vp, vs, bt, lengths = args
    assert kp.dtype == torch.uint8 and kp.shape[-1] == D // 2
    assert torch.isnan(ks).any()
    P = chip_smoke.PAGE
    tokens = 100 + (63 - P)
    entries = math.ceil(100 / P) + math.ceil(63 / P)
    nbytes = (2 * B * H * D * 4 + 2 * tokens * Hkv * (D // 2 + 4)
              + 4 * (entries + B))
    ms, by = chip_smoke.q4_cost(*args)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
    from repro_torch.kernels import ref
    assert torch.isfinite(ref.paged_decode_attention_q4_ref(*args)).all()


@pytest.mark.parametrize("name", ["gemv", "paged_decode_attention_q4"])
def test_quantized_bf16_tolerance_fails_a_dropped_tile(monkeypatch, name):
    """The bf16 bound of the int8 GEMV and the int4 decode passes the same
    function summed in float64 and rounded to bf16 once, and fails a result
    that dropped 256 rows of K (GEMV, K = 4096) or two pages — 32 keys — of
    every sequence's 1963-token walk (int4 decode)."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    from repro_torch.kernels import ref
    if name == "gemv":
        args = chip_smoke.gemv_inputs(torch, 4, 4096, 512, torch.bfloat16, 3)
        x, w, scale = args
        want = ref.gemv_ref(*args)
        f64 = ((x.double() @ w.double()) * scale.double()).to(torch.bfloat16)
        dropped = x.clone()
        dropped[:, 256:512] = 0
        got = ref.gemv_ref(dropped, w, scale)
    else:
        args = chip_smoke.q4_inputs(torch, 32, 8, 128, 4, 1963,
                                    torch.bfloat16, 3)
        q, kp, ks, vp, vs, bt, lengths = args
        want = ref.paged_decode_attention_q4_ref(*args)
        kf, vf = chip_smoke.q4_dequantized(torch, *args[:5])
        f64 = ref.paged_decode_attention_ref(
            q.double(), kf.double(), vf.double(), bt, lengths
        ).to(torch.bfloat16)
        cut = bt.clone()
        cut[:, 40:42] = kp.shape[0]           # sentinel: never read
        got = ref.paged_decode_attention_q4_ref(q, kp, ks, vp, vs, cut,
                                                lengths)
    tol, A = chip_smoke.tolerance(torch, name, args, {}, "bfloat16")
    assert chip_smoke.close(torch, f64, want, "bfloat16", A, tol)[1]
    assert not chip_smoke.close(torch, got, want, "bfloat16", A, tol)[1]


@pytest.mark.parametrize("quantized", [False, True])
def test_gemv_f32_summation_bound_fails_a_dropped_k_tile(quantized):
    """The bound the ``bench`` phase holds the f32 GEMV to, at the benchmark
    runner's scale (x and w standard normal, K = 4096): it passes the
    product summed in float64 and rounded once to f32, and fails a result
    that left out a 32-row tile of K."""
    from repro_torch.kernels import ref
    from repro_torch.serving.quantized_weights import quantize_weight
    g = torch.Generator().manual_seed(5)
    x = torch.randn((1, 4096), generator=g)
    w = torch.randn((4096, 512), generator=g)
    if quantized:
        wq = quantize_weight(w)
        args = (x, wq["q"], wq["scale"])
    else:
        args = (x, w, None)
    want = ref.gemv_ref(*args)
    f64 = x.double() @ args[1].double()
    if quantized:   # the scale applies to the accumulator, as in the kernel
        f64 = f64 * args[2].double()
    f64 = f64.float()
    dropped = x.clone()
    dropped[:, 2048:2080] = 0
    tol, A = chip_smoke.summation_tolerance(torch, "gemv", args, {},
                                            "float32")
    assert chip_smoke.close(torch, f64, want, "float32", A, tol)[1]
    assert not chip_smoke.close(torch, ref.gemv_ref(dropped, *args[1:]),
                                want, "float32", A, tol)[1]


def test_flash_bound_counts_visible_pairs(monkeypatch):
    """Operations: 4 B H D per query-key pair the causal (and windowed)
    mask lets through; bytes: q, k and v read and the output written."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    B, H, Hkv, D, T = 2, 8, 2, 16, 2000
    for window, pairs in ((0, T * (T + 1) // 2),
                          (300, 300 * 301 // 2 + (T - 300) * 300)):
        args, kw = chip_smoke.flash_inputs(torch, H, Hkv, D, B, T, window,
                                           torch.float32, seed=0)
        flops = 4.0 * B * H * D * pairs
        nbytes = (2 * B * H + 2 * B * Hkv) * T * D * 4
        t_ops = flops / chip_smoke.PEAK_FLOPS["float32"] * 1e3
        assert t_ops > nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
        ms, by = chip_smoke.flash_cost(args, kw)
        assert by == "operations" and ms == pytest.approx(t_ops)


def test_dense_decode_bound_counts_valid_rows(monkeypatch):
    """Bytes: q in, out back, K and V of every position before its row's
    length, and the lengths; rows past a length hold NaN that the plain
    version never lets through."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    H, Hkv, D, S = 8, 2, 16, 300
    q, k, v, lengths = chip_smoke.dense_decode_inputs(torch, H, Hkv, D, 4, S,
                                                      torch.float32, seed=0)
    assert lengths.tolist() == [1, 2049, S, 777]
    tokens = sum(min(n, S) for n in lengths.tolist())
    nbytes = 2 * 4 * H * D * 4 + 2 * tokens * Hkv * D * 4 + 4 * 4
    ms, by = chip_smoke.dense_decode_cost(q, k, v, lengths)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
    from repro_torch.kernels import ref
    assert torch.isfinite(ref.decode_attention_ref(q, k, v, lengths)).all()


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention"])
def test_dense_bf16_tolerance_fails_a_dropped_tile(monkeypatch, name):
    """The bf16 bound of B5 and B6 passes the plain version run with
    unrounded (f32) softmax weights, and fails a result that skipped one
    32-key tile of a 2048-token prompt (B5: keys 64..95, hidden from every
    later query) or one 128-token split of the dense walk (B6: positions
    1024..1151, inside the rows of lengths 2049 and 4160)."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    from repro_torch.kernels import ref
    from repro_torch.models.attention import _dense_attention
    if name == "flash_attention":
        plain = ref.flash_attention_ref
        args, kw = chip_smoke.flash_inputs(torch, 8, 2, 128, 1, 2048, 0,
                                           torch.bfloat16, seed=3)
        q, k, v = (x.transpose(1, 2) for x in args)
        pos = torch.arange(2048)[None]
        hole = pos.clone()
        hole[:, 64:96] = 1 << 20                 # after every query
        got = _dense_attention(q, k, v, pos, hole, 0, 0.0).transpose(1, 2)
    else:
        plain, kw = ref.decode_attention_ref, {}
        args = chip_smoke.dense_decode_inputs(torch, 32, 8, 128, 4, 4160,
                                              torch.bfloat16, seed=3)
        q, k, v, lengths = args
        B, S, Hkv, D = k.shape
        P = 32                                   # the arena as 32-token pages
        bt = torch.arange(B * S // P, dtype=torch.int32).reshape(B, S // P)
        bt[:, 1024 // P:1152 // P] = B * S // P  # sentinel: never read
        got = ref.paged_decode_attention_ref(
            q, k.reshape(-1, P, Hkv, D), v.reshape(-1, P, Hkv, D), bt,
            lengths)
    want = plain(*args, **kw)
    abs_ctx = chip_smoke.abs_context(plain, name, args, kw)
    f32 = [x.float() if x.is_floating_point() else x for x in args]
    f32_p = plain(*f32, **kw).to(torch.bfloat16)
    assert chip_smoke.close(torch, f32_p, want, "bfloat16", abs_ctx)[1]
    assert not chip_smoke.close(torch, got, want, "bfloat16", abs_ctx)[1]


def test_serve_cli_stop_tokens_as_the_reference(capsys):
    """``--stop-token`` is repeatable and feeds ``SamplingParams.stop`` in
    both CLIs: with every id of the reduced vocabulary a stop token, every
    request stops at its first token with finish reason "stop"."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve
    argv = ["--arch", "llama2-7b", "--reduced", "--requests", "3",
            "--prompt-len", "12", "--max-new", "4", "--max-len", "64",
            "--no-paged"]
    stops = [a for i in range(256) for a in ("--stop-token", str(i))]
    assert serve.main(argv + ["--device", "cpu"] + stops) == 0
    ours = capsys.readouterr().out
    assert jax_serve.main([a for a in argv if a != "--no-paged"] + stops) == 0
    want = capsys.readouterr().out
    for out in (ours, want):
        assert "requests=3 tokens=3 " in out and "finish[stop=3]" in out
    assert serve.main(argv + ["--device", "cpu", "--max-new", "2"]) == 0
    assert "finish[length=3]" in capsys.readouterr().out


def test_serve_cli_mamba2_on_cpu(capsys):
    """mamba2 serves on the dense arena with whole-prompt prefill (the SSD
    chunk kernel's plain version here); the paged pool is refused with the
    reference's error."""
    from repro_torch.launch import serve
    argv = ["--arch", "mamba2-2.7b", "--reduced", "--device", "cpu",
            "--requests", "2", "--prompt-len", "64", "--max-new", "4"]
    assert serve.main(argv + ["--no-paged", "--max-len", "96",
                              "--prefill-chunk", "0"]) == 0
    out = capsys.readouterr().out
    assert "requests=2 tokens=8" in out and "kv=dense[4x96]" in out
    assert "ssd_chunk=0" in out
    assert np.isfinite(float(out.split("TTFT p50=")[1].split("ms")[0]))
    with pytest.raises(ValueError, match="all-attention plan"):
        serve.main(argv + ["--paged"])


def test_ssd_bound_counts_the_causal_half(monkeypatch):
    """Bytes: x, dt, A, B, C read once, y and the states written once (f32);
    operations: C B^T and the weighted product over the Q(Q+1)/2 pairs
    j <= i, and the state's 2 Q N P per chunk and head."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    nc, H, Q, P, N = 2, 8, 40, 16, 32
    args = chip_smoke.ssd_inputs(torch, nc, H, Q, P, N, torch.bfloat16, 0)
    x, dt, A, B, C = args
    assert x.dtype == B.dtype == torch.bfloat16 and dt.dtype == torch.float32
    assert (dt > 0).all() and (A < 0).all()
    pairs = Q * (Q + 1) // 2
    flops = nc * (2 * pairs * N + H * (2 * pairs * P + 2 * Q * N * P))
    nbytes = (2 * (nc * H * Q * P + 2 * nc * Q * N) + 4 * (nc * H * Q + H)
              + 4 * nc * H * (Q * P + N * P))
    t_ops = flops / chip_smoke.PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
    ms, by = chip_smoke.ssd_cost(*args)
    assert ms == pytest.approx(max(t_ops, t_bytes))
    assert by == ("operations" if t_ops > t_bytes else "bytes")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_tolerance_fails_a_dropped_row_tile(monkeypatch, dtype):
    """B7's bound passes the same function computed in float64 and rounded
    to f32, and fails a result missing one 64-row tile of one block's four
    heads (rows 64..127 of heads 0..3 of chunk 1), at mamba2's P and N and
    a full 256-token chunk."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    from repro_torch.kernels import ref
    args = chip_smoke.ssd_inputs(torch, 2, 8, 256, 64, 128, dtype, 5)
    want = ref.ssd_chunk_ref(*args)
    tol, A = chip_smoke.tolerance(torch, "ssd_chunk", args, {}, "float32")
    x, dt, a, B, C = (t.double() for t in args)
    cs = torch.cumsum(dt * a[None, :, None], dim=-1)
    Q = x.shape[2]
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    L = torch.exp(torch.where(tri, cs[..., :, None] - cs[..., None, :],
                              -math.inf))
    xb = x * dt[..., None]
    f64 = ((C @ B.transpose(-1, -2))[:, None] * L @ xb,
           B.transpose(-1, -2)[:, None]
           @ (xb * torch.exp(cs[..., -1:] - cs)[..., None]))
    f64 = tuple(t.to(torch.float32) for t in f64)
    assert chip_smoke.close(torch, chip_smoke.flat(f64),
                            chip_smoke.flat(want), "float32", A, tol)[1]
    y = want[0].clone()
    y[1, 0:4, 64:128] = 0
    assert not chip_smoke.close(torch, chip_smoke.flat((y, want[1])),
                                chip_smoke.flat(want), "float32", A, tol)[1]


def test_gemm_bound_counts_operations(monkeypatch):
    """B8: bytes are x and w read once and the product written once,
    operations 2 M K N; at 2048 x 4096 x 12288 the operations bind, 0.208 ms
    in bf16 and 3.08 ms at the f32 peak; at M = 37 the weight bytes do."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    for (M, K, N), dtype, want, by in (
            ((2048, 4096, 12288), torch.bfloat16, 0.208, "operations"),
            ((2048, 4096, 12288), torch.float32, 3.08, "operations"),
            ((37, 4096, 4096), torch.bfloat16, 0.0102, "bytes")):
        x = torch.zeros((M, K), dtype=dtype)
        w = torch.zeros((K, N), dtype=dtype)
        nbytes = (M * K + K * N + M * N) * x.element_size()
        t_ops = 2 * M * K * N / chip_smoke.PEAK_FLOPS[str(dtype)[6:]] * 1e3
        ms, got_by = chip_smoke.gemm_cost(x, w)
        assert ms == pytest.approx(max(
            t_ops, nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3))
        assert ms == pytest.approx(want, rel=0.01) and got_by == by


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_tolerance_fails_a_dropped_k_tile(monkeypatch, dtype):
    """B8's bound passes the product summed in float64 and rounded once to
    x's dtype, and fails one that left out a 32-row tile of K (K = 4096),
    as B3's does."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    from repro_torch.kernels import ref
    x, w = chip_smoke.gemm_inputs(torch, 64, 4096, 256, dtype, 3)
    want = ref.matmul_ref(x, w)
    f64 = (x.double() @ w.double()).to(dtype)
    dropped = x.clone()
    dropped[:, 1024:1056] = 0
    dt = chip_smoke.dtype_name(x)
    tol, A = chip_smoke.tolerance(torch, "matmul", (x, w), {}, dt)
    assert chip_smoke.close(torch, f64, want, dt, A, tol)[1]
    assert not chip_smoke.close(torch, ref.matmul_ref(dropped, w), want, dt,
                                A, tol)[1]


def test_prefill_bound_counts_window_pairs(monkeypatch):
    """Over a sliding-window pool whose history has wrapped, the operations
    count each query's keys inside its window only, and the bytes the
    history positions some query sees: the same totals as counting the
    plain version's own mask pair by pair."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    from repro_torch.kernels import ref
    from repro_torch.models.attention import _gather_history
    H, Hkv, D = 4, 2, 16
    args, kw = chip_smoke.ring_prefill_inputs(torch, H, Hkv, D,
                                              torch.float32, seed=1)
    q, _, _, kp, vp, bt, starts, offs, lens = args
    assert kw["ring"] < min(offs[:2].tolist())   # the history has wrapped
    _, _, pos = _gather_history(kp, vp, bt, offs, kw["ring"])
    pairs = seen_total = 0
    for n in range(len(lens)):
        m, off = int(lens[n]), int(offs[n])
        if m <= 0 or int(starts[n]) >= q.shape[0]:
            continue
        seen = torch.zeros_like(pos[n], dtype=torch.bool)
        for i in range(m):
            vis = (pos[n] >= 0) & (off + i - pos[n] < kw["window"])
            seen |= vis
            pairs += int(vis.sum()) + min(i + 1, kw["window"])
        seen_total += int(seen.sum())
    nbytes = (int(lens.sum()) * (2 * H + 2 * Hkv) * D * 4
              + 2 * seen_total * Hkv * D * 4
              + 4 * len(lens) * (3 + bt.shape[1]))
    want = chip_smoke.bound(nbytes, 4.0 * pairs * H * D, "float32")
    assert chip_smoke.prefill_cost(args, kw) == pytest.approx(want)
    # the plain version masks every NaN-poisoned slot of the pool
    out = ref.packed_prefill_attention_ref(*args, **kw)
    assert torch.isfinite(out).all()


def test_require_routes_takes_one_route_or_one_per_kernel():
    """``bench`` runs B8 on both routes (its f32 row on the tile, its bf16
    row on the tensor cores) and the other two-route kernels on the tile;
    a count on the wrong route, or a missing one, fails."""
    launches = {"flash_attention": 21, "packed_prefill_attention": 21,
                "gemv": 42, "matmul": 42}
    routes = {"flash_attention": {"wgmma": 0, "tile": 21},
              "packed_prefill_attention": {"wgmma": 0, "tile": 21},
              "gemv": {"wgmma": 0, "tile": 42},
              "matmul": {"wgmma": 21, "tile": 21}}
    want = {"matmul": {"wgmma": 21, "tile": 21}, "gemv": "tile",
            "flash_attention": "tile", "packed_prefill_attention": "tile"}
    chip_smoke.require_routes("bench", routes, launches, want)
    with pytest.raises(AssertionError, match="matmul"):
        chip_smoke.require_routes("bench", routes, launches, "tile")
    routes["gemv"] = {"wgmma": 1, "tile": 41}
    with pytest.raises(AssertionError, match="gemv"):
        chip_smoke.require_routes("bench", routes, launches, want)
    idle = {name: 0 for name in launches}
    chip_smoke.require_routes("serve", {n: {"wgmma": 0, "tile": 0}
                                        for n in idle}, idle, "wgmma")


def test_phase_ab_refuses_a_tree_without_chip_smoke(tmp_path):
    """``scripts/torch_phase_ab.py`` runs a phase only from checkouts that
    hold ``chip_smoke.py``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_phase_ab", ROOT / "scripts" / "torch_phase_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    with pytest.raises(SystemExit, match="no chip_smoke.py"):
        ab.main(["--phase", "serve_quantized", "--trees", str(tmp_path)])
