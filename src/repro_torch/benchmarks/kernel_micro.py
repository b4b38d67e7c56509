"""Kernel micro-benchmarks of the port: the rows of the reference's
``benchmarks/kernel_micro.py``, in its order, through ``kernels/ops.py``.

Two kinds of rows:

- analytic (``h100_*``, savings, arithmetic intensity): the least time the
  H100 could take for a shape — bytes over 3.35 TB/s, operations over
  989 TFLOP/s (bf16 dense) — computed from the shape, never measured;
- timed (``<device>_us``): on ``cuda`` the CUDA-event median of the
  hand-written kernel over ``CUDA_REPS`` calls after a warm-up call that
  builds it; on ``cpu`` the host wall time of the plain versions
  (``kernels/ref.py``), which is no device metric.

On the card one more timed row runs B8 (``matmul``) at the analytic rows'
own shape, 2048 x 4096 x 12288 in bf16.  Inputs come from a seeded
``torch.Generator`` on the device.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.serving.quantized_weights import quantize_weight

Row = Tuple[str, float, str, str]

PEAK = 989e12          # H100 bf16 dense FLOP/s
BW = 3.35e12           # H100 HBM bytes/s
CPU_REPS = 3
CUDA_REPS = 20


def _time_us(fn, device: torch.device) -> float:
    """Microseconds per call of ``fn`` after one warm-up call: the median
    of CUDA-event times on the card, the mean host wall time on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(CPU_REPS):
            fn()
        return (time.perf_counter() - t0) / CPU_REPS * 1e6
    torch.cuda.synchronize(device)
    times = []
    for _ in range(CUDA_REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3)
    times.sort()
    return times[len(times) // 2]


def bench_kernels(device="cuda") -> List[Row]:
    dev = resolve_device(device)
    tag = dev.type
    rows: List[Row] = []
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    # decode GEMV at llama2-7b FFN shape, bf16 vs int8.  The analytical
    # rows are the H100 HBM bound (weight bytes / BW); the timed rows run
    # f32 and int8 weights through the GEMV (B3) at a production shape
    K, N, B = 4096, 11008, 1
    x = randn(B, K)
    w = randn(K, N).to(torch.bfloat16)
    wq = quantize_weight(w.float())
    t_bf16 = K * N * 2 / BW
    t_int8 = K * N * 1 / BW
    rows.append(("kernel.gemv.bf16.h100_bound_us", t_bf16 * 1e6, "us", ""))
    rows.append(("kernel.gemv.int8.h100_bound_us", t_int8 * 1e6, "us", ""))
    rows.append(("kernel.gemv.int8_traffic_saving", t_bf16 / t_int8, "x", ""))
    wf = w.float()
    us = _time_us(lambda: ops.gemv(x, wf), dev)
    rows.append((f"kernel.gemv.f32.{tag}_us", us, "us", ""))
    us = _time_us(lambda: ops.gemv(x, wq["q"], wq["scale"]), dev)
    rows.append((f"kernel.gemv.int8.{tag}_us", us, "us", ""))

    # prefill GEMM (B8) at llama2 qkv shape
    M, K2, N2 = 2048, 4096, 12288
    t_flops = 2 * M * K2 * N2 / PEAK
    t_bytes = (M * K2 + K2 * N2 + M * N2) * 2 / BW
    rows.append(("kernel.matmul.h100_compute_us", t_flops * 1e6, "us", ""))
    rows.append(("kernel.matmul.h100_memory_us", t_bytes * 1e6, "us", ""))
    rows.append(("kernel.matmul.arith_intensity",
                 2 * M * K2 * N2 / ((M * K2 + K2 * N2 + M * N2) * 2),
                 "flops/B", ""))
    xs = randn(256, 512)
    ws = randn(512, 256)
    us = _time_us(lambda: ops.matmul(xs, ws, bm=128, bn=128, bk=256), dev)
    rows.append((f"kernel.matmul.{tag}_us", us, "us", ""))
    if tag == "cuda":
        xb = randn(M, K2).to(torch.bfloat16)
        wb = randn(K2, N2).to(torch.bfloat16)
        us = _time_us(lambda: ops.matmul(xb, wb), dev)
        rows.append((f"kernel.matmul.bf16_{M}x{K2}x{N2}.cuda_us", us, "us",
                     ""))
        del xb, wb

    # flash decode (B6) at 32k cache
    S, Hkv, D, H = 32768, 8, 128, 32
    kv_bytes = 2 * S * Hkv * D * 2
    rows.append(("kernel.decode_attn.h100_bound_us", kv_bytes / BW * 1e6,
                 "us", ""))
    qq = randn(1, H, D)
    kc = randn(1, 2048, Hkv, D)
    vc = randn(1, 2048, Hkv, D)
    lengths = i32([2048])
    us = _time_us(lambda: ops.decode_attention(qq, kc, vc, lengths), dev)
    rows.append((f"kernel.decode_attn.{tag}_us", us, "us", ""))

    # prefill flash attention (B5): causal tiling skips the strict upper
    # triangle of the [T, T] score grid — at nq = nk tiles of 128 tokens the
    # executed tile count is nk(nk+1)/2 of nk^2, -> 2x as T grows
    T2, H2, Hkv2, D2 = 256, 8, 4, 64
    bq = 128
    nk = T2 // bq
    rows.append(("kernel.flash_attn.causal_skip_saving",
                 nk * nk / (nk * (nk + 1) / 2), "x", ""))
    flops = 4 * H2 * T2 * T2 * D2 / 2          # causal half of QK^T + PV
    rows.append(("kernel.flash_attn.h100_compute_us",
                 flops / PEAK * 1e6, "us", ""))
    qp = randn(1, H2, T2, D2)
    kp = randn(1, Hkv2, T2, D2)
    vp = randn(1, Hkv2, T2, D2)
    us = _time_us(lambda: ops.flash_attention(qp, kp, vp), dev)
    rows.append((f"kernel.flash_attn.{tag}_us", us, "us", ""))

    # packed multi-request prefill (B2): the same T-token budget as ONE
    # multi-segment stream over the paged arena (serving's packed chunk
    # path) — vs the padded [N, C] batch the engine would otherwise launch,
    # whose row count is N * max(take) rather than ~sum(take)
    P, W, n_pages = 16, 8, 32
    bp = 64                                    # segment alignment
    takes = [192, 64, 48, 32]                  # mixed-length tick
    starts, cur = [], 0
    for t in takes:
        starts.append(cur)
        cur += -(-t // bp) * bp                # aligned segment starts
    Tp = max(cur, bp)
    pad_rows = len(takes) * max(takes)
    rows.append(("kernel.packed_prefill.padded_rows_saving",
                 pad_rows / Tp, "x", ""))
    qs = randn(Tp, H2, D2)
    ks = randn(Tp, Hkv2, D2)
    vs = randn(Tp, Hkv2, D2)
    kpg = randn(n_pages, P, Hkv2, D2)
    vpg = randn(n_pages, P, Hkv2, D2)
    bt = torch.full((len(takes), W), n_pages, dtype=torch.int32, device=dev)
    bt[:, :2] = torch.arange(2 * len(takes), dtype=torch.int32,
                             device=dev).reshape(len(takes), 2)
    seg_starts = i32(starts)
    seg_offs = i32([2 * P] * len(takes))       # resumed chunks
    seg_lens = i32(takes)
    us = _time_us(lambda: ops.packed_prefill_attention(
        qs, ks, vs, kpg, vpg, bt, seg_starts, seg_offs, seg_lens,
        ring=4096), dev)
    rows.append((f"kernel.packed_prefill.{tag}_us", us, "us", ""))
    return rows


ALL = [bench_kernels]
