#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100 — the quickest proof that the port builds, runs its main path through
its own kernels, and agrees with its plain PyTorch versions.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, one JSON line each:

1. ``device``  — the card's name, compute capability (must be 9.0) and the
   ``nvidia-smi`` name / power limit line.
2. ``build``   — every kernel compiled from ``src/repro_torch/csrc`` by
   ``nvcc`` (one process per source, all started together), with seconds,
   and the registers, stack and spill bytes ``-Xptxas -v`` reported for
   every kernel of B5's, B2's, B3's, B8's, B7's, B6's, B1's and B4's
   sources in that build; the tensor-core kernels and every kernel of
   B7's, B6's, B1's and B4's sources may not spill, and B8's must be given
   168 registers a thread (what its ``setmaxnreg`` hand-over from producer
   to consumers assumes).
3. ``kernel``  — each kernel against its plain version on the card, per
   dtype and shape set: qwen3-8b (H=32, Hkv=8, D=128) and llama2-7b (H=32,
   Hkv=32) geometry, page size 16, contexts 512 and 4096; paged decode
   (float and packed-int4 pages, with a sentinel page and NaN on every
   masked row) at batch 1 and 4, packed prefill on a pack_align=8 stream
   of four segments with history, and the int8 GEMV at every (K, N) of the
   two models' layers for M = 1, 4 and 32 rows; whole-prompt flash
   attention (B5) at T = 2560 and 4000 (a ragged last tile), window 0 and
   1024, batch 1 and (T = 2560) 2; dense decode (B6) over a 4160-position
   arena at batch 1 and 4 with lengths 1, ragged and 4160 and NaN on every
   row at or past a length; packed prefill over the dense arena's view
   (one 8192-token page per slot, block table = slot, unwritten rows NaN);
   and the SSD chunk kernel (B7) at mamba2 geometry (H=80, P=64, N=128)
   for 32 chunks of 256, one of 200 and one of 24, x/B/C in f32 and bf16
   (dt and A f32, made as ``ssm_prefill`` makes them); the prefill GEMM
   (B8) at M = 2048 and every (K, N) of the two models' projections
   (2048 x 4096 x 12288 among them) and at M = 37; B5 and B2 at head dim
   64, the benchmark runner's; B2 over a sliding-window pool (window 1000,
   ring 1000 < offset: the history has wrapped) at both geometries in f32
   and bf16; and in bf16 B5 at T = 4000 with window 1000 (cutting key
   tiles) at both geometries, B2 over pages of 12 tokens, and B5 and B2
   at head dim 16.  B5 and B2 have two routes (bf16 at head dim 64 or 128,
   and pages of a multiple of 8 tokens, on the tensor cores; the rest on
   the CUDA-core tile), chosen by the wrapper and passed to the C entry
   point: every check of theirs must launch only the route its inputs
   name, and each entry point must refuse a route its inputs cannot take
   (``check_route_refusals``: f32 or head dim 16 on the tensor cores, B5
   in bf16 at 128 on the tile, B2 over pages of 12 on the tensor cores).
   B3 and B8 have two routes in the same way (bf16 that TMA can address —
   B3 with at most 32 rows of x — on the tensor cores: wgmma over a
   TMA-fed ring; f32 and other shapes on the tile), and the kernel phase
   adds for them: B3 over int8 weights covering -127 ... 127, B8 at N =
   1024 (128-column tiles), two launches of each on the same inputs giving
   identical bits, and refusals of f32 B3 and B8, B8 at K = 41 and B3 over
   int8 rows of 1000 bytes on the tensor cores.  B6 and B1 run one split-K
   walk with its combine in the same launch (bf16 on the tensor cores, f32
   on the CUDA cores; ``csrc/decode_split.cuh``), and the kernel phase
   holds them at the edges of that walk in both dtypes and geometries
   (``kernel_phase_decode_edges``): lengths 1, one stage +-1 and one split
   +-1 (the split the kernel takes for that call), over an arena of 4099
   positions and over block tables whose pages are out of order, with a
   sentinel page inside a row and lengths ending inside a page; and two
   launches of each on the same inputs giving identical bits.  B4 runs
   the same walk over packed int4 pages (its own stage and split) and is
   held at the same edges.  B7 has two routes (bf16 at P = 64 on the
   tensor cores, each f32 operand split into three bf16 pieces; f32 and
   other head dims on the CUDA-core tile): its checks assert the route
   their inputs name, its entry point must refuse f32, P = 32 and N = 100
   on the tensor cores, and ``kernel_phase_ssd_edges`` holds it at Q = 1,
   24, 200 and 256 over 1 and 33 chunks, over chunks whose cs spans 100 in
   every head, and two launches to the same bits.
   Tolerances: B7, whatever the input dtype and route, the per-element
   worst-case
   bound of f32 arithmetic of ``ssd_tolerance``; otherwise
   f32 |err| <= 1e-4; bf16 (see ``tolerance``) for the float
   attention kernels (B1, B2, B5, B6), per
   element, |err| <= 2^-7 A + 2^-6 |ref|, where A is the plain version's
   f32 result with every V row replaced by its absolute value (sum_i p_i
   |v_i|).  Both sides round the softmax weights p to bf16 before P.V,
   each p by at most one bf16 unit roundoff (2^-8), which moves the result
   by at most 2^-8 A per side; both round the output to bf16, and the
   kernel divides by a sum of rounded p, each at most 2^-8 |ref|.  The
   bound is that worst case and no looser, so a result that skipped one
   32-key tile of a 2k-token walk fails it.  The int8 GEMV and the int4
   decode compute in f32 throughout, so their bf16 bound is one output
   rounding per side plus the f32 summation term: |err| <= 2^-7 |ref| +
   (2n + 2) 2^-24 A over n summed terms; B8 the same with n = K and
   A = |x| @ |w|, in f32 without the 2^-7 |ref| term.  Times are CUDA
   events, median of 20 launches, L2 flushed between launches; ``bound_ms``
   is the larger of the bytes the call must move over 3.35 TB/s and its
   operations over the peak rate of its type (989 TFLOP/s bf16, 67 TFLOP/s
   f32): B5 by its 4 B H D (visible query-key pairs) operations, B6 by the
   K/V bytes of its valid rows, B7 by the operations of the causal half
   (``ssd_cost``); ``library_ms`` times one library call on
   the same inputs — for attention ``scaled_dot_product_attention`` on the
   pre-gathered dense K/V (dequantized beforehand for int4; repeated to the
   H query heads beforehand) with a boolean mask (``is_causal`` for B5
   without a window), for the GEMV ``torch.matmul`` on the weight
   dequantized beforehand, for B7 three batched ``torch.matmul`` calls over
   a materialised L, for B8 ``torch.matmul`` on the same tensors — a
   yardstick only, never used by the port.
4. ``bench``   — the port's benchmark runner in process,
   ``repro_torch.benchmarks.run.main(["--device", "cuda"])``: the HALO
   analytic model's paper figures and the kernel micro-benchmarks, each
   row a JSON line, all finite.  B8, the GEMV, B5, B6 and B2 must launch
   there and no other kernel, and no plain version may be called; B8 is
   re-checked at the inputs of its 2048 x 4096 x 12288 bf16 launch.  The
   runner's f32 rows (B3, B5, B2 and one of B8's) must launch on the tile,
   B8's bf16 row on the tensor cores.
5. ``serve``   — ``ServingEngine`` on qwen3-8b at full width and all 36
   layers in bf16 (random weights from a seeded ``torch.Generator`` on the
   card): paged pool (page 16, 1024 pages), max_batch 4, default
   ``PhaseAwareConfig`` (halo, prefill_chunk 2048, pack_align 8), prompts of
   1900, 1000, 333 and 37 tokens, 64 new tokens each.  Every request must
   finish, no logit may be NaN, and each kernel's launch count must equal
   n_layers x the prefill (resp. decode) steps, and 0 for the kernels off
   this path.  The four requests run
   three times (rounds) to show the call's spread; the headline TTFT and
   TPOT are the medians over rounds.  Each kernel is then checked and timed
   again at the exact inputs the main path gave it (bf16), and checked once
   more on those inputs cast to f32 (|err| <= 1e-4).  A ``profile`` line
   says where one more round's time goes under ``torch.profiler`` (device
   busy time, top kernels) and estimates the device's idle share as one
   minus that busy time over the unprofiled rounds' median wall time.
6. ``serve_quantized`` — the same model and prompts with int8 weights and
   packed-int4 KV pages (HALO's decode datapath), two rounds: the int8 GEMV
   must launch 7 x n_layers times per decode step (wq, wk, wv, wo and the
   three FFN matmuls), the int4 decode kernel n_layers times per decode
   step, the packed-prefill kernel (over the pool dequantized to bf16)
   n_layers times per prefill step, the float decode kernel never; each
   kernel is re-checked at the main path's inputs as in ``serve``, the
   GEMV's seven calls also timed with the L2 flushed by a read (clean)
   rather than a write (the ``gemv_clean_l2`` line), and a ``profile``
   line (``"of": "serve_quantized"``) follows as for ``serve``.
7. ``serve_dense`` — qwen3-8b as in ``serve`` on the DENSE arena
   (``paged=False``, max_len 8192, max_batch 4) with whole-prompt prefill
   (``prefill_chunk=0``): prompts of 8000, 4096, 2304 and 1000 tokens, 64
   new tokens each, two rounds.  Each round, the flash-attention kernel
   must launch 36 x 3 times (every prompt above 2048 tokens, every layer;
   the 1000-token one takes the plain dense path), the dense decode kernel
   36 x the decode steps, the paged, int8 and int4 kernels and the packed
   prefill never.  Then one more round on a second dense engine with the
   default packed chunks (prefill_chunk 2048): packed prefill 36 x the
   prefill steps over the arena viewed as one 8192-token page per slot,
   flash attention never.  B5 (the 8000-token prompt's first layer), B6
   (the first layer of the first decode step with all four requests
   decoding) and B2 (the first packed launch) are re-checked at those
   inputs as in ``serve``.  TTFT per prompt length, TPOT, decode tokens/s,
   peak memory and a ``profile`` line (``"of": "serve_dense"``).
8. ``serve_ssm`` — mamba2-2.7b at full width and all 64 layers in bf16
   (random seeded weights) on the dense arena (max_len 8448, max_batch 4)
   with whole-prompt prefill: after the 24-token warm-up, prompts of 8192,
   4096, 2048 and 200 tokens, 64 new tokens each, two rounds.  Each round
   B7 must launch 64 x 4 times (every prompt, every layer), every launch
   on its tensor-core route, and every other kernel never; B7 is
   re-checked at the 8192-token prompt's first-layer inputs (bf16, and
   cast to f32), and the layout moves around it timed there, beside the
   tensor-core route's own bound (``ssd_route_cost``).  TTFT per prompt length, TPOT, decode tokens/s, weight and state
   bytes, peak memory, a ``profile`` line for a round and one for a
   prefill-only pass with B7's share of its device time.
9. ``preempt`` — the same model cut to 4 layers, with a pool small enough
   to force preemptions; every request must finish.
10. ``parity``  — reduced llama2-7b and qwen3-8b in f32, one engine on
   ``cuda`` (kernels) and one on ``cpu`` (plain versions), same weights,
   f32 KV (with and without a forced preemption) and int8 KV on the paged
   pool, and the dense arena with whole-prompt prefill (a 2100-token
   prompt among short ones) and with packed chunks; reduced mamba2-2.7b on
   the dense arena with whole-prompt prefill: equal tick logs, and
   equal greedy streams up to the first position where the CPU run's own
   top-2 logit margin, recorded as it served, is at most 1e-3.

In every serve phase each kernel's plain version must be called 0 times:
on the card nothing falls back to it.  B5, B2, B3, B8 and B7 count their
launches by route: ``serve``, ``serve_quantized`` (B3 among them), both
``serve_dense`` rounds and ``serve_ssm`` (bf16) must launch only their
tensor-core route, ``parity`` (f32) only the CUDA-core tile, and ``bench``
as said above.

Then one ``{"kernels": [...]}`` line (launches from the serve phase whose
main path runs the kernel — ``serve_quantized`` for the GEMV and the int4
decode, whose times sum one layer's seven GEMV calls, ``serve_dense`` for
B5 and B6, ``serve_ssm`` for B7, ``bench`` for B8 — times at its inputs
in bf16, ``max_abs_err`` from the f32 check at those inputs and
``max_abs_err_bf16`` from the bf16 one), the ``nvidia-smi`` line, and
as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the last
line is never printed and the exit code is not 0.  Without a CUDA device,
or without the repository's ``src/`` beside it, the script exits non-zero.
"""

from __future__ import annotations

import bisect
import dataclasses
import gc
import json
import subprocess
import sys
import time
import traceback
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# |err| <= atol + rtol |ref| + p_abs A, per element, A = sum_i p_i |v_i|
# (see above)
TOL = {"float32": dict(atol=1e-4, rtol=0.0, p_abs=0.0),
       "bfloat16": dict(atol=0.0, rtol=2.0 ** -6, p_abs=2.0 ** -7)}
PAGE = 16
ITERS = 20
ROUNDS = 3                # serve rounds of the same four requests
ROUNDS_QUANTIZED = 2      # serve_quantized rounds of them
ROUNDS_DENSE = 2          # serve_dense whole-prompt rounds
DENSE_MAX_LEN = 8192      # serve_dense arena positions per slot
ROUNDS_SSM = 2            # serve_ssm rounds
SSM_MAX_LEN = 8448        # serve_ssm arena positions per slot (8192 + 256)
DEV = "cuda"              # the card; the input builders allocate here
FAILED = []               # kernel checks that disagreed (raised per phase)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and roofline
# ---------------------------------------------------------------------------

class Timer:
    """Median per-call device time of ``fn`` over ``ITERS`` calls, timed
    with CUDA events; a 256 MB buffer is rewritten between calls so every
    call finds the 50 MB L2 cold, as a layer's kernel does on the main
    path (each layer reads its own pool).  The rewrite leaves the L2 full
    of dirty lines, which a call that reads much must first write back (up
    to 50 MB); with ``clean`` the buffer is read instead, so the L2 is cold
    and clean, as it is between a decode step's weight reads."""

    def __init__(self, torch, clean=False):
        self.torch, self.clean = torch, clean
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn, iters: int = ITERS) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            if self.clean:
                self.flush.sum()
            else:
                self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]


def bound(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def close(torch, got, ref, dt: str, abs_ctx=None, tol=None):
    """(max |got - ref|, within ``tol`` (default ``TOL[dt]``), the element
    whose error is the largest share of its bound) over every element;
    ``abs_ctx`` is A, needed where ``tol["p_abs"]`` is not 0."""
    tol = TOL[dt] if tol is None else tol
    g, r = got.float(), ref.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf"), False, None
    err = (g - r).abs()
    bound = tol["atol"] + tol["rtol"] * r.abs()
    if tol["p_abs"]:
        bound = bound + tol["p_abs"] * abs_ctx.float()
    share = err / bound.clamp(min=1e-30)
    i = int(share.argmax())
    worst = dict(err=float(err.flatten()[i]), ref=float(r.flatten()[i]),
                 bound=float(bound.flatten()[i]), index=i)
    return float(err.max()), bool((err <= bound).all()), worst


# the arguments that hold V, per float attention kernel
V_ARGS = {"paged_decode_attention": (2,), "packed_prefill_attention": (2, 4),
          "flash_attention": (2,), "decode_attention": (2,)}


def abs_context(plain, name, args, kw):
    """A = sum_i p_i |v_i|: the plain version in f32 with |V|."""
    f32 = [x.float() if x.is_floating_point() else x for x in args]
    for i in V_ARGS[name]:
        f32[i] = f32[i].abs()
    return plain(*f32, **kw)


# ---------------------------------------------------------------------------
# paged decode attention (B1)
# ---------------------------------------------------------------------------

def decode_inputs(torch, H, Hkv, D, B, ctx, dtype, seed):
    """A ragged batch against a shared pool: lengths ctx, ctx-37, ...;
    see ``paged_inputs``."""
    return paged_inputs(torch, H, Hkv, D,
                        [max(ctx - 37 * b, 1) for b in range(B)], dtype, seed)


def paged_inputs(torch, H, Hkv, D, lengths, dtype, seed):
    """One query token per sequence of ``lengths`` against a shared pool:
    pages scattered at random (a row's pages out of order); one sentinel
    page inside the last row's length; every masked row of the pool (past
    a length, on the unused page the sentinel clamps to) poisoned with
    NaN."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    B, ctx = len(lengths), max(lengths)
    W = -(-ctx // PAGE) + 2
    n_pages = sum(-(-n // PAGE) for n in lengths) + 1
    perm = torch.randperm(n_pages - 1, device=DEV, generator=g).tolist()
    bt = torch.full((B, W), n_pages, dtype=torch.int32)
    k = torch.randn((n_pages, PAGE, Hkv, D), device=DEV, generator=g)
    v = torch.randn((n_pages, PAGE, Hkv, D), device=DEV, generator=g)
    k[n_pages - 1] = float("nan")
    v[n_pages - 1] = float("nan")
    for b, n in enumerate(lengths):
        for i in range(-(-n // PAGE)):
            page = perm.pop()
            bt[b, i] = page
            tail = n - i * PAGE
            if tail < PAGE:
                k[page, tail:] = float("nan")
                v[page, tail:] = float("nan")
    if B > 1:
        bt[B - 1, 1] = n_pages                     # skipped whole
    q = torch.randn((B, H, D), device=DEV, generator=g)
    return (q.to(dtype), k.to(dtype), v.to(dtype), bt.to(DEV),
            torch.tensor(lengths, dtype=torch.int32, device=DEV))


def decode_cost(q, k_pages, v_pages, bt, lengths):
    B, H, D = q.shape
    n_pages, P, Hkv, _ = k_pages.shape
    el = q.element_size()
    bt, lengths = bt.cpu().tolist(), lengths.cpu().tolist()
    tokens = entries = 0
    for b in range(B):
        walk = min(-(-lengths[b] // P), len(bt[b]))
        entries += walk
        tokens += sum(min(P, lengths[b] - i * P) for i in range(walk)
                      if bt[b][i] < n_pages)
    nbytes = 2 * q.numel() * el + 2 * tokens * Hkv * D * el + 4 * (entries + B)
    return bound(nbytes, 4.0 * tokens * H * D, dtype_name(q))


def decode_library(torch, q, k_pages, v_pages, bt, lengths):
    """scaled_dot_product_attention on the pre-gathered dense K/V (one
    call; the gather is outside the timed call)."""
    import torch.nn.functional as F
    B, H, D = q.shape
    n_pages, P, Hkv, _ = k_pages.shape
    S = -(-int(lengths.max()) // P) * P
    pages = bt[:, :S // P].long()
    k = k_pages[pages.clamp(max=n_pages - 1)].reshape(B, S, Hkv, D)
    v = v_pages[pages.clamp(max=n_pages - 1)].reshape(B, S, Hkv, D)
    ok = ((torch.arange(S, device=q.device)[None] < lengths[:, None].long())
          & (pages < n_pages).repeat_interleave(P, dim=1))
    v = torch.where(ok[:, :, None, None], v, torch.zeros_like(v))
    k = k.permute(0, 2, 1, 3).repeat_interleave(H // Hkv, dim=1).contiguous()
    v = v.permute(0, 2, 1, 3).repeat_interleave(H // Hkv, dim=1).contiguous()
    qq, mask = q[:, :, None, :], ok[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)


# ---------------------------------------------------------------------------
# packed prefill attention (B2)
# ---------------------------------------------------------------------------

def prefill_inputs(torch, H, Hkv, D, ctx, dtype, seed, page=PAGE):
    """A pack_align=8 stream of four segments — lengths 203, 77, 130, 45 at
    8-aligned starts, so no segment is aligned to a 16- or 64-row tile —
    with histories of ctx, ctx/2+5, 61 and 0 tokens, one pad segment
    (start == T, all-sentinel table row) and 16 stream rows past the last
    segment, over pages of ``page`` tokens.  History slots a segment has
    not written yet are NaN."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    lens = [203, 77, 130, 45, 0]
    offs = [ctx, ctx // 2 + 5, 61, 0, 0]
    starts, cur = [], 0
    for n in lens[:-1]:
        starts.append(cur)
        cur = -(-(cur + n) // 8) * 8
    T = cur + 16
    starts.append(T)
    W = max(-(-(o + n) // page) for o, n in zip(offs, lens))
    n_pages = sum(-(-(o + n) // page) for o, n in zip(offs, lens)) + 1
    perm = torch.randperm(n_pages - 1, device=DEV, generator=g).tolist()
    bt = torch.full((len(lens), W), n_pages, dtype=torch.int32)
    k = torch.randn((n_pages, page, Hkv, D), device=DEV, generator=g)
    v = torch.randn((n_pages, page, Hkv, D), device=DEV, generator=g)
    k[n_pages - 1] = float("nan")
    v[n_pages - 1] = float("nan")
    for s, (o, n) in enumerate(zip(offs, lens)):
        for i in range(-(-(o + n) // page)):
            pg = perm.pop()
            bt[s, i] = pg
            lo = max(o - i * page, 0)
            if lo < page:                  # this chunk's own slots: unwritten
                k[pg, lo:] = float("nan")
                v[pg, lo:] = float("nan")
    q = torch.randn((T, H, D), device=DEV, generator=g)
    kn = torch.randn((T, Hkv, D), device=DEV, generator=g)
    vn = torch.randn((T, Hkv, D), device=DEV, generator=g)
    i32 = dict(dtype=torch.int32, device=DEV)
    return ((q.to(dtype), kn.to(dtype), vn.to(dtype), k.to(dtype),
             v.to(dtype), bt.to(DEV), torch.tensor(starts, **i32),
             torch.tensor(offs, **i32), torch.tensor(lens, **i32)),
            dict(ring=n_pages * page, window=0))


def ring_prefill_inputs(torch, H, Hkv, D, dtype, seed, window=1000):
    """Packed prefill over a sliding-window pool, as serving lays it out:
    ring = min(window, capacity) = 1000 slots, so a block-table row holds
    ceil(1000 / 16) = 63 pages, the last one half past the ring.  The
    stream of ``prefill_inputs`` (lengths 203, 77, 130, 45 at 8-aligned
    starts, a pad segment, 16 rows past the last segment) with histories of
    3000 and 1500 tokens, which have wrapped (every slot written, the
    oldest positions outside the first queries' window), 700 and 0.  Pages
    past the slots a segment reaches are sentinels; slots not written yet,
    and those past the ring on a row's last page, hold NaN."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    ring = window
    lens = [203, 77, 130, 45, 0]
    offs = [3000, 1500, 700, 0, 0]
    starts, cur = [], 0
    for n in lens[:-1]:
        starts.append(cur)
        cur = -(-(cur + n) // 8) * 8
    T = cur + 16
    starts.append(T)
    W = -(-ring // PAGE)
    need = [-(-min(o + n, ring) // PAGE) for o, n in zip(offs, lens)]
    n_pages = sum(need) + 1
    perm = torch.randperm(n_pages - 1, device=DEV, generator=g).tolist()
    bt = torch.full((len(lens), W), n_pages, dtype=torch.int32)
    k = torch.randn((n_pages, PAGE, Hkv, D), device=DEV, generator=g)
    v = torch.randn((n_pages, PAGE, Hkv, D), device=DEV, generator=g)
    k[n_pages - 1] = float("nan")
    v[n_pages - 1] = float("nan")
    for s, o in enumerate(offs):
        for i in range(need[s]):
            page = perm.pop()
            bt[s, i] = page
            lo = max(min(o, ring) - i * PAGE, 0)
            if lo < PAGE:                  # slots not written (yet)
                k[page, lo:] = float("nan")
                v[page, lo:] = float("nan")
    q = torch.randn((T, H, D), device=DEV, generator=g)
    kn = torch.randn((T, Hkv, D), device=DEV, generator=g)
    vn = torch.randn((T, Hkv, D), device=DEV, generator=g)
    i32 = dict(dtype=torch.int32, device=DEV)
    return ((q.to(dtype), kn.to(dtype), vn.to(dtype), k.to(dtype),
             v.to(dtype), bt.to(DEV), torch.tensor(starts, **i32),
             torch.tensor(offs, **i32), torch.tensor(lens, **i32)),
            dict(ring=ring, window=window))


def _history_slots(bt, off, ring, n_pages, P):
    """Logical history slots a segment sees: s < min(off, ring, W*P) on an
    allocated page."""
    n = min(off, ring, len(bt) * P)
    return [s for s in range(n) if bt[s // P] < n_pages]


def _slot_position(s, off, ring):
    """The position ring slot s holds before a chunk at ``off``."""
    return off - 1 - (off - 1 - s) % ring


def _visible_pairs(n, off, hist, window):
    """(query, key) pairs of an n-token chunk at ``off`` over history
    positions ``hist`` and its own causal keys, with a window when > 0;
    and the history positions some query sees (all when window is 0)."""
    if window <= 0:
        return n * len(hist) + n * (n + 1) // 2, len(hist)
    hist = sorted(hist)
    pairs = sum(len(hist) - bisect.bisect_right(hist, off + i - window)
                + min(i + 1, window) for i in range(n))
    # the first query sees the most history: every later one sees less
    return pairs, len(hist) - bisect.bisect_right(hist, off - window)


def prefill_cost(args, kw):
    q, kn, _, k_pages, _, bt, starts, offs, lens = args
    T, H, D = q.shape
    n_pages, P, Hkv, _ = k_pages.shape
    el = q.element_size()
    bt, starts = bt.cpu().tolist(), starts.cpu().tolist()
    offs, lens = offs.cpu().tolist(), lens.cpu().tolist()
    toks = hist = pairs = 0
    for n in range(len(lens)):
        if lens[n] <= 0 or starts[n] >= T:
            continue
        pos = [_slot_position(s, offs[n], kw["ring"]) for s in
               _history_slots(bt[n], offs[n], kw["ring"], n_pages, P)]
        p, h = _visible_pairs(lens[n], offs[n], pos, kw["window"])
        toks += lens[n]
        hist += h
        pairs += p
    nbytes = (toks * (2 * H + 2 * Hkv) * D * el + 2 * hist * Hkv * D * el
              + 4 * (len(lens) * (3 + len(bt[0]))))
    return bound(nbytes, 4.0 * pairs * H * D, dtype_name(q))


def prefill_library(torch, args, kw):
    """scaled_dot_product_attention over the pre-gathered dense K/V: every
    segment's visible history followed by the stream, with a boolean mask
    for segment, causality, history visibility and the window (one
    call)."""
    import torch.nn.functional as F
    q, kn, vn, k_pages, v_pages, bt, starts, offs, lens = args
    T, H, D = q.shape
    n_pages, P, Hkv, _ = k_pages.shape
    G = H // Hkv
    keys, vals, cols, hpos = [], [], [], []
    seg = torch.full((T,), -1, dtype=torch.long, device=q.device)
    qpos = torch.zeros((T,), dtype=torch.long, device=q.device)
    btl = bt.cpu().tolist()
    for n, (st, off, ln) in enumerate(zip(starts.tolist(), offs.tolist(),
                                          lens.tolist())):
        if ln <= 0 or st >= T:
            continue
        seg[st:st + ln] = n
        qpos[st:st + ln] = torch.arange(off, off + ln, device=q.device)
        slots = _history_slots(btl[n], off, kw["ring"], n_pages, P)
        if slots:
            s = torch.tensor(slots, device=q.device)
            pg = bt[n].long()[s // P]
            keys.append(k_pages[pg, s % P])
            vals.append(v_pages[pg, s % P])
            cols.append(torch.full((len(slots),), n, device=q.device))
            hpos.append(torch.tensor([_slot_position(x, off, kw["ring"])
                                      for x in slots], device=q.device))
    keys.append(kn)
    vals.append(vn)
    n_hist = sum(c.numel() for c in cols)
    k = torch.cat(keys).permute(1, 0, 2).repeat_interleave(G, 0)[None]
    v = torch.cat(vals).permute(1, 0, 2).repeat_interleave(G, 0)[None]
    t = torch.arange(T, device=q.device)
    hist_ok = (seg[:, None] == torch.cat(cols)[None]) if cols else \
        torch.zeros((T, 0), dtype=torch.bool, device=q.device)
    self_ok = ((seg[:, None] == seg[None]) & (seg[:, None] >= 0)
               & (t[None] <= t[:, None]))
    if kw["window"] > 0:
        if cols:
            hist_ok &= qpos[:, None] - torch.cat(hpos)[None] < kw["window"]
        self_ok &= t[:, None] - t[None] < kw["window"]
    mask = torch.cat([hist_ok, self_ok], dim=1)[None, None]
    assert mask.shape[-1] == n_hist + T
    qq = q.permute(1, 0, 2)[None].contiguous()
    return lambda: F.scaled_dot_product_attention(qq, k.contiguous(),
                                                  v.contiguous(),
                                                  attn_mask=mask)


# ---------------------------------------------------------------------------
# int8 GEMV (B3)
# ---------------------------------------------------------------------------

# the (K, N) of every matmul the two models route through the GEMV under
# int8 weights: wq/wo, wk/wv (qwen3-8b: 8 kv heads), the FFN's gate/up and
# down projections (qwen3-8b 12288, llama2-7b 11008 — not a multiple of the
# kernel's 128-column tile)
GEMV_SHAPES = {"qwen3-8b": [(4096, 4096), (4096, 1024), (4096, 12288),
                            (12288, 4096)],
               "llama2-7b": [(4096, 4096), (4096, 11008), (11008, 4096)]}


def gemv_inputs(torch, M, K, N, dtype, seed, quantized=True):
    """x [M, K] in ``dtype`` and a fan-in-scaled normal weight: quantized
    to int8 per output channel, as the engine serves it, or (the kernel's
    float variant) in x's dtype with no scale."""
    from repro_torch.serving.quantized_weights import quantize_weight
    g = torch.Generator(device=DEV).manual_seed(seed)
    w = torch.randn((K, N), device=DEV, generator=g) / K ** 0.5
    x = torch.randn((M, K), device=DEV, generator=g).to(dtype)
    if not quantized:
        return x, w.to(dtype), None
    w = quantize_weight(w)
    return x, w["q"], w["scale"]


def gemv_cost(x, w, scale):
    M, K = x.shape
    N = w.shape[1]
    el = x.element_size()
    nbytes = (w.numel() * w.element_size() + (0 if scale is None else 4 * N)
              + (M * K + M * N) * el)
    return bound(nbytes, 2.0 * M * K * N, dtype_name(x))


def gemv_dequantized(x, w, scale):
    """The weight in f32, its scale applied."""
    return w.float() if scale is None else w.float() * scale.float()


def gemv_library(torch, x, w, scale):
    """``torch.matmul`` on the weight dequantized to x's dtype beforehand
    (a yardstick only)."""
    wd = gemv_dequantized(x, w, scale).to(x.dtype)
    return lambda: torch.matmul(x, wd)


# ---------------------------------------------------------------------------
# paged decode attention over packed-int4 pages (B4)
# ---------------------------------------------------------------------------

def q4_inputs(torch, H, Hkv, D, B, ctx, dtype, seed):
    """B1's ragged batch (``decode_inputs``) over packed int4 pages
    (``q4_pages``)."""
    return q4_pages(torch, H, Hkv, D, [max(ctx - 37 * b, 1) for b in range(B)],
                    dtype, seed)


def q4_pages(torch, H, Hkv, D, lengths, dtype, seed):
    """B1's pool for ``lengths`` (``paged_inputs``: pages out of order, a
    sentinel page inside the last row) quantized to int4 per (token, kv
    head) and packed; the scales of every masked row (past a length, on the
    unused page the sentinel clamps to) are NaN."""
    from repro_torch.serving.quantized_cache import (pack_int4,
                                                     quantize_token_int4)
    q, k, v, bt, lengths = paged_inputs(torch, H, Hkv, D, lengths,
                                        torch.float32, seed)
    masked = torch.isnan(k[..., 0])
    kq, ks = quantize_token_int4(torch.nan_to_num(k))
    vq, vs = quantize_token_int4(torch.nan_to_num(v))
    ks[masked] = float("nan")
    vs[masked] = float("nan")
    return (q.to(dtype), pack_int4(kq), ks, pack_int4(vq), vs, bt, lengths)


def q4_dequantized(torch, q, kp, ks, vp, vs):
    """The int4 pool dequantized to f32 [n_pages, P, Hkv, D] per side."""
    from repro_torch.serving.quantized_cache import dequantize, unpack_int4
    return (dequantize(unpack_int4(kp), ks), dequantize(unpack_int4(vp), vs))


def q4_cost(q, kp, ks, vp, vs, bt, lengths):
    """B1's count with (D/2 + 4) bytes per live token and kv head a side."""
    B, H, D = q.shape
    n_pages, P, Hkv, _ = kp.shape
    el = q.element_size()
    bt, lengths = bt.cpu().tolist(), lengths.cpu().tolist()
    tokens = entries = 0
    for b in range(B):
        walk = min(-(-lengths[b] // P), len(bt[b]))
        entries += walk
        tokens += sum(min(P, lengths[b] - i * P) for i in range(walk)
                      if bt[b][i] < n_pages)
    nbytes = (2 * q.numel() * el + 2 * tokens * Hkv * (D // 2 + 4)
              + 4 * (entries + B))
    return bound(nbytes, 4.0 * tokens * H * D, dtype_name(q))


def q4_library(torch, q, kp, ks, vp, vs, bt, lengths):
    """``decode_library`` on the pool dequantized to q's dtype beforehand
    (a yardstick only)."""
    kf, vf = q4_dequantized(torch, q, kp, ks, vp, vs)
    return decode_library(torch, q, kf.to(q.dtype), vf.to(q.dtype), bt,
                          lengths)


def tolerance(torch, name, args, kw, dt):
    """(tolerance, A) of one check. f32: |err| <= 1e-4. bf16, B1, B2, B5 and B6:
    ``TOL["bfloat16"]`` (see the module docstring). bf16, B3 and B4: both sides
    compute in f32 from the same values (bf16 x or q widen exactly; int8 and
    int4 codes times their scales are the same f32 products), and each f32 sum
    of n terms is off by at most n 2^-24 times the sum of their magnitudes A,
    so the two differ by at most 2n 2^-24 A, plus a term of exp and division
    per p in B4 that (n + 1) covers; each side then rounds once to bf16, at
    most half an ulp, 2^-8 |ref| — so |err| <= 2^-7 |ref| + (2n + 2) 2^-24 A,
    with n = K for B3 (A = |x| @ |w| times the scale) and n = the longest
    length for B4 (A = sum_i p_i |v_i|). B4 keeps p in f32, so no p-rounding
    term enters. B7, f32 and bf16: ``ssd_tolerance``. B8, f32 and bf16:
    both sides sum the K exact products in f32 (bf16 products are exact in
    f32) and round once to x's dtype, so B3's form with n = K and
    A = |x| @ |w|, its 2^-7 |ref| term for bf16 only."""
    if name == "ssd_chunk":
        return ssd_tolerance(torch, *args)
    if name == "matmul" or (name == "gemv" and dt != "float32"):
        return summation_tolerance(torch, name, args, kw, dt)
    if dt == "float32" or name in V_ARGS:
        if not TOL[dt]["p_abs"]:
            return TOL[dt], None
        plain = ref_of(name)
        return TOL[dt], abs_context(plain, name, args, kw)
    from repro_torch.kernels import ref
    q, kp, ks, vp, vs, bt, lengths = args
    n = int(lengths.max())
    kf, vf = q4_dequantized(torch, q, kp, ks, vp, vs)
    A = ref.paged_decode_attention_ref(q.float(), kf, vf.abs(), bt, lengths)
    return dict(atol=0.0, rtol=2.0 ** -7, p_abs=(2 * n + 2) * 2.0 ** -24), A


def summation_tolerance(torch, name, args, kw, dt):
    """(tolerance, A) of B3 and B8 in either dtype: |err| <= 2^-7 |ref|
    (bf16 only) + (2K + 2) 2^-24 A, A = |x| @ |w| (B3: w dequantized).
    Both sides sum the K exact products in f32 and round once to x's dtype
    (see ``tolerance``); unlike a fixed absolute bound it scales with the
    magnitudes summed, and it fails a result missing one 32-row K tile
    (``tests/test_torch_smoke.py``)."""
    x = args[0]
    w = gemv_dequantized(*args) if name == "gemv" else args[1].float()
    A = x.float().abs() @ w.abs()
    return dict(atol=0.0, rtol=2.0 ** -7 if dt == "bfloat16" else 0.0,
                p_abs=(2 * x.shape[1] + 2) * 2.0 ** -24), A


# ---------------------------------------------------------------------------
# prefill GEMM, HALO's CiM path (B8)
# ---------------------------------------------------------------------------

# the (K, N) of the two models' prefill GEMMs for one 2048-token chunk: wq/wo,
# wk/wv (qwen3-8b: 8 kv heads), the FFN's gate/up and down projections
# (llama2-7b's 11008 is no multiple of the reference's 512-row K block, so
# its rows pass bk=256)
GEMM_SHAPES = {"qwen3-8b": [(4096, 4096), (4096, 1024), (4096, 12288),
                            (12288, 4096)],
               "llama2-7b": [(4096, 11008), (11008, 4096)]}
GEMM_M = 2048
# shapes that reach B8's edge code: K a multiple of neither 4 nor 8 and
# N < 128 (element-by-element loads in both dtypes, zero-fill past K,
# column guards); and K % 32 != 0, N % 128 != 0, M % 128 != 0 with the
# 16-byte copies on (partial K step, partial tiles), under blocks that the
# reference's contract admits
GEMM_EDGES = [((37, 41, 24), {}),
              ((100, 4104, 1000), {"bn": 200, "bk": 216})]


def gemm_inputs(torch, M, K, N, dtype, seed):
    """x [M, K] standard normal and a fan-in-scaled normal w [K, N], both
    in ``dtype``."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    w = torch.randn((K, N), device=DEV, generator=g) / K ** 0.5
    x = torch.randn((M, K), device=DEV, generator=g)
    return x.to(dtype), w.to(dtype)


def gemm_cost(x, w):
    """Bytes: x and w read once, the product written once; operations
    2 M K N."""
    M, K = x.shape
    N = w.shape[1]
    nbytes = (M * K + K * N + M * N) * x.element_size()
    return bound(nbytes, 2.0 * M * K * N, dtype_name(x))


def matmul_plain(x, w, **blocks):
    """``matmul_ref`` under the kernel's call: the block sizes are the
    reference's contract on the shapes, not part of the function."""
    from repro_torch.kernels import ref
    return ref.matmul_ref(x, w)


# ---------------------------------------------------------------------------
# whole-prompt flash attention (B5)
# ---------------------------------------------------------------------------

def flash_inputs(torch, H, Hkv, D, B, T, window, dtype, seed):
    """q [B,H,T,D], k/v [B,Hkv,T,D] of a T-token prompt, causal."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((B, H, T, D), device=DEV, generator=g)
    k = torch.randn((B, Hkv, T, D), device=DEV, generator=g)
    v = torch.randn((B, Hkv, T, D), device=DEV, generator=g)
    return (q.to(dtype), k.to(dtype), v.to(dtype)), dict(causal=True,
                                                         window=window)


def visible_pairs(T, causal, window):
    """Query-key pairs a T-token prompt's mask lets through (per head)."""
    if not causal:
        return sum(min(T - i + window - 1, T) if window > 0 else T
                   for i in range(T))
    if window <= 0:
        return T * (T + 1) // 2
    return sum(min(i + 1, window) for i in range(T))


def flash_cost(args, kw):
    q, k, _ = args
    B, H, T, D = q.shape
    el = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * el
    flops = 4.0 * B * H * D * visible_pairs(T, kw["causal"], kw["window"])
    return bound(nbytes, flops, dtype_name(q))


def flash_library(torch, args, kw):
    """``scaled_dot_product_attention`` with K/V repeated to the H query
    heads beforehand: ``is_causal`` without a window, a boolean band mask
    with one."""
    import torch.nn.functional as F
    q, k, v = args
    G = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(G, dim=1).contiguous()
    v = v.repeat_interleave(G, dim=1).contiguous()
    if kw["window"] <= 0:
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=kw["causal"])
    t = torch.arange(q.shape[2], device=q.device)
    mask = (t[None] <= t[:, None]) & (t[:, None] - t[None] < kw["window"])
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


# ---------------------------------------------------------------------------
# dense-arena decode attention (B6) and packed prefill over the arena (B2)
# ---------------------------------------------------------------------------

def dense_decode_inputs(torch, H, Hkv, D, B, S, dtype, seed):
    """One query token per row against a dense arena [B,S,Hkv,D]: lengths
    S - 37 at batch 1; 1, 2049, S and 777 at batch 4; see
    ``arena_inputs``."""
    return arena_inputs(torch, H, Hkv, D, S, [S - 37] if B == 1
                        else [1, 2049, S, 777][:B], dtype, seed)


def arena_inputs(torch, H, Hkv, D, S, lengths, dtype, seed):
    """One query token per row of ``lengths`` against a dense arena
    [B,S,Hkv,D].  Every row at or past a length holds NaN."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    B = len(lengths)
    k = torch.randn((B, S, Hkv, D), device=DEV, generator=g)
    v = torch.randn((B, S, Hkv, D), device=DEV, generator=g)
    for b, n in enumerate(lengths):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    q = torch.randn((B, H, D), device=DEV, generator=g)
    return (q.to(dtype), k.to(dtype), v.to(dtype),
            torch.tensor(lengths, dtype=torch.int32, device=DEV))


def dense_decode_cost(q, k, v, lengths):
    B, H, D = q.shape
    Hkv = k.shape[2]
    el = q.element_size()
    tokens = sum(min(n, k.shape[1]) for n in lengths.cpu().tolist())
    nbytes = 2 * q.numel() * el + 2 * tokens * Hkv * D * el + 4 * B
    return bound(nbytes, 4.0 * tokens * H * D, dtype_name(q))


def dense_decode_library(torch, q, k, v, lengths):
    """``scaled_dot_product_attention`` over the arena with K/V repeated to
    the H query heads and masked rows zeroed beforehand, and a boolean
    length mask."""
    import torch.nn.functional as F
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    ok = torch.arange(S, device=q.device)[None] < lengths[:, None].long()
    k = torch.where(ok[:, :, None, None], k, torch.zeros_like(k))
    v = torch.where(ok[:, :, None, None], v, torch.zeros_like(v))
    k = k.permute(0, 2, 1, 3).repeat_interleave(H // Hkv, dim=1).contiguous()
    v = v.permute(0, 2, 1, 3).repeat_interleave(H // Hkv, dim=1).contiguous()
    qq, mask = q[:, :, None, :], ok[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask)


def arena_prefill_inputs(torch, H, Hkv, D, dtype, seed, R=DENSE_MAX_LEN):
    """Packed prefill over a dense arena [4, R, Hkv, D] viewed as 4 pages
    of R tokens (block table = slot): segments of 203, 77 and 130 tokens
    with histories of 6144, 2048 and 0 tokens in slots 1, 3 and 0, and a
    pad segment (slot sentinel 4, start == T).  Arena rows at or past a
    segment's offset — and all of the unused slot 2 — hold NaN."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    lens, offs, slots = [203, 77, 130, 0], [6144, 2048, 0, 0], [1, 3, 0, 4]
    starts, cur = [], 0
    for n in lens[:-1]:
        starts.append(cur)
        cur = -(-(cur + n) // 8) * 8
    T = cur + 16
    starts.append(T)
    k = torch.randn((4, R, Hkv, D), device=DEV, generator=g)
    v = torch.randn((4, R, Hkv, D), device=DEV, generator=g)
    k[2] = float("nan")
    v[2] = float("nan")
    for o, s in zip(offs[:-1], slots[:-1]):
        k[s, o:] = float("nan")
        v[s, o:] = float("nan")
    q = torch.randn((T, H, D), device=DEV, generator=g)
    kn = torch.randn((T, Hkv, D), device=DEV, generator=g)
    vn = torch.randn((T, Hkv, D), device=DEV, generator=g)
    i32 = dict(dtype=torch.int32, device=DEV)
    return ((q.to(dtype), kn.to(dtype), vn.to(dtype), k.to(dtype),
             v.to(dtype), torch.tensor(slots, **i32)[:, None],
             torch.tensor(starts, **i32), torch.tensor(offs, **i32),
             torch.tensor(lens, **i32)),
            dict(ring=R, window=0))


# ---------------------------------------------------------------------------
# Mamba-2 intra-chunk SSD (B7)
# ---------------------------------------------------------------------------

SSD_GEOM = dict(H=80, P=64, N=128)   # mamba2-2.7b: 80 heads of 64, state 128


def ssd_inputs(torch, nc, H, Q, P, N, dtype, seed, span=None):
    """x [nc,H,Q,P] and B/C [nc,Q,N] standard normal in ``dtype``; A and dt
    f32, made as ``ssm_prefill`` makes them from the init's A_log and
    dt_bias: A = -exp(log(linspace(1, 16, H))), dt = softplus(u + dt_bias)
    with u standard normal and dt_bias = softplus^-1 of a log-uniform draw
    in [1e-3, 1e-1].  With ``span``, each (chunk, head)'s dt is then scaled
    so that its cs spans exactly ``span``: sum_j dt_j |A_h| = span."""
    import math
    import torch.nn.functional as F
    g = torch.Generator(device=DEV).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=DEV)
    x = torch.randn((nc, H, Q, P), generator=g, **f32)
    dt0 = torch.exp(math.log(1e-3) + torch.rand((H,), generator=g, **f32)
                    * (math.log(1e-1) - math.log(1e-3)))
    dt = F.softplus(torch.randn((nc, H, Q), generator=g, **f32)
                    + torch.log(torch.expm1(dt0))[None, :, None])
    A = -torch.exp(torch.log(torch.linspace(1.0, 16.0, H, **f32)))
    if span is not None:
        dt = dt * (span / (dt.sum(-1, keepdim=True)
                           * A.abs()[None, :, None]))
    B = torch.randn((nc, Q, N), generator=g, **f32)
    C = torch.randn((nc, Q, N), generator=g, **f32)
    return x.to(dtype), dt, A, B.to(dtype), C.to(dtype)


def ssd_bytes(x, dt, A, Bm, Cm):
    """Every input read once, y and the states written once (f32)."""
    nc, H, Q, P = x.shape
    N = Bm.shape[-1]
    return ((x.numel() + Bm.numel() + Cm.numel()) * x.element_size()
            + (dt.numel() + A.numel()) * 4 + 4 * nc * H * (Q * P + N * P))


def ssd_cost(x, dt, A, Bm, Cm):
    """Bytes: ``ssd_bytes``.  Operations: the causal half the function
    needs — per chunk C B^T over the Q(Q+1)/2 pairs j <= i (2 N each); per
    chunk and head G (dt x) over those pairs (2 P each) and the state,
    2 Q N P."""
    nc, H, Q, P = x.shape
    N = Bm.shape[-1]
    pairs = Q * (Q + 1) // 2
    flops = nc * (2.0 * pairs * N + H * (2.0 * pairs * P + 2.0 * Q * N * P))
    return bound(ssd_bytes(x, dt, A, Bm, Cm), flops, dtype_name(x))


def ssd_route_cost(x, dt, A, Bm, Cm):
    """``ssd_bytes`` against the operations B7's tensor-core route issues
    for the same causal half: G' x and the state as three bf16 products
    each (the split operand's hi, mid and lo), C B^T as one, at the bf16
    peak — the least time of that route's arithmetic."""
    nc, H, Q, P = x.shape
    N = Bm.shape[-1]
    pairs = Q * (Q + 1) // 2
    flops = nc * (2.0 * pairs * N
                  + 3 * H * (2.0 * pairs * P + 2.0 * Q * N * P))
    return bound(ssd_bytes(x, dt, A, Bm, Cm), flops, "bfloat16")


def ssd_library(torch, x, dt, A, Bm, Cm):
    """The same function as three batched ``torch.matmul`` calls over a
    materialised L (made beforehand, with dt x and the decay weights):
    C B^T, (C B^T o L)(dt x) and B^T (decay dt x) — a yardstick only."""
    Q = x.shape[2]
    cs = torch.cumsum(dt * A[None, :, None], dim=-1)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(tri, cs[..., :, None] - cs[..., None, :],
                              -float("inf")))
    xb = x.float() * dt[..., None]
    xw = xb * torch.exp(cs[..., -1:] - cs)[..., None]
    Bf, Cf = Bm.float(), Cm.float()
    Bt = Bf.transpose(-1, -2)[:, None]

    def run():
        cb = torch.matmul(Cf, Bf.transpose(-1, -2))
        return torch.matmul(cb[:, None] * L, xb), torch.matmul(Bt, xw)
    return run


def ssd_tolerance(torch, x, dt, A, Bm, Cm):
    """(tolerance, bound) of B7, per element of y and the states (flattened
    together): |err| <= e (2Q + 2N + 16 + 4 Q S) A, e = 2^-24, where A is the
    plain version on |x|, |B| and |C| (the sum of the magnitudes of every
    term) and S = sum_j |dt_j A_h| over the chunk (= |cs_last|).  Both sides
    compute in f32 from the same values (bf16 inputs widen exactly).  Each
    side's sums over at most Q (j) and N (C.B) terms are off by at most
    (Q + N) e times their magnitudes; the products and the exp round about 8
    times per term; each cumulative sum cs_k is off by at most k e S, so
    cs_i - cs_j by at most 2 Q e S a side and exp(cs_i - cs_j) relatively
    by as much: 4 Q e S between the two sides.  The bound is that worst
    case, so a result missing one 64-row tile of one head block fails it
    (``tests/test_torch_smoke.py``)."""
    from repro_torch.kernels import ref
    Q, N = x.shape[2], Bm.shape[-1]
    e = 2.0 ** -24
    S = (dt * A.abs()[None, :, None]).sum(-1)                  # [nc,H]
    fac = e * (2 * Q + 2 * N + 16 + 4 * Q * S)[..., None, None]
    ay, ast = ref.ssd_chunk_ref(x.float().abs(), dt, A, Bm.float().abs(),
                                Cm.float().abs())
    return (dict(atol=0.0, rtol=0.0, p_abs=1.0),
            torch.cat([(fac * ay).flatten(), (fac * ast).flatten()]))


def flat(out):
    """A kernel's result as one tensor: B7's (y, states) flattened and
    concatenated, any other as it is."""
    if isinstance(out, tuple):
        import torch
        return torch.cat([t.flatten() for t in out])
    return out


# ---------------------------------------------------------------------------
# one kernel check: kernel vs plain version, times, bound
# ---------------------------------------------------------------------------

def ref_of(name):
    from repro_torch.kernels import ref
    return {"paged_decode_attention": ref.paged_decode_attention_ref,
            "packed_prefill_attention": ref.packed_prefill_attention_ref,
            "gemv": ref.gemv_ref,
            "paged_decode_attention_q4": ref.paged_decode_attention_q4_ref,
            "flash_attention": ref.flash_attention_ref,
            "decode_attention": ref.decode_attention_ref,
            "ssd_chunk": ref.ssd_chunk_ref,
            "matmul": matmul_plain,
            }[name]


def cost_and_library(torch, name, args, kw):
    if name == "paged_decode_attention":
        return decode_cost(*args), decode_library(torch, *args)
    if name == "packed_prefill_attention":
        return prefill_cost(args, kw), prefill_library(torch, args, kw)
    if name == "gemv":
        return gemv_cost(*args), gemv_library(torch, *args)
    if name == "flash_attention":
        return flash_cost(args, kw), flash_library(torch, args, kw)
    if name == "decode_attention":
        return dense_decode_cost(*args), dense_decode_library(torch, *args)
    if name == "ssd_chunk":
        return ssd_cost(*args), ssd_library(torch, *args)
    if name == "matmul":
        x, w = args
        return gemm_cost(x, w), lambda: torch.matmul(x, w)
    return q4_cost(*args), q4_library(torch, *args)


LIBRARY = {"gemv": "torch.matmul on the weight dequantized to x's dtype "
                   "beforehand (yardstick only)",
           "ssd_chunk": "three batched torch.matmul calls over L, dt x and "
                        "the decay weights made beforehand (yardstick only)",
           "matmul": "torch.matmul on the same tensors (yardstick only)",
           "paged_decode_attention_q4": "scaled_dot_product_attention on "
                                        "pre-gathered K/V dequantized to "
                                        "q's dtype (yardstick only)"}

def check_kernel(torch, timer, name, args, kw, label, timed=True,
                 bound_of=tolerance):
    """Kernel against its plain version on ``args`` within
    ``bound_of(torch, name, args, kw, dtype)``; with ``timed``, also the
    CUDA-event times of kernel, plain version and library call."""
    kernel, plain = kernel_functions()[name], ref_of(name)
    dt = dtype_name(args[0])
    before = route_counts().get(name)
    got = flat(kernel(*args, **kw))
    want = flat(plain(*args, **kw))
    torch.cuda.synchronize()
    tol, abs_ctx = bound_of(torch, name, args, kw, dt)
    err, ok, worst = close(torch, got, want, dt, abs_ctx, tol)
    row = dict(name=name, shape=label, dtype=dt, max_abs_err=err, tol=tol,
               worst_element=worst)
    if timed:
        (bound_ms, bound_by), library = cost_and_library(torch, name, args,
                                                         kw)
        row.update(kernel_ms=timer(lambda: kernel(*args, **kw)),
                   plain_ms=timer(lambda: plain(*args, **kw)),
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=timer(library),
                   library=LIBRARY.get(
                       name, "scaled_dot_product_attention on pre-gathered "
                             "dense K/V (yardstick only)"))
    if before is not None:
        # every launch of this check took the route its inputs name
        path = expected_route(name, args)
        took = {r: n - before[r] for r, n in route_counts()[name].items()}
        row["route"] = path
        if not took[path] or any(n for r, n in took.items() if r != path):
            ok = False
            err = f"{err}, routes {took}, expected {path}"
    emit("kernel", **row, ok=ok)
    if not ok:
        FAILED.append(f"{name} [{label}, {dt}]: max |err| {err}")
    return row


# (H, Hkv, D) of the two served models
GEOMS = {"qwen3-8b": (32, 8, 128), "llama2-7b": (32, 32, 128)}


def kernel_phase(torch, timer):
    seed = 0
    for dtype in (torch.float32, torch.bfloat16):
        for model, (H, Hkv, D) in GEOMS.items():
            for ctx in (512, 4096):
                for B in (1, 4):
                    seed += 1
                    args = decode_inputs(torch, H, Hkv, D, B, ctx, dtype, seed)
                    check_kernel(torch, timer, "paged_decode_attention", args,
                                 {}, f"{model} B={B} ctx={ctx}")
                seed += 1
                args, kw = prefill_inputs(torch, H, Hkv, D, ctx, dtype, seed)
                check_kernel(torch, timer, "packed_prefill_attention", args,
                             kw, f"{model} 4 segments, history<={ctx}")
                for B in (1, 4):
                    seed += 1
                    args = q4_inputs(torch, H, Hkv, D, B, ctx, dtype, seed)
                    check_kernel(torch, timer, "paged_decode_attention_q4",
                                 args, {}, f"{model} B={B} ctx={ctx}")
            for K, N in GEMV_SHAPES[model]:
                for M in (1, 4, 32):
                    seed += 1
                    args = gemv_inputs(torch, M, K, N, dtype, seed)
                    check_kernel(torch, timer, "gemv", args, {},
                                 f"{model} M={M} K={K} N={N}")
            # the float variant (weights in x's dtype, no scale): off the
            # serving path, held all the same
            K, N = GEMV_SHAPES[model][-1]
            seed += 1
            args = gemv_inputs(torch, 4, K, N, dtype, seed, quantized=False)
            check_kernel(torch, timer, "gemv", args, {},
                         f"{model} M=4 K={K} N={N}, float weights")
            for B, T, window in ((1, 2560, 0), (1, 2560, 1024), (1, 4000, 0),
                                 (1, 4000, 1024), (2, 2560, 0)):
                seed += 1
                args, kw = flash_inputs(torch, H, Hkv, D, B, T, window, dtype,
                                        seed)
                check_kernel(torch, timer, "flash_attention", args, kw,
                             f"{model} B={B} T={T} window={window}")
            for B in (1, 4):
                seed += 1
                args = dense_decode_inputs(torch, H, Hkv, D, B, 4160, dtype,
                                           seed)
                check_kernel(torch, timer, "decode_attention", args, {},
                             f"{model} B={B} S=4160")
            seed += 1
            args, kw = arena_prefill_inputs(torch, H, Hkv, D, dtype, seed)
            check_kernel(torch, timer, "packed_prefill_attention", args, kw,
                         f"{model} dense arena view, P=R={DENSE_MAX_LEN}")
        # B7 at mamba2 geometry: an 8192-token prompt's 32 chunks of 256, a
        # 200-token prompt's one chunk and the 24-token warm-up's
        for nc, Q in ((32, 256), (1, 200), (1, 24)):
            seed += 1
            args = ssd_inputs(torch, nc, Q=Q, dtype=dtype, seed=seed,
                              **SSD_GEOM)
            check_kernel(torch, timer, "ssd_chunk", args, {},
                         f"mamba2-2.7b nc={nc} Q={Q}")
        kernel_phase_b8_d64(torch, timer, dtype)
        kernel_phase_routes(torch, timer, dtype)
        kernel_phase_b3_b8(torch, timer, dtype)
        kernel_phase_decode_edges(torch, timer, dtype)
        kernel_phase_ssd_edges(torch, timer, dtype)
    require_all_agree("kernel")


def kernel_phase_b8_d64(torch, timer, dtype):
    """B8 at the two models' prefill GEMM shapes for a 2048-token chunk
    (2048 x 4096 x 12288 among them, the benchmark runner's analytic
    shape), at M = 37 and at the edges (``GEMM_EDGES``); B5 and B2 at head
    dim 64, the benchmark runner's.  Seeds of their own, so the other
    checks' inputs stay as they were."""
    seed = 1000 + 100 * (dtype == torch.bfloat16)
    for model, shapes in GEMM_SHAPES.items():
        kw = {"bk": 256} if model == "llama2-7b" else {}
        for K, N in shapes:
            seed += 1
            args = gemm_inputs(torch, GEMM_M, K, N, dtype, seed)
            check_kernel(torch, timer, "matmul", args, kw,
                         f"{model} M={GEMM_M} K={K} N={N}")
    seed += 1
    args = gemm_inputs(torch, 37, 4096, 4096, dtype, seed)
    check_kernel(torch, timer, "matmul", args, {}, "M=37 K=4096 N=4096")
    for (M, K, N), kw in GEMM_EDGES:
        seed += 1
        args = gemm_inputs(torch, M, K, N, dtype, seed)
        check_kernel(torch, timer, "matmul", args, kw,
                     f"edges M={M} K={K} N={N} {kw}")
    for H, Hkv, T in ((8, 4, 256), (32, 8, 2560)):
        seed += 1
        args, kw = flash_inputs(torch, H, Hkv, 64, 1, T, 0, dtype, seed)
        check_kernel(torch, timer, "flash_attention", args, kw,
                     f"D=64 H={H} Hkv={Hkv} T={T}")
    seed += 1
    args, kw = prefill_inputs(torch, 8, 4, 64, 512, dtype, seed)
    check_kernel(torch, timer, "packed_prefill_attention", args, kw,
                 "D=64 H=8 Hkv=4 4 segments, history<=512")


def kernel_phase_routes(torch, timer, dtype):
    """What B5's and B2's two routes need beyond the cases above: B2 over a
    sliding-window pool whose history has wrapped (ring < offset), at both
    models' geometry, in either dtype; in bf16, B5 at a T that is no
    multiple of 64 with a window that cuts key tiles (T = 4000, window
    1000), at both geometries, and on the CUDA-core tile B2 over pages of
    12 tokens and B5 and B2 at head dim 16 (the reduced configurations').
    Seeds of their own, so the other checks' inputs stay as they were."""
    seed = 2000 + 100 * (dtype == torch.bfloat16)
    for model, (H, Hkv, D) in GEOMS.items():
        seed += 1
        args, kw = ring_prefill_inputs(torch, H, Hkv, D, dtype, seed)
        check_kernel(torch, timer, "packed_prefill_attention", args, kw,
                     f"{model} sliding-window pool, ring={kw['ring']} < "
                     "offset")
    if dtype != torch.bfloat16:
        return
    for model, (H, Hkv, D) in GEOMS.items():
        seed += 1
        args, kw = flash_inputs(torch, H, Hkv, D, 1, 4000, 1000, dtype, seed)
        check_kernel(torch, timer, "flash_attention", args, kw,
                     f"{model} B=1 T=4000 window=1000")
    # pages of 12 tokens: no multiple of 8, so the CUDA-core tile at D = 128
    seed += 1
    args, kw = prefill_inputs(torch, 32, 8, 128, 512, dtype, seed, page=12)
    check_kernel(torch, timer, "packed_prefill_attention", args, kw,
                 "qwen3-8b 4 segments, history<=512, pages of 12")
    # the reduced qwen3-8b's 4 query heads over 1 kv head, D = 16
    seed += 1
    args, kw = flash_inputs(torch, 4, 1, 16, 1, 2100, 0, dtype, seed)
    check_kernel(torch, timer, "flash_attention", args, kw,
                 "D=16 H=4 Hkv=1 T=2100")
    seed += 1
    args, kw = prefill_inputs(torch, 4, 1, 16, 512, dtype, seed)
    check_kernel(torch, timer, "packed_prefill_attention", args, kw,
                 "D=16 H=4 Hkv=1 4 segments, history<=512")
    check_route_refusals(torch, seed + 1)


def check_route_refusals(torch, seed):
    """The C entry points launch the route the wrapper names and refuse
    inputs that route cannot take, so the per-route counts are of kernels
    launched.  With ``route`` made to name the route the inputs cannot
    take, each call here must raise and launch nothing."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm_cim as gm
    from repro_torch.kernels import gemv_cid as gc
    from repro_torch.kernels import ssd_scan as ss
    module = {"flash_attention": fa, "packed_prefill_attention": fa,
              "gemv": gc, "matmul": gm, "ssd_chunk": ss}
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("flash_attention", "f32 D=128", "wgmma",
         flash_inputs(torch, 32, 8, 128, 1, 256, 0, f32, seed)),
        ("flash_attention", "bf16 D=16", "wgmma",
         flash_inputs(torch, 4, 1, 16, 1, 256, 0, bf16, seed + 1)),
        ("flash_attention", "bf16 D=128", "tile",
         flash_inputs(torch, 32, 8, 128, 1, 256, 0, bf16, seed + 2)),
        ("packed_prefill_attention", "f32 D=128", "wgmma",
         prefill_inputs(torch, 32, 8, 128, 64, f32, seed + 3)),
        ("packed_prefill_attention", "bf16 D=128 pages of 12", "wgmma",
         prefill_inputs(torch, 32, 8, 128, 64, bf16, seed + 4, page=12)),
        ("matmul", "f32 M=256 K=4096 N=1024", "wgmma",
         (gemm_inputs(torch, 256, 4096, 1024, f32, seed + 5), {})),
        ("matmul", "bf16 M=37 K=41 N=24", "wgmma",
         (gemm_inputs(torch, 37, 41, 24, bf16, seed + 6), {})),
        ("gemv", "f32 x, int8 w, M=4 K=4096 N=1024", "wgmma",
         (gemv_inputs(torch, 4, 4096, 1024, f32, seed + 7), {})),
        # rows of 1000 int8 bytes: not 16-byte aligned
        ("gemv", "bf16 x, int8 w, M=4 K=4096 N=1000", "wgmma",
         (gemv_inputs(torch, 4, 4096, 1000, bf16, seed + 8), {})),
        # B7's tensor-core route takes bf16 at P = 64 and N a multiple of 8
        ("ssd_chunk", "f32 P=64 N=128", "mma",
         (ssd_inputs(torch, 1, 8, 64, 64, 128, f32, seed + 9), {})),
        ("ssd_chunk", "bf16 P=32 N=128", "mma",
         (ssd_inputs(torch, 1, 8, 64, 32, 128, bf16, seed + 10), {})),
        ("ssd_chunk", "bf16 P=64 N=100", "mma",
         (ssd_inputs(torch, 1, 8, 64, 64, 100, bf16, seed + 11), {})),
    ]
    for name, label, wrong, (args, kw) in cases:
        fn, mod = kernel_functions()[name], module[name]
        before = fn.launches
        real = mod.route
        mod.route = lambda *a, _wrong=wrong: _wrong
        try:
            fn(*args, **kw)
            refused = False
        except RuntimeError:
            refused = True
        finally:
            mod.route = real
        ok = refused and fn.launches == before
        emit("route_refusal", name=name, inputs=label, route=wrong,
             refused=refused, ok=ok)
        if not ok:
            FAILED.append(f"{name} [{label}]: route {wrong} was not refused")


def kernel_phase_b3_b8(torch, timer, dtype):
    """What B3's and B8's two routes need beyond the cases above: B3 over
    int8 weights that take every value -127 ... 127; B8 at N = 1024, where
    the tensor-core route takes 128-column tiles; and two launches of each
    on the same inputs giving the same bits, on either route (the split-K
    sums of B3 are taken in chunk order and its tile counters reset by each
    launch).  Seeds of their own, so the other checks' inputs stay as they
    were."""
    from repro_torch.kernels import gemm_cim as gm
    seed = 3000 + 100 * (dtype == torch.bfloat16)
    g = torch.Generator(device=DEV).manual_seed(seed)
    K, N = 4096, 4096
    q = torch.randint(-127, 128, (K, N), device=DEV, generator=g,
                      dtype=torch.int8)
    q.view(-1)[:255] = torch.arange(-127, 128, device=DEV, dtype=torch.int8)
    scale = torch.rand(N, device=DEV, generator=g) / (127 * K ** 0.5)
    x = torch.randn((4, K), device=DEV, generator=g).to(dtype)
    check_kernel(torch, timer, "gemv", (x, q, scale), {},
                 f"M=4 K={K} N={N}, int8 weights -127..127", timed=False)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    seed += 1
    args = gemm_inputs(torch, GEMM_M, 4096, 1024, dtype, seed)
    check_kernel(torch, timer, "matmul", args, {},
                 f"M={GEMM_M} K=4096 N=1024, block_n "
                 f"{gm.block_n(GEMM_M, 1024, sms)}", timed=False)
    (M, K, N), edge_kw = GEMM_EDGES[1]
    repeats = [("gemv", gemv_inputs(torch, 4, 4096, 12288, dtype, seed + 1),
                {}),
               ("gemv", gemv_inputs(torch, 32, 12288, 4096, dtype, seed + 2),
                {}),
               ("gemv", gemv_inputs(torch, 4, 4096, 11008, dtype, seed + 3,
                                    quantized=False), {}),
               ("matmul", gemm_inputs(torch, GEMM_M, 4096, 12288, dtype,
                                      seed + 4), {}),
               ("matmul", gemm_inputs(torch, M, K, N, dtype, seed + 5),
                edge_kw)]
    for name, args, kw in repeats:
        check_same_bits(torch, name, args, kw, shapes_label(args, kw),
                        route=expected_route(name, args))


def check_same_bits(torch, name, args, kw, label, **extra):
    """Two launches of ``name`` on the same inputs must give the same
    bits."""
    fn = kernel_functions()[name]
    a, b = flat(fn(*args, **kw)), flat(fn(*args, **kw))
    torch.cuda.synchronize()
    same = bool(torch.equal(a, b))
    emit("repeat", name=name, inputs=label, **extra, identical=same, ok=same)
    if not same:
        FAILED.append(f"{name} [{label}]: two launches differ")


# an arena length that no stage (4 or 16 tokens) or split divides, and a
# pool context that ends inside a page
DECODE_EDGE_S = 4099
DECODE_EDGE_CTX = 4103


def decode_edge_lengths(torch, dtype, H, Hkv, D, capacity, longest):
    """Lengths at the edges of the decode walk (B1, B4, B6) over a cache of
    storage ``dtype`` for a call whose longest sequence has ``longest``
    tokens: 1, one stage (a warp's chunk) +-1, one split (the split the
    kernel takes for this call, ``split_for``) +-1, and the longest
    last."""
    from repro_torch.kernels import decode_attention as da
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = da.plan(dtype, D, H // Hkv, Hkv, 8, capacity, sms)
    w, sp = p.warp_tokens, da.split_for(p, longest, Hkv)
    return [1, w - 1, w, w + 1, sp - 1, sp, sp + 1, longest], w, sp


def kernel_phase_decode_edges(torch, timer, dtype):
    """B6, B1 and B4 at the edges of their walk, at both models' geometry:
    the lengths of ``decode_edge_lengths`` over an arena of 4099 positions
    (no multiple of a stage) and over a pool whose block tables list pages
    out of order, with a sentinel page inside the last row and lengths that
    end inside a page, for B4 packed in int4 with NaN scales on every
    masked row (its stage and split are the packed geometry's); then two
    launches of each on the same inputs, which must give the same bits (the
    in-kernel combine sums in split order and each launch leaves its
    counters at zero).  Seeds of their own, so the other checks' inputs
    stay as they were."""
    from repro_torch.kernels import decode_attention as da
    seed = 4000 + 100 * (dtype == torch.bfloat16)
    seed_q4 = 4500 + 100 * (dtype == torch.bfloat16)
    for model, (H, Hkv, D) in GEOMS.items():
        S = DECODE_EDGE_S
        lengths, w, sp = decode_edge_lengths(torch, dtype, H, Hkv, D, S, S)
        seed += 1
        dense = arena_inputs(torch, H, Hkv, D, S, lengths, dtype, seed)
        check_kernel(torch, timer, "decode_attention", dense, {},
                     f"{model} edges S={S} stage={w} split={sp} "
                     f"lengths={lengths}", timed=False)
        ctx = DECODE_EDGE_CTX
        W = -(-ctx // PAGE) + 2
        lengths, w, sp = decode_edge_lengths(torch, dtype, H, Hkv, D,
                                             W * PAGE, ctx)
        seed += 1
        paged = paged_inputs(torch, H, Hkv, D, lengths, dtype, seed)
        check_kernel(torch, timer, "paged_decode_attention", paged, {},
                     f"{model} edges pages out of order, stage={w} "
                     f"split={sp} lengths={lengths}", timed=False)
        lengths, w, sp = decode_edge_lengths(torch, da.PACKED, H, Hkv, D,
                                             W * PAGE, ctx)
        seed_q4 += 1
        q4 = q4_pages(torch, H, Hkv, D, lengths, dtype, seed_q4)
        check_kernel(torch, timer, "paged_decode_attention_q4", q4, {},
                     f"{model} edges int4 pages out of order, stage={w} "
                     f"split={sp} lengths={lengths}", timed=False)
        for name, args in (("decode_attention", dense),
                           ("paged_decode_attention", paged),
                           ("paged_decode_attention_q4", q4)):
            check_same_bits(torch, name, args, {},
                            f"{model} edges, " + shapes_label(args, {}))


def kernel_phase_ssd_edges(torch, timer, dtype):
    """B7 at the edges of its routes at mamba2's geometry (H = 80, P = 64,
    N = 128): chunks of Q = 1, 24, 200 and 256 positions (rows and keys
    past Q in a 16-, 64-row tile, or none) over one chunk and over 33; 8
    chunks whose cs spans 100 in every head (exp(cs_i - cs_j) underflows
    far below the diagonal, and the tolerance's 4 Q S term is large where
    the spans of ``ssd_inputs`` are small); and two launches on the same
    inputs giving the same bits.  bf16 takes the tensor cores, f32 the
    tile (``check_kernel`` requires the route ``route`` names).  Seeds of
    their own, so the other checks' inputs stay as they were."""
    seed = 5000 + 100 * (dtype == torch.bfloat16)
    for nc in (1, 33):
        for Q in (1, 24, 200, 256):
            seed += 1
            args = ssd_inputs(torch, nc, Q=Q, dtype=dtype, seed=seed,
                              **SSD_GEOM)
            check_kernel(torch, timer, "ssd_chunk", args, {},
                         f"edges nc={nc} Q={Q}", timed=False)
    seed += 1
    args = ssd_inputs(torch, 8, Q=256, dtype=dtype, seed=seed, span=100.0,
                      **SSD_GEOM)
    check_kernel(torch, timer, "ssd_chunk", args, {},
                 "edges nc=8 Q=256, cs spans 100 in every head", timed=False)
    check_same_bits(torch, "ssd_chunk", args, {},
                    "edges, " + shapes_label(args, {}),
                    route=expected_route("ssd_chunk", args))


def require_all_agree(phase: str) -> None:
    failed, FAILED[:] = list(FAILED), []
    if failed:
        raise AssertionError(f"{phase}: kernels disagree with their plain "
                             "versions:\n  " + "\n  ".join(failed))


# ---------------------------------------------------------------------------
# the benchmark runner
# ---------------------------------------------------------------------------

def bench_phase(torch, timer):
    """The port's benchmark runner in process on the card,
    ``run.main(["--device", "cuda"])``: the HALO analytic model's paper
    figures and the kernel micro-benchmarks.  Each CSV row is emitted as a
    JSON line and must be finite.  Each kernel of ``ON_PATH["bench"]``
    launches as often as the runner's timing makes it (one warm-up call
    and ``CUDA_REPS`` timed ones per row), every other kernel and every
    plain version never.  Each kernel is then re-checked at every distinct
    set of inputs the runner gave it (as the runner ran it, and cast to
    f32); the kernels line takes each kernel's largest call.  The runner's
    GEMV weights are standard normal, as the reference's are, not scaled
    by their fan-in as the kernel phase's: its f32 products reach |ref| ~
    20, where the fixed 1e-4 of the other f32 checks lies below the
    rounding of a 4096-term f32 sum taken in another order (~100 ulps).
    B3 is held there, in f32 too, to its per-element summation bound
    (``summation_tolerance``), as it is in bf16 and B8 is in both."""
    import contextlib
    import io
    import math
    from repro_torch.benchmarks import kernel_micro
    from repro_torch.benchmarks import run as bench_run

    fns = kernel_functions()
    for fn in fns.values():
        fn.launches = 0
    reset_routes()
    out = io.StringIO()
    t0 = time.monotonic()
    with MainPathProbe(torch, 1, None, keep="each shape") as probe, \
            contextlib.redirect_stdout(out):
        rc = bench_run.main(["--device", "cuda"])
    wall_s = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in fns.items()}
    routes = route_counts()
    lines = out.getvalue().splitlines()
    if rc != 0 or not lines or lines[0] != "name,value,unit,paper":
        raise AssertionError(f"bench: the runner returned {rc}")
    rows = []
    for line in lines[1:]:
        name, value, unit, paper = line.split(",", 3)
        rows.append(dict(name=name, value=float(value), unit=unit,
                         paper=paper))
        emit("bench", **rows[-1])
    emit("bench", rows=len(rows), wall_s=wall_s, launches=launches,
         plain_calls=probe.plain_calls)
    bad = [r["name"] for r in rows if not math.isfinite(r["value"])]
    if bad:
        raise AssertionError(f"bench: rows not finite: {bad}")
    if not any(r["name"].startswith("kernel.matmul.bf16_") for r in rows):
        raise AssertionError("bench: no B8 row at the analytic shape")
    if probe.plain_calls:
        raise AssertionError(f"bench: plain versions called on the card: "
                             f"{probe.plain_calls}")
    # two timed rows each for the GEMV (f32 and int8 weights) and B8 (the
    # f32 row and the bf16 one at the analytic shape), one for the others
    reps = 1 + kernel_micro.CUDA_REPS
    require_launches("bench", launches, {
        "gemv": 2 * reps, "matmul": 2 * reps, "decode_attention": reps,
        "flash_attention": reps, "packed_prefill_attention": reps,
        "paged_decode_attention": 0, "paged_decode_attention_q4": 0,
        "ssd_chunk": 0})
    # the runner's B5, B2 and B3 rows draw f32 inputs (torch.randn), and
    # B8 one f32 row and one bf16 row (the tensor cores)
    require_routes("bench", routes, launches, {
        "matmul": {"wgmma": reps, "tile": reps}, "gemv": "tile",
        "flash_attention": "tile", "packed_prefill_attention": "tile"})
    main = {}
    for name in ON_PATH["bench"]:
        calls = list(probe.inputs[name].values())
        if len(calls) != (2 if name in ("gemv", "matmul") else 1):
            raise AssertionError(f"bench: {name} ran at {len(calls)} sets "
                                 "of input shapes")
        bound_of = summation_tolerance if name == "gemv" else tolerance
        checked = [recheck(torch, timer, name, args, kw, launches[name],
                           "bench main path, " + shapes_label(args, kw),
                           bound_of=bound_of)
                   for args, kw in calls]
        main[name] = max(checked, key=lambda r: r["bound_ms"])
    require_all_agree("bench")
    return main


def shapes_label(args, kw):
    """A kernel call's input shapes and dtypes, and its keywords."""
    parts = ["None" if t is None else
             "x".join(map(str, t.shape)) + f" {dtype_name(t)}" for t in args]
    parts += [f"{k}={v}" for k, v in sorted(kw.items())]
    return "; ".join(parts)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

class MainPathProbe:
    """Wraps the model entry points the engine calls, the kernel wrappers
    and their plain versions for the length of a ``with`` block: checks
    every logit tensor for NaN (one device flag, read once), counts
    prefill and decode steps and every call of a plain version, and keeps
    the inputs the main path gave each kernel for the checks after the
    run — the first packed-prefill, flash-attention and SSD chunk
    launches, of the
    last decode step the first layer's paged decode attention launch and
    its ``GEMV_PER_LAYER`` GEMV calls (wq, wk, wv, wo, gate, up, down), and
    of the first decode step with the most requests decoding the first
    layer's dense decode launch.  With ``keep="each shape"`` it keeps
    instead a copy of each kernel's first call at every distinct set of
    input shapes, dtypes and keywords (the benchmark runner's calls).
    Without an ``engine`` the model entry points are left as they are.
    The kernels' own ``launches`` counters are untouched by it."""

    GEMV_PER_LAYER = 7

    def __init__(self, torch, n_layers: int, engine, keep=None):
        self.torch, self.n_layers, self.engine = torch, n_layers, engine
        self.keep = keep
        self.nan = torch.zeros((), dtype=torch.bool, device=DEV)
        self.steps = {"prefill": 0, "decode": 0}
        self.calls = {name: 0 for name in kernel_functions()}
        self.plain_calls = {}  # plain version -> calls
        self.inputs = {}       # name -> {call in the layer | shapes: (args, kw)}
        self._rows = 0         # most requests decoding in one step so far
        self._busiest = False  # this decode step has more than any before

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.serving import engine as eng
        from repro_torch.serving.types import RequestState
        self._saved = [(ops, attr, getattr(ops, attr)) for attr in
                       ("_da", "_fa", "_gemv", "_ssd", "_gemm", "_ref")]

        def model(fn, step):
            def wrapped(*a, **k):
                if step == "decode":
                    rows = sum(r is not None
                               and r.state == RequestState.DECODING
                               for r in self.engine.slot_req)
                    self._busiest = rows > self._rows
                    self._rows = max(rows, self._rows)
                out = fn(*a, **k)
                self.nan |= self.torch.isnan(out[0]).any()
                self.steps[step] += 1
                return out
            return wrapped

        def kernel(fn, name, keep, per_layer=1):
            # keep: "first" launch (copied), "last" (references), the
            # "busiest" decode step's (copied), or the first at "each
            # shape" (copied; overrides the others)
            keep = self.keep or keep

            def wrapped(*a, **k):
                i = self.calls[name]
                self.calls[name] += 1
                kept = self.inputs.setdefault(name, {})
                if keep == "each shape":
                    j = (tuple(x if x is None else (tuple(x.shape), x.dtype)
                               for x in a), tuple(sorted(k.items())))
                    take = j not in kept
                else:
                    j = i % (self.n_layers * per_layer)
                    take = j < per_layer and {
                        "first": j not in kept, "last": True,
                        "busiest": self._busiest}[keep]
                if take:
                    clone = keep != "last"
                    kept[j] = (tuple(x.clone() if clone and x is not None
                                     else x for x in a), dict(k))
                return fn(*a, **k)
            return wrapped

        def plain(fn):
            def wrapped(*a, **k):
                self.plain_calls[fn.__name__] = (
                    self.plain_calls.get(fn.__name__, 0) + 1)
                return fn(*a, **k)
            return wrapped

        if self.engine is not None:
            self._saved += [(eng, attr, getattr(eng, attr)) for attr in
                            ("forward", "forward_chunk_packed",
                             "prefill_into_arena")]
            eng.forward = model(eng.forward, "decode")
            eng.forward_chunk_packed = model(eng.forward_chunk_packed,
                                             "prefill")
            eng.prefill_into_arena = model(eng.prefill_into_arena, "prefill")
        # the dispatcher reaches the kernel wrappers and the plain versions
        # through its module handles; stand-ins there leave the wrappers
        # (and their counts) untouched.  Paged decode: the last step's pool
        # is final (written before it is read and never after) and a GEMV's
        # inputs are never written again, so references suffice; prefill
        # pools change after the first launch, and a dense arena row may be
        # rewritten by a later request in its slot, so those inputs are
        # copied once.
        ops._da = types.SimpleNamespace(
            paged_decode_attention=kernel(ops._da.paged_decode_attention,
                                          "paged_decode_attention", "last"),
            paged_decode_attention_q4=kernel(
                ops._da.paged_decode_attention_q4,
                "paged_decode_attention_q4", "last"),
            decode_attention=kernel(ops._da.decode_attention,
                                    "decode_attention", "busiest"))
        ops._fa = types.SimpleNamespace(
            packed_prefill_attention=kernel(
                ops._fa.packed_prefill_attention, "packed_prefill_attention",
                "first"),
            flash_attention=kernel(ops._fa.flash_attention,
                                   "flash_attention", "first"))
        ops._gemv = types.SimpleNamespace(gemv=kernel(
            ops._gemv.gemv, "gemv", "last", self.GEMV_PER_LAYER))
        ops._ssd = types.SimpleNamespace(ssd_chunk=kernel(
            ops._ssd.ssd_chunk, "ssd_chunk", "first"))
        ops._gemm = types.SimpleNamespace(matmul=kernel(
            ops._gemm.matmul, "matmul", "first"))
        ops._ref = types.SimpleNamespace(**{
            name: plain(getattr(ops._ref, name)) for name in dir(ops._ref)
            if name.endswith("_ref")})
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        return False


def kernel_functions():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm_cim as gm
    from repro_torch.kernels import gemv_cid as gc
    from repro_torch.kernels import ssd_scan as ss
    return {"paged_decode_attention": da.paged_decode_attention,
            "packed_prefill_attention": fa.packed_prefill_attention,
            "gemv": gc.gemv,
            "paged_decode_attention_q4": da.paged_decode_attention_q4,
            "flash_attention": fa.flash_attention,
            "decode_attention": da.decode_attention,
            "ssd_chunk": ss.ssd_chunk,
            "matmul": gm.matmul}


def make_engine(torch, cfg, params, device, **sc_kw):
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    from repro_torch.serving.scheduler import PhaseAwareConfig
    phase = sc_kw.pop("phase", PhaseAwareConfig())
    sc_kw.setdefault("paged", True)
    sc = ServeConfig(phase=phase, **sc_kw)
    return ServingEngine(cfg, params, sc, device=device)


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if len(xs) % 2 else (
        xs[len(xs) // 2 - 1] + xs[len(xs) // 2]) / 2


def serve_round(reqs, log, wall_s):
    """One round's end-to-end numbers: every request's TTFT and TPOT and
    their medians, and the decode rate over decode-only ticks."""
    decode_only = [t for t in log if t.decode_reqs and not t.prefill_reqs]
    decode_wall = sum(t.wall_s for t in decode_only)
    ttft = [r.ttft * 1e3 for r in reqs]
    tpot = [r.tpot * 1e3 for r in reqs]
    return dict(wall_s=wall_s, steps=len(log), ttft_ms=ttft, tpot_ms=tpot,
                ttft_ms_median=median(ttft), tpot_ms_median=median(tpot),
                decode_tok_s=(sum(len(t.decode_reqs) for t in decode_only)
                              / decode_wall if decode_wall else None))


def serve_rounds(torch, eng, prompts, n_rounds, n_layers):
    """The main path: the first prompt as a short warm-up request (cuBLAS
    handles, allocator; not counted), then the peak-memory statistic and
    every kernel's count set to 0 and the other prompts served
    ``n_rounds`` times under the probe.  Returns the rounds' numbers, the
    probe, each kernel's launches and the steps' tick records."""
    from repro_torch.serving.sampling import SamplingParams

    warm, prompts = prompts[0], prompts[1:]
    eng.generate([warm], SamplingParams(max_new_tokens=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ticks0 = eng.n_ticks
    fns = kernel_functions()
    for fn in fns.values():
        fn.launches = 0
    reset_routes()
    rounds, unfinished = [], False
    with MainPathProbe(torch, n_layers, eng) as probe:
        for _ in range(n_rounds):
            t1, n1 = time.monotonic(), eng.n_ticks
            reqs = eng.generate(prompts, SamplingParams(max_new_tokens=64))
            torch.cuda.synchronize()
            wall_s = time.monotonic() - t1
            unfinished |= any(r.state.value != "done"
                              or len(r.generated) != 64 for r in reqs)
            rounds.append(serve_round(
                reqs, list(eng.tick_log)[-(eng.n_ticks - n1):], wall_s))
    launches = {name: fn.launches for name, fn in fns.items()}
    probe.routes = route_counts()
    log = list(eng.tick_log)[-(eng.n_ticks - ticks0):]
    if unfinished:
        raise AssertionError("not every request finished its 64 tokens")
    if bool(probe.nan):
        raise AssertionError("a logit was NaN")
    if probe.steps["decode"] != len([t for t in log if t.decode_reqs]):
        raise AssertionError("decode steps != ticks that decoded")
    if probe.plain_calls:
        raise AssertionError(f"plain versions called on the card: "
                             f"{probe.plain_calls}")
    return rounds, probe, launches, log


def require_launches(phase, launches, expect):
    """Each kernel launched exactly as often as the main path's steps
    say: > 0 where it is on the path, 0 where it is not."""
    for name, n in expect.items():
        if launches[name] != n or (n == 0) != (name not in ON_PATH[phase]):
            raise AssertionError(f"{phase}: {name} launched {launches[name]} "
                                 f"times, expected {n}")


# the kernels with two routes behind one entry point (tensor cores or the
# tile: kernels/flash_attention.py, gemv_cid.py, gemm_cim.py and
# ssd_scan.py), and the source each is built from
ROUTED = ("flash_attention", "packed_prefill_attention", "gemv", "matmul",
          "ssd_chunk")
SOURCE_OF = {"flash_attention": "flash_attention",
             "packed_prefill_attention": "packed_prefill_attention",
             "gemv": "gemv_int8", "matmul": "gemm_cim",
             "ssd_chunk": "ssd_chunk"}


# the sources none of whose kernels may spill (B6's, B1's, B4's and B7's)
NO_SPILL = ("decode_attention", "paged_decode_attention",
            "paged_decode_attention_q4", "ssd_chunk")


def route_counts():
    """Each two-route kernel's launches by route, as its wrapper counts."""
    fns = kernel_functions()
    return {name: dict(fns[name].routes) for name in ROUTED}


def reset_routes():
    fns = kernel_functions()
    for name in ROUTED:
        for r in fns[name].routes:
            fns[name].routes[r] = 0


def require_routes(phase, routes, launches, want):
    """Every launch of a two-route kernel in ``phase`` took the route
    ``want`` names: one route for all ("wgmma" or "tile"; a kernel whose
    tensor-core route is named otherwise, B7's "mma", has no launch to
    take it), or per kernel a route or a count per route (a kernel the
    dict leaves out may not launch)."""
    for name in ROUTED:
        if name not in routes:
            continue
        w = want.get(name, {}) if isinstance(want, dict) else want
        expect = ({w: launches[name]} if isinstance(w, str) else dict(w))
        got = {r: n for r, n in routes[name].items() if n}
        if got != {r: n for r, n in expect.items() if n}:
            raise AssertionError(f"{phase}: {name} launched {routes[name]} "
                                 f"by route, expected {expect}")


def expected_route(name, args):
    """The route a two-route kernel's inputs name (its wrapper's
    ``route``)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm_cim as gm
    from repro_torch.kernels import gemv_cid as gc
    if name == "gemv":
        x, w = args[0], args[1]
        return gc.route(x.dtype, x.shape[0], x.shape[1], w.shape[1],
                        w.element_size(), _build.aligned16(x, w))
    if name == "matmul":
        x, w = args
        return gm.route(x.dtype, x.shape[1], w.shape[1],
                        _build.aligned16(x, w))
    if name == "ssd_chunk":
        from repro_torch.kernels import ssd_scan as ss
        x, _, _, B, C = args
        return ss.route(x.dtype, x.shape[-1], B.shape[-1],
                        _build.aligned16(x, B, C))
    pages = args[3].shape[1] if name == "packed_prefill_attention" else 8
    return fa.route(args[0].dtype, args[0].shape[-1], pages)


# the kernels each phase's main path runs
ON_PATH = {"serve": ("paged_decode_attention", "packed_prefill_attention"),
           "serve_quantized": ("gemv", "paged_decode_attention_q4",
                               "packed_prefill_attention"),
           "serve_dense": ("flash_attention", "decode_attention"),
           "serve_dense_packed": ("packed_prefill_attention",
                                  "decode_attention"),
           "serve_ssm": ("ssd_chunk",),
           # the benchmark runner's kernel_micro suite
           "bench": ("gemv", "matmul", "decode_attention", "flash_attention",
                     "packed_prefill_attention")}


def free_device_memory(torch):
    """Return a finished phase's tensors to the card: an engine and its
    executor's program table refer to each other, so ``del`` alone leaves
    them to the cycle collector."""
    gc.collect()
    torch.cuda.empty_cache()


def serve_prompts(cfg):
    """A 24-token warm-up prompt, then the four served prompts."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
            for n in (24, 1900, 1000, 333, 37)]


def dense_prompts(cfg):
    """A 24-token warm-up prompt, then the four served prompts of the dense
    phase: three above the 2048-token threshold of whole-prompt attention
    and one below it."""
    import numpy as np
    rng = np.random.default_rng(2)
    return [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
            for n in (24, 8000, 4096, 2304, 1000)]


def serve_row(torch, cfg, prompts, rounds, probe, launches, log, **extra):
    return dict(model=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype,
                prompts=[len(p) for p in prompts[1:]], max_new_tokens=64,
                rounds=rounds, steps=len(log),
                ttft_ms_by_prompt={len(p): median([r["ttft_ms"][i]
                                                   for r in rounds])
                                   for i, p in enumerate(prompts[1:])},
                prefill_steps=probe.steps["prefill"],
                decode_steps=probe.steps["decode"],
                ttft_ms_median=median([r["ttft_ms_median"] for r in rounds]),
                tpot_ms_median=median([r["tpot_ms_median"] for r in rounds]),
                decode_tok_s_median=median([r["decode_tok_s"]
                                            for r in rounds]),
                launches=launches, routes=probe.routes,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                **extra)


def recheck(torch, timer, name, args, kw, launches, label,
            bound_of=tolerance):
    """A kernel at inputs the main path gave it: checked and timed in the
    path's dtype, and checked again on the inputs cast to f32."""
    row = check_kernel(torch, timer, name, args, kw, label,
                       bound_of=bound_of)
    row["launches"] = launches
    f32 = tuple(x.float() if x is not None and x.is_floating_point() else x
                for x in args)
    row["f32"] = check_kernel(torch, timer, name, f32, kw,
                              label + ", cast to f32", timed=False,
                              bound_of=bound_of)
    return row


def serve_phase(torch, timer):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(get_config("qwen3-8b"), dtype="bfloat16")
    t0 = time.monotonic()
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_params(cfg, gen, DEV)
    torch.cuda.synchronize()
    t_init = time.monotonic() - t0
    eng = make_engine(torch, cfg, params, DEV, max_batch=4,
                      page_size=PAGE, n_pages=1024)
    prompts = serve_prompts(cfg)
    t0 = time.monotonic()
    rounds, probe, launches, log = serve_rounds(torch, eng, prompts, ROUNDS,
                                                cfg.n_layers)
    emit("serve", **serve_row(torch, cfg, prompts, rounds, probe, launches, log,
                              init_s=t_init, wall_s=time.monotonic() - t0,
                              preemptions=eng.preemptions))
    L = cfg.n_layers
    require_launches("serve", launches, {
        "packed_prefill_attention": L * probe.steps["prefill"],
        "paged_decode_attention": L * probe.steps["decode"],
        "gemv": 0, "paged_decode_attention_q4": 0, "matmul": 0})
    require_routes("serve", probe.routes, launches, "wgmma")
    main = {name: recheck(torch, timer, name, *probe.inputs[name][0],
                          launches[name], "serve main path")
            for name in ON_PATH["serve"]}
    require_all_agree("serve")
    profile_phase(torch, eng, prompts[1:],
                  median([r["wall_s"] for r in rounds]))
    del eng, params, probe
    free_device_memory(torch)
    return main


def serve_quantized_phase(torch, timer):
    """The serve phase's model and prompts under HALO's decode datapath:
    int8 weights (per output channel, quantized at engine build) and
    packed-int4 KV pages.  Decode matmuls run in the int8 GEMV, decode
    attention in the int4 paged decode kernel, prefill attention in the
    packed-prefill kernel over the pool dequantized to bf16."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(get_config("qwen3-8b"), dtype="bfloat16")
    t0 = time.monotonic()
    gen = torch.Generator(device=DEV).manual_seed(0)
    eng = make_engine(torch, cfg, init_params(cfg, gen, DEV), DEV,
                      max_batch=4, page_size=PAGE, n_pages=1024,
                      weights_dtype="int8", kv_dtype="int4")
    torch.cuda.synchronize()          # the bf16 matmul weights are freed
    torch.cuda.empty_cache()
    t_init = time.monotonic() - t0
    prompts = serve_prompts(cfg)
    t0 = time.monotonic()
    rounds, probe, launches, log = serve_rounds(torch, eng, prompts,
                                                ROUNDS_QUANTIZED,
                                                cfg.n_layers)
    emit("serve_quantized", **serve_row(
        torch, cfg, prompts, rounds, probe, launches, log, weights_dtype="int8",
        kv_dtype="int4", init_s=t_init, wall_s=time.monotonic() - t0,
        preemptions=eng.preemptions))
    L = cfg.n_layers
    require_launches("serve_quantized", launches, {
        "gemv": MainPathProbe.GEMV_PER_LAYER * L * probe.steps["decode"],
        "paged_decode_attention_q4": L * probe.steps["decode"],
        "packed_prefill_attention": L * probe.steps["prefill"],
        "paged_decode_attention": 0, "matmul": 0})
    require_routes("serve_quantized", probe.routes, launches, "wgmma")
    main = {name: recheck(torch, timer, name, *probe.inputs[name][0],
                          launches[name], "serve_quantized main path")
            for name in ("paged_decode_attention_q4",
                         "packed_prefill_attention")}
    calls = [recheck(torch, timer, "gemv", *probe.inputs["gemv"][j],
                     launches["gemv"],
                     f"serve_quantized main path, layer call {j}")
             for j in range(MainPathProbe.GEMV_PER_LAYER)]
    # the same calls timed again with the L2 left clean between them
    clean = Timer(torch, clean=True)
    gemv = kernel_functions()["gemv"]
    for j, c in enumerate(calls):
        args = probe.inputs["gemv"][j][0]
        c["kernel_ms_clean_l2"] = clean(lambda: gemv(*args))
        c["library_ms_clean_l2"] = clean(gemv_library(torch, *args))
    emit("gemv_clean_l2", calls=[
        dict(call=j, kernel_ms=c["kernel_ms_clean_l2"],
             library_ms=c["library_ms_clean_l2"], bound_ms=c["bound_ms"])
        for j, c in enumerate(calls)])
    del clean
    # one layer's seven GEMV calls as one entry: their times and bounds add
    main["gemv"] = dict(
        launches=launches["gemv"],
        kernel_ms=sum(c["kernel_ms"] for c in calls),
        plain_ms=sum(c["plain_ms"] for c in calls),
        bound_ms=sum(c["bound_ms"] for c in calls),
        bound_by=("bytes" if all(c["bound_by"] == "bytes" for c in calls)
                  else "operations"),
        library_ms=sum(c["library_ms"] for c in calls),
        kernel_ms_clean_l2=sum(c["kernel_ms_clean_l2"] for c in calls),
        library_ms_clean_l2=sum(c["library_ms_clean_l2"] for c in calls),
        max_abs_err=max(c["max_abs_err"] for c in calls),
        f32=dict(max_abs_err=max(c["f32"]["max_abs_err"] for c in calls)),
        per="one layer of a decode step: wq, wk, wv, wo, gate, up, down")
    require_all_agree("serve_quantized")
    profile_phase(torch, eng, prompts[1:],
                  median([r["wall_s"] for r in rounds]), of="serve_quantized")
    del eng, probe
    free_device_memory(torch)
    return main


def serve_dense_phase(torch, timer):
    """qwen3-8b on the dense arena: whole-prompt prefill (B5 above 2048
    tokens), dense decode (B6); then the default packed chunks on a second
    dense engine (B2 over the arena's one-page-per-slot view, B6)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.scheduler import PhaseAwareConfig

    cfg = dataclasses.replace(get_config("qwen3-8b"), dtype="bfloat16")
    L = cfg.n_layers
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    torch.cuda.synchronize()
    t_init = time.monotonic() - t0
    prompts = dense_prompts(cfg)
    n_long = sum(len(p) > 2048 for p in prompts[1:])
    main = {}
    for chunk, n_rounds, phase in ((0, ROUNDS_DENSE, "serve_dense"),
                                   (2048, 1, "serve_dense_packed")):
        eng = make_engine(torch, cfg, params, DEV, paged=False, max_batch=4,
                          max_len=DENSE_MAX_LEN,
                          phase=PhaseAwareConfig(prefill_chunk=chunk))
        t0 = time.monotonic()
        rounds, probe, launches, log = serve_rounds(torch, eng, prompts,
                                                    n_rounds, L)
        emit("serve_dense", **serve_row(
            torch, cfg, prompts, rounds, probe, launches, log,
            arena=f"dense [4 x {DENSE_MAX_LEN}]", prefill_chunk=chunk,
            kv_reserved_gb=eng.kv_bytes()["reserved"] / 1e9, init_s=t_init,
            wall_s=time.monotonic() - t0))
        expect = {name: 0 for name in kernel_functions()}
        expect["decode_attention"] = L * probe.steps["decode"]
        if chunk == 0:
            expect["flash_attention"] = L * n_long * n_rounds
        else:
            expect["packed_prefill_attention"] = L * probe.steps["prefill"]
        require_launches(phase, launches, expect)
        require_routes(phase, probe.routes, launches, "wgmma")
        for name in ON_PATH[phase]:
            if name not in main:
                main[name] = recheck(torch, timer, name,
                                     *probe.inputs[name][0], launches[name],
                                     f"{phase} main path")
        require_all_agree(phase)
        if chunk == 0:
            profile_phase(torch, eng, prompts[1:],
                          median([r["wall_s"] for r in rounds]),
                          of="serve_dense")
        del eng, probe
        free_device_memory(torch)
    del params
    free_device_memory(torch)
    return main


def ssm_prompts(cfg):
    """A 24-token warm-up prompt, then the four served prompts of the
    mamba2 phase: lengths the reference takes (a multiple of its 256-token
    SSD chunk, or at most one chunk)."""
    import numpy as np
    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
            for n in (24, 8192, 4096, 2048, 200)]


def serve_ssm_phase(torch, timer):
    """mamba2-2.7b at full width (64 layers, d_model 2560, bf16) on the
    dense arena with whole-prompt prefill: every prompt's every layer runs
    the SSD chunk kernel (B7) once, decode is the recurrent update in
    PyTorch.  B7 is re-checked at the 8192-token prompt's first-layer
    inputs; its layout moves are timed at those inputs; its share of the
    prefill's device time is read from a profiled prefill-only pass."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(get_config("mamba2-2.7b"), dtype="bfloat16")
    L = cfg.n_layers
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0), DEV)
    torch.cuda.synchronize()
    t_init = time.monotonic() - t0
    weights_gb = sum(t.numel() * t.element_size()
                     for t in _leaves(params)) / 1e9
    prompts = ssm_prompts(cfg)
    from repro_torch.serving.scheduler import PhaseAwareConfig
    eng = make_engine(torch, cfg, params, DEV, paged=False, max_batch=4,
                      max_len=SSM_MAX_LEN,
                      phase=PhaseAwareConfig(prefill_chunk=0))
    t0 = time.monotonic()
    rounds, probe, launches, log = serve_rounds(torch, eng, prompts,
                                                ROUNDS_SSM, L)
    n_prompts = len(prompts) - 1
    emit("serve_ssm", **serve_row(
        torch, cfg, prompts, rounds, probe, launches, log,
        arena=f"dense [4 x {SSM_MAX_LEN}]", prefill_chunk=0,
        weights_gb=weights_gb,
        state_reserved_gb=eng.kv_bytes()["reserved"] / 1e9, init_s=t_init,
        wall_s=time.monotonic() - t0))
    if probe.steps["prefill"] != n_prompts * ROUNDS_SSM:
        raise AssertionError(f"serve_ssm: {probe.steps['prefill']} prefill "
                             "steps, expected one per prompt and round")
    expect = {name: 0 for name in kernel_functions()}
    expect["ssd_chunk"] = L * n_prompts * ROUNDS_SSM
    require_launches("serve_ssm", launches, expect)
    # bf16 at P = 64: every launch on the tensor cores
    require_routes("serve_ssm", probe.routes, launches, {"ssd_chunk": "mma"})
    args, kw = probe.inputs["ssd_chunk"][0]
    T0 = len(prompts[1])
    Q = min(cfg.ssm.chunk_size, T0)
    if tuple(args[0].shape[:3]) != (T0 // Q, cfg.ssm.n_heads(cfg.d_model), Q):
        raise AssertionError(f"serve_ssm: the first B7 launch had x "
                             f"{tuple(args[0].shape)}, not the {T0}-token "
                             "prompt's first layer")
    main = {"ssd_chunk": recheck(torch, timer, "ssd_chunk", args, kw,
                                 launches["ssd_chunk"],
                                 f"serve_ssm main path, {T0}-token prompt, "
                                 "layer 0")}
    route_ms, route_by = ssd_route_cost(*args)
    emit("serve_ssm_layout", of=f"B7 at the {T0}-token prompt's layer 0",
         layout_ms=ssd_layout_ms(torch, timer, *args),
         kernel_ms=main["ssd_chunk"]["kernel_ms"],
         bound_ms_mma_route=route_ms, bound_by_mma_route=route_by)
    require_all_agree("serve_ssm")
    profile_phase(torch, eng, prompts[1:],
                  median([r["wall_s"] for r in rounds]), of="serve_ssm")
    prefill_share(torch, eng, prompts[1:])
    del eng, probe, params, args
    free_device_memory(torch)
    return main


def ssd_layout_ms(torch, timer, x, dt, A, Bm, Cm):
    """Device time of the layout moves around one B7 call at these inputs:
    x [B,T,H,P] -> [B*nc,H,Q,P], dt likewise, and y back from [B*nc,H,Q,P]
    to [B,T,H,P] order (``models/ssm.ssd_chunked``)."""
    nc, H, Q, P = x.shape
    x_in = x.transpose(1, 2).reshape(1, nc * Q, H, P).contiguous()
    dt_in = dt.transpose(1, 2).reshape(1, nc * Q, H).contiguous()
    y = torch.empty((nc, H, Q, P), dtype=torch.float32, device=x.device)

    def moves():
        x_in.reshape(nc, Q, H, P).transpose(1, 2).contiguous()
        dt_in.reshape(nc, Q, H).transpose(1, 2).contiguous()
        y.permute(0, 2, 1, 3).contiguous()
    return timer(moves)


# the names of B7's kernels, both routes
SSD_KERNELS = ("ssd_mma", "ssd_y", "ssd_states")


def prefill_share(torch, eng, prompts):
    """B7's share of a prefill's device time: the four prompts once more,
    one new token each (so no decode step runs), under ``torch.profiler``;
    B7's kernels (``ssd_mma`` on the tensor cores; the tile's ``ssd_y``
    and ``ssd_states``) against every kernel's and copy's device time.
    Its launches are outside the counted run."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.sampling import SamplingParams

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.generate(prompts, SamplingParams(max_new_tokens=1))
        torch.cuda.synchronize()

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and device_us(e) > 0]
    busy = sum(device_us(e) for e in rows) / 1e3
    b7 = sum(device_us(e) for e in rows
             if any(k in e.key for k in SSD_KERNELS)) / 1e3
    top = sorted(rows, key=device_us, reverse=True)[:8]
    emit("profile", of="serve_ssm prefill", prompts=[len(p) for p in prompts],
         max_new_tokens=1,
         device_busy_ms=busy if rows else "not measured",
         ssd_chunk_ms=b7 if rows else "not measured",
         ssd_chunk_share=b7 / busy if rows and busy else "not measured",
         top_kernels=[dict(name=e.key[:80], calls=e.count,
                           device_ms=device_us(e) / 1e3) for e in top])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def profile_phase(torch, eng, prompts, round_wall_s, of="serve"):
    """Where a serve round's time goes: one more round of the same four
    prompts and 64 new tokens under ``torch.profiler``, device activity
    only.  Reports the profiled wall time, the device's busy time (sum of
    kernel and copy self times on the one stream) and the kernels that take
    the most of it.  Tracing slows the host loop, so the profiled wall is
    no reading of the idle share; the estimate given is one minus the busy
    time over ``round_wall_s``, the unprofiled rounds' median wall for the
    same work.  Its launches are outside the counted main-path run."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.sampling import SamplingParams

    torch.cuda.synchronize()
    t0 = time.monotonic()
    # device activity only: tracing every CPU op as well slows the eager
    # host loop several-fold more
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.generate(prompts, SamplingParams(max_new_tokens=64))
        torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, copies), should any CPU event be
    # recorded: a CPU op carries the device time of its kernels as well
    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in rows) / 1e3
    top = sorted(rows, key=device_us, reverse=True)[:8]
    emit("profile", of=of, prompts=[len(p) for p in prompts],
         max_new_tokens=64,
         profiled_wall_ms=wall_ms, unprofiled_round_wall_ms=round_wall_s * 1e3,
         device_busy_ms=busy_ms if rows else "not measured",
         device_idle_share_estimate=(1.0 - busy_ms / (round_wall_s * 1e3)
                                     if rows else "not measured"),
         top_kernels=[dict(name=e.key[:80], calls=e.count,
                           device_ms=device_us(e) / 1e3) for e in top])


def preempt_phase(torch):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.sampling import SamplingParams

    cfg = dataclasses.replace(get_config("qwen3-8b"), dtype="bfloat16",
                              n_layers=4)
    gen = torch.Generator(device=DEV).manual_seed(1)
    params = init_params(cfg, gen, DEV)
    n_pages = 56
    eng = make_engine(torch, cfg, params, DEV, max_batch=4,
                      page_size=PAGE, n_pages=n_pages)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (300, 200, 150, 100)]
    t0 = time.monotonic()
    reqs = eng.generate(prompts, SamplingParams(max_new_tokens=64))
    torch.cuda.synchronize()
    row = dict(model=cfg.name, n_layers=cfg.n_layers, n_pages=n_pages,
               prompts=[len(p) for p in prompts], wall_s=time.monotonic() - t0,
               steps=eng.n_ticks, preemptions=eng.preemptions,
               finished=sum(r.state.value == "done" for r in reqs))
    emit("preempt", **row)
    if row["finished"] != len(reqs) or any(len(r.generated) != 64
                                           for r in reqs):
        raise AssertionError("preempt: not every request finished")
    if eng.preemptions < 1:
        raise AssertionError("preempt: the pool forced no preemption")
    del eng, params
    free_device_memory(torch)


class RecordMargins:
    """For the length of a ``with`` block, record the top-2 logit margin of
    every token a port engine appends, per request: the engine's sampler
    keeps each program's last-position logits, its single device-to-host
    transfer point hands each token on with its row's margin, and its
    ``_append_token`` files the margin under the request."""

    def __init__(self, torch, eng):
        self.torch, self.eng = torch, eng
        self.margins = {}

    def __enter__(self):
        import numpy as np
        from repro_torch.serving import engine as eng_mod
        torch, eng = self.torch, self.eng
        rows = []
        sample = eng_mod.sample_greedy
        to_host, append = eng._to_host, eng._append_token
        self._saved = sample

        def sample_kept(logits):
            rows.append(logits[:, -1].float())
            return sample(logits)

        def host(arr):
            toks = to_host(arr)
            top2 = torch.topk(rows[-1], 2, dim=-1).values.cpu().numpy()
            rows.clear()
            out = np.empty(toks.shape, object)
            for i, t in enumerate(toks.tolist()):
                out[i] = Tok(t)
                out[i].margin = float(top2[i, 0] - top2[i, 1])
            return out

        def appended(req, tok):
            self.margins.setdefault(req.req_id, []).append(tok.margin)
            return append(req, tok)

        eng_mod.sample_greedy = sample_kept
        eng._to_host, eng._append_token = host, appended
        return self

    def __exit__(self, *exc):
        from repro_torch.serving import engine as eng_mod
        eng_mod.sample_greedy = self._saved
        for attr in ("_to_host", "_append_token"):
            delattr(self.eng, attr)
        return False


class Tok(int):
    """A sampled token that carries its row's top-2 logit margin."""
    margin: float


def parity_phase(torch):
    """Reduced llama2-7b and qwen3-8b: on the paged pool with f32 KV (a
    roomy pool and one that forces preemption) and int8 KV, and on the
    dense arena with whole-prompt prefill (a 2100-token prompt, above the
    flash-attention threshold, among short ones) and with packed chunks;
    reduced mamba2-2.7b on the dense arena with whole-prompt prefill
    (prompts of 64, 12, 32 and 2 tokens) —
    a ``cuda`` engine (kernels) and a ``cpu`` engine (plain versions) on
    the same weights must log the same ticks, and their greedy streams
    must be equal up to the first position where the CPU run's own top-2
    margin is at most 1e-3."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.scheduler import PhaseAwareConfig

    fns = kernel_functions()
    for name in ROUTED:
        fns[name].launches = 0
    reset_routes()
    for name in ("llama2-7b", "qwen3-8b"):
        cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
        params_cpu = init_params(cfg, torch.Generator().manual_seed(7), "cpu")
        params_dev = _to_device(params_cpu, DEV)
        rng = np.random.default_rng(5)
        short = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
                 for n in (13, 29, 7, 22)]
        long = [rng.integers(0, cfg.vocab_size, 2100, dtype=np.int32)]
        cases = [(dict(kv_dtype=kv, n_pages=n, page_size=8,
                       phase=PhaseAwareConfig(prefill_chunk=8, pack_align=8)),
                  short) for kv, n in (("f32", 96), ("f32", 12),
                                       ("int8", 96))]
        cases += [(dict(paged=False, max_len=2176,
                        phase=PhaseAwareConfig(prefill_chunk=c, pack_align=8)),
                   long + short[1:]) for c in (0, 64)]
        for kw, prompts in cases:
            parity_case(torch, name, cfg, params_dev, params_cpu, kw, prompts)
    # reduced mamba2: whole-prompt prefill through B7 (chunks of 32; the
    # 2-token prompt's conv window left-padded) and the recurrent decode
    cfg = dataclasses.replace(get_config("mamba2-2.7b").reduced(),
                              dtype="float32")
    params_cpu = init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (64, 12, 32, 2)]
    parity_case(torch, "mamba2-2.7b", cfg, _to_device(params_cpu, DEV),
                params_cpu, dict(paged=False, max_len=96,
                                 phase=PhaseAwareConfig(prefill_chunk=0)),
                prompts)
    # f32 throughout: B2 and B5 ran, on the CUDA-core tile only (B3 and B8
    # are on no path here)
    launches = {name: fns[name].launches for name in ROUTED}
    routes = route_counts()
    emit("parity", launches=launches, routes=routes)
    if not (launches["flash_attention"]
            and launches["packed_prefill_attention"]):
        raise AssertionError(f"parity: B2 or B5 never launched: {launches}")
    require_routes("parity", routes, launches, "tile")


def parity_case(torch, name, cfg, params_dev, params_cpu, kw, prompts):
    """One ``parity`` case: the same requests on a ``cuda`` and a ``cpu``
    engine, compared by ``compare_parity``."""
    from repro_torch.serving.sampling import SamplingParams

    runs = []
    for dev, params in ((DEV, params_dev), ("cpu", params_cpu)):
        eng = make_engine(torch, cfg, params, dev, max_batch=4, **kw)
        with RecordMargins(torch, eng) as rec:
            reqs = eng.generate(prompts, SamplingParams(max_new_tokens=8))
        runs.append((
            [(t.prefill_reqs, t.decode_reqs, t.preemptions,
              t.prefill_tokens) for t in eng.tick_log],
            [list(r.generated) for r in reqs], eng.preemptions,
            [rec.margins[r.req_id] for r in reqs]))
    label = (f"{name} {kw.get('kv_dtype', 'f32')} "
             f"{'paged' if kw.get('paged', True) else 'dense'} "
             f"chunk={kw['phase'].prefill_chunk}")
    compare_parity(label, runs, kw, len(prompts))


def compare_parity(label, runs, kw, n_prompts):
    """Equal tick logs, and streams equal up to the CPU run's first
    near-tie (margin <= 1e-3); emits the ``parity`` line."""
    (log_g, out_g, pre_g, _), (log_c, out_c, _, margins) = runs
    if log_g != log_c:
        raise AssertionError(f"parity {label}: tick logs differ")
    flips, compared = [], 0
    for i, (a, b) in enumerate(zip(out_g, out_c)):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), len(b))
        compared += j
        if j == len(b):
            continue
        flips.append(dict(request=i, position=j, margin=margins[i][j]))
        if margins[i][j] > 1e-3:
            raise AssertionError(
                f"parity {label}: request {i} differs at token {j} where the "
                f"CPU margin is {margins[i][j]}")
    emit("parity", case=label, n_pages=kw.get("n_pages"), ticks=len(log_g),
         preemptions=pre_g, streams_equal=out_g == out_c,
         positions_compared=compared, near_tie_flips=flips)
    if kw.get("n_pages") == 12 and pre_g < 1:
        raise AssertionError(f"parity {label}: no preemption forced")
    if compared < n_prompts:
        raise AssertionError(f"parity {label}: only {compared} positions "
                             "compared")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing under {SRC}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401  (sets the f32 matmul precision flags)
    from repro_torch.kernels import _build

    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    emit("device", name=name, capability=list(cap), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    if cap != (9, 0):
        raise AssertionError(f"the kernels are built for sm_90a; {name} is "
                             f"sm_{cap[0]}{cap[1]}")
    t0 = time.monotonic()
    built = _build.build_all()
    ptxas = {src: _build.ptxas_usage(src)
             for src in [SOURCE_OF[n] for n in ROUTED] + list(NO_SPILL)}
    emit("build", seconds=time.monotonic() - t0, compiled=built, ptxas=ptxas)
    # the tensor-core kernels, the decode walk of B1, B4 and B6, and both
    # of B7's routes hold their accumulators in registers: a spill there is
    # a design fault (the other CUDA-core tiles' are reported only)
    spilled = [r["kernel"] for src, rows in ptxas.items() for r in rows
               if ("wgmma_kernel" in r["kernel"] or src in NO_SPILL)
               and (r["spill_stores"] or r["spill_loads"])]
    if spilled:
        raise AssertionError(f"kernels that may not spill spill registers: "
                             f"{spilled}")
    # B8's producer hands 128 of its registers a thread to the consumers
    # (setmaxnreg 40 -> 232): that needs the launch's 168 a thread, the most
    # one block of 384 threads can have; with fewer the consumers would wait
    # for registers that never come
    short = [r for r in ptxas["gemm_cim"]
             if "gemm_wgmma_kernel" in r["kernel"] and r["registers"] != 168]
    if short:
        raise AssertionError(f"B8's tensor-core kernel was not given 168 "
                             f"registers a thread: {short}")

    timer = Timer(torch)
    failed = []

    def run(phase, fn, *args):
        # a failed phase is reported and the later ones still run, so one
        # call shows every fault; the script fails at the end all the same
        try:
            return fn(*args)
        except Exception as e:
            traceback.print_exc()
            emit(phase, failed=f"{type(e).__name__}: {e}")
            failed.append(phase)
            free_device_memory(torch)
            return None

    run("kernel", kernel_phase, torch, timer)
    main_bench = run("bench", bench_phase, torch, timer)
    main_path = run("serve", serve_phase, torch, timer)
    main_quantized = run("serve_quantized", serve_quantized_phase, torch,
                         timer)
    main_dense = run("serve_dense", serve_dense_phase, torch, timer)
    main_ssm = run("serve_ssm", serve_ssm_phase, torch, timer)
    run("preempt", preempt_phase, torch)
    run("parity", parity_phase, torch)
    if failed:
        raise AssertionError(f"failed phases: {failed}")

    # each kernel's numbers from the serve phase whose main path it is on
    sources = {"paged_decode_attention": (
                   "src/repro_torch/csrc/paged_decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:186", main_path),
               "packed_prefill_attention": (
                   "src/repro_torch/csrc/packed_prefill_attention.cu",
                   "src/repro/kernels/flash_attention.py:217", main_path),
               "gemv": (
                   "src/repro_torch/csrc/gemv_int8.cu",
                   "src/repro/kernels/gemv_cid.py:74", main_quantized),
               "paged_decode_attention_q4": (
                   "src/repro_torch/csrc/paged_decode_attention_q4.cu",
                   "src/repro/kernels/decode_attention.py:313",
                   main_quantized),
               "flash_attention": (
                   "src/repro_torch/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:83", main_dense),
               "decode_attention": (
                   "src/repro_torch/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:96", main_dense),
               "ssd_chunk": (
                   "src/repro_torch/csrc/ssd_chunk.cu",
                   "src/repro/kernels/ssd_scan.py:64", main_ssm),
               "matmul": (
                   "src/repro_torch/csrc/gemm_cim.cu",
                   "src/repro/kernels/gemm_cim.py:39", main_bench)}
    kernels = []
    for kname, (source, replaces, main) in sources.items():
        r = main[kname]
        kernels.append(dict(name=kname, route="cuda", source=source,
                            replaces=replaces, launches=r["launches"],
                            max_abs_err=r["f32"]["max_abs_err"],
                            max_abs_err_bf16=r["max_abs_err"],
                            ms=r["kernel_ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
