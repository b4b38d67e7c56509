#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100 — the quickest proof that the port builds, runs its main path through
its own kernels, and agrees with its plain PyTorch versions.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases, one JSON line each:

1. ``device``  — the card's name, compute capability (must be 9.0) and the
   ``nvidia-smi`` name / power limit line.
2. ``build``   — every kernel compiled from ``src/repro_torch/csrc`` by
   ``nvcc`` (one process per source, all started together), with seconds.
3. ``kernel``  — each kernel against its plain version on the card, per
   dtype and shape set: qwen3-8b (H=32, Hkv=8, D=128) and llama2-7b (H=32,
   Hkv=32) geometry, page size 16, contexts 512 and 4096; paged decode at
   batch 1 and 4, packed prefill on a pack_align=8 stream of four segments
   with history.  Tolerances: f32 |err| <= 1e-4; bf16, per element,
   |err| <= 2^-7 A + 2^-6 |ref|, where A is the plain version's f32 result
   with every V row replaced by its absolute value (sum_i p_i |v_i|).  Both
   sides round the softmax weights p to bf16 before P.V, each p by at most
   one bf16 unit roundoff (2^-8), which moves the result by at most
   2^-8 A per side; both round the output to bf16, and the kernel divides
   by a sum of rounded p, each at most 2^-8 |ref|.  The bound is that
   worst case and no looser, so a result that skipped one 32-key tile of a
   2k-token walk fails it.  Times are CUDA
   events, median of 20 launches, L2 flushed between launches; ``bound_ms``
   is the larger of the bytes the call must move over 3.35 TB/s and its
   operations over the peak rate of its type (989 TFLOP/s bf16, 67 TFLOP/s
   f32); ``library_ms`` times one ``scaled_dot_product_attention`` call on
   the pre-gathered dense K/V with a boolean mask — a yardstick only, never
   used by the port.
4. ``serve``   — ``ServingEngine`` on qwen3-8b at full width and all 36
   layers in bf16 (random weights from a seeded ``torch.Generator`` on the
   card): paged pool (page 16, 1024 pages), max_batch 4, default
   ``PhaseAwareConfig`` (halo, prefill_chunk 2048, pack_align 8), prompts of
   1900, 1000, 333 and 37 tokens, 64 new tokens each.  Every request must
   finish, no logit may be NaN, and each kernel's launch count must equal
   n_layers x the prefill (resp. decode) steps.  The four requests run
   three times (rounds) to show the call's spread; the headline TTFT and
   TPOT are the medians over rounds.  Each kernel is then checked and timed
   again at the exact inputs the main path gave it (bf16), and checked once
   more on those inputs cast to f32 (|err| <= 1e-4).  A ``profile`` line
   says where one more round's time goes under ``torch.profiler`` (device
   busy time, top kernels) and estimates the device's idle share as one
   minus that busy time over the unprofiled rounds' median wall time.
5. ``preempt`` — the same model cut to 4 layers, with a pool small enough
   to force preemptions; every request must finish.
6. ``parity``  — reduced llama2-7b and qwen3-8b in f32, one engine on
   ``cuda`` (kernels) and one on ``cpu`` (plain versions), same weights:
   equal tick logs, and equal greedy streams up to the first position
   where the CPU run's top-2 logit margin is at most 1e-3.

Then one ``{"kernels": [...]}`` line (launches from the serve phase, times
at its inputs in bf16, ``max_abs_err`` from the f32 check at those inputs
and ``max_abs_err_bf16`` from the bf16 one), the ``nvidia-smi`` line, and
as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the last
line is never printed and the exit code is not 0.  Without a CUDA device,
or without the repository's ``src/`` beside it, the script exits non-zero.
"""

from __future__ import annotations

import dataclasses
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
    path (each layer reads its own pool)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn, iters: int = ITERS) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
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


def close(torch, got, ref, dt: str, abs_ctx=None):
    """(max |got - ref|, within ``TOL[dt]``, the element whose error is
    the largest share of its bound) over every element; ``abs_ctx`` is A,
    needed where ``TOL[dt]["p_abs"]`` is not 0."""
    tol = TOL[dt]
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


def abs_context(plain, name, args, kw):
    """A = sum_i p_i |v_i|: the plain version in f32 with |V|."""
    f32 = [x.float() if x.is_floating_point() else x for x in args]
    for i in ((2,) if name == "paged_decode_attention" else (2, 4)):
        f32[i] = f32[i].abs()
    return plain(*f32, **kw)


# ---------------------------------------------------------------------------
# paged decode attention (B1)
# ---------------------------------------------------------------------------

def decode_inputs(torch, H, Hkv, D, B, ctx, dtype, seed):
    """A ragged batch against a shared pool: lengths ctx, ctx-37, ...;
    pages scattered at random; one sentinel page inside the last row's
    length; every masked row of the pool (past a length, on the unused
    page the sentinel clamps to) poisoned with NaN."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    lengths = [max(ctx - 37 * b, 1) for b in range(B)]
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

def prefill_inputs(torch, H, Hkv, D, ctx, dtype, seed):
    """A pack_align=8 stream of four segments — lengths 203, 77, 130, 45 at
    8-aligned starts, so no segment is aligned to a 16- or 64-row tile —
    with histories of ctx, ctx/2+5, 61 and 0 tokens, one pad segment
    (start == T, all-sentinel table row) and 16 stream rows past the last
    segment.  History slots a segment has not written yet are NaN."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    lens = [203, 77, 130, 45, 0]
    offs = [ctx, ctx // 2 + 5, 61, 0, 0]
    starts, cur = [], 0
    for n in lens[:-1]:
        starts.append(cur)
        cur = -(-(cur + n) // 8) * 8
    T = cur + 16
    starts.append(T)
    W = max(-(-(o + n) // PAGE) for o, n in zip(offs, lens))
    n_pages = sum(-(-(o + n) // PAGE) for o, n in zip(offs, lens)) + 1
    perm = torch.randperm(n_pages - 1, device=DEV, generator=g).tolist()
    bt = torch.full((len(lens), W), n_pages, dtype=torch.int32)
    k = torch.randn((n_pages, PAGE, Hkv, D), device=DEV, generator=g)
    v = torch.randn((n_pages, PAGE, Hkv, D), device=DEV, generator=g)
    k[n_pages - 1] = float("nan")
    v[n_pages - 1] = float("nan")
    for s, (o, n) in enumerate(zip(offs, lens)):
        for i in range(-(-(o + n) // PAGE)):
            page = perm.pop()
            bt[s, i] = page
            lo = max(o - i * PAGE, 0)
            if lo < PAGE:                  # this chunk's own slots: unwritten
                k[page, lo:] = float("nan")
                v[page, lo:] = float("nan")
    q = torch.randn((T, H, D), device=DEV, generator=g)
    kn = torch.randn((T, Hkv, D), device=DEV, generator=g)
    vn = torch.randn((T, Hkv, D), device=DEV, generator=g)
    i32 = dict(dtype=torch.int32, device=DEV)
    return ((q.to(dtype), kn.to(dtype), vn.to(dtype), k.to(dtype),
             v.to(dtype), bt.to(DEV), torch.tensor(starts, **i32),
             torch.tensor(offs, **i32), torch.tensor(lens, **i32)),
            dict(ring=n_pages * PAGE, window=0))


def _history_slots(bt, off, ring, n_pages, P):
    """Logical history slots a segment sees: s < min(off, ring, W*P) on an
    allocated page (window 0: every written position precedes the chunk)."""
    n = min(off, ring, len(bt) * P)
    return [s for s in range(n) if bt[s // P] < n_pages]


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
        h = len(_history_slots(bt[n], offs[n], kw["ring"], n_pages, P))
        toks += lens[n]
        hist += h
        pairs += lens[n] * h + lens[n] * (lens[n] + 1) // 2
    nbytes = (toks * (2 * H + 2 * Hkv) * D * el + 2 * hist * Hkv * D * el
              + 4 * (len(lens) * (3 + len(bt[0]))))
    return bound(nbytes, 4.0 * pairs * H * D, dtype_name(q))


def prefill_library(torch, args, kw):
    """scaled_dot_product_attention over the pre-gathered dense K/V: every
    segment's visible history followed by the stream, with a boolean mask
    for segment, causality and history visibility (one call)."""
    import torch.nn.functional as F
    q, kn, vn, k_pages, v_pages, bt, starts, offs, lens = args
    T, H, D = q.shape
    n_pages, P, Hkv, _ = k_pages.shape
    G = H // Hkv
    keys, vals, cols = [], [], []
    seg = torch.full((T,), -1, dtype=torch.long, device=q.device)
    btl = bt.cpu().tolist()
    for n, (st, off, ln) in enumerate(zip(starts.tolist(), offs.tolist(),
                                          lens.tolist())):
        if ln <= 0 or st >= T:
            continue
        seg[st:st + ln] = n
        slots = _history_slots(btl[n], off, kw["ring"], n_pages, P)
        if slots:
            s = torch.tensor(slots, device=q.device)
            pg = bt[n].long()[s // P]
            keys.append(k_pages[pg, s % P])
            vals.append(v_pages[pg, s % P])
            cols.append(torch.full((len(slots),), n, device=q.device))
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
    mask = torch.cat([hist_ok, self_ok], dim=1)[None, None]
    assert mask.shape[-1] == n_hist + T
    qq = q.permute(1, 0, 2)[None].contiguous()
    return lambda: F.scaled_dot_product_attention(qq, k.contiguous(),
                                                  v.contiguous(),
                                                  attn_mask=mask)


# ---------------------------------------------------------------------------
# one kernel check: kernel vs plain version, times, bound
# ---------------------------------------------------------------------------

def check_kernel(torch, timer, name, args, kw, label, timed=True):
    """Kernel against its plain version on ``args``; with ``timed``, also
    the CUDA-event times of kernel, plain version and library call."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    if name == "paged_decode_attention":
        kernel, plain = da.paged_decode_attention, ref.paged_decode_attention_ref
    else:
        kernel = fa.packed_prefill_attention
        plain = ref.packed_prefill_attention_ref
    dt = dtype_name(args[0])
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    abs_ctx = (abs_context(plain, name, args, kw) if TOL[dt]["p_abs"]
               else None)
    err, ok, worst = close(torch, got, want, dt, abs_ctx)
    row = dict(name=name, shape=label, dtype=dt, max_abs_err=err, tol=TOL[dt],
               worst_element=worst)
    if timed:
        if name == "paged_decode_attention":
            bound_ms, bound_by = decode_cost(*args)
            library = decode_library(torch, *args)
        else:
            bound_ms, bound_by = prefill_cost(args, kw)
            library = prefill_library(torch, args, kw)
        row.update(kernel_ms=timer(lambda: kernel(*args, **kw)),
                   plain_ms=timer(lambda: plain(*args, **kw)),
                   bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=timer(library),
                   library="scaled_dot_product_attention on pre-gathered "
                           "dense K/V (yardstick only)")
    emit("kernel", **row, ok=ok)
    if not ok:
        FAILED.append(f"{name} [{label}, {dt}]: max |err| {err}")
    return row


def kernel_phase(torch, timer):
    geoms = {"qwen3-8b": (32, 8, 128), "llama2-7b": (32, 32, 128)}
    seed = 0
    for dtype in (torch.float32, torch.bfloat16):
        for model, (H, Hkv, D) in geoms.items():
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
    require_all_agree("kernel")


def require_all_agree(phase: str) -> None:
    failed, FAILED[:] = list(FAILED), []
    if failed:
        raise AssertionError(f"{phase}: kernels disagree with their plain "
                             "versions:\n  " + "\n  ".join(failed))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

class MainPathProbe:
    """Wraps the model entry points the engine calls and the two kernel
    wrappers for the length of a ``with`` block: checks every logit
    tensor for NaN (one device flag, read once), counts prefill and decode
    steps, and keeps the inputs of the first packed-prefill launch and of
    the last decode step's first-layer launch — the shapes the main path
    gives each kernel — for the checks after the run.  The kernels' own
    ``launches`` counters are untouched by it."""

    def __init__(self, torch, n_layers: int):
        self.torch, self.n_layers = torch, n_layers
        self.nan = torch.zeros((), dtype=torch.bool, device=DEV)
        self.steps = {"prefill": 0, "decode": 0}
        self.calls = {"paged_decode_attention": 0,
                      "packed_prefill_attention": 0}
        self.inputs = {}

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.serving import engine as eng
        self._saved = [(eng, "forward", eng.forward),
                       (eng, "forward_chunk_packed", eng.forward_chunk_packed),
                       (ops, "_da", ops._da), (ops, "_fa", ops._fa)]

        def model(fn, step):
            def wrapped(*a, **k):
                out = fn(*a, **k)
                self.nan |= self.torch.isnan(out[0]).any()
                self.steps[step] += 1
                return out
            return wrapped

        def kernel(fn, name, clone):
            def wrapped(*a, **k):
                i = self.calls[name]
                self.calls[name] += 1
                if i % self.n_layers == 0 and (name not in self.inputs
                                               or not clone):
                    self.inputs[name] = (
                        tuple(x.clone() if clone else x for x in a), dict(k))
                return fn(*a, **k)
            return wrapped

        eng.forward = model(eng.forward, "decode")
        eng.forward_chunk_packed = model(eng.forward_chunk_packed, "prefill")
        # the dispatcher reaches the kernel wrappers through its module
        # handles; stand-ins there leave the wrappers (and their counts)
        # untouched.  Decode: the last step's pool is final (written before
        # it is read and never after), so references suffice; prefill pools
        # change after the first launch, so its inputs are copied once.
        ops._da = types.SimpleNamespace(paged_decode_attention=kernel(
            ops._da.paged_decode_attention, "paged_decode_attention", False))
        ops._fa = types.SimpleNamespace(packed_prefill_attention=kernel(
            ops._fa.packed_prefill_attention, "packed_prefill_attention",
            True))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        return False


def kernel_functions():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    return {"paged_decode_attention": da.paged_decode_attention,
            "packed_prefill_attention": fa.packed_prefill_attention}


def make_engine(torch, cfg, params, device, **sc_kw):
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    from repro_torch.serving.scheduler import PhaseAwareConfig
    phase = sc_kw.pop("phase", PhaseAwareConfig())
    sc = ServeConfig(paged=True, phase=phase, **sc_kw)
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


def serve_phase(torch, timer):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.sampling import SamplingParams

    cfg = dataclasses.replace(get_config("qwen3-8b"), dtype="bfloat16")
    t0 = time.monotonic()
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = init_params(cfg, gen, DEV)
    torch.cuda.synchronize()
    t_init = time.monotonic() - t0
    eng = make_engine(torch, cfg, params, DEV, max_batch=4,
                      page_size=PAGE, n_pages=1024)
    rng = np.random.default_rng(0)
    # warm-up (cuBLAS handles, allocator): one short request, not counted
    eng.generate([rng.integers(0, cfg.vocab_size, 24, dtype=np.int32)],
                 SamplingParams(max_new_tokens=2))
    torch.cuda.synchronize()
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
               for n in (1900, 1000, 333, 37)]
    ticks0 = eng.n_ticks
    fns = kernel_functions()
    for fn in fns.values():
        fn.launches = 0
    rounds, unfinished = [], False
    t0 = time.monotonic()
    with MainPathProbe(torch, cfg.n_layers) as probe:
        for _ in range(ROUNDS):
            t1, n1 = time.monotonic(), eng.n_ticks
            reqs = eng.generate(prompts, SamplingParams(max_new_tokens=64))
            torch.cuda.synchronize()
            wall_s = time.monotonic() - t1
            unfinished |= any(r.state.value != "done"
                              or len(r.generated) != 64 for r in reqs)
            rounds.append(serve_round(
                reqs, list(eng.tick_log)[-(eng.n_ticks - n1):], wall_s))
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in fns.items()}
    log = list(eng.tick_log)[-(eng.n_ticks - ticks0):]
    decode_ticks = [t for t in log if t.decode_reqs]
    row = dict(model=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype,
               prompts=[len(p) for p in prompts], max_new_tokens=64,
               init_s=t_init, rounds=rounds, wall_s=wall, steps=len(log),
               prefill_steps=probe.steps["prefill"],
               decode_steps=probe.steps["decode"],
               ttft_ms_median=median([r["ttft_ms_median"] for r in rounds]),
               tpot_ms_median=median([r["tpot_ms_median"] for r in rounds]),
               decode_tok_s_median=median([r["decode_tok_s"] for r in rounds]),
               launches=launches, preemptions=eng.preemptions,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("serve", **row)
    if unfinished:
        raise AssertionError("serve: not every request finished its 64 tokens")
    if bool(probe.nan):
        raise AssertionError("serve: a logit was NaN")
    if probe.steps["decode"] != len(decode_ticks):
        raise AssertionError("serve: decode steps != ticks that decoded")
    L = cfg.n_layers
    expect = {"packed_prefill_attention": L * probe.steps["prefill"],
              "paged_decode_attention": L * probe.steps["decode"]}
    for name, n in expect.items():
        if launches[name] != n or n == 0:
            raise AssertionError(f"serve: {name} launched {launches[name]} "
                                 f"times, expected {n} (> 0)")
    main = {}
    for name, (args, kw) in probe.inputs.items():
        main[name] = check_kernel(torch, timer, name, args, kw,
                                  "serve main path")
        main[name]["launches"] = launches[name]
        f32 = tuple(x.float() if x.is_floating_point() else x for x in args)
        main[name]["f32"] = check_kernel(torch, timer, name, f32, kw,
                                         "serve main path, cast to f32",
                                         timed=False)
    require_all_agree("serve")
    profile_phase(torch, eng, prompts, median([r["wall_s"] for r in rounds]))
    del eng, params, probe
    torch.cuda.empty_cache()
    return main


def profile_phase(torch, eng, prompts, round_wall_s):
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
    emit("profile", prompts=[len(p) for p in prompts], max_new_tokens=64,
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
    torch.cuda.empty_cache()


def last_logits(torch, cfg, params, seq):
    """f32 logits after ``seq`` on the CPU plain path (one packed segment
    into a fresh pool)."""
    import numpy as np
    from repro_torch.models.transformer import forward_chunk_packed
    from repro_torch.serving.kv_pool import KVPool
    pool = KVPool(cfg, n_slots=1, n_pages=-(-len(seq) // 8), page_size=8,
                  device="cpu")
    assert pool.grow(0, len(seq))
    T = -(-len(seq) // 8) * 8
    toks = np.zeros(T, np.int32)
    toks[:len(seq)] = seq
    logits, _ = forward_chunk_packed(
        params, cfg, torch.from_numpy(toks), torch.tensor([0]),
        torch.tensor([0]), torch.tensor([len(seq)]), torch.tensor([0]),
        pool.caches, block_tables=pool.block_tables())
    return logits[0, 0]


def parity_phase(torch):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.serving.scheduler import PhaseAwareConfig

    for name in ("llama2-7b", "qwen3-8b"):
        cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
        params_cpu = init_params(cfg, torch.Generator().manual_seed(7), "cpu")
        params_dev = _to_device(params_cpu, DEV)
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32)
                   for n in (13, 29, 7, 22)]
        for n_pages in (96, 12):
            runs = []
            for dev, params in ((DEV, params_dev), ("cpu", params_cpu)):
                eng = make_engine(
                    torch, cfg, params, dev, max_batch=4, page_size=8,
                    n_pages=n_pages,
                    phase=PhaseAwareConfig(prefill_chunk=8, pack_align=8))
                reqs = eng.generate(prompts, SamplingParams(max_new_tokens=8))
                runs.append((
                    [(t.prefill_reqs, t.decode_reqs, t.preemptions,
                      t.prefill_tokens) for t in eng.tick_log],
                    [list(r.generated) for r in reqs], eng.preemptions))
            (log_g, out_g, pre_g), (log_c, out_c, _) = runs
            if log_g != log_c:
                raise AssertionError(f"parity {name}: tick logs differ")
            flips = []
            for i, (a, b) in enumerate(zip(out_g, out_c)):
                j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                         None)
                if j is None:
                    continue
                top2 = torch.topk(last_logits(
                    torch, cfg, params_cpu,
                    np.concatenate([prompts[i], np.asarray(b[:j], np.int32)])),
                    2).values
                margin = float(top2[0] - top2[1])
                flips.append(dict(request=i, position=j, margin=margin))
                if margin > 1e-3:
                    raise AssertionError(
                        f"parity {name}: request {i} differs at token {j} "
                        f"where the CPU margin is {margin}")
            emit("parity", model=cfg.name, n_pages=n_pages, ticks=len(log_g),
                 preemptions=pre_g, streams_equal=out_g == out_c,
                 near_tie_flips=flips)
            if n_pages == 12 and pre_g < 1:
                raise AssertionError(f"parity {name}: no preemption forced")


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
    emit("build", seconds=time.monotonic() - t0, compiled=built)

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
            torch.cuda.empty_cache()
            return None

    run("kernel", kernel_phase, torch, timer)
    main_path = run("serve", serve_phase, torch, timer)
    run("preempt", preempt_phase, torch)
    run("parity", parity_phase, torch)
    if failed:
        raise AssertionError(f"failed phases: {failed}")

    sources = {"paged_decode_attention": (
                   "src/repro_torch/csrc/paged_decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:186"),
               "packed_prefill_attention": (
                   "src/repro_torch/csrc/packed_prefill_attention.cu",
                   "src/repro/kernels/flash_attention.py:217")}
    kernels = []
    for kname, (source, replaces) in sources.items():
        r = main_path[kname]
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
