"""Serving CLI of the PyTorch port: batched requests through the
packed-prefill engine over the paged pool or the dense arena (port of the
main path of src/repro/launch/serve.py).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --requests 4 --prompt-len 1024 --max-new 64 --n-pages 1024

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --no-paged --max-len 8192 --prefill-chunk 0 --prompt-len 8000

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
      --no-paged --max-len 8448 --prefill-chunk 0 --prompt-len 8192

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --no-paged --max-len 8448 --prefill-chunk 0 --prompt-len 8192

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --reduced --device cpu          # the plain PyTorch path, no card

``--weights-dtype int8`` quantizes the matmul weights per output channel
at engine build (decode-shaped products then run in the int8 GEMV kernel);
``--kv-dtype int8`` stores KV pages int8 and ``--kv-dtype int4`` packs them
two nibbles per byte, both with per-token scale pages (int4 decode runs in
the int4 paged decode kernel); quantized KV needs the paged pool.

``--no-paged`` serves from the dense arena of ``--max-len`` positions per
slot (the JAX CLI's default; this one defaults to the paged pool).  There
``--prefill-chunk 0`` prefills every prompt whole, in the flash-attention
kernel above 2048 tokens, and decode runs in the dense flash-decode kernel.
``--arch mamba2-2.7b`` and ``--arch zamba2-2.7b`` serve only there
(``--no-paged --prefill-chunk 0``, as the reference does): their prefill
runs the SSD chunk kernel, and a prompt longer than the SSD chunk (256
tokens; 32 with ``--reduced``) must be a multiple of it, as in the
reference.  zamba2's shared attention block (head dim 160) prefills in the
flash-attention kernel above 2048 tokens and decodes in the dense
flash-decode kernel.

``--prefix-cache`` reuses shared-prompt KV pages copy-on-write through a
radix prefix cache (paged pool only); ``--shared-prefix N`` opens every
prompt with the same N tokens to exercise it.  ``--speculative`` turns on
greedy draft/verify decoding with the model-free n-gram drafter,
``--spec-k`` draft tokens a window (default 4; paged pool only).  The
report then adds the cache's hit rate and the drafter's acceptance.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --requests 4 --prompt-len 1400 --shared-prefix 1024 --max-new 64 \
      --n-pages 1024 --prefix-cache --speculative --spec-k 4

Sampling is PER REQUEST (``SamplingParams``): ``--temperature 0`` IS
greedy, and ``--temperature``, ``--top-k``, ``--top-p`` and ``--stop-token
ID`` (repeatable; finish reason ``stop``) apply to every request, request i
drawing with seed ``--seed`` + i.  ``--mixed-sampling`` keeps even-indexed
requests greedy while odd-indexed ones sample at ``--temperature``: a mixed
batch runs in ONE program per tick.

``--host-spill-pages N`` (paged pool only) puts a host-memory KV tier of N
pages per run behind the pool (pinned memory on the card): a preempted
request's pages swap out and back in instead of being recomputed, and with
``--prefix-cache`` evicted prefix blocks demote to it and promote back on a
hit.  ``--executor disaggregated`` pins prefill programs and decode
programs to separate device groups (one card serves both) and reports the
KV pages and bytes each prefill -> decode handoff moves across the 2.5D
link.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --requests 4 --prompt-len 1900 --max-new 64 --n-pages 192 \
      --host-spill-pages 256 --temperature 0.8 --top-k 50 --top-p 0.95 \
      --mixed-sampling --executor disaggregated

Observability: ``--trace-out t.json`` records request-lifecycle spans and
per-tick events as Chrome trace-event JSON (open in Perfetto),
``--metrics m.prom`` writes the engine's metrics registry as Prometheus
text, and ``--slo-ttft-ms`` / ``--slo-tpot-ms`` attach per-request
deadlines, adding goodput (the fraction of requests meeting their SLO) to
the report.  ``--traffic`` replaces the fixed batch with a seeded arrival
trace replayed through the async front-end (``serving/frontend.py``,
``serving/traffic.py``): ``--rate-rps`` arrivals a second for
``--duration-s`` seconds (``--arrival onoff`` for bursty ON/OFF instead of
Poisson), prompt and output lengths drawn per request up to
``--prompt-len`` / ``--max-new``, paced in real time (``--time-scale``
scales the clock; 0 submits in trace order with no waiting).
``--admission`` turns on shed-before-thrash admission control (a request
whose projected TTFT busts its deadline is refused at submit;
``--admission-tick-cost-s`` fixes the projection's seconds a tick instead
of the live tick-wall EMA, ``--max-pending-tokens`` adds the structural
backpressure cap).  The report then becomes the traffic scorecard.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --prompt-len 1900 --max-new 64 --n-pages 184 --traffic \
      --rate-rps 3 --duration-s 10 --slo-ttft-ms 1000 --admission \
      --trace-out serving-trace.json --metrics serving-metrics.prom

Weights are random, drawn from ``--seed`` on the device (no checkpoint is
read).  ``--reduced`` runs the family's tiny f32 config.  The engine runs on
``--device`` (``cuda`` by default; there is no silent fallback to the CPU).
Reports TTFT/TPOT, throughput, the per-tick phase occupancy, KV bytes and
preemptions, and how often each kernel launched.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from collections import Counter

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b",
                    choices=["qwen3-8b", "llama2-7b", "mamba2-2.7b",
                             "zamba2-2.7b"])
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config in f32")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--strategy", default="halo",
                    choices=["halo", "cent", "attacc"])
    ap.add_argument("--max-len", type=int, default=512,
                    help="dense arena positions per slot (--no-paged)")
    ap.add_argument("--paged", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="the paged KV pool (default here); --no-paged "
                         "serves from the dense arena, which is the JAX "
                         "CLI's default")
    ap.add_argument("--prefill-chunk", type=int, default=2048,
                    help="tokens per prefill chunk (chunked prefill); 0 "
                         "prefills each prompt whole (--no-paged only)")
    ap.add_argument("--max-prefill-tokens", type=int, default=8192,
                    help="per-tick prefill token budget")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--n-pages", type=int, default=64,
                    help="pages per run pool")
    ap.add_argument("--kv-dtype", default="f32",
                    choices=["f32", "int8", "int4"],
                    help="KV page format: f32 = the model dtype; int8: "
                         "per-token scale pages; int4: packed nibble pairs")
    ap.add_argument("--weights-dtype", default="f32",
                    choices=["f32", "int8"],
                    help="int8: per-output-channel quantized matmul weights")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache: shared-prompt KV pages are "
                         "reused copy-on-write (paged only)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of system prompt shared by every request "
                         "(exercises the prefix cache)")
    ap.add_argument("--speculative", action="store_true",
                    help="speculative decoding: n-gram draft/verify loop "
                         "over the paged pool (paged only)")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="draft tokens per verify window (default 4)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples on the device "
                         "(per-request SamplingParams)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=0.0,
                    help="nucleus sampling threshold (0 = off)")
    ap.add_argument("--mixed-sampling", action="store_true",
                    help="odd-indexed requests sample at --temperature, "
                         "even-indexed ones stay greedy (one program per "
                         "tick serves both)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stop-token", type=int, action="append", default=[],
                    metavar="ID",
                    help="extra stop-token id (repeatable; finish reason "
                         "'stop')")
    ap.add_argument("--executor", default="colocated",
                    choices=["colocated", "disaggregated"],
                    help="disaggregated: prefill/decode programs pinned to "
                         "separate device groups, KV migrates at the "
                         "prefill->decode handoff (HALO's 2.5D link)")
    ap.add_argument("--host-spill-pages", type=int, default=0,
                    help="host-memory KV tier size in pages per run: "
                         "preemption swaps pages out instead of "
                         "recomputing, prefix evictions demote to host "
                         "(paged only; 0 = off)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the run "
                         "(request lifecycle spans + per-tick phase "
                         "events; open in Perfetto / chrome://tracing)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write the metrics registry as Prometheus-style "
                         "text exposition after the run")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="per-request TTFT deadline in ms; enables the "
                         "goodput / SLO-attainment report")
    ap.add_argument("--slo-tpot-ms", type=float, default=None,
                    help="per-request TPOT deadline in ms; enables the "
                         "goodput / SLO-attainment report")
    ap.add_argument("--traffic", action="store_true",
                    help="replace the fixed batch with a seeded arrival "
                         "trace replayed through the async front-end "
                         "(one client task per arrival); --requests is "
                         "ignored, the trace is --rate-rps x --duration-s")
    ap.add_argument("--rate-rps", type=float, default=None,
                    help="mean arrivals per second (traffic; default 4)")
    ap.add_argument("--duration-s", type=float, default=None,
                    help="trace horizon in seconds (traffic; default 2)")
    ap.add_argument("--arrival", default=None,
                    choices=["poisson", "onoff"],
                    help="arrival process (traffic; default poisson; "
                         "onoff = bursty exponential ON/OFF dwells)")
    ap.add_argument("--time-scale", type=float, default=None,
                    help="replay clock multiplier (traffic; default 1 = "
                         "real time; 0 = submit in trace order with no "
                         "waiting)")
    ap.add_argument("--admission", action="store_true",
                    help="SLO-aware admission control: shed requests "
                         "whose projected TTFT busts their deadline "
                         "instead of letting the pool thrash")
    ap.add_argument("--admission-tick-cost-s", type=float, default=None,
                    help="fix the admission projection's seconds-per-tick "
                         "(deterministic decisions) instead of the live "
                         "tick-wall EMA")
    ap.add_argument("--max-pending-tokens", type=int, default=None,
                    help="structural backpressure cap on queued prefill "
                         "tokens: beyond it best-effort submits defer, "
                         "deadline-carrying ones shed")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    if args.spec_k is not None and not args.speculative:
        ap.error("--spec-k requires --speculative")
    if args.speculative and not args.paged:
        ap.error("--speculative requires the paged pool (the draft/verify "
                 "loop runs over it)")
    if args.mixed_sampling and args.temperature <= 0.0:
        ap.error("--mixed-sampling needs --temperature > 0 (the stochastic "
                 "half samples at that temperature)")
    if args.host_spill_pages and not args.paged:
        ap.error("--host-spill-pages requires the paged pool (the spill "
                 "tier stores device pool pages)")
    if args.spec_k is None:
        args.spec_k = 4
    if not args.traffic and any(v is not None for v in (
            args.rate_rps, args.duration_s, args.arrival, args.time_scale)):
        ap.error("--rate-rps/--duration-s/--arrival/--time-scale require "
                 "--traffic")
    if not args.admission and (args.admission_tick_cost_s is not None
                               or args.max_pending_tokens is not None):
        ap.error("--admission-tick-cost-s/--max-pending-tokens require "
                 "--admission")
    if args.traffic and args.mixed_sampling:
        ap.error("--traffic and --mixed-sampling are exclusive (trace "
                 "requests share one SamplingParams)")
    if args.traffic and args.shared_prefix >= args.prompt_len:
        ap.error("--traffic needs --shared-prefix < --prompt-len "
                 "(a prompt needs at least one non-shared token)")
    if args.rate_rps is None:
        args.rate_rps = 4.0
    if args.duration_s is None:
        args.duration_s = 2.0
    if args.arrival is None:
        args.arrival = "poisson"
    if args.time_scale is None:
        args.time_scale = 1.0

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     gemv_cid, ssd_scan)
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    from repro_torch.serving.metrics import SLO
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.serving.scheduler import AdmissionConfig, PhaseAwareConfig
    from repro_torch.serving.speculative import SpecConfig
    from repro_torch.serving.tracing import Tracer

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    params = init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    sc = ServeConfig(
        max_batch=args.max_batch,
        phase=PhaseAwareConfig(strategy=args.strategy,
                               max_decode_batch=args.max_batch,
                               prefill_chunk=args.prefill_chunk,
                               max_prefill_tokens=args.max_prefill_tokens),
        seed=args.seed, max_len=args.max_len, paged=args.paged,
        page_size=args.page_size,
        n_pages=args.n_pages, kv_dtype=args.kv_dtype,
        weights_dtype=args.weights_dtype, prefix_cache=args.prefix_cache,
        speculative=SpecConfig(k=args.spec_k) if args.speculative else None,
        executor=args.executor, host_spill_pages=args.host_spill_pages,
        admission=(AdmissionConfig(
            tick_cost_s=args.admission_tick_cost_s,
            max_pending_tokens=args.max_pending_tokens)
            if args.admission else None))
    # tracing is opt-in: disabled, it reads no clock and the engine's device
    # work is unchanged
    tracer = Tracer(enabled=bool(args.trace_out))
    slo = None
    if args.slo_ttft_ms is not None or args.slo_tpot_ms is not None:
        slo = SLO(ttft_ms=args.slo_ttft_ms, tpot_ms=args.slo_tpot_ms)
    engine = ServingEngine(cfg, params, sc, device=device, tracer=tracer)

    kernels = (decode_attention.paged_decode_attention,
               flash_attention.packed_prefill_attention, gemv_cid.gemv,
               decode_attention.paged_decode_attention_q4,
               flash_attention.flash_attention,
               decode_attention.decode_attention, ssd_scan.ssd_chunk)
    launches0 = [k.launches for k in kernels]
    mode_s = "mixed" if args.mixed_sampling else (
        "greedy" if args.temperature <= 0.0 else f"t={args.temperature}")
    stop = tuple(args.stop_token)
    t0 = time.monotonic()
    if args.traffic:
        import asyncio

        from repro_torch.serving.frontend import AsyncEngine
        from repro_torch.serving.traffic import (TenantSpec, TrafficConfig,
                                                 replay, synthesize)
        # prompt/output lengths draw uniformly from [half, full] so the
        # trace exercises mixed shapes the way real traffic does
        p_lo = max(args.shared_prefix + 1, (args.prompt_len + 1) // 2)
        tenant = TenantSpec(
            name="cli", rate_rps=args.rate_rps, arrival=args.arrival,
            prompt_len=(min(p_lo, args.prompt_len), args.prompt_len),
            output_len=(max(1, (args.max_new + 1) // 2), args.max_new),
            shared_prefix_len=args.shared_prefix,
            n_prefixes=2 if args.shared_prefix else 1, slo=slo)
        events = synthesize(TrafficConfig(
            tenants=(tenant,), duration_s=args.duration_s, seed=args.seed,
            vocab_size=cfg.vocab_size))
        sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                            top_p=args.top_p, seed=args.seed, stop=stop)

        async def _go():
            async with AsyncEngine(engine) as fe:
                return await replay(fe, events, time_scale=args.time_scale,
                                    sampling=sp)

        report = asyncio.run(_go())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"arch={cfg.name} device={device} strategy={args.strategy} "
              f"chunk={args.prefill_chunk} sampling={mode_s} "
              f"traffic[{args.arrival} rate={args.rate_rps:g}rps "
              f"dur={args.duration_s:g}s scale={args.time_scale:g}] "
              f"admission={'on' if args.admission else 'off'}")
        print(report.render())
    else:
        rng = np.random.default_rng(args.seed)
        shared = rng.integers(0, cfg.vocab_size,
                              (min(args.shared_prefix, args.prompt_len),),
                              dtype=np.int32)
        prompts = [np.concatenate([shared, rng.integers(
            0, cfg.vocab_size, (args.prompt_len - len(shared),),
            dtype=np.int32)]) for _ in range(args.requests)]
        # per-request sampling: --temperature 0 IS greedy; --mixed-sampling
        # keeps even-indexed requests greedy
        done = [engine.submit(p, sampling=SamplingParams(
            temperature=(0.0 if args.mixed_sampling and i % 2 == 0
                         else args.temperature),
            top_k=args.top_k, top_p=args.top_p, seed=args.seed + i,
            max_new_tokens=args.max_new, stop=stop), slo=slo)
            for i, p in enumerate(prompts)]
        engine.run_until_drained()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.monotonic() - t0

        ttfts = [r.ttft for r in done if not np.isnan(r.ttft)]
        tpots = [r.tpot for r in done if not np.isnan(r.tpot)]
        total_new = sum(len(r.generated) for r in done)
        ttft_p50 = np.median(ttfts) * 1e3 if ttfts else float("nan")
        tpot_p50 = np.median(tpots) * 1e3 if tpots else float("nan")
        print(f"arch={cfg.name} device={device} strategy={args.strategy} "
              f"chunk={args.prefill_chunk} requests={len(done)} "
              f"tokens={total_new} wall={wall:.2f}s sampling={mode_s}")
        reasons_s = " ".join(f"{k}={v}" for k, v in sorted(
            Counter(r.finish_reason for r in done).items(),
            key=lambda kv: str(kv[0])))
        print(f"TTFT p50={ttft_p50:.1f}ms  TPOT p50={tpot_p50:.1f}ms  "
              f"throughput={total_new / wall:.1f} tok/s  "
              f"finish[{reasons_s}]")
    occ = engine.phase_occupancy()
    print(f"ticks={engine.n_ticks} occupancy prefill={occ['prefill']:.2f} "
          f"decode={occ['decode']:.2f} mixed={occ['mixed']:.2f}  "
          f"host-transfers={engine.host_transfers}")
    kv = engine.kv_bytes()
    arena = (f"paged[{args.n_pages}x{args.page_size},{args.kv_dtype}]"
             if args.paged else f"dense[{args.max_batch}x{args.max_len}]")
    print(f"kv={arena} "
          f"weights={args.weights_dtype} "
          f"reserved={kv['reserved'] / 1e6:.2f}MB "
          f"peak-resident={kv['peak_resident'] / 1e6:.2f}MB "
          f"preemptions={engine.preemptions}")
    if args.prefix_cache:
        ps = engine.prefix_stats()
        print(f"prefix-cache hit-rate={ps['hit_rate']:.2f} "
              f"tokens-from-cache={ps['hit_tokens']:.0f} "
              f"prefill-executed={ps['prefill_tokens_executed']:.0f} "
              f"cow-copies={ps['cow_copies']:.0f} "
              f"evicted-pages={ps['cache_evicted_pages']:.0f}")
    if args.speculative:
        ss = engine.spec_stats()
        print(f"speculative drafter=ngram k={args.spec_k} "
              f"windows={ss['windows']:.0f} "
              f"acceptance={ss['acceptance_rate']:.2f} "
              f"tokens/tick={ss['tokens_per_tick']:.2f}")
    if args.executor == "disaggregated":
        xs = engine.executor.stats()
        print(f"disaggregated prefill-devices={xs['prefill_devices']} "
              f"decode-devices={xs['decode_devices']} "
              f"migrated-pages={xs['migrated_pages']} "
              f"migrated={xs['migrated_bytes'] / 1e6:.2f}MB "
              f"handoff-batches={xs['migration_batches']}")
    if args.host_spill_pages:
        c = engine.counts()
        print(f"host-tier pages={args.host_spill_pages} "
              f"pinned={engine.host_tier.pinned} "
              f"swap-out={c['swap_out_bytes'] / 1e6:.2f}MB "
              f"swap-in={c['swap_in_bytes'] / 1e6:.2f}MB "
              f"swap-resumes={c['swap_resumes']} "
              f"recompute-resumes={c['recompute_preemptions']} "
              f"resident-pages={c['host_resident_pages']}")
    if slo is not None:
        g = engine.goodput()
        slo_s = " ".join(
            f"{k}={v}" for k, v in (("ttft_ms", args.slo_ttft_ms),
                                    ("tpot_ms", args.slo_tpot_ms))
            if v is not None)
        print(f"slo[{slo_s}] attained={g['slo_attained']}/{g['slo_total']} "
              f"goodput={g['goodput']:.2f} "
              f"ttft-violations={g['ttft_violations']} "
              f"tpot-violations={g['tpot_violations']}")
    if args.trace_out:
        engine.tracer.write(args.trace_out)
        print(f"trace: {len(engine.tracer.events())} events -> "
              f"{args.trace_out}")
    if args.metrics:
        snap = engine.metrics_snapshot()  # refreshes gauges before render
        with open(args.metrics, "w") as f:
            f.write(engine.metrics.render())
        print(f"metrics: {len(snap['counters'])} counters "
              f"{len(snap['gauges'])} gauges "
              f"{len(snap['histograms'])} histograms -> {args.metrics}")
    print("kernel launches: " + " ".join(
        f"{k.__name__}={k.launches - n}" for k, n in zip(kernels, launches0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
