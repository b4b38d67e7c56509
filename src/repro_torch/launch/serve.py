"""Serving CLI of the PyTorch port: batched greedy requests through the
packed-prefill engine over the paged pool or the dense arena (port of the
main path of src/repro/launch/serve.py).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --requests 4 --prompt-len 1024 --max-new 64 --n-pages 1024

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
      --no-paged --max-len 8192 --prefill-chunk 0 --prompt-len 8000

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
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
``--arch mamba2-2.7b`` serves only there (``--no-paged --prefill-chunk
0``, as the reference does): its prefill runs the SSD chunk kernel, and a
prompt longer than the SSD chunk (256 tokens; 32 with ``--reduced``) must be
a multiple of it, as in the reference.

``--stop-token ID`` (repeatable) ends a request when it emits that token
(finish reason ``stop``).

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
                    choices=["qwen3-8b", "llama2-7b", "mamba2-2.7b"])
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stop-token", type=int, action="append", default=[],
                    metavar="ID",
                    help="extra stop-token id (repeatable; finish reason "
                         "'stop')")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.kernels import (decode_attention, flash_attention,
                                     gemv_cid, ssd_scan)
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.serving.scheduler import PhaseAwareConfig

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
        weights_dtype=args.weights_dtype)
    engine = ServingEngine(cfg, params, sc, device=device)

    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, (args.prompt_len,),
                            dtype=np.int32) for _ in range(args.requests)]
    kernels = (decode_attention.paged_decode_attention,
               flash_attention.packed_prefill_attention, gemv_cid.gemv,
               decode_attention.paged_decode_attention_q4,
               flash_attention.flash_attention,
               decode_attention.decode_attention, ssd_scan.ssd_chunk)
    launches0 = [k.launches for k in kernels]
    t0 = time.monotonic()
    done = engine.generate(prompts,
                           SamplingParams(max_new_tokens=args.max_new,
                                          stop=tuple(args.stop_token)))
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
          f"tokens={total_new} wall={wall:.2f}s")
    reasons_s = " ".join(f"{k}={v}" for k, v in sorted(
        Counter(r.finish_reason for r in done).items(),
        key=lambda kv: str(kv[0])))
    print(f"TTFT p50={ttft_p50:.1f}ms  TPOT p50={tpot_p50:.1f}ms  "
          f"throughput={total_new / wall:.1f} tok/s  finish[{reasons_s}]")
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
    print("kernel launches: " + " ".join(
        f"{k.__name__}={k.launches - n}" for k, n in zip(kernels, launches0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
