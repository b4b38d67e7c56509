#!/usr/bin/env python3
"""Host-only replays of the ``serve_traffic`` trace of ``chip_smoke.py``:
which pool sizes drain, and which fall into the preemption livelock of
ROADMAP queue C.

    PYTHONPATH=src python scripts/traffic_livelock.py --pages 184 256 \\
        --seeds 0 1 2 --rates 3.0 4.5 [--package repro]

The engine's model programs are stubbed (every token 0, the KV cache
returned as it came), so what runs is the host logic alone — admission,
planning, paging, preemption and swaps — on reduced qwen3-8b with the
phase's page geometry (pages of 16 tokens, max_batch 4, a 256-page host
tier, the default ``PhaseAwareConfig``).  Time is a fake clock that each
program call advances by ``--step`` seconds.  For each seed and arrival
rate, the two-tenant trace of the phase (chat: interactive lane, prompts of
300–1900 tokens, TTFT 1000 ms and TPOT 150 ms; batch: batch lane,
1000–2000 tokens; 64 new tokens each; two thirds of the rate chat) arrives
over ``--duration`` s and is served with admission off, at a fixed tick
cost and on the tick-wall EMA; a run that has not drained after
``--max-ticks`` ticks is counted as livelocked.  ``--package repro`` runs
the JAX package's engine instead of the port's (the same host decisions).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import itertools
import sys
import types


def stub_engine(pkg):
    """``pkg``'s ServingEngine with the model programs stubbed."""
    engine = importlib.import_module(f"{pkg}.serving.engine")
    if pkg == "repro":
        import jax.numpy as jnp
        zeros = lambda n: jnp.zeros((n,), jnp.int32)          # noqa: E731
    else:
        import torch
        zeros = lambda n: torch.zeros((n,), dtype=torch.int32)  # noqa: E731
    cache_arg = {"whole": 3, "decode": 2, "decode_paged": 2, "packed": 6,
                 "packed_paged": 6, "chunk": 5, "chunk_paged": 5}

    class HostOnly(engine.ServingEngine):
        clock = None

        def _program(self, group, kind):
            def run(*args):
                n = (args[2].shape[0] if kind.startswith("packed") else
                     1 if kind == "whole" else args[1].shape[0])
                self.clock.advance()
                return zeros(n), args[cache_arg[kind]]
            return run

    return engine, HostOnly


class Clock:
    def __init__(self, step):
        self.t, self.step = 1000.0, step

    def monotonic(self):
        return self.t

    def advance(self):
        self.t += self.step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", default="repro_torch",
                    choices=["repro_torch", "repro"])
    ap.add_argument("--pages", type=int, nargs="+", default=[184, 256])
    ap.add_argument("--host-pages", type=int, default=256)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--rates", type=float, nargs="+", default=[3.0, 4.5])
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--step", type=float, default=0.04,
                    help="fake seconds a program call takes")
    ap.add_argument("--max-ticks", type=int, default=2500)
    args = ap.parse_args(argv)
    pkg = args.package
    cfgs = importlib.import_module(f"{pkg}.configs.base")
    sched = importlib.import_module(f"{pkg}.serving.scheduler")
    metrics = importlib.import_module(f"{pkg}.serving.metrics")
    traffic = importlib.import_module(f"{pkg}.serving.traffic")
    engine, HostOnly = stub_engine(pkg)
    cfg = dataclasses.replace(cfgs.get_config("qwen3-8b").reduced(),
                              dtype="float32")
    if pkg == "repro":
        import jax
        from repro.models.transformer import init_params
        params = init_params(jax.random.PRNGKey(0), cfg)
        device = {}
    else:
        import torch
        from repro_torch.models.transformer import init_params
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        device = dict(device="cpu")
    livelocked = runs = 0
    for pages, seed, rate in itertools.product(args.pages, args.seeds,
                                               args.rates):
        clock = Clock(args.step)
        engine.time = types.SimpleNamespace(monotonic=clock.monotonic)
        events = traffic.synthesize(traffic.TrafficConfig(tenants=(
            traffic.TenantSpec(
                name="chat", rate_rps=rate * 2 / 3, prompt_len=(300, 1900),
                output_len=(64, 64), priority=sched.PRIORITY_INTERACTIVE,
                slo=metrics.SLO(1000.0, 150.0)),
            traffic.TenantSpec(
                name="batch", rate_rps=rate / 3, prompt_len=(1000, 2000),
                output_len=(64, 64), priority=sched.PRIORITY_BATCH)),
            duration_s=args.duration, seed=seed,
            vocab_size=cfg.vocab_size))
        row = []
        for label, adm in (("off", None),
                           ("fixed", sched.AdmissionConfig(
                               tick_cost_s=1.3 * args.step)),
                           ("ema", sched.AdmissionConfig())):
            eng = HostOnly(cfg, params, engine.ServeConfig(
                max_batch=4, paged=True, page_size=16, n_pages=pages,
                host_spill_pages=args.host_pages, admission=adm,
                phase=sched.PhaseAwareConfig()), **device)
            eng.clock = clock
            t0, i, ticks = clock.t, 0, 0
            while ticks < args.max_ticks:
                while i < len(events) and t0 + events[i].t <= clock.t:
                    ev = events[i]
                    eng.submit(ev.prompt, max_new_tokens=ev.max_new_tokens,
                               slo=ev.slo, priority=ev.priority)
                    i += 1
                if eng._live():
                    eng.step()
                    ticks += 1
                elif i < len(events):
                    clock.t = t0 + events[i].t
                else:
                    break
            stuck = eng._live()
            livelocked += stuck
            runs += 1
            row.append(f"{label}: {'LIVELOCK' if stuck else 'drained'} "
                       f"ticks={ticks} preemptions={eng.preemptions} "
                       f"shed={eng.admission_shed}")
        print(f"{pkg} pages={pages} seed={seed} rate={rate:g} "
              f"events={len(events)} | " + " | ".join(row), flush=True)
    print(f"{livelocked} of {runs} runs livelocked")
    return 0


if __name__ == "__main__":
    sys.exit(main())
