"""The port's async front-end and traffic harness (ROADMAP A10) on the CPU:
``AsyncEngine``'s greedy streams against the synchronous port engine and
its shed set against the reference's, concurrent clients, cancellation and
``aclose()`` conserving pool and host-tier pages (a swapped request among
them), ``abort``, the shed stream's single terminal output,
``synthesize``'s events against the reference's for the same
``TrafficConfig``, the per-replay report windows, and the overload
experiment: shedding gives fewer preemptions and higher goodput than the
same engine without admission.

Each async case runs under a plain ``asyncio.run`` inside a sync test.  No
test sleeps or reads the wall clock for an assertion: where latency
matters (the overload experiment) the engine module's clock is replaced,
for that test only, by one that advances a fixed step per program call,
and admission projects with a fixed ``tick_cost_s`` or an EMA of that
clock.  ``HostOnlyEngine`` stubs the model programs (every token 0) so
paging, swapping, admission and the async machinery run at host speed.
"""

import asyncio
import json
import types

import numpy as np
import pytest
import torch

from repro.serving import traffic as jax_traffic
from repro.serving.frontend import AsyncEngine as JaxAsyncEngine
from repro.serving.metrics import SLO as JaxSLO
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import traffic
from repro_torch.serving.engine import ServeConfig, ServingEngine
from repro_torch.serving.frontend import AsyncEngine
from repro_torch.serving.metrics import SLO, quantile
from repro_torch.serving.scheduler import (PRIORITY_BATCH,
                                           PRIORITY_INTERACTIVE,
                                           AdmissionConfig, PhaseAwareConfig)
from repro_torch.serving.traffic import (TenantSpec, TrafficConfig, replay,
                                         synthesize)
from torch_spec_parity import models
from torch_tier_parity import build, prompts_of


class HostOnlyEngine(ServingEngine):
    """The model programs stubbed (every sampled token 0, the cache
    returned as it came); the pool, the host tier's page copies, admission
    and the async machinery are the engine's own.  With a ``clock`` (the
    engine module's, replaced for one test) each program call advances it
    one step."""

    _CACHE_ARG = {"whole": 3, "decode": 2, "decode_paged": 2, "packed": 6,
                  "packed_paged": 6, "chunk_paged": 5}
    clock = None

    def _program(self, group, kind):
        cache_arg = self._CACHE_ARG[kind]

        def run(*args):
            if kind in ("packed", "packed_paged"):
                n = args[2].shape[0]
            else:
                n = 1 if kind == "whole" else args[1].shape[0]
            if self.clock is not None:
                self.clock.advance()
            return torch.zeros((n,), dtype=torch.int32), args[cache_arg]

        return run


def serve_cfg(max_batch=2, n_pages=48, prefill_chunk=8,
              max_prefill_tokens=16, **kw):
    return ServeConfig(max_batch=max_batch, max_len=96, paged=True,
                       page_size=8, n_pages=n_pages,
                       phase=PhaseAwareConfig(
                           max_decode_batch=max_batch,
                           prefill_chunk=prefill_chunk,
                           max_prefill_tokens=max_prefill_tokens,
                           pack_align=8), **kw)


def host_engine(sc, name="llama2-7b"):
    cfg, params = models(name)[2:]
    return HostOnlyEngine(cfg, params, sc, device="cpu")


def real_engine(sc, name):
    cfg, params = models(name)[2:]
    return ServingEngine(cfg, params, sc, device="cpu")


def assert_pools_free(eng):
    for p in eng.pool.pools:
        p.check_invariants()
        assert p.free_pages() == p.n_pages, "pages leaked"
    if eng.host_tier is not None:
        eng.host_tier.check_invariants()
        assert eng.host_tier.used_pages() == 0, "host pages leaked"


def _async_tokens(engine, prompt_list, max_new):
    """Every prompt as its own client task, streams consumed concurrently;
    per-request (handle, outputs) in submission order."""

    async def go():
        async with AsyncEngine(engine) as fe:
            async def client(p):
                handle = await fe.submit(p, max_new_tokens=max_new)
                outs = [out async for out in handle]
                assert outs[-1].finished
                return handle, outs

            return await asyncio.gather(*[client(p) for p in prompt_list])

    return asyncio.run(go())


@pytest.mark.parametrize("name,kw", [
    ("llama2-7b", dict()), ("qwen3-8b", dict(kv_dtype="int8")),
    ("llama2-7b", dict(n_pages=14, host_spill_pages=64))],
    ids=["llama2", "qwen3-int8kv", "llama2-swap"])
def test_async_streams_equal_the_sync_engine(name, kw):
    """Same prompts, same order, greedy, real programs: the async
    front-end's streams equal the synchronous engine's token for token,
    the streamed outputs reassemble to ``Request.generated``, and the tick
    logs are the same."""
    ps = prompts_of(name, (14, 14, 14, 14, 20), seed=3)
    kw.setdefault("max_batch", 4 if "host_spill_pages" in kw else 2)
    sync = real_engine(serve_cfg(**kw), name)
    reqs = [sync.submit(p, max_new_tokens=6) for p in ps]
    sync.run_until_drained()
    want = [list(r.generated) for r in reqs]
    eng = real_engine(serve_cfg(**kw), name)
    got = _async_tokens(eng, ps, max_new=6)
    assert [h.req_id for h, _ in got] == [r.req_id for r in reqs]
    assert [[t for o in outs for t in o.new_token_ids]
            for _, outs in got] == want
    assert [h.token_ids() for h, _ in got] == want
    assert [(t.prefill_reqs, t.decode_reqs, t.preemptions)
            for t in eng.tick_log] == [
        (t.prefill_reqs, t.decode_reqs, t.preemptions)
        for t in sync.tick_log]
    assert_pools_free(eng)


def test_concurrent_clients_interleave_incremental_outputs():
    eng = host_engine(serve_cfg())
    got = _async_tokens(eng, prompts_of("llama2-7b", (16,) * 5), max_new=6)
    assert [h.req_id for h, _ in got] == list(range(5))
    for h, outs in got:
        assert h.finish_reason == "length"
        assert sum(len(o.new_token_ids) for o in outs) == 6
        # tokens arrive across several outputs (ticks), not in one blob
        assert len(outs) >= 2 and not outs[0].finished
    assert_pools_free(eng)


def _swapping_engine():
    """Four long requests over 14 pages with a host tier: decode growth
    preempts, and the victims swap out."""
    return host_engine(serve_cfg(max_batch=4, n_pages=14,
                                 host_spill_pages=64))


async def _until_swapped(eng, limit=2000):
    for _ in range(limit):
        if eng.host_tier.used_pages() > 0:
            return [r for r in eng.queue if r.swap is not None]
        await asyncio.sleep(0)
    raise AssertionError("no request was swapped out")


def test_stream_cancellation_conserves_pages_with_a_swapped_request():
    """Four streams over a pool that swaps; once a request's pages are in
    the host tier, its stream and one running stream are dropped: both turn
    into aborts, the swapped request's host pages are freed, the survivors
    finish, and every device and host page is free after the drain."""
    eng = _swapping_engine()
    ps = prompts_of("llama2-7b", (30, 25, 21, 18), seed=9)

    async def go():
        async with AsyncEngine(eng) as fe:
            async def client(p):
                async for _ in fe.stream(p, max_new_tokens=40):
                    await asyncio.sleep(0)

            tasks = [asyncio.create_task(client(p)) for p in ps]
            swapped = await _until_swapped(eng)
            doomed = {swapped[0].req_id}
            doomed.add(next(r.req_id for r in eng.slot_req
                            if r is not None))
            for rid in doomed:
                tasks[rid].cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            await fe.drain()
            return doomed

    doomed = asyncio.run(go())
    reasons = {r.req_id: r.finish_reason for r in eng.done}
    assert {i for i, why in reasons.items() if why == "abort"} == doomed
    assert sorted(reasons) == [0, 1, 2, 3]
    assert eng.swap_outs > 0 and eng.counts()["host_resident_pages"] == 0
    assert_pools_free(eng)


def test_aclose_with_swapped_requests_in_flight_frees_every_page():
    eng = _swapping_engine()
    ps = prompts_of("llama2-7b", (30, 25, 21, 18), seed=9)

    async def go():
        async with AsyncEngine(eng) as fe:
            handles = [await fe.submit(p, max_new_tokens=40) for p in ps]
            await _until_swapped(eng)
            return handles
        # aclose aborts every forgotten stream on the way out

    handles = asyncio.run(go())
    assert [h.request.finish_reason for h in handles] == ["abort"] * 4
    assert eng.counts()["host_resident_pages"] == 0
    assert_pools_free(eng)


def test_frontend_abort_returns_terminal_output():
    eng = host_engine(serve_cfg())

    async def go():
        async with AsyncEngine(eng) as fe:
            handle = await fe.submit(prompts_of("llama2-7b", (16,))[0],
                                     max_new_tokens=50)
            out = await fe.abort(handle.req_id)
            assert out is not None and out.finished
            assert out.finish_reason == "abort"
            assert await fe.abort(9999) is None          # unknown id
            outs = [o async for o in handle]             # stream terminates
            assert outs[-1].finish_reason == "abort"

    asyncio.run(go())
    assert_pools_free(eng)


def shed_cfg(**adm_kw):
    """A fixed 1 s a tick: every decision is a function of the queues."""
    return serve_cfg(max_batch=4, admission=AdmissionConfig(
        tick_cost_s=1.0, **adm_kw))


def test_shed_stream_is_one_terminal_output():
    eng = host_engine(shed_cfg())

    async def go():
        async with AsyncEngine(eng) as fe:
            for p in prompts_of("llama2-7b", (16,) * 4):
                await fe.submit(p, max_new_tokens=4)
            outs = [out async for out in fe.stream(
                prompts_of("llama2-7b", (16,), seed=1)[0], max_new_tokens=4,
                slo=SLO(ttft_ms=1000.0))]
            assert len(outs) == 1 and outs[0].finished
            assert outs[0].finish_reason == "shed"
            assert outs[0].new_token_ids == []
            await fe.drain()

    asyncio.run(go())
    assert eng.counts()["shed"] == 1
    assert_pools_free(eng)


def _tenants(mod, slo_cls, vocab):
    """Two tenants in ``mod``'s types: Poisson chat under an SLO in the
    interactive lane, bursty ON/OFF batch traffic over two shared
    prefixes."""
    return mod.TrafficConfig(tenants=(
        mod.TenantSpec(name="chat", rate_rps=30.0, prompt_len=(12, 20),
                       output_len=(2, 6), priority=PRIORITY_INTERACTIVE,
                       slo=slo_cls(ttft_ms=3000.0, tpot_ms=500.0)),
        mod.TenantSpec(name="batch", rate_rps=40.0, arrival="onoff",
                       on_s=0.2, off_s=0.3, prompt_len=(14, 24),
                       output_len=(3, 5), shared_prefix_len=8, n_prefixes=2,
                       priority=PRIORITY_BATCH)),
        duration_s=1.0, seed=5, vocab_size=vocab)


def test_synthesize_equals_the_reference():
    """The same TrafficConfig gives the reference's events: times, tenants,
    prompts, output budgets, lanes and SLOs, in the same order."""
    vocab = models("llama2-7b")[2].vocab_size
    ours = synthesize(_tenants(traffic, SLO, vocab))
    ref = jax_traffic.synthesize(_tenants(jax_traffic, JaxSLO, vocab))
    assert len(ours) == len(ref) > 20
    assert {e.tenant for e in ours} == {"chat", "batch"}
    for a, b in zip(ours, ref):
        assert (a.t, a.tenant, a.max_new_tokens, a.priority) == (
            b.t, b.tenant, b.max_new_tokens, b.priority)
        assert np.array_equal(a.prompt, b.prompt)
        assert a.prompt.dtype == b.prompt.dtype == np.int32
        assert (a.slo is None) == (b.slo is None)
        if a.slo is not None:
            assert (a.slo.ttft_ms, a.slo.tpot_ms) == (b.slo.ttft_ms,
                                                      b.slo.tpot_ms)


def test_traffic_validation_equals_the_reference():
    bad_tenants = [dict(rate_rps=0.0), dict(rate_rps=1.0, arrival="uniform"),
                   dict(rate_rps=1.0, prompt_len=(0, 4)),
                   dict(rate_rps=1.0, arrival="onoff", on_s=0.0),
                   dict(rate_rps=1.0, prompt_len=(8, 16),
                        shared_prefix_len=8)]
    for kw in bad_tenants:
        for mod in (jax_traffic, traffic):
            with pytest.raises(ValueError):
                mod.TenantSpec(name="x", **kw)
    with pytest.raises(ValueError):
        TrafficConfig(tenants=(), duration_s=1.0)
    with pytest.raises(ValueError):
        TrafficConfig(tenants=(TenantSpec(name="a", rate_rps=1.0),
                               TenantSpec(name="a", rate_rps=2.0)),
                      duration_s=1.0)

    async def bad_scale():
        async with AsyncEngine(host_engine(serve_cfg())) as fe:
            await replay(fe, [], time_scale=-1.0)

    with pytest.raises(ValueError):
        asyncio.run(bad_scale())


def test_replay_report_windows_are_per_replay():
    """A second replay on the same engine reports its own window, not the
    engine's lifetime totals."""
    eng = host_engine(serve_cfg())
    events = synthesize(TrafficConfig(
        tenants=(TenantSpec(name="t", rate_rps=20.0, prompt_len=(8, 12),
                            output_len=(2, 3), slo=SLO(ttft_ms=1e9)),),
        duration_s=0.4, seed=6, vocab_size=models("llama2-7b")[2].vocab_size))

    async def go():
        async with AsyncEngine(eng) as fe:
            return (await replay(fe, events, time_scale=0),
                    await replay(fe, events, time_scale=0))

    r1, r2 = asyncio.run(go())
    assert r1.n_requests == r2.n_requests == len(events) > 0
    assert r1.total_tokens == r2.total_tokens
    assert r2.slo_total == len(events)           # window, not 2x lifetime
    assert r1.goodput == r2.goodput == 1.0
    assert [r.req_id for r in r2.results] == [
        len(events) + i for i in range(len(events))]
    assert_pools_free(eng)


def test_replayed_shed_set_equals_the_reference():
    """A trace-order replay (``time_scale=0``) under a fixed tick cost:
    which requests shed, and every request's finish reason and stream, is
    the reference's, request for request — real programs on both sides."""
    name = "llama2-7b"
    vocab = models(name)[2].vocab_size
    kw = dict(tenants=None, duration_s=0.5, seed=3, vocab_size=vocab)

    def trace(mod, slo_cls):
        # a 6e6-ms deadline at margin 1e-3: admitted while the projection
        # is under 6 s (six ticks), and met by any CPU run once served
        kw["tenants"] = (mod.TenantSpec(
            name="t", rate_rps=30.0, prompt_len=(12, 16), output_len=(2, 4),
            slo=slo_cls(ttft_ms=6e6)),)
        return mod.synthesize(mod.TrafficConfig(**kw))

    adm = dict(tick_cost_s=1.0, margin=1e-3)
    ref, ours = build(name, max_batch=4, admission=adm)
    reports = []
    for eng, front, events in (
            (ref, JaxAsyncEngine, trace(jax_traffic, JaxSLO)),
            (ours, AsyncEngine, trace(traffic, SLO))):
        async def go(eng=eng, front=front, events=events):
            async with front(eng) as fe:
                return await (jax_traffic.replay if front is JaxAsyncEngine
                              else replay)(fe, events, time_scale=0)
        reports.append(asyncio.run(go()))
    a, b = reports
    assert len(b.results) >= 10 and 0 < b.n_shed < len(b.results)
    assert [(r.req_id, r.finish_reason, r.n_tokens) for r in b.results] == [
        (r.req_id, r.finish_reason, r.n_tokens) for r in a.results]
    assert [list(r.generated) for r in ours.done] == [
        list(r.generated) for r in ref.done]
    assert ours.counts() == ref.counts()
    assert_pools_free(ours)


class _Clock:
    """The engine module's clock for one test: ``monotonic()`` reads a
    counter that each stubbed program call advances by ``step``."""

    def __init__(self, step):
        self.t, self.step = 1000.0, step

    def monotonic(self):
        return self.t

    def advance(self):
        self.t += self.step


def _overload_twin(cfg_kw, admission, events, clock, warmup):
    """One engine through ``events`` at their trace times on the fake
    clock: arrivals due by the clock's time are submitted before each tick,
    and an idle engine jumps to the next arrival.  Returns the engine and
    the window's preemptions, shed requests and goodput."""
    eng = host_engine(serve_cfg(admission=admission, **cfg_kw))
    eng.clock = clock
    for ev in warmup:
        eng.submit(ev.prompt, max_new_tokens=ev.max_new_tokens)
    eng.run_until_drained()
    p0, g0 = eng.preemptions, eng.goodput()
    t0, i = clock.t, 0
    for _ in range(20_000):
        while i < len(events) and t0 + events[i].t <= clock.t:
            ev = events[i]
            eng.submit(ev.prompt, max_new_tokens=ev.max_new_tokens,
                       slo=ev.slo, priority=ev.priority)
            i += 1
        if eng._live():
            eng.step()
        elif i < len(events):
            clock.t = t0 + events[i].t
        else:
            break
    assert i == len(events) and not eng._live()
    g1 = eng.goodput()
    total = g1["slo_total"] - g0["slo_total"]
    attained = g1["slo_attained"] - g0["slo_attained"]
    return eng, dict(preemptions=eng.preemptions - p0,
                     shed=eng.admission_shed, total=total,
                     goodput=attained / total)


def test_overload_shedding_beats_preemption_thrash(monkeypatch):
    """The reference's acceptance experiment on a fake clock: a Poisson
    trace at ~6x the unloaded service rate over a pool whose decode growth
    preempts.  With admission on — a fixed tick cost (the calibration's
    median tick wall) or the tick-wall EMA of the same clock — there are
    strictly fewer preemptions and strictly higher goodput than without,
    and some requests are shed; every page is free after each run."""
    clock = _Clock(step=0.003)
    monkeypatch.setattr(engine_mod, "time",
                        types.SimpleNamespace(monotonic=clock.monotonic))
    geom = dict(max_batch=4, n_pages=14, prefill_chunk=8,
                max_prefill_tokens=16)
    vocab = models("llama2-7b")[2].vocab_size
    cal = host_engine(serve_cfg(**geom))
    cal.clock = clock
    for p in prompts_of("llama2-7b", (24, 24, 24), seed=8):
        cal.submit(p, max_new_tokens=8)
    t0 = clock.t
    cal.run_until_drained()
    wall_cal = clock.t - t0
    ttft_cal = quantile([r.ttft for r in cal.done], 0.5)
    tpot_cal = quantile([r.tpot for r in cal.done], 0.5)
    tick_cal = quantile([t.wall_s for t in cal.tick_log], 0.5)
    assert wall_cal > 0 and ttft_cal > 0 and tick_cal > 0
    slo = SLO(ttft_ms=6 * ttft_cal * 1e3, tpot_ms=5 * tpot_cal * 1e3)
    events = synthesize(TrafficConfig(
        tenants=(TenantSpec(name="burst", rate_rps=6 * 3 / wall_cal,
                            prompt_len=(20, 28), output_len=(8, 8),
                            slo=slo),),
        duration_s=3 * wall_cal, seed=11, vocab_size=vocab))
    assert len(events) >= 12
    warm = events[:4]
    runs = {label: _overload_twin(geom, adm, events, clock, warm)
            for label, adm in (
                ("off", None),
                ("fixed", AdmissionConfig(tick_cost_s=tick_cal)),
                ("ema", AdmissionConfig()))}
    off = runs["off"][1]
    assert off["preemptions"] >= 1, "the off twin never thrashed"
    for label in ("fixed", "ema"):
        eng, on = runs[label]
        assert on["shed"] > 0, label
        assert on["total"] == off["total"] == len(events)
        assert on["preemptions"] < off["preemptions"], (label, on, off)
        assert on["goodput"] > off["goodput"], (label, on, off)
    for eng, _ in runs.values():
        assert_pools_free(eng)


_CLI = ["--arch", "llama2-7b", "--reduced", "--device", "cpu",
        "--prompt-len", "24", "--max-new", "4", "--prefill-chunk", "8",
        "--n-pages", "32", "--page-size", "8"]


def test_cli_serves_traffic_with_admission_trace_and_metrics(tmp_path,
                                                             capsys):
    """``--traffic`` (trace order, no waiting) with ``--admission`` at a
    fixed tick cost, an SLO, ``--trace-out`` and ``--metrics``: the
    scorecard, the goodput line, a Chrome trace whose tick track has one
    span a tick and a Prometheus file with the admission and SLO counters;
    then the fixed batch with ``--admission``."""
    from repro_torch.launch import serve
    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    assert serve.main(_CLI + [
        "--traffic", "--rate-rps", "40", "--duration-s", "0.3",
        "--time-scale", "0", "--admission", "--admission-tick-cost-s",
        "0.5", "--slo-ttft-ms", "1500", "--trace-out", str(trace),
        "--metrics", str(prom)]) == 0
    out = capsys.readouterr().out
    assert "admission=on" in out and "goodput=" in out and "shed=" in out
    assert "slo[ttft_ms=1500.0]" in out
    doc = json.loads(trace.read_text())
    ticks = [e for e in doc["traceEvents"] if e.get("cat") == "tick"]
    n_ticks = int(out.split("ticks=")[1].split()[0])
    assert len(ticks) == n_ticks > 0
    text = prom.read_text()
    for name in ("serving_slo_requests_total", "serving_ticks_total",
                 "serving_tick_wall_seconds_count"):
        assert name in text
    assert serve.main(_CLI + ["--requests", "3", "--admission",
                              "--slo-ttft-ms", "1e9"]) == 0
    out = capsys.readouterr().out
    assert "finish[length=3]" in out and "attained=3/3" in out


@pytest.mark.parametrize("argv,why", [
    (["--rate-rps", "2"], "require --traffic"),
    (["--time-scale", "0"], "require --traffic"),
    (["--max-pending-tokens", "64"], "require --admission"),
    (["--admission-tick-cost-s", "0.1"], "require --admission"),
    (["--traffic", "--mixed-sampling", "--temperature", "0.5"],
     "are exclusive"),
    (["--traffic", "--shared-prefix", "24"], "--shared-prefix <")])
def test_cli_refuses_what_the_reference_refuses(argv, why, capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as exc:
        serve.main(_CLI + argv)
    assert exc.value.code == 2
    assert why in capsys.readouterr().err
