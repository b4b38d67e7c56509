"""The port's observability half of ROADMAP A10 against the JAX package's on
the CPU: ``Tracer`` (event schema, the disabled tracer, the clamp of
pre-epoch timestamps), ``quantile``, ``SLO`` and ``slo_attainment``, and on
reduced llama2-7b / qwen3-8b engines in f32 (the reference's weights,
``torch_tier_parity``) goodput, ``submit``'s refusal of a non-``SLO``,
``check_drained``'s buckets and the engine's trace, event for event.

The same inputs go through both packages.  Where a result depends on a
clock, the clock is a fake one (the tracer's ``clock`` argument) or the
deadlines sit far from any latency a CPU run can show (1e-6 ms is always
missed, 1e9 ms always met), so no assertion reads the wall clock.
"""

import json
import math

import numpy as np
import pytest

from repro.serving import metrics as jax_metrics
from repro.serving import tracing as jax_tracing
from repro_torch.serving import metrics, tracing
from repro_torch.serving.sampling import SamplingParams
from torch_tier_parity import build, prompts_of, run_script, submit_all

GENEROUS = (1e9, 1e9)      # (ttft_ms, tpot_ms) no CPU run can miss
HOPELESS = (1e-6, None)    # a TTFT bound every request misses


def _clock(start=100.0):
    state = {"t": start}

    def clock():
        state["t"] += 1.0
        return state["t"]

    return clock


def _trace(mod):
    """One scripted timeline through ``mod.Tracer`` on a fake clock."""
    tr = mod.Tracer(clock=_clock())                 # t0 = 101
    t0, t1 = tr.now(), tr.now()                     # 102, 103
    tr.begin_request(5, t0, prompt_len=8)
    tr.request_span(5, "prefill_chunk", t0, t1, take=8, offset=0)
    tr.request_span(7, "queued", -5.0, t1)          # before t0: clamped
    tr.tick_span(t0, t1, index=0, preemptions=0)
    tr.instant("first_token", t1, req_id=5)
    tr.instant("compile", t1, group="decode")
    tr.end_request(5, t1, reason="length")
    return tr


def test_tracer_events_equal_the_reference(tmp_path):
    """Metadata, envelopes, spans and instants: the same events, field for
    field, as the reference's ``Tracer`` on the same fake clock, and the
    same JSON document on disk."""
    ours, ref = _trace(tracing), _trace(jax_tracing)
    assert ours.events() == ref.events()
    assert (tracing.PID, tracing.TICK_TID) == (jax_tracing.PID,
                                               jax_tracing.TICK_TID)
    meta = [e for e in ours.events() if e["ph"] == "M"]
    assert [m["args"]["name"] for m in meta] == [
        "serving-engine", "ticks", "req 5", "req 7"]
    b, = [e for e in ours.events() if e["ph"] == "b"]
    assert b["tid"] == 6 and b["ts"] == pytest.approx(1e6)
    queued = [e for e in ours.events() if e.get("name") == "queued"][0]
    assert queued["ts"] == 0.0 and queued["dur"] >= 0.0
    for tr, name in ((ours, "ours.json"), (ref, "ref.json")):
        tr.write(str(tmp_path / name))
    assert (json.loads((tmp_path / "ours.json").read_text())
            == json.loads((tmp_path / "ref.json").read_text()))
    assert ours.to_json()["displayTimeUnit"] == "ms"


def test_disabled_tracer_is_inert():
    """Disabled: ``now()`` is 0.0 without a clock read and no emitter
    records anything, in both packages."""
    reads = []

    def clock():
        reads.append(1)
        return 1.0

    for mod in (tracing, jax_tracing):
        tr = mod.Tracer(enabled=False, clock=clock)
        assert tr.now() == 0.0
        tr.begin_request(0, 0.0)
        tr.request_span(0, "decode", 0.0, 1.0)
        tr.tick_span(0.0, 1.0)
        tr.instant("preempt", 0.0)
        tr.end_request(0, 0.0)
        assert tr.events() == []
    assert reads == []


@pytest.mark.parametrize("xs", [
    [3.0, 1.0, 2.0], [1.0, 2.0], [1.0, float("nan"), 3.0, None], [],
    [float("nan")], [0.3, 7.0, 1.5, 2.2, 9.9, 4.1, 0.01]])
def test_quantile_equals_the_reference(xs):
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        got, want = metrics.quantile(xs, q), jax_metrics.quantile(xs, q)
        assert (math.isnan(got) and math.isnan(want)) or got == want
    for mod in (metrics, jax_metrics):
        with pytest.raises(ValueError, match="quantile"):
            mod.quantile([1.0], 1.5)


def test_slo_validation_and_attainment_equal_the_reference():
    for kw in (dict(ttft_ms=0.0), dict(tpot_ms=-5.0)):
        for mod in (metrics, jax_metrics):
            with pytest.raises(ValueError, match=next(iter(kw))):
                mod.SLO(**kw)
    nan = float("nan")
    for slo in [(100.0, 10.0), (None, 10.0), (100.0, None), (None, None)]:
        for ttft, tpot in [(0.05, 0.005), (0.2, 0.005), (0.05, 0.02),
                           (0.2, 0.02), (0.1, 0.01), (nan, 0.005),
                           (nan, nan)]:
            assert metrics.slo_attainment(ttft, tpot, metrics.SLO(*slo)) \
                == jax_metrics.slo_attainment(ttft, tpot,
                                              jax_metrics.SLO(*slo))


@pytest.mark.parametrize("name", ["llama2-7b", "qwen3-8b"])
def test_goodput_counts_match_the_reference(name):
    """A generous, a hopeless and an SLO-free request, then one hopeless
    request aborted before it ran: the ``serving_slo_*`` counters,
    ``goodput()`` and ``counts()`` after every tick equal the reference's,
    and the abort is excluded."""
    ps = prompts_of(name, (12, 17, 9, 14), seed=5)
    ops = [("submit", ps[0], dict(max_new_tokens=4), dict(slo=GENEROUS)),
           ("submit", ps[1], dict(max_new_tokens=4), dict(slo=HOPELESS)),
           ("submit", ps[2], dict(max_new_tokens=4)),
           ("submit", ps[3], dict(max_new_tokens=4), dict(slo=HOPELESS)),
           ("abort", 3)]
    got = run_script(name, ops, n_pages=64)
    ours, ref = got["engine"], got["ref"]
    assert ours.goodput() == ref.goodput() == {
        "slo_total": 2, "slo_attained": 1, "ttft_violations": 1,
        "tpot_violations": 0, "goodput": 0.5}
    assert ours.counts() == ref.counts()
    snap = ours.metrics_snapshot()["counters"]
    assert snap["serving_slo_requests_total"] == 2
    assert snap["serving_aborted_total"] == 1


def test_goodput_is_vacuous_without_slos():
    ref, ours = build("llama2-7b", n_pages=64)
    for eng in (ref, ours):
        assert eng.goodput()["goodput"] == 1.0
    got = run_script("llama2-7b", submit_all(
        prompts_of("llama2-7b", (10, 11), seed=2), max_new=3))
    assert got["engine"].goodput() == got["ref"].goodput() == {
        "slo_total": 0, "slo_attained": 0, "ttft_violations": 0,
        "tpot_violations": 0, "goodput": 1.0}


def test_submit_rejects_a_non_slo():
    ref, ours = build("llama2-7b")
    p = prompts_of("llama2-7b", (8,))[0]
    for eng in (ref, ours):
        with pytest.raises(TypeError, match="slo"):
            eng.submit(p, slo={"ttft_ms": 5.0})
        assert not eng.queue and eng._next_id == 0


def test_check_drained_reports_admission_buckets_as_the_reference():
    """One queued, one deferred (over the pending-token cap) and one shed
    request, then a zero-tick drain: the same RuntimeError text in both
    packages, with ``deferred`` and ``shed`` as their own buckets."""
    adm = dict(tick_cost_s=1.0, max_pending_tokens=24)
    ref, ours = build("llama2-7b", max_batch=4, admission=adm)
    ps = prompts_of("llama2-7b", (16, 16, 16), seed=1)
    msgs = []
    for eng, slo in ((ref, jax_metrics.SLO), (ours, metrics.SLO)):
        eng.submit(ps[0], max_new_tokens=4)
        eng.submit(ps[1], max_new_tokens=4)                  # deferred
        eng.submit(ps[2], max_new_tokens=4, slo=slo(ttft_ms=1.0))  # shed
        with pytest.raises(RuntimeError) as exc:
            eng.run_until_drained(max_ticks=0)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    msg = msgs[1]
    assert "1 deferred" in msg and "1 shed" in msg and "1 queued" in msg
    assert "'deferred': 1" in msg
    for eng in (ref, ours):
        eng.run_until_drained()
    assert [r.finish_reason for r in ours.done] == [
        r.finish_reason for r in ref.done] == ["shed", "length", "length"]


def _events(tracer):
    """The trace without its clock readings."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in tracer.events()]


@pytest.mark.parametrize("mode", ["swap", "spec-prefix"])
def test_engine_trace_equals_the_reference(mode):
    """Both engines traced over one script — a pool that preempts and
    swaps through a host tier, or the prefix cache with n-gram speculation — give the same events in
    the same order, every argument equal (only the clock readings differ);
    and the trace reconciles with the registry: tick spans sum to the
    lifetime counters, prefill spans to the prefill tokens, decode and
    verify spans to the decode tokens, every request opened and closed
    once."""
    if mode == "swap":
        kw = dict(n_pages=14, host_spill_pages=64, max_batch=4)
        ps = prompts_of("llama2-7b", (30, 25, 21, 18), seed=9)
        ops = submit_all(ps, max_new=8)
        ops = [op + (dict(slo=GENEROUS),) for op in ops]
    else:
        kw = dict(n_pages=40, prefix_cache=True, k=3)
        ps = prompts_of("llama2-7b", (24, 30, 20, 26), seed=4, head=8)
        ps[1] = np.tile(ps[1][:6], 5)
        ops = submit_all(ps, max_new=8)
    got = run_script("llama2-7b", ops, trace=True, **kw)
    ours, ref = got["engine"], got["ref"]
    assert _events(ours.tracer) == _events(ref.tracer)
    evs = ours.tracer.events()
    ticks = [e for e in evs if e.get("cat") == "tick"]
    spans = [e for e in evs if e.get("cat") == "phase"]
    assert len(ticks) == ours.n_ticks
    by = lambda n: [s for s in spans if s["name"] == n]   # noqa: E731
    assert sum(s["args"]["take"] for s in by("prefill_chunk")) \
        == ours.prefill_tokens_executed
    assert (sum(s["args"]["tokens"] for s in by("decode"))
            + sum(s["args"]["emitted"] for s in by("verify_window"))) \
        == ours.decode_tokens_emitted
    c = ours.counts()
    for key, want in (("preemptions", ours.preemptions),
                      ("swap_out_bytes", c["swap_out_bytes"]),
                      ("swap_in_bytes", c["swap_in_bytes"]),
                      ("prefill_tokens", ours.prefill_tokens_executed),
                      ("spec_drafted", ours.spec_drafted)):
        assert sum(t["args"][key] for t in ticks) == want, key
    begins = [e for e in evs if e["ph"] == "b"]
    ends = [e for e in evs if e["ph"] == "e"]
    assert len(begins) == len(ends) == len(ps)
    snap = ours.metrics_snapshot()
    assert snap["histograms"]["serving_tick_wall_seconds"]["count"] \
        == len(ticks)
    assert snap["histograms"]["serving_ttft_seconds"]["count"] == len(ps)
    if mode == "swap":
        assert ours.preemptions > 0
        assert len(by("swap_out")) == len(by("swap_in")) == ours.swap_outs
        assert sum(s["args"]["bytes"] for s in by("swap_out")) \
            == c["swap_out_bytes"]
        assert ours.goodput()["slo_attained"] == len(ps)
    else:
        assert ours.prefix_stats()["hit_tokens"] > 0
        assert by("verify_window")
    json.dumps(ours.tracer.to_json())
    assert all(e["dur"] >= 0 for e in evs if e["ph"] == "X")


def test_traced_streams_equal_untraced():
    """Tracing changes nothing the engine computes: the same streams, tick
    log, host transfers and compile keys with the tracer on or off."""
    ps = prompts_of("qwen3-8b", (30, 25, 21, 18), seed=9)
    runs = []
    for trace in (False, True):
        eng = build("qwen3-8b", max_batch=4, n_pages=14,
                    host_spill_pages=64, trace=trace)[1]
        reqs = eng.generate(ps, SamplingParams(max_new_tokens=8))
        runs.append(([r.generated for r in reqs],
                     [(t.prefill_reqs, t.decode_reqs, t.preemptions)
                      for t in eng.tick_log],
                     eng.host_transfers, eng.compile_count,
                     len(eng.tracer.events())))
    assert runs[0][:4] == runs[1][:4]
    assert runs[0][4] == 0 < runs[1][4]
