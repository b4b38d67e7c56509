"""SLO-aware admission control and priority lanes (ROADMAP A10) of the
port's engine against the JAX package's on the CPU: reduced llama2-7b /
qwen3-8b in f32 on the reference's own weights (``torch_tier_parity``),
driven by one script of submits, aborts and ticks.

After every op and tick the shed and deferred decisions (``deferred``, the
finish reasons so far, ``goodput()``), ``counts()`` with every key, the
queue, the slots, the pools, the host tier and the tick record equal the
reference's; the greedy streams too.

The controller projects TTFT with a FIXED ``tick_cost_s`` of 1 s, so every
decision is a function of the queues alone, never of a clock.  Its
``margin`` of 1e-3 makes a 1e7-ms TTFT deadline an admission threshold of
10 s (ten ticks of backlog) while the deadline itself, 2.8 hours, is met by
any CPU run: the attainment counters are then a function of the decisions
too.  A 1e-6-ms deadline is shed whenever it is projected at all.
"""

import numpy as np
import pytest

from repro_torch.serving.scheduler import (PRIORITY_BATCH,
                                           PRIORITY_INTERACTIVE)
from torch_tier_parity import build, prompts_of, run_script

ADMISSION = dict(tick_cost_s=1.0, margin=1e-3, max_pending_tokens=64)
TIGHT = (1e7, None)          # admitted while the backlog is < ~10 ticks
HOPELESS = (1e-6, None)      # always shed


def _script(name, seed=7):
    """Eight submits with steps between them: SLO-carrying requests in
    both lanes (some shed once the backlog grows), best-effort ones (some
    deferred over the 64-token cap), a hopeless one, and an abort of a
    deferred request."""
    ps = prompts_of(name, (20, 26, 18, 30, 22, 15, 27, 19), seed=seed)
    sp = dict(max_new_tokens=6)
    inter = dict(slo=TIGHT, priority=PRIORITY_INTERACTIVE)
    batch = dict(priority=PRIORITY_BATCH)
    return [("submit", ps[0], sp, batch),
            ("submit", ps[1], sp, inter),
            ("submit", ps[2], sp, batch),
            ("submit", ps[3], sp, batch),          # over the cap: deferred
            ("step",),
            ("submit", ps[4], sp, inter),
            ("submit", ps[5], sp, dict(slo=HOPELESS)),
            ("submit", ps[6], sp, batch),
            ("abort", 6),
            ("step",), ("step",),
            ("submit", ps[7], sp, inter)]


CASES = {
    "llama2-paged": ("llama2-7b", dict(n_pages=40)),
    "qwen3-paged": ("qwen3-8b", dict(n_pages=40)),
    "llama2-int8kv": ("llama2-7b", dict(n_pages=40, kv_dtype="int8")),
    "qwen3-int8kv": ("qwen3-8b", dict(n_pages=40, kv_dtype="int8")),
    # a pool that preempts, swapped through the host tier
    "llama2-host-tier": ("llama2-7b", dict(n_pages=14, host_spill_pages=64,
                                           max_batch=4)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_admission_decisions_match_the_reference(case):
    name, kw = CASES[case]
    kw = dict(kw)
    got = run_script(name, _script(name), admission=ADMISSION, **kw)
    ours, ref = got["engine"], got["ref"]
    c = ours.counts()
    assert c == ref.counts()
    assert c["shed"] >= 2 and ours.admission_deferred >= 1
    reasons = [r.finish_reason for r in got["reqs"]]
    assert reasons[5] == "shed" and reasons[6] == "abort"
    assert reasons.count("length") >= 4
    # shed deadline-carrying demand counts un-attained; aborts not at all
    g = ours.goodput()
    assert g["slo_total"] == sum(r.slo is not None and r.finish_reason
                                 != "abort" for r in got["reqs"])
    assert g["slo_attained"] == sum(r.slo is not None and r.finish_reason
                                    == "length" for r in got["reqs"])
    if kw.get("host_spill_pages"):
        assert ours.preemptions > 0 and ours.swap_outs > 0
        assert c["host_resident_pages"] == 0
    snap = ours.metrics_snapshot()["counters"]
    assert snap["serving_admission_shed_total"] == c["shed"]
    assert snap["serving_admission_deferred_total"] \
        == ours.admission_deferred


def test_interactive_prefill_goes_before_batch():
    """A BATCH request submitted first and an INTERACTIVE one second, one
    chunk of budget a tick: the interactive prompt's chunks run first
    (priority, then TTFT deadline, then age), as in the reference; with one
    slot, the interactive request takes it."""
    name = "llama2-7b"
    ps = prompts_of(name, (24, 24, 16), seed=3)
    sp = dict(max_new_tokens=4)
    ops = [("submit", ps[0], sp, dict(priority=PRIORITY_BATCH)),
           ("submit", ps[1], sp, dict(priority=PRIORITY_INTERACTIVE,
                                      slo=(1e9, None))),
           ("step",), ("step",)]
    got = run_script(name, ops, prefill_chunk=8, max_prefill_tokens=8)
    log = list(got["engine"].tick_log)
    assert log[0].prefill_reqs == [1] and log[1].prefill_reqs == [1]
    got = run_script(name, ops + [("submit", ps[2], sp)], max_batch=1)
    first = [t.prefill_reqs for t in got["engine"].tick_log if
             t.prefill_reqs][0]
    assert first == [1]
    done = [r.req_id for r in got["engine"].done]
    assert done.index(1) < done.index(0)


def test_edf_orders_deadlines_within_a_lane():
    """Two STANDARD requests, the second with the earlier TTFT deadline:
    its prefill goes first (EDF inside the class), as in the reference."""
    name = "qwen3-8b"
    ps = prompts_of(name, (16, 16), seed=8)
    sp = dict(max_new_tokens=3)
    ops = [("submit", ps[0], sp, dict(slo=(1e9, None))),
           ("submit", ps[1], sp, dict(slo=(1e8, None))),
           ("step",)]
    got = run_script(name, ops, prefill_chunk=8, max_prefill_tokens=8)
    assert got["engine"].tick_log[0].prefill_reqs == [1]


def test_deferred_request_drains_and_aborts_free_nothing():
    """A best-effort request over the pending-token cap parks in
    ``deferred`` (no slot, no page), re-enters when the backlog drains, and
    an abort of a parked one is pure list removal."""
    ref, ours = build("llama2-7b", max_batch=2,
                      admission=dict(tick_cost_s=1.0, max_pending_tokens=24))
    ps = prompts_of("llama2-7b", (16, 16, 16), seed=1)
    for eng in (ref, ours):
        first = eng.submit(ps[0], max_new_tokens=4)
        parked = eng.submit(ps[1], max_new_tokens=4)
        gone = eng.submit(ps[2], max_new_tokens=4)
        assert [r.req_id for r in eng.deferred] == [1, 2]
        assert parked not in eng.queue and eng.counts()["deferred"] == 2
        out = eng.abort(gone.req_id)
        assert out.finish_reason == "abort" and gone.slot == -1
        eng.run_until_drained()
        assert (first.finish_reason, parked.finish_reason) == ("length",
                                                               "length")
        assert eng.admission_deferred == 2 and not eng.deferred
        for p in eng.pool.pools:
            p.check_invariants()
            assert p.free_pages() == p.n_pages
    assert [len(r.generated) for r in ours.done] == [
        len(r.generated) for r in ref.done]


def test_tick_ema_skips_ticks_that_met_a_new_shape():
    """The tick-wall EMA (alpha 0.2) counts only ticks without a new
    program shape, starts at the first such tick's wall and stays a
    positive cost."""
    ours = build("llama2-7b")[1]
    ps = prompts_of("llama2-7b", (16, 12), seed=2)
    ours.generate(ps, None)
    log = list(ours.tick_log)
    quiet = [t.wall_s for t in log if t.new_compiles == 0]
    assert 0 < len(quiet) < len(log)
    assert ours._tick_wall_n == len(quiet)
    ema = quiet[0]
    for w in quiet[1:]:
        ema = 0.8 * ema + 0.2 * w
    assert ours.tick_wall_ema == pytest.approx(ema) and ema > 0
    assert np.isfinite(ours.tick_wall_ema)
