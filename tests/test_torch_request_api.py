"""The request API of the port's engine (ROADMAP A8) against the JAX
package's on the CPU: mixed greedy/stochastic batches, ``abort`` at every
stage, ``stream`` and ``metrics_snapshot``, and the CLI's sampling flags.

Engines run reduced llama2-7b / qwen3-8b in f32 on the reference's own
weights (``torch_tier_parity``), where greedy streams are decisive; every
host decision is compared after every tick.  The two packages draw random
numbers from different sources, so a stochastic request is held to the
reference in the number of tokens it emits and in the tick log (which
depends on lengths only, without speculation), and to itself in its
draws: a request's stream is a pure function of its seed and emission
count, the same solo or batched and on every arena.
"""

import numpy as np
import pytest

from repro_torch.launch import serve
from repro_torch.serving.engine import RequestState, ServeConfig, \
    ServingEngine
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import PhaseAwareConfig
from torch_spec_parity import models
from torch_tier_parity import build, prompts_of, run_script, submit_all

STOCH = dict(temperature=0.8, top_k=20, top_p=0.95)
MIXED = [None, dict(STOCH, seed=11), None, dict(temperature=1.1, seed=12)]


@pytest.mark.parametrize("name,mode", [
    ("llama2-7b", dict()), ("qwen3-8b", dict()),
    ("llama2-7b", dict(kv_dtype="int8")),
    ("llama2-7b", dict(paged=False, prefill_chunk=8)),
    ("qwen3-8b", dict(paged=False, prefill_chunk=0)),
    ("llama2-7b", dict(packed_prefill=False)),
    ("mamba2-2.7b", dict(paged=False, prefill_chunk=0))],
    ids=["llama2-paged", "qwen3-paged", "llama2-int8kv", "llama2-dense",
         "qwen3-dense-whole", "llama2-padded", "mamba2-dense-whole"])
def test_mixed_batches_match_the_reference(name, mode):
    """Greedy rows 0 and 2, stochastic rows 1 and 3: the reference's tick
    logs, counts(), host transfers after every tick (one a program call)
    and compile keys (``all_greedy`` included), and the greedy rows' streams
    bit for bit."""
    ps = prompts_of(name, (13, 29, 7, 22), seed=5)
    run_script(name, submit_all(ps, MIXED, max_new=8), max_batch=4,
               n_pages=64, **mode)


def _stream_of(eng, prompt, others=(), sp=SamplingParams(
        max_new_tokens=10, seed=7, **STOCH)):
    reqs = eng.generate([prompt, *others],
                        [sp] + [SamplingParams(max_new_tokens=10)] *
                        len(others))
    return [int(t) for t in reqs[0].generated]


def _engine(name, **kw):
    cfg, tp = models(name)[2:]
    phase = dict(kw.pop("phase", {}))
    kw.setdefault("paged", True)
    return ServingEngine(cfg, tp, ServeConfig(
        max_batch=kw.pop("max_batch", 4), max_len=96, page_size=8,
        phase=PhaseAwareConfig(prefill_chunk=phase.get("prefill_chunk", 8),
                               pack_align=8), **kw), device="cpu")


def test_stochastic_streams_are_reproducible_solo_batched_and_across_modes():
    """One stochastic request (seed 7): the same stream served alone, in a
    batch with greedy neighbours, on the dense arena, with the prefix cache
    (after a request that publishes its head), preempted and recomputed,
    and preempted and swapped through the host tier."""
    name = "llama2-7b"
    ps = prompts_of(name, (30, 25, 21, 18), seed=9, head=16)
    solo = _stream_of(_engine(name, n_pages=64), ps[0])
    assert len(solo) == 10
    runs = {
        "batched": _stream_of(_engine(name, n_pages=64), ps[0], ps[1:]),
        "dense": _stream_of(_engine(name, paged=False), ps[0], ps[1:]),
        "dense-whole": _stream_of(_engine(name, paged=False,
                                          phase=dict(prefill_chunk=0)),
                                  ps[0], ps[1:]),
    }
    eng = _engine(name, n_pages=64, prefix_cache=True)
    eng.generate([ps[1]], SamplingParams(max_new_tokens=2))
    runs["prefix"] = _stream_of(eng, ps[0], ps[2:])
    assert eng.prefix_stats()["hit_tokens"] > 0
    for spill in (0, 64):
        eng = _engine(name, n_pages=14, host_spill_pages=spill)
        runs[f"preempted-{spill}"] = _stream_of(eng, ps[0], ps[1:])
        assert eng.preemptions > 0
        assert eng.counts()["swap_resumes"] == (eng.preemptions if spill
                                                else 0)
    for mode, stream in runs.items():
        assert stream == solo, mode


@pytest.mark.parametrize("stage", ["waiting", "prefilling", "decoding",
                                   "swapped", "mid_verify"])
def test_abort_at_every_stage_matches_the_reference(stage):
    """``abort`` of a queued, swapped-out, prefilling, decoding or
    speculating request (greedy, so both packages serve the same tokens):
    after every op and tick the pool, host tier, prefix cache, queue and
    counts equal the reference's, and the survivors' streams too.  The
    abort's own output (finish_reason "abort", tokens so far) matches."""
    name = "qwen3-8b"
    kw = dict(prefix_cache=True)
    if stage == "swapped":
        kw.update(n_pages=8, host_spill_pages=32)
    if stage == "mid_verify":
        kw.update(k=3)
    ps = prompts_of(name, (24, 30, 20, 26), seed=4, head=8)
    # a looping prompt gives the n-gram drafter something to propose
    ps[1] = np.tile(ps[1][:6], 5)
    ops = submit_all(ps, max_new=12)
    steps = {"waiting": 0, "prefilling": 1, "decoding": 4,
             "swapped": 7, "mid_verify": 6}[stage]
    victim = {"waiting": 3, "swapped": 1}.get(stage, 1)
    ops += [("step",)] * steps + [("abort", victim)]
    got = run_script(name, ops, **kw)
    ours = got["engine"]
    out = got["aborts"][0]
    assert out.finish_reason == "abort" and out.finished
    r = got["reqs"][victim]
    assert r.state == RequestState.DONE and r.finish_reason == "abort"
    assert ours.counts()["done"] == 4 and ours.aborted == 1
    if stage == "swapped":
        assert ours.swap_outs > 0
    if stage == "mid_verify":
        assert ours.spec_windows > 0
    # an unknown or finished id: None on both
    assert ours.abort(99) is None and ours.abort(victim) is None


def test_abort_states_are_where_the_test_means():
    """The stages ``test_abort_at_every_stage_matches_the_reference`` aims
    at: after that many ticks the victim is prefilling, decoding, or
    queued with its KV swapped out."""
    name = "qwen3-8b"
    ps = prompts_of(name, (24, 30, 20, 26), seed=4, head=8)
    ps[1] = np.tile(ps[1][:6], 5)
    for steps, kw, want in (
            (1, dict(), RequestState.PREFILLING),
            (4, dict(), RequestState.DECODING),
            (7, dict(n_pages=8, host_spill_pages=32), RequestState.WAITING)):
        eng = build(name, prefix_cache=True, **kw)[1]
        reqs = [eng.submit(p, sampling=SamplingParams(max_new_tokens=12))
                for p in ps]
        for _ in range(steps):
            eng.step()
        assert reqs[1].state == want
        assert (reqs[1].swap is not None) == ("host_spill_pages" in kw)


def test_stream_and_metrics_snapshot():
    """``stream`` yields each request's tokens as its ticks produce them
    (concatenated, they are ``generated``), an ``abort`` from the
    consuming loop ends that request without re-yielding it, and
    ``metrics_snapshot`` refreshes the occupancy gauges."""
    name = "llama2-7b"
    eng = _engine(name, n_pages=64, max_batch=2, host_spill_pages=8)
    ps = prompts_of(name, (20, 12, 9), seed=2)
    reqs = [eng.submit(p, sampling=SamplingParams(
        max_new_tokens=6, **(STOCH if i == 1 else {}), seed=i))
        for i, p in enumerate(ps)]
    seen = {r.req_id: [] for r in reqs}
    snap = eng.metrics_snapshot()
    assert snap["gauges"]["serving_requests_queued"] == 3
    aborted = False
    for out in eng.stream():
        seen[out.req_id] += out.new_token_ids
        if not aborted and out.req_id == 0 and out.n_generated >= 2:
            assert eng.abort(2).finish_reason == "abort"
            aborted = True
    assert aborted
    for r in reqs[:2]:
        assert seen[r.req_id] == list(r.generated) and len(r.generated) == 6
    assert seen[2] == [] and reqs[2].finish_reason == "abort"
    snap = eng.metrics_snapshot()
    g = snap["gauges"]
    assert (g["serving_requests_queued"], g["serving_requests_active"],
            g["serving_requests_done"]) == (0, 0, 3)
    assert g["serving_host_resident_pages"] == 0
    assert snap["counters"]["serving_aborted_total"] == 1


def test_serve_cli_sampling_and_tier_flags(capsys):
    """The reference's ``ap.error`` checks for the new flags, and a run
    mixing greedy and stochastic requests over a pool small enough to
    swap, with the disaggregated executor: every request finishes, and
    the report carries the sampling mode, the handoff and the host tier."""
    base = ["--arch", "llama2-7b", "--reduced", "--device", "cpu"]
    for bad in (["--mixed-sampling"],
                ["--host-spill-pages", "8", "--no-paged"]):
        with pytest.raises(SystemExit) as e:
            serve.main(base + bad)
        assert e.value.code == 2
    capsys.readouterr()
    assert serve.main(base + [
        "--requests", "4", "--prompt-len", "40", "--max-new", "8",
        "--prefill-chunk", "16", "--page-size", "8", "--n-pages", "20",
        "--temperature", "0.8", "--top-k", "20", "--top-p", "0.9",
        "--mixed-sampling", "--host-spill-pages", "32",
        "--executor", "disaggregated"]) == 0
    out = capsys.readouterr().out
    assert "requests=4 tokens=32" in out and "sampling=mixed" in out
    assert "disaggregated prefill-devices=1 decode-devices=1" in out
    assert "host-tier pages=32 pinned=False" in out
    assert "swap-resumes=1 recompute-resumes=0" in out
