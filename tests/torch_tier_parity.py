"""The engine check shared by the request-API and tiered-KV test files:
the port's ServingEngine against the JAX package's on the CPU, on a
reduced model in f32 with the reference's own weights (through
``params_from_jax``), driven by one script of submits, aborts and ticks.

Everything the host decides must be equal after every tick: the tick
record (prefill and decode request lists, prefill tokens, preemptions,
drafted and accepted tokens, migrated pages and bytes, swap bytes, host
pages in use), ``counts()``, the host transfers so far, each run's page
pool (block tables, lengths, refcounts, cache pins, free list), the host
tier's free lists and the prefix cache's stats, and with admission control
the deferred requests and the finish reasons so far; after the drain also
``prefix_stats()``, ``spec_stats()``, the compile count and the finish
reasons.  Greedy streams must be equal; a stochastic request (the two
packages draw from different sources) must emit as many tokens, each
inside the vocabulary.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro.serving.engine import ServeConfig as JaxServeConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.metrics import SLO as JaxSLO
from repro.serving.sampling import SamplingParams as JaxSamplingParams
from repro.serving.scheduler import AdmissionConfig as JaxAdmissionConfig
from repro.serving.scheduler import PhaseAwareConfig as JaxPhaseAwareConfig
from repro.serving.speculative import SpecConfig as JaxSpecConfig
from repro.serving.tracing import Tracer as JaxTracer
from repro_torch.serving.engine import ServeConfig, ServingEngine
from repro_torch.serving.metrics import SLO
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import AdmissionConfig, PhaseAwareConfig
from repro_torch.serving.speculative import SpecConfig
from repro_torch.serving.tracing import Tracer
from torch_spec_parity import models

_TICK_FIELDS = ("prefill_reqs", "decode_reqs", "prefill_tokens",
                "preemptions", "spec_drafted", "spec_accepted",
                "migrated_pages", "migrated_bytes", "swap_out_bytes",
                "swap_in_bytes", "host_resident_pages")


def build(name: str, *, k: Optional[int] = None, max_batch: int = 2,
          prefill_chunk: int = 8, max_prefill_tokens: int = 16,
          admission: Optional[Dict] = None, trace: bool = False, **kw):
    """(reference engine, port engine) of reduced ``name`` with the same
    ServeConfig: ``speculative=SpecConfig(k=k)`` when ``k`` is given,
    ``admission=AdmissionConfig(**admission)`` when ``admission`` is given,
    pages of 8 tokens and the other fields ``kw``; with ``trace`` each
    engine records into its package's ``Tracer``."""
    jcfg, jp, cfg, tp = models(name)
    common = dict(max_batch=max_batch, max_len=96, page_size=8, **kw)
    common.setdefault("paged", True)
    common.setdefault("n_pages", 40)
    phase = dict(max_decode_batch=max_batch, prefill_chunk=prefill_chunk,
                 max_prefill_tokens=max_prefill_tokens, pack_align=8)
    ref = JaxServingEngine(jcfg, jp, JaxServeConfig(
        phase=JaxPhaseAwareConfig(**phase),
        speculative=JaxSpecConfig(k=k) if k else None,
        admission=(JaxAdmissionConfig(**admission)
                   if admission is not None else None), **common),
        tracer=JaxTracer() if trace else None)
    ours = ServingEngine(cfg, tp, ServeConfig(
        phase=PhaseAwareConfig(**phase),
        speculative=SpecConfig(k=k) if k else None,
        admission=(AdmissionConfig(**admission)
                   if admission is not None else None), **common),
        device="cpu", tracer=Tracer() if trace else None)
    return ref, ours


def host_state(eng) -> Dict:
    """What the host decided so far, comparable across the packages."""
    out = dict(counts=eng.counts(), transfers=eng.host_transfers,
               queue=[r.req_id for r in eng.queue],
               slots=[None if r is None else r.req_id
                      for r in eng.slot_req],
               slot_pos=[int(p) for p in eng.slot_pos])
    if eng.paged:
        out["pools"] = [(p.table.tolist(), p.lens.tolist(), p.ref.tolist(),
                         p.external.tolist(), list(p.free))
                        for p in eng.pool.pools]
    if eng.host_tier is not None:
        out["host_free"] = [list(f) for f in eng.host_tier.free]
    if eng.prefix is not None:
        out["prefix"] = eng.prefix.stats()
    if eng.admission is not None:
        out["deferred"] = [r.req_id for r in eng.deferred]
        out["done"] = [(r.req_id, r.finish_reason) for r in eng.done]
        out["goodput"] = eng.goodput()
    return out


def tick_record(t) -> Tuple:
    return tuple(getattr(t, f) for f in _TICK_FIELDS)


# ("submit", prompt, sampling kwargs[, {"slo": (ttft_ms, tpot_ms),
# "priority": p}]) | ("abort", i) | ("step",)
Op = Tuple


def run_script(name: str, ops: Sequence[Op], *, max_ticks: int = 600,
               **build_kw) -> Dict:
    """Run ``ops`` on both engines, then drain them, comparing
    ``host_state`` after every op and tick; return the port's results."""
    ref, ours = build(name, **build_kw)
    reqs: List[Tuple] = []
    aborts = []

    def both_equal(where):
        a, b = host_state(ref), host_state(ours)
        for key in a:
            assert b[key] == a[key], (where, key)

    for i, op in enumerate(ops):
        if op[0] == "submit":
            prompt, sp = op[1], dict(op[2])
            extra = dict(op[3]) if len(op) > 3 else {}
            slo = extra.pop("slo", None)
            reqs.append((
                ref.submit(prompt.copy(), sampling=JaxSamplingParams(**sp),
                           slo=None if slo is None else JaxSLO(*slo),
                           **extra),
                ours.submit(prompt.copy(), sampling=SamplingParams(**sp),
                            slo=None if slo is None else SLO(*slo),
                            **extra)))
        elif op[0] == "abort":
            a, b = ref.abort(op[1]), ours.abort(op[1])
            assert (a is None) == (b is None)
            if a is not None:
                assert (b.req_id, b.n_generated, b.finish_reason) == (
                    a.req_id, a.n_generated, a.finish_reason)
            aborts.append(b)
        else:
            ref.step()
            ours.step()
            assert tick_record(ours.tick_log[-1]) == tick_record(
                ref.tick_log[-1]), (i, "tick")
        both_equal(i)
    ticks = 0
    while ref._live() or ours._live():
        assert ticks < max_ticks, "did not drain"
        ref.step()
        ours.step()
        ticks += 1
        assert tick_record(ours.tick_log[-1]) == tick_record(
            ref.tick_log[-1]), ("drain", ticks)
        both_equal(("drain", ticks))
    for eng in (ref, ours):
        if eng.paged:
            for p in eng.pool.pools:
                p.check_invariants()
        if eng.host_tier is not None:
            eng.host_tier.check_invariants()
    vocab = models(name)[2].vocab_size
    for a, b in reqs:
        assert (b.finish_reason, len(b.generated)) == (a.finish_reason,
                                                       len(a.generated))
        if b.sampling.greedy:
            assert [int(t) for t in b.generated] == [int(t)
                                                     for t in a.generated]
        else:
            assert all(0 <= int(t) < vocab for t in b.generated)
    assert ours.prefix_stats() == ref.prefix_stats()
    assert ours.spec_stats() == ref.spec_stats()
    assert ours.compile_count == ref.compile_count
    return dict(engine=ours, ref=ref, reqs=[b for _, b in reqs],
                ref_reqs=[a for a, _ in reqs], aborts=aborts)


def submit_all(prompts, sampling=None, max_new: int = 12) -> List[Op]:
    """One submit op per prompt (greedy unless ``sampling[i]`` says)."""
    ops = []
    for i, p in enumerate(prompts):
        sp = dict(max_new_tokens=max_new)
        if sampling is not None and sampling[i]:
            sp.update(sampling[i])
        ops.append(("submit", p, sp))
    return ops


def prompts_of(name: str, lengths, seed: int = 3, head: int = 0):
    """Prompts of ``lengths`` tokens from ``seed``, opening with one shared
    ``head``-token prefix when ``head`` > 0."""
    vocab = models(name)[2].vocab_size
    rng = np.random.default_rng(seed)
    h = rng.integers(0, vocab, head).astype(np.int32)
    return [np.concatenate([h, rng.integers(0, vocab, n - head)
                            .astype(np.int32)]) for n in lengths]


# ---------------------------------------------------------------------------
# the tiered-KV and disaggregated cases, one test file per model
# ---------------------------------------------------------------------------

# the cases each model runs; the second model repeats the first rows of
# each table (one swap, one recompute, one demote/promote, paged and dense
# disaggregation)
TIER_CASES = {
    # a pool that preempts: swapped through the host tier, recomputed, and
    # a tier too small for any victim (every preemption falls back)
    "swap": dict(n_pages=14, host_spill_pages=64),
    "swap-int8kv": dict(n_pages=14, host_spill_pages=64, kv_dtype="int8"),
    "recompute": dict(n_pages=14),
    "tier-full": dict(n_pages=14, host_spill_pages=1),
    "swap-spec": dict(n_pages=14, host_spill_pages=64, k=3),
}
PREFIX_CASES = {
    # a cached head evicted by filler prompts (demoted), then hit again
    # (promoted); with 8 pages the fillers also preempt and swap
    "demote-promote": dict(n_pages=9, host_spill_pages=16),
    "demote-promote-swap": dict(n_pages=8, host_spill_pages=16),
    "demote-promote-int8kv": dict(n_pages=9, host_spill_pages=16,
                                  kv_dtype="int8"),
    "demote-tier-full": dict(n_pages=9, host_spill_pages=1),
}
DISAGG_CASES = {
    "paged": dict(),
    "paged-int8kv": dict(kv_dtype="int8"),
    "paged-prefix": dict(prefix_cache=True),
    "dense": dict(paged=False),
    "dense-whole": dict(paged=False, prefill_chunk=0),
}


def tier_case(name, case):
    """Four prompts over a pool that preempts, greedy and stochastic rows
    mixed: everything host-visible equals the reference after every
    tick."""
    kw = dict(TIER_CASES[case])
    ps = prompts_of(name, (30, 25, 21, 18), seed=9)
    sampling = None if "k" in kw else [None, dict(temperature=0.9,
                                                  seed=3), None, None]
    got = run_script(name, submit_all(ps, sampling, max_new=10),
                     max_batch=4, **kw)
    eng = got["engine"]
    assert eng.preemptions > 0
    c = eng.counts()
    assert c["swap_resumes"] + c["recompute_preemptions"] == eng.preemptions
    assert c["swap_out_bytes"] == c["swap_in_bytes"] == sum(
        t.swap_out_bytes for t in eng.tick_log)
    if kw.get("host_spill_pages", 0) > 1:
        assert c["swap_resumes"] == eng.preemptions > 0
    else:
        assert c["recompute_preemptions"] > 0
    assert c["host_resident_pages"] == 0
    return got


def prefix_case(name, case):
    """A cached 16-token head, three filler prompts that evict it, then a
    prompt that hits it again: demoted and promoted blocks (or, with a
    one-page tier, dropped ones) and the prefix stats equal the
    reference's."""
    kw = dict(PREFIX_CASES[case])
    h = prompts_of(name, (22, 19), seed=6, head=16)
    f = prompts_of(name, (30, 28, 26), seed=7)
    got = run_script(name, submit_all([h[0], *f, h[1]], max_new=8),
                     prefix_cache=True, **kw)
    st = got["engine"].prefix.stats()
    assert st == got["ref"].prefix.stats()
    if kw["host_spill_pages"] > 1:
        assert st["demoted_blocks"] > 0 and st["promoted_blocks"] > 0
        assert got["reqs"][-1].cached_tokens > 0
    else:
        assert st["promoted_blocks"] == 0 and st["evicted_blocks"] > 0
    return got


def disagg_case(name, case):
    """Disaggregated against the reference's disaggregated engine (every
    host decision) and against the port's colocated one: the same streams
    and tick logs but for the migration fields, and the migrated pages
    and bytes the reference's formula gives, summed over the requests;
    one migration batch per tick that had a handoff."""
    kw = dict(DISAGG_CASES[case])
    ps = prompts_of(name, (30, 25, 21, 18), seed=9,
                    head=16 if kw.get("prefix_cache") else 0)
    dis = run_script(name, submit_all(ps, max_new=6), max_batch=4,
                     n_pages=64, executor="disaggregated", **kw)
    a = build(name, max_batch=4, n_pages=64, **kw)[1]
    colo = a.generate(ps, SamplingParams(max_new_tokens=6))
    b = dis["engine"]
    assert [r.generated for r in dis["reqs"]] == [r.generated for r in colo]
    strip = lambda t: tick_record(t)[:6]          # noqa: E731
    assert [strip(t) for t in b.tick_log] == [strip(t) for t in a.tick_log]
    assert a.counts()["migrated_bytes"] == 0
    if b.paged:
        want_pages = sum(
            max(p.pages_of(r.prompt_len) - p.pages_of(r.cached_tokens), 0)
            for r in dis["reqs"] for p in b.pool.pools)
        want_bytes = sum(
            max(p.pages_of(r.prompt_len) - p.pages_of(r.cached_tokens), 0)
            * b.pool.page_bytes(i)
            for r in dis["reqs"] for i, p in enumerate(b.pool.pools))
    else:
        want_pages = 0
        want_bytes = sum(r.prompt_len * b._dense_token_bytes
                         + b._dense_state_bytes for r in dis["reqs"])
    c = b.counts()
    assert (c["migrated_pages"], c["migrated_bytes"]) == (want_pages,
                                                          want_bytes)
    assert b.executor.migration_batches == sum(
        t.migrated_bytes > 0 for t in b.tick_log)
    assert b.executor.stats()["prefill_devices"] == 1
    return dis
