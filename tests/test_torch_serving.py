"""The port's host-side serving pieces against the JAX package's on the CPU:
the page pool's accounting and invariants, the scheduler's packing and tick
plans, the KV pool's device layout, greedy sampling (alone and as the greedy
rows of a mixed batch), the executor's compile counting, the options the
port still refuses, the combinations the reference refuses for good (with
its errors), and whole-prompt serving with ``packed_prefill=False``, which
the reference serves."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models.transformer import init_params as jax_init_params
from repro.serving import engine as jax_engine
from repro.serving import kv_pool as jax_kv_pool
from repro.serving import scheduler as jax_sched
from repro.serving import speculative as jax_spec
from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import init_params
from repro_torch.serving import kv_pool, sampling, scheduler
from repro_torch.serving.engine import ServeConfig, ServingEngine
from repro_torch.serving.executor import make_executor
from repro_torch.serving.speculative import SpecConfig


def _pool_state(p):
    return (p.table.tolist(), p.lens.tolist(), p.ref.tolist(),
            p.external.tolist(), list(p.free))


@pytest.mark.parametrize("seed", range(4))
def test_page_pool_matches_reference(seed):
    """A random interleaving of grow / shrink / release / attach / retain /
    release_ref / cow leaves both pools in the same state after every
    step, and the port's invariants hold throughout."""
    rng = np.random.default_rng(seed)
    n_pages, P, n_slots = 12, 4, 4
    cap = [n_pages * P, 10][seed % 2]            # position-indexed, or ring
    pools = [jax_kv_pool.PagePool(n_pages, P, n_slots, cap),
             kv_pool.PagePool(n_pages, P, n_slots, cap)]
    for _ in range(300):
        op = rng.choice(["grow", "shrink", "release", "attach", "retain",
                         "release_ref", "cow"])
        s = int(rng.integers(n_slots))
        cur = int(pools[0].lens[s])
        if op == "grow":
            args = (s, cur + int(rng.integers(0, 9)))
        elif op == "shrink":
            args = (s, int(rng.integers(0, cur + 1)))
        elif op == "release":
            args = (s,)
        elif op == "attach":
            donors = [d for d in range(n_slots)
                      if d != s and pools[0].lens[d] >= P]
            if cur or not donors:
                continue
            d = donors[int(rng.integers(len(donors)))]
            n = pools[0].pages_of(int(pools[0].lens[d]) // P * P)
            args = (s, [int(x) for x in pools[0].table[d, :n]], n * P)
        elif op in ("retain", "release_ref"):
            live = [p for p in range(n_pages) if pools[0].ref[p] > 0
                    and (op == "retain" or pools[0].external[p] > 0)]
            if not live:
                continue
            args = (live[int(rng.integers(len(live)))],)
        else:
            rows = [r for r in range(pools[0].width)
                    if pools[0].table[s, r] < n_pages]
            if not rows or not pools[0].free:
                continue
            args = (s, rows[int(rng.integers(len(rows)))])
        results = [getattr(p, op)(*args) for p in pools]
        assert results[0] == results[1], (op, args)
        assert _pool_state(pools[0]) == _pool_state(pools[1]), (op, args)
        pools[1].check_invariants()


def test_pack_chunks_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        chunks = [(i, int(t)) for i, t in
                  enumerate(rng.integers(0, 300, rng.integers(1, 6)))]
        align = int(2 ** rng.integers(0, 8))
        assert (dataclasses.asdict(scheduler.pack_chunks(chunks, align=align))
                == dataclasses.asdict(jax_sched.pack_chunks(chunks,
                                                            align=align)))
    for n in range(0, 3000, 7):
        assert scheduler.bucket_tokens(n, 8) == jax_sched.bucket_tokens(n, 8)
        assert scheduler.bucket_pow2(n, 64) == jax_sched.bucket_pow2(n, 64)


@pytest.mark.parametrize("strategy", ["halo", "cent", "attacc"])
def test_plan_tick_matches_reference(strategy):
    """The same waiting/decoding sets and pool headroom give the same plan
    (chunks, groups, packing) in both schedulers."""
    rng = np.random.default_rng(["halo", "cent", "attacc"].index(strategy))
    kw = dict(strategy=strategy, max_decode_batch=4, prefill_chunk=16,
              max_prefill_tokens=40, pack_align=8)
    ours = scheduler.PhaseScheduler(scheduler.PhaseAwareConfig(**kw))
    ref = jax_sched.PhaseScheduler(jax_sched.PhaseAwareConfig(**kw))
    for _ in range(200):
        n_wait = int(rng.integers(0, 5))
        waiting = [(i, int(rng.integers(1, 60)), True,
                    int(rng.integers(0, 30))) for i in range(n_wait)]
        decoding = [10 + i for i in range(int(rng.integers(0, 5)))]
        tkw = dict(free_pages=int(rng.integers(0, 20)), page_size=8,
                   capacity=256)
        a = ours.plan_tick(waiting, decoding, **tkw)
        b = ref.plan_tick(waiting, decoding, **tkw)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_kv_pool_layout():
    """Zero-initialized [L, n_pages, P, Hkv, D] pools per run, and block
    tables whose unused rows are all-sentinel."""
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(),
                              dtype="float32")
    pool = kv_pool.KVPool(cfg, n_slots=3, n_pages=10, page_size=4,
                          device="cpu")
    (c,) = pool.caches
    shape = (cfg.n_layers, 10, 4, cfg.n_kv_heads, cfg.d_head)
    assert tuple(c["k"].shape) == shape and tuple(c["v"].shape) == shape
    assert not c["k"].any() and not c["v"].any()
    assert pool.grow(1, 9)
    (bt,) = pool.block_tables(rows=[1], n=2)
    assert bt.dtype == torch.int32 and tuple(bt.shape) == (2, 10)
    assert (bt[0, :3] < 10).all() and (bt[0, 3:] == 10).all()
    assert (bt[1] == 10).all()
    # quantized pools: int8 pages, or uint8 nibble pairs at half the head
    # width, each beside zero f32 scale pages [L, n_pages, P, Hkv]
    for kv_dtype, dtype, width in (("int8", torch.int8, cfg.d_head),
                                   ("int4", torch.uint8, cfg.d_head // 2)):
        (q,) = kv_pool.KVPool(cfg, n_slots=3, n_pages=10, page_size=4,
                              kv_dtype=kv_dtype, device="cpu").caches
        assert set(q) == {"k", "v", "k_scale", "v_scale"}
        for name in ("k", "v"):
            assert q[name].dtype == dtype and not q[name].any()
            assert tuple(q[name].shape) == shape[:-1] + (width,)
            assert q[f"{name}_scale"].dtype == torch.float32
            assert tuple(q[f"{name}_scale"].shape) == shape[:-1]


def test_greedy_sampling_takes_the_first_maximum():
    """argmax takes the first maximum, and a greedy row of a mixed batch
    (``sample_tokens_rows``) is that argmax whatever its neighbours draw."""
    logits = torch.tensor([[[0.0, 3.0, 3.0, 1.0]], [[5.0, 5.0, 0.0, 5.0]]])
    assert sampling.sample_greedy(logits).tolist() == [1, 0]
    mixed = torch.cat([logits, logits])[:, -1]            # rows 0, 1 greedy
    keys = sampling.row_keys(torch.tensor([1, 2, 3, 4]),
                             torch.tensor([0, 5, 7, 9]))
    got = sampling.sample_tokens_rows(
        mixed, torch.tensor([0.0, 0.0, 0.7, 1.3]),
        torch.tensor([0, 0, 2, 0]), torch.tensor([0.0, 0.0, 0.0, 0.9]), keys)
    assert got.dtype == torch.int32
    assert got[:2].tolist() == sampling.sample_greedy(logits).tolist()


def test_executor_counts_first_seen_shapes():
    ex = make_executor("colocated", {"decode_paged": len, "packed_paged": len})
    for shape in [(4,), (4,), (2,), (4,)]:
        ex.begin_tick()
        ex.note_compile("decode", "decode_paged", shape, True)
    assert ex.compile_count == 2 and ex.tick_new_compiles == 0
    assert ex.program("decode", "decode_paged") is len
    with pytest.raises(NotImplementedError):
        ex.program("prefill", "chunk")
    dis = make_executor("disaggregated", {"decode_paged": len},
                        device="cpu")
    assert dis.migrates_kv and dis.program("decode", "decode_paged") is len
    with pytest.raises(ValueError, match="expected 'colocated' or"):
        make_executor("pipelined", {})


def _tiny():
    cfg = dataclasses.replace(get_config("llama2-7b").reduced(),
                              dtype="float32")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


_MODEL_DRAFTER = SpecConfig(k=2, drafter="model", draft_arch="llama2-7b")


@pytest.mark.parametrize("option,item", [
    (dict(paged=False, packed_prefill=False), "item 11"),
    (dict(paged=True, speculative=_MODEL_DRAFTER), "item 7c"),
    (dict(paged=True, prefix_cache=True, host_spill_pages=4,
          admission=scheduler.AdmissionConfig(),
          speculative=_MODEL_DRAFTER), "item 7c"),
    (dict(paged=True, speculative=_MODEL_DRAFTER, greedy=False,
          temperature=0.7), "item 7c"),
    (dict(paged=True, host_spill_pages=4, speculative=_MODEL_DRAFTER),
     "item 7c"),
    (dict(paged=False, packed_prefill=False,
          admission=scheduler.AdmissionConfig()), "item 11"),
    (dict(paged=True, greedy=False, temperature=0.7,
          admission=scheduler.AdmissionConfig(tick_cost_s=0.01),
          speculative=_MODEL_DRAFTER), "item 7c"),
    (dict(paged=False, packed_prefill=False, executor="disaggregated",
          admission=scheduler.AdmissionConfig(max_pending_tokens=64)),
     "item 11")],
    ids=[f"option{i}" for i in range(8)])
def test_unported_options_raise(option, item):
    """What the port still refuses — the dense arena's padded prefill and
    the draft-model drafter — raises naming its ROADMAP item, whatever
    served option (admission control among them) comes with it."""
    cfg, params = _tiny()
    with pytest.raises(NotImplementedError, match=item):
        ServingEngine(cfg, params, ServeConfig(**option), device="cpu")


def test_engine_refuses_stochastic_requests():
    """A negative temperature raises the reference's ValueError; a
    stochastic request is served, its draws reproducible."""
    cfg, params = _tiny()
    with pytest.raises(ValueError, match="temperature must be >= 0"):
        sampling.SamplingParams(temperature=-1.0)
    streams = []
    for _ in range(2):
        eng = ServingEngine(cfg, params, ServeConfig(paged=True),
                            device="cpu")
        req = eng.submit(np.arange(5, dtype=np.int32),
                         sampling=sampling.SamplingParams(
                             temperature=1.0, seed=3, max_new_tokens=6))
        eng.run_until_drained()
        assert req.finish_reason == "length" and len(req.generated) == 6
        streams.append(list(req.generated))
    assert streams[0] == streams[1]


def test_entry_points_never_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    cfg, params = _tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params, ServeConfig(paged=True))
    assert resolve_device("cpu") == torch.device("cpu")


def _both_tiny():
    jcfg = dataclasses.replace(jax_get_config("llama2-7b").reduced(),
                               dtype="float32")
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(get_config("llama2-7b").reduced(),
                              dtype="float32")
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("option", [
    dict(paged=True, host_spill_pages=-1),
    dict(paged=False, host_spill_pages=-1),
    dict(paged=False, prefix_cache=True),
    dict(paged=False, host_spill_pages=4),
    dict(paged=False, speculative="k=2"),
    dict(paged=False, kv_dtype="int8"),
])
def test_refused_for_good_as_the_reference(option):
    """Negative host spill pages, and the dense arena with a prefix cache,
    a host spill tier, speculation or a quantized KV cache: the reference
    refuses each with a ValueError whatever else is set, and the port
    raises the same error, before it looks for unported options."""
    jcfg, jp, cfg, tp = _both_tiny()
    kw = dict(option)
    if "speculative" in kw:
        jkw = dict(kw, speculative=jax_spec.SpecConfig(k=2))
        kw["speculative"] = SpecConfig(k=2)
    else:
        jkw = kw
    with pytest.raises(ValueError) as want:
        jax_engine.ServingEngine(jcfg, jp, jax_engine.ServeConfig(**jkw))
    with pytest.raises(ValueError) as got:
        ServingEngine(cfg, tp, ServeConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)


def test_whole_prompt_serves_with_packed_prefill_off():
    """``packed_prefill=False`` on the dense arena with ``prefill_chunk=0``:
    the reference reads the flag only for chunked prefill and serves every
    prompt whole; so does the port, with the reference's tick log and
    greedy streams (up to the reference's first near-tie)."""
    from torch_quantized_parity import MARGIN, _record_margins

    jcfg, jp, cfg, tp = _both_tiny()
    kw = dict(paged=False, packed_prefill=False, max_batch=2, max_len=64)
    ref = jax_engine.ServingEngine(jcfg, jp, jax_engine.ServeConfig(
        phase=jax_sched.PhaseAwareConfig(prefill_chunk=0), **kw))
    ours = ServingEngine(cfg, tp, ServeConfig(
        phase=scheduler.PhaseAwareConfig(prefill_chunk=0), **kw),
        device="cpu")
    margins = _record_margins(ref)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (13, 29, 7)]
    runs = []
    for eng in (ref, ours):
        reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
        eng.run_until_drained(max_ticks=100)
        runs.append(([(t.prefill_reqs, t.decode_reqs, t.prefill_tokens)
                      for t in eng.tick_log],
                     [[int(t) for t in r.generated] for r in reqs]))
    (want_log, want), (got_log, got) = runs
    assert got_log == want_log and not ours.chunked
    compared = 0
    for rid, (a, b) in enumerate(zip(got, want)):
        assert len(a) == len(b) == 5
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), 5)
        compared += j
        if j < 5:
            assert margins[rid][j] <= MARGIN, (rid, j, margins[rid][j])
    assert compared >= 8, compared
