"""The checks shared by ``test_torch_dense_engine*.py``: the port's
ServingEngine on the dense arena (``paged=False``) against the JAX
package's on the CPU, on a reduced model in f32 with the reference's own
weights, max_batch 4, max_len 3136, prompts of 3072, 29, 7 and 22 tokens
(the first above the 2048-token dense threshold of whole-prompt
attention), six new tokens each.

Modes: ``whole`` (``prefill_chunk=0``: every prompt prefills whole, the
first through the flash-attention path), ``packed`` (the default packed
chunks of 2048 tokens), and ``whole+w8`` (whole-prompt with int8 weights).

The tick logs, the compile accounting (``compile_count`` and every tick's
``new_compiles``) and the KV byte accounting must be equal, and the greedy
streams equal up to the first position, per request, where the
reference's own top-2 logit margin is at most 1e-3 (``MARGIN``; see
``torch_quantized_parity.py``, whose margin recorder this reuses).  Each
check asserts how many positions it compared.

``check_idle_slots_untouched``: the dense decode tick runs every one of the
max_batch rows, but only the active slots write K/V — the arena rows of
idle slots (never used, or retired with stale K/V) stay bit-identical, and
their stale contents do not reach any stream."""

import dataclasses

import jax
import numpy as np
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models.transformer import init_params as jax_init_params
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.scheduler import PhaseAwareConfig as JaxPhaseAwareConfig
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import ServeConfig, ServingEngine
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import PhaseAwareConfig
from torch_quantized_parity import MARGIN, _record_margins

PROMPT_LENS = (3072, 29, 7, 22)
MAX_NEW = 6
MAX_LEN = 3136
MODES = {"whole": (0, "f32"), "packed": (2048, "f32"),
         "whole+w8": (0, "int8")}


def _prompts(cfg):
    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in PROMPT_LENS]


def _run(engine, prompts):
    for p in prompts:
        engine.submit(p, max_new_tokens=MAX_NEW)
    done = engine.run_until_drained(max_ticks=400)
    assert len(done) == len(prompts)
    log = [(t.prefill_reqs, t.decode_reqs, t.prefill_tokens, t.preemptions,
            t.new_compiles) for t in engine.tick_log]
    return log, {r.req_id: [int(t) for t in r.generated] for r in done}


def _count_flash(monkeypatch, calls):
    flash = ops.flash_attention

    def counted(*a, **k):
        calls.append(a[0].shape[2])
        return flash(*a, **k)

    monkeypatch.setattr(ops, "flash_attention", counted)


def check_dense_engine(name, mode, monkeypatch):
    chunk, weights = MODES[mode]
    jcfg = dataclasses.replace(jax_get_config(name).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    prompts = _prompts(cfg)
    kw = dict(max_batch=4, max_len=MAX_LEN, paged=False,
              weights_dtype=weights)
    ref = JaxServingEngine(jcfg, jp, JaxServeConfig(
        phase=JaxPhaseAwareConfig(prefill_chunk=chunk), **kw))
    margins = _record_margins(ref)
    ours = ServingEngine(cfg, tp, ServeConfig(
        phase=PhaseAwareConfig(prefill_chunk=chunk), **kw), device="cpu")
    want_log, want = _run(ref, prompts)
    flash = []
    _count_flash(monkeypatch, flash)
    got_log, got = _run(ours, prompts)
    # whole prompts above the threshold take the flash-attention route,
    # once per layer; packed chunks never do
    assert flash == ([3072] * cfg.n_layers if chunk == 0 else [])
    assert got_log == want_log
    assert ours.compile_count == ref.compile_count
    assert ours.kv_bytes() == ref.kv_bytes()
    assert ours.prefill_tokens_executed == ref.prefill_tokens_executed
    assert ours.prefill_rows_executed == ref.prefill_rows_executed
    assert got.keys() == want.keys()
    compared = 0
    for rid, stream in want.items():
        assert len(margins[rid]) == len(stream) == len(got[rid]) == MAX_NEW
        for j, (a, b) in enumerate(zip(got[rid], stream)):
            if a != b:
                assert margins[rid][j] <= MARGIN, (
                    f"request {rid} differs at token {j} where the "
                    f"reference's margin is {margins[rid][j]}")
                break
            compared += 1
    assert compared >= len(PROMPT_LENS) * MAX_NEW // 2, compared


def check_idle_slots_untouched(name, chunk):
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (40, 23)]

    def engine():
        return ServingEngine(cfg, params, ServeConfig(
            max_batch=4, max_len=64,
            phase=PhaseAwareConfig(prefill_chunk=chunk)), device="cpu")

    clean = engine()
    want = [r.generated for r in clean.generate(
        prompts, [SamplingParams(max_new_tokens=n) for n in (2, 9)])]
    eng = engine()
    # slots 2 and 3 hold garbage no request ever wrote (as a retired
    # request's stale rows would)
    g = torch.Generator().manual_seed(0)
    for run in eng.cache:
        for leaf in run.values():
            leaf[:, 2:] = torch.randn(leaf[:, 2:].shape, generator=g) * 50
    idle = [{k: v[:, 2:].clone() for k, v in run.items()}
            for run in eng.cache]
    for p, max_new in zip(prompts, (2, 9)):
        eng.submit(p, max_new_tokens=max_new)
    retired = None
    while eng._live():
        eng.step()
        if retired is None and eng.slot_req[0] is None:
            # request 0 retired: its slot's rows are stale from now on
            retired = [{k: v[:, 0].clone() for k, v in run.items()}
                       for run in eng.cache]
            t_retired = eng.n_ticks
    # request 1 decoded on after request 0 left its slot
    assert retired is not None and eng.n_ticks > t_retired
    for run, snap, old in zip(eng.cache, idle, retired):
        for key in run:
            assert torch.equal(run[key][:, 2:], snap[key])
            assert torch.equal(run[key][:, 0], old[key])
    assert [r.generated for r in eng.done] == want

