"""The port's ServingEngine serving reduced mamba2-2.7b against the JAX
package's on the CPU, in f32 with the reference's own weights: the dense
arena with whole-prompt prefill (an SSM plan never chunks), max_batch 2,
prompts of 12, 32 and 64 tokens (one, one and two SSD chunks of 32), six
new tokens each — equal tick logs, compile accounting and byte
accounting, and greedy streams equal up to the first position, per
request, where the reference's own top-2 logit margin is at most 1e-3
(``torch_quantized_parity.MARGIN``).  Modes: the f32 weights, int8
weights (decode matmuls through the GEMV route), and
``packed_prefill=False`` with ``prefill_chunk=0``, which the reference
serves whole.  Also: an idle slot's conv window and state stay
bit-identical across decode ticks, both engines refuse a 40-token prompt
(not a multiple of the chunk) and the paged pool."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models.transformer import init_params as jax_init_params
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.scheduler import PhaseAwareConfig as JaxPhaseAwareConfig
from repro_torch.configs import get_config
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import ServeConfig, ServingEngine
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import PhaseAwareConfig
from torch_quantized_parity import MARGIN, _record_margins

NAME = "mamba2-2.7b"
PROMPT_LENS = (12, 32, 64)
MAX_NEW = 6
MODES = {"whole": dict(),
         "whole+w8": dict(weights_dtype="int8"),
         "unpacked": dict(packed_prefill=False, prefill_chunk=0)}


def _cfgs():
    jcfg = dataclasses.replace(jax_get_config(NAME).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(NAME).reduced(), dtype="float32")
    return jcfg, cfg


def _engines(kw, chunk=2048):
    jcfg, cfg = _cfgs()
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    ref = JaxServingEngine(jcfg, jp, JaxServeConfig(
        phase=JaxPhaseAwareConfig(prefill_chunk=chunk), **kw))
    ours = ServingEngine(cfg, tp, ServeConfig(
        phase=PhaseAwareConfig(prefill_chunk=chunk), **kw), device="cpu")
    return cfg, ref, ours


def _run(engine, prompts):
    for p in prompts:
        engine.submit(p, max_new_tokens=MAX_NEW)
    done = engine.run_until_drained(max_ticks=200)
    assert len(done) == len(prompts)
    log = [(t.prefill_reqs, t.decode_reqs, t.prefill_tokens, t.preemptions,
            t.new_compiles) for t in engine.tick_log]
    return log, {r.req_id: [int(t) for t in r.generated] for r in done}


@pytest.mark.parametrize("mode", list(MODES))
def test_ssm_engine_matches_reference(mode):
    kw = dict(MODES[mode])
    chunk = kw.pop("prefill_chunk", 2048)
    cfg, ref, ours = _engines(dict(max_batch=2, max_len=96, **kw), chunk)
    assert not ref.chunked and not ours.chunked
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    margins = _record_margins(ref)
    want_log, want = _run(ref, prompts)
    tl.reset_gemv_route_count()
    got_log, got = _run(ours, prompts)
    assert (tl.gemv_route_count() > 0) == ("w8" in mode)
    assert got_log == want_log
    assert ours.compile_count == ref.compile_count
    assert ours.kv_bytes() == ref.kv_bytes()
    assert (ours._dense_token_bytes, ours._dense_state_bytes) == (
        ref._dense_token_bytes, ref._dense_state_bytes)
    assert ours._dense_token_bytes == 0 < ours._dense_state_bytes
    assert ours.prefill_tokens_executed == ref.prefill_tokens_executed
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


def test_idle_slot_state_untouched():
    """The decode tick computes every max_batch row, but only the active
    slots take their new conv window and state: slot 2, never used, and
    slot 0 after its request retired keep theirs bit for bit, and a garbage
    state there reaches no stream.  The 2-token prompt's conv window is
    left-padded with zeros (T < d_conv - 1)."""
    _, cfg = _cfgs()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (32, 2)]
    sampling = [SamplingParams(max_new_tokens=n) for n in (2, 9)]

    def engine():
        return ServingEngine(cfg, params, ServeConfig(
            max_batch=3, max_len=64,
            phase=PhaseAwareConfig(prefill_chunk=0)), device="cpu")

    want = [r.generated for r in engine().generate(prompts, sampling)]
    eng = engine()
    g = torch.Generator().manual_seed(0)
    for run in eng.cache:
        for leaf in run.values():
            leaf[:, 2] = torch.randn(leaf[:, 2].shape, generator=g) * 50
    idle = [{k: v[:, 2].clone() for k, v in run.items()} for run in eng.cache]
    for p, sp in zip(prompts, sampling):
        eng.submit(p, sampling=sp)
    retired = None
    while eng._live():
        eng.step()
        if retired is None and eng.slot_req[0] is None:
            retired = [{k: v[:, 0].clone() for k, v in run.items()}
                       for run in eng.cache]
            t_retired = eng.n_ticks
    assert retired is not None and eng.n_ticks > t_retired
    for run, snap, old in zip(eng.cache, idle, retired):
        for key in run:
            assert torch.equal(run[key][:, 2], snap[key])
            assert torch.equal(run[key][:, 0], old[key])
    assert [r.generated for r in sorted(eng.done,
                                        key=lambda r: r.req_id)] == want


def test_both_refuse_a_prompt_off_the_chunk_grid():
    """A 40-token prompt at the reduced chunk of 32: the reference's
    ``ssd_chunked`` asserts T % chunk == 0 when it prefills; the port
    raises ValueError at the same point."""
    cfg, ref, ours = _engines(dict(max_batch=2, max_len=96))
    p = np.arange(40, dtype=np.int32) % cfg.vocab_size
    ref.submit(p, max_new_tokens=2)
    with pytest.raises(AssertionError):
        ref.run_until_drained()
    ours.submit(p, max_new_tokens=2)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ours.run_until_drained()


def test_both_refuse_the_paged_pool():
    jcfg, cfg = _cfgs()
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    with pytest.raises(ValueError, match="all-attention plan"):
        JaxServingEngine(jcfg, jp, JaxServeConfig(paged=True))
    with pytest.raises(ValueError, match="all-attention plan"):
        ServingEngine(cfg, tp, ServeConfig(paged=True), device="cpu")
