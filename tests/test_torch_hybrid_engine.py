"""The port's ServingEngine serving reduced zamba2-2.7b against the JAX
package's on the CPU, in f32 with the reference's own weights: the dense
arena with whole-prompt prefill (a hybrid plan never chunks or pages),
max_batch 2, prompts of 12, 32 and 64 tokens (one, one and two SSD chunks
of 32), six new tokens each — equal tick logs, compile accounting and
byte accounting (a shared run's [B, S, H, dh] K/V counted as per-slot
state, as the reference counts it), the disaggregated executor's handoff
bytes, and greedy streams equal up to the first position, per request,
where the reference's own top-2 logit margin is at most 1e-3
(``torch_quantized_parity.MARGIN``).  Modes: the f32 weights, int8
weights (decode matmuls, the shared block's included, through the GEMV
route), and ``packed_prefill=False`` with ``prefill_chunk=0``, which the
reference serves whole.  Also: both engines refuse a 40-token prompt (not
a multiple of the chunk) and the paged pool, the reference's
``test_engine_other_families[zamba2-2.7b]`` on both packages, and the
serving CLI on the CPU."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.base import get_config as jax_get_config
from repro.models.transformer import init_params as jax_init_params
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.scheduler import PhaseAwareConfig as JaxPhaseAwareConfig
from repro_torch.configs import get_config
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import ServeConfig, ServingEngine
from repro_torch.serving.scheduler import PhaseAwareConfig
from torch_quantized_parity import MARGIN, _record_margins

NAME = "zamba2-2.7b"
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
            t.new_compiles, t.migrated_pages, t.migrated_bytes)
           for t in engine.tick_log]
    return log, {r.req_id: [int(t) for t in r.generated] for r in done}


def _prompts(cfg):
    rng = np.random.default_rng(11)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in PROMPT_LENS]


def _compare_streams(got, want, margins):
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


@pytest.mark.parametrize("mode", list(MODES))
def test_hybrid_engine_matches_reference(mode):
    kw = dict(MODES[mode])
    chunk = kw.pop("prefill_chunk", 2048)
    cfg, ref, ours = _engines(dict(max_batch=2, max_len=96, **kw), chunk)
    assert not ref.chunked and not ours.chunked
    prompts = _prompts(cfg)
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
    # the reference prices a shared run's K/V [B, S, H, dh] by slot: its
    # seq axis is not axis 2, so a hybrid has no per-token bytes
    assert ours._dense_token_bytes == 0 < ours._dense_state_bytes
    assert ours.prefill_tokens_executed == ref.prefill_tokens_executed
    _compare_streams(got, want, margins)


def test_disaggregated_handoff_matches_reference():
    """``executor="disaggregated"``: every prompt's handoff moves its slot's
    whole state (SSM conv windows and states and both shared runs' K/V at
    the arena's length), the same bytes and batches as the reference's,
    tick by tick."""
    cfg, ref, ours = _engines(dict(max_batch=2, max_len=96,
                                   executor="disaggregated"), 0)
    prompts = _prompts(cfg)
    margins = _record_margins(ref)
    want_log, want = _run(ref, prompts)
    got_log, got = _run(ours, prompts)
    assert got_log == want_log
    c, w = ours.counts(), ref.counts()
    assert (c["migrated_pages"], c["migrated_bytes"]) == (
        w["migrated_pages"], w["migrated_bytes"])
    assert c["migrated_bytes"] == len(prompts) * ours._dense_state_bytes
    assert ours.executor.migration_batches == ref.executor.migration_batches
    _compare_streams(got, want, margins)


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


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_engine_other_families_zamba2(package):
    """The reference's ``test_engine_other_families[zamba2-2.7b]``
    (tests/test_serving.py:131): three 12-token prompts, 3 new tokens
    each, max_batch 2 over a 48-position arena — on either package."""
    jcfg, cfg = _cfgs()
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
               for _ in range(3)]
    if package == "jax":
        eng = JaxServingEngine(jcfg, jp, JaxServeConfig(max_batch=2,
                                                        max_len=48))
    else:
        eng = ServingEngine(cfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                                 "cpu"),
                            ServeConfig(max_batch=2, max_len=48),
                            device="cpu")
    for p in prompts:
        eng.submit(p, max_new_tokens=3)
    done = eng.run_until_drained()
    assert len(done) == 3
    assert all(len(r.generated) == 3 for r in done)


def test_serve_cli_zamba2_on_cpu(capsys):
    """zamba2 serves through the CLI on the dense arena with whole-prompt
    prefill (the plain versions here); the paged pool is refused with the
    reference's error."""
    from repro_torch.launch import serve
    argv = ["--arch", NAME, "--reduced", "--device", "cpu", "--requests",
            "2", "--prompt-len", "64", "--max-new", "4"]
    assert serve.main(argv + ["--no-paged", "--max-len", "96",
                              "--prefill-chunk", "0"]) == 0
    out = capsys.readouterr().out
    assert "requests=2 tokens=8" in out and "kv=dense[4x96]" in out
    assert "flash_attention=0" in out and "decode_attention=0" in out
    assert np.isfinite(float(out.split("TTFT p50=")[1].split("ms")[0]))
    with pytest.raises(ValueError, match="all-attention plan"):
        serve.main(argv + ["--paged"])
