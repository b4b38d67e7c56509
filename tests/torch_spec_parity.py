"""The engine check shared by ``test_torch_prefix_cache.py`` and
``test_torch_spec_engine*.py``: the port's ServingEngine against the JAX
package's on the CPU, on a reduced model in f32 with the reference's own
weights (through ``params_from_jax``), with the prefix cache, n-gram
speculative decoding and the padded ``packed_prefill=False`` prefill on the
paged pool, alone or together.

Traffic: a 16-token shared head alone and with tails of 6, 13 and 3
tokens (the system-prompt pattern), max_batch 2, pages of 8 tokens,
prefill_chunk 8 and 16 prefill tokens a tick — so later requests attach
the prefix the first ones published — and 24 new tokens each, enough for
the n-gram drafter to find loops in the reduced models' greedy streams.

Everything the host decides must be equal: the tick logs (prefill and
decode request lists, prefill tokens, preemptions, drafted and accepted
tokens per tick), ``prefix_stats()``, ``spec_stats()``, the compile and
host-transfer counts, and every run's page pool after the drain (block
tables, lengths, refcounts, cache pins, free list).  So must the greedy
streams: the weight seed (0) and prompt seed (3) give streams whose every
step is decisive on both sides, as in ``test_torch_engine.py``.
"""

import dataclasses

import jax
import numpy as np

from repro.configs.base import get_config as jax_get_config
from repro.models.transformer import init_params as jax_init_params
from repro.serving.engine import ServeConfig as JaxServeConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.scheduler import PhaseAwareConfig as JaxPhaseAwareConfig
from repro.serving.speculative import SpecConfig as JaxSpecConfig
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import ServeConfig, ServingEngine
from repro_torch.serving.scheduler import PhaseAwareConfig
from repro_torch.serving.speculative import SpecConfig

MAX_NEW = 24
_MODELS = {}


def models(name):
    """(jax cfg, jax params, port cfg, port params) of reduced ``name`` in
    f32, the port's weights converted from the reference's."""
    if name not in _MODELS:
        jcfg = dataclasses.replace(jax_get_config(name).reduced(),
                                   dtype="float32")
        cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
        jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
        _MODELS[name] = (jcfg, jp, cfg,
                         params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    return _MODELS[name]


def shared_prefix_prompts(vocab, seed=3):
    """The 16-token head alone, then with tails of 6, 13 and 3 tokens."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, 16).astype(np.int32)
    return [head.copy()] + [
        np.concatenate([head, rng.integers(0, vocab, n).astype(np.int32)])
        for n in (6, 13, 3)]


def _drain(engine, prompts, max_new, eos_id=None):
    reqs = [engine.submit(p.copy(), max_new_tokens=max_new, eos_id=eos_id)
            for p in prompts]
    engine.run_until_drained(max_ticks=600)
    for p in engine.pool.pools:
        p.check_invariants()
    return dict(
        log=[(t.prefill_reqs, t.decode_reqs, t.prefill_tokens, t.preemptions,
              t.spec_drafted, t.spec_accepted) for t in engine.tick_log],
        streams=[[int(t) for t in r.generated] for r in reqs],
        reasons=[r.finish_reason for r in reqs],
        prefix=engine.prefix_stats(), spec=engine.spec_stats(),
        pools=[(p.table.tolist(), p.lens.tolist(), p.ref.tolist(),
                p.external.tolist(), list(p.free))
               for p in engine.pool.pools],
        compiles=engine.compile_count, transfers=engine.host_transfers,
        preemptions=engine.preemptions)


def check_engine(name, *, k=None, n_pages=40, max_batch=2, prompts=None,
                 max_new=MAX_NEW, eos_id=None, **kw):
    """Serve ``prompts`` (default ``shared_prefix_prompts``) on the
    reference and the port with ``speculative=SpecConfig(k=k)`` when ``k``
    is given and the other ``ServeConfig`` fields ``kw``; assert every
    host-visible result equal and return the port's."""
    jcfg, jp, cfg, tp = models(name)
    if prompts is None:
        prompts = shared_prefix_prompts(cfg.vocab_size)
    common = dict(max_batch=max_batch, max_len=96, paged=True, page_size=8,
                  n_pages=n_pages, **kw)
    phase = dict(max_decode_batch=max_batch, prefill_chunk=8,
                 max_prefill_tokens=16, pack_align=8)
    ref = JaxServingEngine(jcfg, jp, JaxServeConfig(
        phase=JaxPhaseAwareConfig(**phase),
        speculative=JaxSpecConfig(k=k) if k else None, **common))
    ours = ServingEngine(cfg, tp, ServeConfig(
        phase=PhaseAwareConfig(**phase),
        speculative=SpecConfig(k=k) if k else None, **common), device="cpu")
    want = _drain(ref, prompts, max_new, eos_id)
    got = _drain(ours, prompts, max_new, eos_id)
    for key in want:
        assert got[key] == want[key], key
    return got


def assert_spec_ran(got):
    """Speculation ran and its counts are consistent: verify windows with
    drafts, no more accepted than drafted, at least one token a tick."""
    ss = got["spec"]
    assert ss["windows"] > 0 and ss["drafted"] > 0
    assert 0 <= ss["accepted"] <= ss["drafted"]
    assert ss["tokens_per_tick"] >= 1.0
