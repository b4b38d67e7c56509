"""The check shared by ``test_torch_quantized_engine*.py``: the port's
ServingEngine under quantized serving against the JAX package's on the
CPU, on a reduced model in f32 with the reference's own weights, under int8
weights (``w8``), int8 KV (``kv8``), packed int4 KV (``kv4``) or both
(``w8+kv4``); paged pool of 8-token pages, pack_align 8, prefill_chunk 8,
prompts of 13, 29, 7 and 22 tokens.

The tick logs must be equal.  The greedy streams must be equal up to the
first position, per request, where the reference's own top-2 logit margin
is at most 1e-3: there the two sides may round a near-tie apart (the
quantizers are discontinuous, so a 1e-7 difference in a projection can
move a code by one step), and what follows a flipped token is a different
continuation.  The reference's margins are recorded while it serves: each
phase program's logits leave the jitted program through a debug callback,
and the engine's single device-to-host transfer point hands each token on
with its row's margin.  Each test asserts how many positions it compared.
Under int8 weights the GEMV route must have been taken, and not without.
"""

import dataclasses

import jax
import numpy as np

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

PROMPT_LENS = (13, 29, 7, 22)
MAX_NEW = 6
MARGIN = 1e-3
MODES = {"w8": dict(weights_dtype="int8"), "kv8": dict(kv_dtype="int8"),
         "kv4": dict(kv_dtype="int4"),
         "w8+kv4": dict(weights_dtype="int8", kv_dtype="int4")}


class _Tok(int):
    """A sampled token that carries the top-2 margin of its logits row."""
    margin: float


def _record_margins(engine):
    """Make the JAX engine hand every sampled token on as a ``_Tok`` with
    its row's top-2 logit margin, and record per request the margin of
    every token it appends."""
    rows = []
    margins = {}
    sample, to_host, append = (engine._sample, engine._to_host,
                               engine._append_token)

    def keep(lg):
        rows.append(np.asarray(lg))

    def traced_sample(logits, *a):
        jax.debug.callback(keep, logits[:, -1])
        return sample(logits, *a)

    def host(arr):
        toks = to_host(arr)
        jax.effects_barrier()
        lg = rows[-1]
        rows.clear()
        top2 = np.sort(lg, axis=-1)[:, -2:]
        assert (np.argmax(lg, axis=-1) == toks).all()
        out = np.empty(toks.shape, object)
        for i, t in enumerate(toks.tolist()):
            out[i] = _Tok(t)
            out[i].margin = float(top2[i, 1] - top2[i, 0])
        return out

    def appended(req, tok):
        margins.setdefault(req.req_id, []).append(tok.margin)
        return append(req, tok)

    engine._sample, engine._to_host = traced_sample, host
    engine._append_token = appended
    return margins


def _run(engine, prompts):
    for p in prompts:
        engine.submit(p, max_new_tokens=MAX_NEW)
    done = engine.run_until_drained(max_ticks=400)
    assert len(done) == len(prompts)
    log = [(t.prefill_reqs, t.decode_reqs, t.prefill_tokens, t.preemptions)
           for t in engine.tick_log]
    return log, {r.req_id: [int(t) for t in r.generated] for r in done}


def check_quantized_engine(name, mode):
    jcfg = dataclasses.replace(jax_get_config(name).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    kw = dict(max_batch=4, page_size=8, n_pages=96, paged=True, max_len=128,
              **MODES[mode])
    ref = JaxServingEngine(jcfg, jp, JaxServeConfig(
        phase=JaxPhaseAwareConfig(prefill_chunk=8, pack_align=8), **kw))
    margins = _record_margins(ref)
    ours = ServingEngine(cfg, tp, ServeConfig(
        phase=PhaseAwareConfig(prefill_chunk=8, pack_align=8), **kw),
        device="cpu")
    want_log, want = _run(ref, prompts)
    tl.reset_gemv_route_count()
    got_log, got = _run(ours, prompts)
    assert (tl.gemv_route_count() > 0) == ("w8" in mode)
    assert got_log == want_log
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
    # every first token and most of the rest: a stream may stop at a
    # near-tie, but not all of them at once
    assert compared >= len(PROMPT_LENS) * MAX_NEW // 2, compared
