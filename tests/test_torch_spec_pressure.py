"""The port's ServingEngine with n-gram speculative decoding against the
JAX package's on reduced llama2-7b in f32, under pool pressure
(preemption and resume) and with an eos inside a verify window
(``torch_spec_parity.py`` has the check).  Targets:
tests/test_speculative.py:274-297 and :414-430."""

import numpy as np

from torch_spec_parity import check_engine, models

NAME = "llama2-7b"


def test_spec_under_preemption_matches_reference():
    """A pool of 6 pages for three 14-token prompts and 12 new tokens each
    (the reference's pressure case): speculation backs off, requests are
    preempted and resumed, and every decision matches."""
    _, _, cfg, _ = models(NAME)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, 14).astype(np.int32)
               for _ in range(3)]
    got = check_engine(NAME, k=3, n_pages=6, max_batch=3, prompts=prompts,
                       max_new=12)
    assert got["preemptions"] > 0


def test_spec_eos_clips_inside_a_window():
    """An eos emitted inside a verify window ends the stream there, as in
    the reference."""
    _, _, cfg, _ = models(NAME)
    prompts = [np.arange(10, dtype=np.int32) % 7]
    probe = check_engine(NAME, k=4, prompts=prompts, max_new=20)
    eos = probe["streams"][0][9]
    got = check_engine(NAME, k=4, prompts=prompts, max_new=20, eos_id=eos)
    stream = got["streams"][0]
    assert stream[-1] == eos and len(stream) <= 10
    assert got["reasons"] == ["eos"]
