"""The port's ServingEngine with n-gram speculative decoding (ROADMAP A7b),
alone and with the prefix cache, against the JAX package's on reduced
llama2-7b in f32: equal tick logs (drafted and accepted tokens per tick
included), spec and prefix stats, pools after the drain and greedy streams
(``torch_spec_parity.py`` has the check).  With the cache:
``test_torch_spec_cache_engine.py``; under pool pressure and eos:
``test_torch_spec_pressure.py``; qwen3-8b: ``test_torch_spec_engine_qwen3.py``.
Targets: tests/test_speculative.py:183-432."""

import pytest

from torch_spec_parity import assert_spec_ran, check_engine

NAME = "llama2-7b"


@pytest.mark.parametrize("k", [2, 4])
def test_spec_matches_reference(k):
    got = check_engine(NAME, k=k)
    assert_spec_ran(got)
    assert got["spec"]["accepted"] > 0
