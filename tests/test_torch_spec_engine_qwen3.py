"""The port's ServingEngine with n-gram speculative decoding (ROADMAP A7b)
against the JAX package's on reduced qwen3-8b in f32: alone, with the
prefix cache, and with both and the padded ``packed_prefill=False``
prefill (``torch_spec_parity.py`` has the check;
``test_torch_spec_engine.py`` holds llama2-7b)."""

import pytest

from torch_spec_parity import assert_spec_ran, check_engine

NAME = "qwen3-8b"


@pytest.mark.parametrize("options", [
    dict(),
    dict(prefix_cache=True),
    dict(prefix_cache=True, packed_prefill=False),
    dict(prefix_cache=True, kv_dtype="int8"),
], ids=["spec", "spec+cache", "spec+cache+padded", "spec+cache+kv8"])
def test_spec_matches_reference(options):
    got = check_engine(NAME, k=4, **options)
    assert_spec_ran(got)
    if options.get("prefix_cache"):
        assert got["prefix"]["hit_rate"] > 0
