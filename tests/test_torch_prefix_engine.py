"""The port's ServingEngine with the prefix cache (ROADMAP A7a) and with
the padded ``packed_prefill=False`` prefill on the paged pool, against the
JAX package's on reduced llama2-7b in f32: equal tick logs, prefix stats,
pools after the drain and greedy streams (``torch_spec_parity.py`` has the
check; ``test_torch_prefix_engine_qwen3.py`` holds qwen3-8b)."""

import pytest

from torch_spec_parity import check_engine

NAME = "llama2-7b"


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_prefix_cache_matches_reference(kv_dtype):
    got = check_engine(NAME, prefix_cache=True, kv_dtype=kv_dtype)
    assert got["prefix"]["hit_rate"] > 0 and got["prefix"]["hit_tokens"] > 0
    assert got["prefix"]["cached_pages"] > 0


def test_padded_prefill_matches_reference():
    """``packed_prefill=False`` on the paged pool: the tick's chunks as one
    padded [N, C] batch through ``forward_chunk``."""
    got = check_engine(NAME, packed_prefill=False)
    assert got["prefix"]["hit_rate"] == 0
