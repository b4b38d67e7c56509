"""The port's ServingEngine with n-gram speculative decoding and the prefix
cache together (ROADMAP A7a + A7b), f32 and int8 KV, against the JAX
package's on reduced llama2-7b in f32 (``torch_spec_parity.py`` has the
check).  Target: tests/test_speculative.py:200-258."""

import pytest

from torch_spec_parity import assert_spec_ran, check_engine

NAME = "llama2-7b"


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_spec_with_prefix_cache_matches_reference(kv_dtype):
    got = check_engine(NAME, k=4, prefix_cache=True, kv_dtype=kv_dtype)
    assert_spec_ran(got)
    assert got["prefix"]["hit_rate"] > 0
