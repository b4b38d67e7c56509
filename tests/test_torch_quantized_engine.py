"""The port's ServingEngine under int8 weights, int8 KV, packed int4 KV and
int8 weights with int4 KV against the JAX package's, on reduced llama2-7b:
equal tick logs, greedy streams equal up to the reference's first near-tie
(top-2 margin <= 1e-3), the GEMV route taken exactly when weights are int8
(``torch_quantized_parity.py`` has the check)."""

import pytest

from torch_quantized_parity import MODES, check_quantized_engine


@pytest.mark.parametrize("mode", list(MODES))
def test_quantized_engine_matches_reference(mode):
    check_quantized_engine("llama2-7b", mode)
