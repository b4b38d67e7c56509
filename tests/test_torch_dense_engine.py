"""The port's ServingEngine on the dense arena against the JAX package's, on
reduced llama2-7b: whole-prompt prefill (one prompt above the 2048-token
threshold), the default packed chunks, and whole-prompt with int8 weights —
equal tick logs and compile accounting, greedy streams equal up to the
reference's first near-tie — and the arena rows of idle slots untouched by
decode (``torch_dense_parity.py`` has the checks)."""

import pytest

from torch_dense_parity import (MODES, check_dense_engine,
                                check_idle_slots_untouched)


@pytest.mark.parametrize("mode", list(MODES))
def test_dense_engine_matches_reference(mode, monkeypatch):
    check_dense_engine("llama2-7b", mode, monkeypatch)


@pytest.mark.parametrize("chunk", [0, 2048])
def test_idle_slots_untouched(chunk):
    check_idle_slots_untouched("llama2-7b", chunk)
