"""``test_torch_tier_engine.py``'s engine cases on reduced qwen3-8b in f32:
a swap, a recompute, a demote/promote round, and paged and dense
disaggregation (one file per model spreads the cost over the workers)."""

import pytest

from torch_tier_parity import disagg_case, prefix_case, tier_case

NAME = "qwen3-8b"


@pytest.mark.parametrize("case", ["swap", "recompute"])
def test_swap_and_recompute_match_the_reference(case):
    tier_case(NAME, case)


@pytest.mark.parametrize("case", ["demote-promote"])
def test_demote_and_promote_match_the_reference(case):
    prefix_case(NAME, case)


@pytest.mark.parametrize("case", ["paged", "dense"])
def test_disaggregated_matches_colocated_and_the_reference(case):
    disagg_case(NAME, case)
