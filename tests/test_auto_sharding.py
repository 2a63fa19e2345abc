"""Greedy min-copy-cost signature selection (auto-parallel analog)."""

import math

import pytest

from of_spmm.ops.registry import lookup
from of_spmm.parallel.auto_sharding import (
    ChainStep,
    boxing_cost,
    choose_signature,
    direct_cost,
    plan_chain,
)


def test_cost_model_collectives():
    nb, p = 1000.0, 4
    f = (p - 1) / p
    assert direct_cost("S0", "B", nb, p) == f * nb            # all_gather
    assert direct_cost("P", "B", nb, p) == 2 * f * nb         # all_reduce
    assert direct_cost("P", "S0", nb, p) == f * nb            # reduce_scatter
    assert direct_cost("S0", "S1", nb, p) == f * nb / p       # all_to_all
    assert direct_cost("B", "S0", nb, p) == 0.0               # local slice
    assert direct_cost("B", "P", nb, p) == 0.0                # zero-fill
    assert direct_cost("S0", "S0", nb, p) == 0.0
    assert math.isinf(direct_cost("S0", "P", nb, p))
    # single device: everything free
    assert direct_cost("P", "B", nb, 1) == 0.0


def test_bridge_through_broadcast():
    nb, p = 1000.0, 4
    # S->P has no direct collective; bridge = all_gather then local zeroing
    assert boxing_cost("S0", "P", nb, p) == (p - 1) / p * nb
    # direct beats the bridge when it exists
    assert boxing_cost("S0", "S1", nb, p) == (p - 1) / p * nb / p


def test_greedy_picks_zero_cost_signature():
    # gather with params B, indices S0: rule ("B","S0")->("S0",) is free
    op = lookup("gather")
    pl = choose_signature(op, ("B", "S0"), (1e6, 1e3), p=8)
    assert pl.copy_cost == 0.0
    assert pl.in_atoms == ("B", "S0")
    assert pl.out_atoms == ("S0",)


def test_greedy_prefers_cheap_boxing_over_expensive():
    op = lookup("spmm")
    f = 7 / 8
    # Big A (4e7 B), small partial X: re-splitting A S0->S1 would cost an
    # f*|A|/p all_to_all (4.4e6) — dearer than allreducing X P->B (1.75e6),
    # so greedy keeps the row-split rule and boxes X.
    pl = choose_signature(op, ("S0", "P"), (4e7, 1e6), p=8)
    assert pl.rule.ins[0] == "A:S0"
    assert pl.copy_cost == pytest.approx(2 * f * 1e6)
    # Small A, big partial X: now the col-split rule wins — X takes the
    # cheaper P->S0 reduce_scatter and A pays a tiny all_to_all.
    pl2 = choose_signature(op, ("S0", "P"), (1e5, 8e6), p=8)
    assert pl2.rule.ins[0] == "A:S1"
    assert pl2.copy_cost == pytest.approx(f * 1e5 / 8 + f * 8e6)


def test_plan_chain_propagates_outputs():
    # gather (params B, ids S0) -> out S0; feed as data into segment_sum
    # with ids S0: rule ("S0","S0")->P matches free of charge.
    steps = [
        ChainStep("gather", extra_atoms=("S0",), extra_nbytes=(1e3,),
                  out_nbytes=2e6),
        ChainStep("segment_sum", extra_atoms=("S0",), extra_nbytes=(1e3,),
                  out_nbytes=2e6),
    ]
    # chain's first input is gather's params (B); indices are the extra.
    placements, total = plan_chain(steps, "B", 1e6, p=8)
    assert [p.op for p in placements] == ["gather", "segment_sum"]
    assert placements[0].out_atoms == ("S0",)
    assert placements[1].in_atoms == ("S0", "S0")
    assert placements[1].out_atoms == ("P",)
    assert total == 0.0


def test_chain_arity_mismatch_raises():
    with pytest.raises(ValueError):
        choose_signature(lookup("gather"), ("B",), (1.0,), p=4)
