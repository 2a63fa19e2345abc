"""Auto-parallel: greedy min-copy-cost sharding-signature selection.

The reference's auto-parallel story (SURVEY.md §2.7) is per-op greedy SBP
selection: every op enumerates its legal SBP signatures (`GetSbp`), and
`Operator::GreedilyFindMinCopyCostNdSbp` (oneflow/core/operator/
operator.cpp:713-812) picks the signature minimizing the boxing copy cost
from the producers' actual SBPs, using the transfer-cost model in
oneflow/core/framework/sbp_infer_util.{h,cpp}; missing direct transitions
are bridged through intermediate placements by the boxing collector
(oneflow/core/auto_parallel/boxing_collector.{h,cpp}).

JAX re-expression: signatures are the `ShardingRule`s each op
declares in the registry (ops/registry.py), atoms are the SBP strings of
parallel/global_view.py, and the cost model prices the XLA collective that
GSPMD/shard_map would insert for each transition on a mesh axis of size p
(per-device bytes moved, ring algorithms):

    S->B   all_gather       (p-1)/p * nbytes
    P->B   all_reduce     2*(p-1)/p * nbytes
    P->S   reduce_scatter   (p-1)/p * nbytes
    S->S'  all_to_all       (p-1)/p * nbytes / p
    B->S   local slice      0
    B->P   zero-all-but-one 0   (the reference's naive b->p boxing)

Transitions with no direct collective are composed through B — the same
middle-node fallback as the reference's boxing collector.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from of_spmm.ops.registry import OpDef, ShardingRule, lookup

Atom = str  # "S<k>", "B", "P"

_INF = math.inf


def _strip(atom: str) -> Atom:
    """Rule atoms may carry an arg prefix, e.g. "A:S0" -> "S0"."""
    return atom.split(":", 1)[1] if ":" in atom else atom


def _is_split(a: Atom) -> bool:
    return a.startswith("S")


def direct_cost(src: Atom, dst: Atom, nbytes: float, p: int) -> float:
    """Per-device bytes moved by the single collective for src->dst.

    Returns inf when no single collective realizes the transition
    (e.g. S->P), mirroring the reference's cost-table misses that the
    boxing collector must bridge (sbp_infer_util.cpp cost entries).
    """
    if p <= 1 or src == dst:
        return 0.0
    f = (p - 1) / p
    if src == "B":
        # slice (B->S) is local; B->P zeroes all but one shard locally
        return 0.0
    if src == "P":
        if dst == "B":
            return 2.0 * f * nbytes  # all_reduce
        if _is_split(dst):
            return f * nbytes        # reduce_scatter
        return _INF
    if _is_split(src):
        if dst == "B":
            return f * nbytes        # all_gather
        if _is_split(dst):
            return f * nbytes / p    # all_to_all on 1/p-size shards
        return _INF
    return _INF


def boxing_cost(src: Atom, dst: Atom, nbytes: float, p: int) -> float:
    """Min cost over the direct transition and the through-B bridge."""
    c = direct_cost(src, dst, nbytes, p)
    via_b = direct_cost(src, "B", nbytes, p) + direct_cost("B", dst, nbytes, p)
    return min(c, via_b)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A chosen signature for one op instance."""

    op: str
    rule: ShardingRule
    in_atoms: Tuple[Atom, ...]      # required input atoms (prefixes stripped)
    out_atoms: Tuple[Atom, ...]
    copy_cost: float                # bytes/device to box producers into place
    per_input: Tuple[float, ...]    # cost breakdown


def choose_signature(
    op: OpDef,
    producer_atoms: Sequence[Atom],
    input_nbytes: Sequence[float],
    p: int,
) -> Placement:
    """Greedy min-copy-cost signature for one op.

    The analog of GreedilyFindMinCopyCostNdSbp (operator.cpp:713-812):
    enumerate the op's declared signatures, price boxing every input from
    its producer's atom into the required atom, keep the cheapest; ties go
    to the earliest-declared rule (the reference's producer-priority
    ordering of candidate signatures).
    """
    if not op.sharding_rules:
        raise ValueError(f"op {op.name!r} declares no sharding rules")
    if len(producer_atoms) and len(op.sharding_rules[0].ins) != len(producer_atoms):
        raise ValueError(
            f"op {op.name!r} rules take {len(op.sharding_rules[0].ins)} "
            f"inputs, got {len(producer_atoms)} producer atoms")
    best: Optional[Placement] = None
    for rule in op.sharding_rules:
        req = tuple(_strip(a) for a in rule.ins)
        per = tuple(
            boxing_cost(src, dst, nb, p)
            for src, dst, nb in zip(producer_atoms, req, input_nbytes)
        )
        total = sum(per)
        if best is None or total < best.copy_cost:
            best = Placement(
                op=op.name, rule=rule, in_atoms=req,
                out_atoms=tuple(_strip(a) for a in rule.outs),
                copy_cost=total, per_input=per,
            )
    assert best is not None
    return best


@dataclasses.dataclass(frozen=True)
class ChainStep:
    """One op in a linear pipeline: out of step i feeds input 0 of i+1.

    ``extra_atoms``/``extra_nbytes`` describe the op's remaining inputs
    (weights, indices, ...), whose producer placements are fixed.
    """

    op: str
    extra_atoms: Tuple[Atom, ...] = ()
    extra_nbytes: Tuple[float, ...] = ()
    out_nbytes: float = 0.0


def plan_chain(
    steps: Sequence[ChainStep],
    first_atom: Atom,
    first_nbytes: float,
    p: int,
) -> Tuple[List[Placement], float]:
    """Greedy per-op propagation through a linear chain of registered ops.

    Matches the reference's topological-order greedy inference: each op
    sees only its producers' already-fixed placements (no global search —
    SURVEY.md §2.7 notes the snapshot has no ILP/DP planner either).
    Returns the placements and the total copy cost (bytes/device).
    """
    placements: List[Placement] = []
    cur_atom, cur_bytes = first_atom, first_nbytes
    total = 0.0
    for step in steps:
        op = lookup(step.op)
        atoms = (cur_atom,) + tuple(step.extra_atoms)
        nbytes = (cur_bytes,) + tuple(step.extra_nbytes)
        pl = choose_signature(op, atoms, nbytes, p)
        placements.append(pl)
        total += pl.copy_cost
        cur_atom = pl.out_atoms[0]
        cur_bytes = step.out_nbytes or cur_bytes
    return placements, total
