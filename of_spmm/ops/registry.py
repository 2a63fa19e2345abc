"""Op registry: named ops with {impls, oracle, sharding rules}.

The collapse of the reference's three registries — OpRegistry
(oneflow/core/framework/user_op_registry.h:62-89), OpKernelRegistry
(user_op_kernel_registry.h:60-104) and the per-op GetSbp hook — into one
Python-level table. Each entry carries:

- ``impls``: implementation variants keyed by name ("xla", "pallas", ...),
  the analog of kernels registered per device with a matched predicate;
- ``oracle``: the pure-XLA reference implementation the impls are tested
  against (tolerance rtol=1e-4 / atol=1e-5, adopted from the reference's
  check_equality defaults);
- ``auto``: which impl ``impl="auto"`` takes on each platform — the one
  backend decision of the package (``resolve_impl``), set from
  measurements on the card;
- ``sharding_rules``: declarative signatures equivalent to the reference's
  SBP enumerations (e.g. gather_op.cpp:51-82) expressed in mesh terms:
  S(axis) = split, B = replicated/broadcast, P = partial-sum. The parallel
  layer consults these when placing ops on a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax


def platform() -> str:
    """Platform of the default JAX backend ("gpu" or "cpu")."""
    return jax.devices()[0].platform


def pallas_interpret() -> bool:
    """Whether a Pallas kernel runs interpreted.

    Only with OFS_FORCE_PALLAS_INTERPRET (the CPU tests set it). On a GPU
    the kernel compiles through Triton; anywhere else it raises rather
    than silently interpreting."""
    from of_spmm.utils.config import FLAGS

    if FLAGS.get("OFS_FORCE_PALLAS_INTERPRET"):
        return True
    p = platform()
    if p == "gpu":
        return False
    raise RuntimeError(
        f"Pallas kernels compile only for a GPU, but the backend is {p!r}; "
        "use impl='xla', or set OFS_FORCE_PALLAS_INTERPRET=1 to interpret")


@dataclasses.dataclass(frozen=True)
class ShardingRule:
    """One legal (inputs -> outputs) sharding signature.

    Atoms: "S0"/"S1" (split on that tensor axis), "B" (replicated),
    "P" (partial-sum: values must be summed across shards to be correct —
    the reference's PartialSum SBP, sbp_parallel.proto:47-79).
    """

    ins: Tuple[str, ...]
    outs: Tuple[str, ...]
    note: str = ""


@dataclasses.dataclass(frozen=True)
class OpDef:
    name: str
    oracle: Callable
    impls: Dict[str, Callable]
    sharding_rules: Tuple[ShardingRule, ...]
    doc: str = ""
    auto: Dict[str, str] = dataclasses.field(default_factory=dict)

    def resolve_impl(self, name: str = "auto") -> str:
        """Impl name for ``name``; "auto" reads OFS_DEFAULT_IMPL, then the
        op's per-platform choice (``xla`` where none is recorded)."""
        if name == "auto":
            from of_spmm.utils.config import FLAGS

            name = FLAGS.get("OFS_DEFAULT_IMPL")
        if name == "auto":
            name = self.auto.get(platform(), "xla")
        return name

    def impl(self, name: str = "auto") -> Callable:
        name = self.resolve_impl(name)
        if name not in self.impls:
            raise KeyError(
                f"op {self.name!r} has no impl {name!r}; have {sorted(self.impls)}"
            )
        return self.impls[name]


_REGISTRY: Dict[str, OpDef] = {}


def register_op(
    name: str,
    oracle: Callable,
    impls: Dict[str, Callable],
    sharding_rules: Sequence[ShardingRule] = (),
    doc: str = "",
    auto: Optional[Dict[str, str]] = None,
) -> OpDef:
    if name in _REGISTRY:
        raise ValueError(f"op {name!r} already registered")
    op = OpDef(name=name, oracle=oracle, impls=dict(impls),
               sharding_rules=tuple(sharding_rules), doc=doc,
               auto=dict(auto or {}))
    _REGISTRY[name] = op
    return op


def lookup(name: str) -> OpDef:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown op {name!r}; registered ops: {', '.join(all_ops())}")
    return _REGISTRY[name]


def all_ops() -> List[str]:
    return sorted(_REGISTRY)


# impl="auto" for spmm per platform; see the "spmm" registration.
SPMM_AUTO: Dict[str, str] = {"gpu": "pallas", "cpu": "xla"}


def _dpa(implementation: Optional[str]) -> Callable:
    """(B, H, T, d) attention through jax.nn.dot_product_attention."""
    def f(q, k, v, is_causal=False):
        o = jax.nn.dot_product_attention(
            q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3), is_causal=is_causal,
            implementation=implementation)
        return o.transpose(0, 2, 1, 3)
    return f


def _sdpa_oracle(q, k, v, is_causal=False):
    from of_spmm.nn.attention import scaled_dot_product_attention

    return scaled_dot_product_attention(q, k, v, is_causal=is_causal)


def _populate() -> None:
    """Register the built-in op set (idempotent at import)."""
    if _REGISTRY:
        return
    from of_spmm.ops import autograd as ag
    from of_spmm.ops import reference as ref
    from of_spmm.ops.pallas.spmm import spmm_pallas

    register_op(
        "gather",
        oracle=ref.gather,
        impls={"xla": ag.gather},
        sharding_rules=(
            # mirrors gather SBP enumeration, gather_op.cpp:51-82
            ShardingRule(("B", "S0"), ("S0",), "indices split -> out split"),
            ShardingRule(("S0", "B"), ("P",),
                         "params row-split -> out partial-sum (zero fill off-shard)"),
            ShardingRule(("S1", "B"), ("S1",), "params col-split -> out col-split"),
        ),
        doc="out[i, :] = params[indices[i], :], out-of-range -> 0",
    )
    register_op(
        "segment_sum",
        oracle=ref.segment_sum,
        impls={"xla": ag.segment_sum},
        sharding_rules=(
            # mirrors unsorted_segment_sum SBP, unsorted_segment_sum_op.cpp:21-131
            ShardingRule(("S0", "S0"), ("P",), "data+ids split -> out partial-sum"),
            ShardingRule(("S1", "B"), ("S1",), "data col-split -> out col-split"),
            ShardingRule(("P", "B"), ("P",), "partial data -> partial out"),
        ),
        doc="out[ids[i], :] += data[i, :], out-of-range ids dropped",
    )
    register_op(
        "spmv",
        oracle=ref.spmv,
        impls={"xla": ag.spmv},
        sharding_rules=(
            ShardingRule(("A:S0", "B"), ("S0",), "row-split A, replicated x"),
            ShardingRule(("A:S1", "S0"), ("P",), "col-split A, split x -> partial y"),
        ),
        doc="y = A @ x",
    )
    register_op(
        "spmm",
        oracle=ref.spmm,
        impls={
            "xla": lambda b, x: ref.spmm_binned_xla(b, x),
            "pallas": spmm_pallas,
        },
        sharding_rules=(
            ShardingRule(("A:S0", "B"), ("S0",),
                         "row-split A, replicated X -> row-split Y (halo plan "
                         "makes the B requirement local: only halo rows move)"),
            ShardingRule(("A:S1", "S0"), ("P",),
                         "col-split A, row-split X -> partial Y (psum combine)"),
            ShardingRule(("A:B", "S1"), ("S1",), "feature-split X -> feature-split Y"),
        ),
        doc="Y = A @ X over the BinnedEll layout",
        # measured on the card (CHANGES.md, PERF.md): the Triton ELL
        # kernel against XLA's binned path, forward + backward
        auto=SPMM_AUTO,
    )
    register_op(
        "sddmm",
        oracle=ref.sddmm,
        impls={"xla": ag.sddmm},
        sharding_rules=(
            ShardingRule(("S0", "B", "pattern:S0"), ("S0",),
                         "row-split lhs with row-split pattern"),
            ShardingRule(("S1", "S1", "pattern:B"), ("P",),
                         "feature-split contraction -> partial vals"),
        ),
        doc="vals[e] = lhs[rows[e]] . rhs[cols[e]]",
    )
    register_op(
        "spmm_coo",
        oracle=lambda r, c, v, x, n: ref.segment_sum(
            v[:, None] * ref.gather(x, c), r, n
        ),
        impls={"xla": ag.spmm_coo},
        sharding_rules=(
            ShardingRule(("S0", "S0", "S0", "B", "B"), ("P",),
                         "edge-split pattern+vals -> partial-sum out"),
        ),
        doc="Y = A @ X with runtime-valued (traced) edge weights; "
            "differentiable in vals AND x (GAT aggregation)",
    )
    register_op(
        "segment_softmax",
        oracle=ag.segment_softmax,
        impls={"xla": ag.segment_softmax},
        sharding_rules=(
            ShardingRule(("B", "B"), ("B",), "replicated edge scores"),
        ),
        doc="softmax over each segment (per-destination attention weights)",
    )
    register_op(
        "dot_product_attention",
        oracle=_sdpa_oracle,
        impls={"xla": _dpa("xla"), "cudnn": _dpa("cudnn")},
        sharding_rules=(
            ShardingRule(("S0", "S0", "S0"), ("S0",), "batch split"),
        ),
        doc="fused softmax(q k^T / sqrt(d)) v over (B, H, T, d); "
            "jax.nn.dot_product_attention's own default is XLA, so the "
            "GPU asks for cuDNN by name",
        auto={"gpu": "cudnn"},
    )
    register_op(
        "spgemm",
        oracle=ref.spgemm,
        impls={"host": ref.spgemm},
        sharding_rules=(
            ShardingRule(("A:S0", "B:B"), ("C:S0",), "row-split A -> row-split C"),
        ),
        doc="C = A @ B, CSR x CSR -> CSR (plan-time, host)",
    )


_populate()
