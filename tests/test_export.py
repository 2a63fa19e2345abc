"""Export/serving tests (reference: oneflow/api/cpp inference API tests)."""

import jax
import jax.numpy as jnp
import numpy as np

from of_spmm import nn
from of_spmm.export import (
    export_model,
    export_stablehlo_text,
    ir_stats,
    load_model,
    load_params,
)


def test_export_load_roundtrip(tmp_path):
    model = nn.Linear(8, 4)
    params = model.init(jax.random.key(0))
    x = jnp.ones((2, 8))

    def fwd(params, x):
        return model.apply(params, x)

    path = export_model(fwd, (params, x), str(tmp_path / "m"), params=params)
    want = fwd(params, x)

    served = load_model(path)
    p2 = load_params(path, params)
    got = served(jax.tree_util.tree_map(jnp.asarray, p2), x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    assert (tmp_path / "m" / "meta.json").exists()


def test_export_gcn_model(tmp_path):
    """The flagship model exports (spmm plan baked in as constants)."""
    from of_spmm.models import GCN, normalized_adjacency
    from of_spmm.ops.autograd import make_operator
    from of_spmm.sparse.formats import CSR

    rng = np.random.default_rng(0)
    n = 24
    dense = (rng.random((n, n)) < 0.2).astype(np.float32)
    np.fill_diagonal(dense, 0)
    op = make_operator(normalized_adjacency(CSR.from_dense(dense)), place=False)
    model = GCN(feature_dims=(6, 8, 3))
    params = model.init(jax.random.key(1))
    x = jnp.asarray(rng.standard_normal((n, 6)).astype(np.float32))

    def fwd(params, x):
        return model.apply(params, op, x, impl="xla")

    path = export_model(fwd, (params, x), str(tmp_path / "gcn"))
    served = load_model(path)
    np.testing.assert_allclose(
        np.asarray(served(params, x)), np.asarray(fwd(params, x)),
        rtol=1e-5, atol=1e-6)


def test_stablehlo_text_and_stats():
    def f(x):
        return jnp.dot(x, x.T) + 1.0

    x = jnp.ones((4, 8))
    text = export_stablehlo_text(f, (x,))
    assert "stablehlo" in text or "mhlo" in text
    stats = ir_stats(f, (x,))
    assert stats["n_lines"] > 0
    assert any("dot" in k for k in stats["ops"])
