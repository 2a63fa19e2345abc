"""Docstring examples executed as tests (reference runs doctests in CI,
ci/test/doctest.sh + rank-conditional checking in framework/unittest.py)."""

import doctest

import pytest

MODULES = [
    "of_spmm.sparse.formats",
    "of_spmm.optim.lr_scheduler",
]


@pytest.mark.parametrize("modname", MODULES)
def test_doctests(modname):
    import importlib

    mod = importlib.import_module(modname)
    results = doctest.testmod(mod, verbose=False)
    assert results.failed == 0, f"{results.failed} doctest failures in {modname}"
    assert results.attempted > 0, f"no doctests found in {modname}"
