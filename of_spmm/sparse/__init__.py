from of_spmm.sparse.formats import COO, CSR
from of_spmm.sparse.binned import BinnedEll, EllBucket, bin_rows, DEFAULT_LADDER

__all__ = ["COO", "CSR", "BinnedEll", "EllBucket", "bin_rows", "DEFAULT_LADDER"]
