from of_spmm.ops.pallas.spmm import spmm_pallas

__all__ = ["spmm_pallas"]
