"""Graph utilities of the GCN family: the port's own copy of
``skrx.utils.common.normalize_adj_matrix``."""
import numpy as np
import scipy.sparse as sp

__all__ = ["normalize_adj_matrix"]


def normalize_adj_matrix(sp_mat: sp.spmatrix,
                         norm_method: str = "symmetric") -> sp.csr_matrix:
    """Degree-normalise an adjacency matrix in float64: ``left`` D^-1 A,
    ``symmetric`` D^-1/2 A D^-1/2. Rows of degree 0 get 0."""
    adj = sp.csr_matrix(sp_mat, dtype=np.float64)
    degree = np.asarray(adj.sum(axis=1)).flatten()
    if norm_method == "left":
        power = -1.0
    elif norm_method == "symmetric":
        power = -0.5
    else:
        raise ValueError(f"'{norm_method}' is an invalid normalization method "
                         f"(expected 'left' or 'symmetric')")
    with np.errstate(divide="ignore"):
        d_inv = np.power(degree, power)
    d_inv[np.isinf(d_inv)] = 0.0
    d_mat = sp.diags(d_inv)
    norm_adj = d_mat @ adj if norm_method == "left" else d_mat @ adj @ d_mat
    return norm_adj.tocsr()
