"""Graph utilities of the GCN family: the port's own copy of
``skrx.utils.common`` (``normalize_adj_matrix``, ``sp_mat_to_edges``,
``build_ui_adjacency``)."""
from typing import Tuple

import numpy as np
import scipy.sparse as sp

__all__ = ["normalize_adj_matrix", "sp_mat_to_edges", "build_ui_adjacency"]


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


def sp_mat_to_edges(sp_mat: sp.spmatrix
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A scipy sparse matrix as (row ids int32, column ids int32, values
    float32) in its COO order, the host form that
    :func:`skrx_torch.ops.graph.graph_from_coo` takes."""
    coo = sp.coo_matrix(sp_mat)
    return (coo.row.astype(np.int32), coo.col.astype(np.int32),
            coo.data.astype(np.float32))


def build_ui_adjacency(user_ids: np.ndarray, item_ids: np.ndarray,
                       num_users: int, num_items: int,
                       norm_method: str = "symmetric",
                       self_loop: bool = False) -> sp.csr_matrix:
    """The (num_users + num_items)^2 bipartite adjacency of the
    interactions (items offset by num_users), with an optional self loop,
    normalised by :func:`normalize_adj_matrix`."""
    n = num_users + num_items
    rows = np.concatenate([user_ids, item_ids + num_users])
    cols = np.concatenate([item_ids + num_users, user_ids])
    data = np.ones(len(rows), dtype=np.float64)
    adj = sp.csr_matrix((data, (rows, cols)), shape=(n, n))
    if self_loop:
        adj = adj + sp.eye(n, format="csr")
    return normalize_adj_matrix(adj, norm_method)
