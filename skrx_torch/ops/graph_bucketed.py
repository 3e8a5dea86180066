"""Scatter-free sparse propagation by degree-bucketed neighbour gathers:
the port of ``skrx.ops.graph_bucketed``.

``A @ x`` as gathers only: the rows of A are ordered by degree and grouped
into buckets of padded neighbour tables (caps 16, 64, 256, 1,024, 4,096,
then the largest degree), each bucket one dense (M, cap, D) gather and a
weighted sum over its cap; the buckets' outputs, in degree order, are put
back in row order by one gather through the inverse permutation.
:func:`propagate_bucketed` is a ``torch.autograd.Function`` whose gradient
runs the same machinery over Aᵀ (built once). Weights are constants; an
edge mask needs :func:`skrx_torch.ops.graph.propagate`.

It is plain PyTorch, as the JAX package computes it with XLA gathers
outside any Pallas kernel; no model routes to it in either package, and
:func:`skrx_torch.ops.graph.propagate` (kernel #11) stays the path.
"""
from typing import NamedTuple, Tuple

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["BucketedGraph", "bucketed_from_sp_matrix", "propagate_bucketed"]

_DEFAULT_CAPS = (16, 64, 256, 1024, 4096)


class _OneDirection(NamedTuple):
    # per bucket: neighbour ids (M, cap) padded with num_nodes, weights
    nbr: Tuple[torch.Tensor, ...]
    wts: Tuple[torch.Tensor, ...]
    inv_perm: torch.Tensor     # (n,) gather ids restoring row order
    num_nodes: int


class BucketedGraph(NamedTuple):
    fwd: _OneDirection         # A
    bwd: _OneDirection         # A^T


def _build_direction(csr: sp.csr_matrix, caps, device) -> _OneDirection:
    n = csr.shape[0]
    degrees = np.diff(csr.indptr)
    max_deg = int(degrees.max()) if n else 0
    caps = [c for c in caps if c < max_deg] + [max(max_deg, 1)]
    order = np.argsort(degrees, kind="stable")          # ascending degree
    sorted_deg = degrees[order]
    nbr_buckets, wts_buckets = [], []
    start = 0
    for cap in caps:
        end = int(np.searchsorted(sorted_deg, cap, side="right"))
        nodes = order[start:end]
        deg = degrees[nodes]
        # row k's neighbours in columns 0..deg[k]-1, in CSR order
        rows = np.repeat(np.arange(len(nodes)), deg)
        cols = np.arange(int(deg.sum())) - np.repeat(np.cumsum(deg) - deg,
                                                     deg)
        edges = np.repeat(csr.indptr[nodes], deg) + cols
        nbr = np.full((len(nodes), cap), n, dtype=np.int64)
        wts = np.zeros((len(nodes), cap), dtype=np.float32)
        nbr[rows, cols] = csr.indices[edges]
        wts[rows, cols] = csr.data[edges]
        nbr_buckets.append(torch.as_tensor(nbr, device=device))
        wts_buckets.append(torch.as_tensor(wts, device=device))
        start = end
    inv_perm = np.empty(n, dtype=np.int64)
    inv_perm[order] = np.arange(n)
    return _OneDirection(tuple(nbr_buckets), tuple(wts_buckets),
                         torch.as_tensor(inv_perm, device=device), n)


def bucketed_from_sp_matrix(mat: sp.spmatrix, caps=_DEFAULT_CAPS,
                            device="cpu") -> BucketedGraph:
    """Both directions, A and Aᵀ, of a square matrix, on ``device``."""
    csr = sp.csr_matrix(mat).astype(np.float32)
    if csr.shape[0] != csr.shape[1]:
        raise ValueError(f"adjacency must be square, got {csr.shape}")
    return BucketedGraph(_build_direction(csr, caps, device),
                         _build_direction(sp.csr_matrix(csr.T), caps, device))


def _apply_direction(d: _OneDirection, x: torch.Tensor) -> torch.Tensor:
    x_pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    outs = [torch.einsum("mc,mcd->md", wts, x_pad[nbr])
            for nbr, wts in zip(d.nbr, d.wts)]
    return torch.cat(outs)[d.inv_perm]


class _Propagate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph = graph
        return _apply_direction(graph.fwd, x)

    @staticmethod
    def backward(ctx, g):
        return _apply_direction(ctx.graph.bwd, g), None


def propagate_bucketed(graph: BucketedGraph, x: torch.Tensor
                       ) -> torch.Tensor:
    """A @ x by gathers, forward and backward (the gradient through
    Aᵀ)."""
    return _Propagate.apply(x, graph)
