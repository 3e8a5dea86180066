"""Sharded sparse propagation through kernel #11: ``A @ x`` with the graph's
destination rows split over every rank of a mesh, the port of
``skrx.parallel.graph_shard``.

* **Node rows owned.** Rank r holds rows ``r * rows_per .. (r + 1) *
  rows_per`` of the node features, the node count padded up to ``world *
  rows_per`` (``rows_per = -(-N // world)``).
* **Edges by destination.** Each rank keeps the edges into its rows, laid
  out for segsum (#11) as ``Segments`` whose sources index the whole padded
  table; for the gradient, the transposed edges out of its rows.
* **One collective a direction.** The forward all-gathers x over the
  world and runs segsum into the rank's rows; the backward all-gathers the
  cotangent and runs segsum over the rank's slice of A^T. A
  ``torch.autograd.Function`` holds the pair, as JAX's ``custom_vjp``
  does.
* **Edge masks in original edge order.** Every edge keeps its original id,
  so the (E,) dropout or pruning mask a model computes indexes the same
  edges on every rank, in both directions; masks and weights are
  constants. An edge of weight 0 adds an exact 0, whatever the row it
  reads holds.

On CPU tensors segsum runs its plain version, as the JAX package's local
``"segment"`` route; on CUDA tensors it launches the kernel or raises.
:class:`ShardedGraph` and its builders keep JAX's numpy layout element for
element (the padding slots with ``dst_local = rows_per - 1``).
"""
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ..ops.kernels.segsum import Segments, build_segments, segsum
from .distributed import all_gather_rows

__all__ = ["ShardedGraph", "sharded_graph_from_sp_matrix",
           "sharded_graph_from_coo", "make_sharded_propagate",
           "ShardedPropGraph", "pad_rows", "unpad_rows"]


class ShardedGraph(NamedTuple):
    """Edge partition for an n-shard layout. Leading dim = shard."""
    src: np.ndarray        # (S, E_s) int32 global source row ids
    dst_local: np.ndarray  # (S, E_s) int32 dst offset within the shard
    weight: np.ndarray     # (S, E_s) float32, 0 on padding
    edge_id: np.ndarray    # (S, E_s) int32 original edge id (0 on padding)
    num_nodes: int         # true (unpadded) node count
    rows_per_shard: int
    num_shards: int

    @property
    def padded_nodes(self) -> int:
        return self.rows_per_shard * self.num_shards


def sharded_graph_from_coo(src: np.ndarray, dst: np.ndarray,
                           weight: np.ndarray, num_nodes: int,
                           num_shards: int) -> ShardedGraph:
    """Partition COO edges by destination into ``num_shards`` contiguous
    row ranges, padded to equal length. The input order defines the edge
    ids an ``edge_mask`` indexes."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    w = np.asarray(weight, dtype=np.float32)
    ids = np.arange(len(src), dtype=np.int64)
    order = np.argsort(dst, kind="stable")
    src, dst, w, ids = src[order], dst[order], w[order], ids[order]
    n = int(num_nodes)
    rows_per = -(-n // num_shards)
    shard_of = dst // rows_per
    counts = np.bincount(shard_of, minlength=num_shards)
    e_s = max(int(counts.max()), 1)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    offs = np.arange(e_s)
    eidx = starts[:, None] + offs[None, :]
    valid = offs[None, :] < counts[:, None]
    # clip, not gather-then-where: a graph without edges indexes nothing;
    # padding slots read edge 0 and are masked below
    eidx_c = np.minimum(eidx, max(len(src) - 1, 0))
    has_e = len(src) > 0
    # padding dst_local = rows_per - 1 (not 0) keeps each shard's
    # destinations ascending
    src_p = np.where(valid, src[eidx_c] if has_e else 0, 0).astype(np.int32)
    dstl_p = np.where(valid,
                      (dst[eidx_c] if has_e else 0)
                      - (np.arange(num_shards) * rows_per)[:, None],
                      rows_per - 1).astype(np.int32)
    w_p = np.where(valid, w[eidx_c] if has_e else 0.0,
                   0.0).astype(np.float32)
    id_p = np.where(valid, ids[eidx_c] if has_e else 0, 0).astype(np.int32)
    return ShardedGraph(src_p, dstl_p, w_p, id_p, n, int(rows_per),
                        int(num_shards))


def sharded_graph_from_sp_matrix(mat: sp.spmatrix,
                                 num_shards: int) -> ShardedGraph:
    """Partition a square adjacency's edges by destination into
    ``num_shards`` row ranges; edge ids in canonical CSR order, as
    ``graph_from_sp_matrix``'s, so one (E,) edge mask serves both."""
    coo = sp.coo_matrix(sp.csr_matrix(mat))
    if coo.shape[0] != coo.shape[1]:
        raise ValueError(f"adjacency must be square, got {coo.shape}")
    return sharded_graph_from_coo(coo.col, coo.row, coo.data, coo.shape[0],
                                  num_shards)


def pad_rows(x: torch.Tensor, graph: ShardedGraph) -> torch.Tensor:
    """Zero-pad (N, D) node features to the sharded row count."""
    pad = graph.padded_nodes - x.shape[0]
    return F.pad(x, (0, 0, 0, pad)) if pad else x


def unpad_rows(x: torch.Tensor, graph: ShardedGraph) -> torch.Tensor:
    return x[:graph.num_nodes]


def _canonical_coo(coo_edges, sp_matrix):
    """(src, dst, w, ids) in the mask's edge-id order, or None."""
    if coo_edges is not None:
        src, dst, w = coo_edges
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        w = np.asarray(w, dtype=np.float32)
        return src, dst, w, np.arange(len(src), dtype=np.int64)
    if sp_matrix is not None:
        coo = sp.coo_matrix(sp.csr_matrix(sp_matrix))
        return (coo.col.astype(np.int64), coo.row.astype(np.int64),
                coo.data.astype(np.float32),
                np.arange(coo.nnz, dtype=np.int64))
    return None


class _ShardSegments(NamedTuple):
    """One rank's part of a sharded graph, laid out for segsum: each
    direction's edges numbered 0.. in its segments, with their original
    ids (the mask's index) beside them."""
    fwd: Segments              # edges into the rank's rows
    fwd_ids: torch.Tensor      # (E_fwd,) int64 original id of each
    bwd: Segments              # transposed edges out of the rank's rows
    bwd_ids: torch.Tensor
    msg_dtype: torch.dtype
    group: object
    world: int


def _shard_segments(coo, rank: int, world: int, rows_per: int,
                    device) -> tuple:
    src, dst, w, ids = coo
    lo, padded = rank * rows_per, world * rows_per

    def direction(s, d):
        own = (d >= lo) & (d < lo + rows_per)
        seg = build_segments(s[own], d[own] - lo, w[own],
                             np.arange(int(own.sum())), rows_per, padded)
        return seg.to(device), torch.as_tensor(ids[own], device=device)
    return (*direction(src, dst), *direction(dst, src))


def _mask(edge_mask: Optional[torch.Tensor], ids: torch.Tensor):
    return None if edge_mask is None else edge_mask.index_select(0, ids)


class _ShardedPropagate(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x_local, edge_mask, part):
        ctx.part = part
        ctx.save_for_backward(edge_mask)
        x_all = all_gather_rows(x_local, part.group, part.world)
        return segsum(part.fwd, x_all, _mask(edge_mask, part.fwd_ids),
                      part.msg_dtype)

    @staticmethod
    def backward(ctx, grad):
        part = ctx.part
        (edge_mask,) = ctx.saved_tensors
        g_all = all_gather_rows(grad.contiguous(), part.group, part.world)
        return segsum(part.bwd, g_all, _mask(edge_mask, part.bwd_ids),
                      part.msg_dtype), None, None


def make_sharded_propagate(mesh, graph: ShardedGraph,
                           msg_dtype: torch.dtype = torch.float32,
                           coo_edges=None, sp_matrix: sp.spmatrix = None,
                           device=None):
    """``prop(x_local, edge_mask=None)``: this rank's rows of ``A @ x``
    from its rows of ``x`` (each ``graph.rows_per_shard`` rows, on
    ``device``, default the mesh's), differentiable in ``x_local``, with
    the node rows and edges split over every rank of ``mesh`` (a
    collective call). ``edge_mask`` is an (E,) f32 in the original edge
    order, not differentiated. Needs the original edges (``sp_matrix`` or
    ``coo_edges=(src, dst, w)``) to lay out each rank's segments."""
    coo = _canonical_coo(coo_edges, sp_matrix)
    if coo is None:
        raise ValueError("make_sharded_propagate needs sp_matrix= or "
                         "coo_edges= to lay out each rank's segments")
    if mesh.size != graph.num_shards:
        raise ValueError(
            f"graph was partitioned for {graph.num_shards} shards but the "
            f"mesh has {mesh.size} ranks; rebuild with "
            f"sharded_graph_from_sp_matrix(mat, {mesh.size})")
    part = _ShardSegments(
        *_shard_segments(coo, mesh.rank, mesh.size, graph.rows_per_shard,
                         mesh.device if device is None else device),
        msg_dtype, mesh.world, mesh.size)

    def prop(x_local: torch.Tensor,
             edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if edge_mask is not None:
            edge_mask = edge_mask.detach()
        return _ShardedPropagate.apply(x_local, edge_mask, part)
    return prop


class ShardedPropGraph:
    """The model-facing sharded graph: the target of
    :func:`skrx_torch.ops.graph.propagate` under a mesh. ``prop(x_local,
    edge_mask=None)`` maps this rank's ``rows_per_shard`` rows of the
    padded node features to its rows of ``A @ x``. Built by
    ``models.common.build_prop_graph(adj, impl, mesh=...)``."""

    def __init__(self, mesh, mat: Optional[sp.spmatrix] = None,
                 msg_dtype: torch.dtype = torch.float32, coo_edges=None,
                 num_nodes: Optional[int] = None, device=None):
        coo = _canonical_coo(coo_edges, mat)
        if coo is None:
            raise ValueError("ShardedPropGraph needs mat= or coo_edges=")
        if num_nodes is None:
            if mat is None or mat.shape[0] != mat.shape[1]:
                raise ValueError("pass num_nodes= for an edge list")
            num_nodes = mat.shape[0]
        self.mesh = mesh
        self.num_nodes = int(num_nodes)
        self.num_edges = len(coo[0])
        src, dst, w, _ = coo
        self.graph = sharded_graph_from_coo(src, dst, w, num_nodes,
                                            mesh.size)
        self.rows_per_shard = self.graph.rows_per_shard
        self._prop = make_sharded_propagate(
            mesh, self.graph, msg_dtype, coo_edges=(src, dst, w),
            device=device)

    def prop(self, x_local: torch.Tensor,
             edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._prop(x_local, edge_mask)
