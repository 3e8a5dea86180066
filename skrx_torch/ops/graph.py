"""Sparse graph propagation through kernel #11: the port of
``skrx.ops.graph`` and of the graph half of ``skrx.ops.pallas.segsum_mxu``.

A :class:`Graph` is an operator A lowered once on the host: its forward
direction (A, edges by destination) and its backward direction (A^T, edges
by source), each laid out for the segment-sum kernel
(:func:`skrx_torch.ops.kernels.segsum.build_segments`). :func:`propagate`
is ``A @ x`` as a ``torch.autograd.Function``: the forward is the kernel over
A and the gradient the kernel over A^T. Graph weights are constants;
``edge_mask`` (per-epoch edge dropout) is not differentiable and scales the
same edges in both directions, through the edges' original ids. Original
edge ids follow CSR (row-major) order for :func:`graph_from_sp_matrix`, as
in both JAX lowerings, so one (E,) mask means the same edges in either
package.

:func:`propagate_weighted` is ``A(w) @ x`` with per-edge weights ``w``
that are differentiable (SGAT's attention), on a :class:`WeightedGraph` of
unit weights: the kernel scales edge e by ``w[orig_e]`` in both directions,
and the weights' gradient ``dw_e = <g[dst_e], x[src_e]>`` is two row
gathers and a row dot in plain PyTorch, as the JAX package computes it
outside its kernel.
"""
from typing import NamedTuple, Optional, Union

import numpy as np
import scipy.sparse as sp
import torch

from ..parallel.graph_shard import ShardedPropGraph
from .kernels.segsum import Segments, build_segments, segsum

__all__ = ["Graph", "graph_from_coo", "graph_from_sp_matrix",
           "transpose_graph", "propagate", "propagate_layers",
           "edge_dropout", "WeightedGraph", "weighted_graph_from_coo",
           "propagate_weighted"]


class Graph(NamedTuple):
    """The operator A (num_nodes x num_src_nodes) in both directions."""
    fwd: Segments                 # A: rows of the output, edges by dst
    bwd: Segments                 # A^T: the gradient, edges by src
    num_nodes: int
    num_src_nodes: int
    msg_dtype: torch.dtype = torch.float32

    @property
    def num_edges(self) -> int:
        return int(self.fwd.src.shape[0])

    def to(self, device) -> "Graph":
        return self._replace(fwd=self.fwd.to(device), bwd=self.bwd.to(device))


def graph_from_coo(src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
                   num_nodes: int, msg_dtype: torch.dtype = torch.float32,
                   num_src_nodes: Optional[int] = None,
                   device="cpu") -> Graph:
    """A with A[dst_e, src_e] = weight_e, on ``device``. Edge order defines
    the original edge ids that ``edge_mask`` indexes. A rectangular
    operator passes ``num_src_nodes`` != ``num_nodes``: the forward maps
    (num_src_nodes, D) to (num_nodes, D), the backward the reverse."""
    num_src = num_nodes if num_src_nodes is None else num_src_nodes
    ids = np.arange(len(src))
    fwd = build_segments(src, dst, weight, ids, num_nodes, num_src)
    bwd = build_segments(dst, src, weight, ids, num_src, num_nodes)
    return Graph(fwd, bwd, int(num_nodes), int(num_src),
                 msg_dtype).to(device)


def graph_from_sp_matrix(mat: sp.spmatrix,
                         msg_dtype: torch.dtype = torch.float32,
                         device="cpu") -> Graph:
    """A square scipy sparse matrix A as a Graph, so that
    ``propagate(g, x) == A @ x``; edge ids in CSR (row-major) order."""
    coo = sp.coo_matrix(sp.csr_matrix(mat))
    if coo.shape[0] != coo.shape[1]:
        raise ValueError(f"adjacency must be square, got {coo.shape}")
    return graph_from_coo(coo.col, coo.row, coo.data, coo.shape[0],
                          msg_dtype, device=device)


def transpose_graph(graph: Graph) -> Graph:
    """The operator A^T (the directions swapped; tensors shared). Edge ids
    are unchanged, so one edge_mask drives both orientations."""
    return Graph(graph.bwd, graph.fwd, graph.num_src_nodes, graph.num_nodes,
                 graph.msg_dtype)


class _Propagate(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, edge_mask, graph):
        ctx.graph = graph
        ctx.save_for_backward(edge_mask)
        return segsum(graph.fwd, x, edge_mask, graph.msg_dtype)

    @staticmethod
    def backward(ctx, grad):
        graph = ctx.graph
        (edge_mask,) = ctx.saved_tensors
        # the cotangent of a stack or mean may be a strided view
        dx = segsum(graph.bwd, grad.contiguous(), edge_mask, graph.msg_dtype)
        return dx, None, None


def propagate(graph: Union[Graph, ShardedPropGraph], x: torch.Tensor,
              edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One step of ``A @ x`` for x (num_src_nodes, D) f32, differentiable in
    x. ``edge_mask`` (E,) f32 scales each edge's weight (dropout) and is not
    differentiated. On a :class:`~skrx_torch.parallel.ShardedPropGraph`, x
    and the result are this rank's rows (a collective call)."""
    if isinstance(graph, ShardedPropGraph):
        return graph.prop(x, edge_mask)
    if edge_mask is not None:
        edge_mask = edge_mask.detach()
    return _Propagate.apply(x, edge_mask, graph)


class WeightedGraph(NamedTuple):
    """A graph of unit weights for :func:`propagate_weighted`, with its
    edges' endpoints in original edge order (the weights' order)."""
    graph: Graph
    src: torch.Tensor             # (E,) int64 source row of edge e
    dst: torch.Tensor             # (E,) int64 destination row of edge e

    def to(self, device) -> "WeightedGraph":
        return WeightedGraph(self.graph.to(device), self.src.to(device),
                             self.dst.to(device))


def weighted_graph_from_coo(src: np.ndarray, dst: np.ndarray,
                            num_nodes: int,
                            msg_dtype: torch.dtype = torch.float32,
                            num_src_nodes: Optional[int] = None,
                            device="cpu") -> WeightedGraph:
    """The counterpart of ``skrx.ops.pallas.segsum_mxu.
    weighted_mxu_graph_from_coo``: edges ``src_e -> dst_e`` of weight 1,
    whose weights :func:`propagate_weighted` takes at each call, indexed
    by the edges' order here."""
    g = graph_from_coo(src, dst, np.ones(len(src), np.float32), num_nodes,
                       msg_dtype, num_src_nodes, device)
    return WeightedGraph(
        g, torch.as_tensor(np.asarray(src, np.int64), device=device),
        torch.as_tensor(np.asarray(dst, np.int64), device=device))


class _PropagateWeighted(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weights, wgraph):
        ctx.wgraph = wgraph
        ctx.save_for_backward(x, weights)
        graph = wgraph.graph
        return segsum(graph.fwd, x, weights, graph.msg_dtype)

    @staticmethod
    def backward(ctx, grad):
        wgraph = ctx.wgraph
        graph = wgraph.graph
        x, weights = ctx.saved_tensors
        grad = grad.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = segsum(graph.bwd, grad, weights, graph.msg_dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.sum(grad.index_select(0, wgraph.dst)
                           * x.index_select(0, wgraph.src), dim=-1)
        return dx, dw, None


def propagate_weighted(wgraph: WeightedGraph, x: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """The counterpart of ``skrx.ops.pallas.segsum_mxu.
    propagate_mxu_weighted``: ``A(w) @ x`` for x (num_src_nodes, D) f32 and
    ``weights`` (E,) f32 in the graph's edge order, differentiable in both:
    dx runs the kernel over A(w)^T, ``dw_e = <g[dst_e], x[src_e]>``."""
    return _PropagateWeighted.apply(x, weights, wgraph)


def propagate_layers(graph: Graph, x: torch.Tensor, num_layers: int,
                     combine: str = "mean",
                     edge_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """``num_layers`` propagation steps with layer combination: 'mean'
    (LightGCN: the average of layers 0..K), 'sum', or 'last'."""
    if combine not in ("mean", "sum", "last"):
        raise ValueError(f"unknown combine {combine!r}")
    layers = [x]
    h = x
    for _ in range(num_layers):
        h = propagate(graph, h, edge_mask)
        layers.append(h)
    if combine == "last":
        return h
    stacked = torch.stack(layers)
    return stacked.mean(0) if combine == "mean" else stacked.sum(0)


def edge_dropout(generator: torch.Generator, num_edges: int,
                 keep_prob: float) -> torch.Tensor:
    """Bernoulli(keep_prob) edge mask scaled by 1/keep_prob, on the
    generator's device (the counterpart of ``skrx.ops.graph.edge_dropout``;
    the bits differ from JAX's)."""
    if not 0.0 < keep_prob <= 1.0:
        raise ValueError(f"'keep_prob' must be in (0, 1], got {keep_prob}")
    keep = torch.rand(num_edges, generator=generator,
                      device=generator.device) < keep_prob
    return keep.to(torch.float32) / keep_prob
