"""Data-parallel training on a mesh: the batch split over the data axis and
the gradients of replicated parameters summed over it.

JAX trains a model on a mesh by placing its arrays: the math is the single
device's, and XLA inserts the collectives. Here each rank runs its data
index's rows of every batch, and a loss written for one device needs three
things to stay the single device's:

* **Global batch statistics.** A normaliser over the batch (the count of
  valid rows, the batch size) is the whole batch's: :func:`batch_total`,
  :func:`global_rows`, :func:`batch_mean`.
* **Global in-batch terms.** A term that pairs a row with the other rows
  of the batch (an in-batch softmax, a covariance) reads the whole batch
  through :func:`gather_batch`, a differentiable all-gather over the data
  axis whose backward sums the cotangent over it and keeps the rank's rows.
  A term over whole tables or the whole batch that every rank computes
  alike counts once: :func:`once`.
* **Global draws.** A step's draws shaped by the batch are drawn at the
  global shape on every rank, from the same generator, and each rank takes
  its rows (:func:`local_rows`), as the pipelines do with their batches.

The helpers read the mesh of the running :func:`data_parallel` block
(``TorchRecommender.fit`` opens one around every training epoch) and are
the identity outside one, so a loss runs unchanged on one device.

Gradients (:func:`sync_gradients`): a parameter every rank holds and reads
directly gets only its slice's gradient, so the ranks of a model index sum
it over the data axis, once a step, in one all-reduce. A parameter read
through a collective whose backward already sums over the data axis (a
table split over ranks, a row lookup) is skipped, or it would count d
times. A parameter applied to the rank's own node rows of a graph sharded
over every rank gets its rows' share of the whole batch's gradient, summed
over every rank. The m ranks of a data index compute the same loss, so
their sums are equal but for rounding: on a card the backward's
scatter-adds are not ordered, and replicas that drift apart would score
the catalog's shards from different weights. Under a model axis above 1
the replicated gradients are therefore summed over every rank and divided
by m, one result on every rank.
"""
import contextlib
from typing import Dict, Iterable, Optional

import torch

from .distributed import all_gather_rows, all_reduce_sum
from .mesh import Mesh, RowBlocks, gather_rows

__all__ = ["data_parallel", "active_mesh", "batch_total", "global_rows",
           "batch_mean", "local_rows", "gather_batch", "gather_batch_ids",
           "batch_offset", "once", "sync_gradients", "gather_whole"]

_ACTIVE: Optional[Mesh] = None


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """Run the block's training steps as ``mesh``'s rank (None: one
    device)."""
    global _ACTIVE
    before, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = before


def active_mesh() -> Optional[Mesh]:
    """The mesh of the running :func:`data_parallel` block whose data axis
    is above 1, else None."""
    mesh = _ACTIVE
    return mesh if mesh is not None and mesh.data_size > 1 else None


def batch_total(x: torch.Tensor) -> torch.Tensor:
    """``sum(x)`` over the whole batch (not differentiated: a count)."""
    total = torch.sum(x.detach())
    mesh = active_mesh()
    if mesh is not None:
        all_reduce_sum(total, mesh.data_group, mesh.data_size)
    return total


def global_rows(n_local: int) -> int:
    """The whole batch's row count of a rank's ``n_local`` rows."""
    mesh = active_mesh()
    return n_local if mesh is None else n_local * mesh.data_size


def batch_offset(n_local: int) -> int:
    """The global row of this rank's first of ``n_local`` rows."""
    mesh = active_mesh()
    return 0 if mesh is None else mesh.data_index * n_local


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean over the whole batch of the rows
    ``x`` (all dims): ``sum(x)`` over the global count of elements."""
    return torch.sum(x) / (global_rows(x.shape[0]) * (x[0].numel()
                                                      if x.dim() else 1))


def local_rows(x):
    """This rank's rows of ``x``, a draw at the global batch's shape (a
    tensor, None, or nested tuples and lists of them)."""
    mesh = active_mesh()
    if mesh is None or x is None:
        return x
    if isinstance(x, (tuple, list)):
        return type(x)(local_rows(v) for v in x)
    n = x.shape[0] // mesh.data_size
    return x[mesh.data_index * n:(mesh.data_index + 1) * n]


def gather_batch_ids(x: torch.Tensor) -> torch.Tensor:
    """The whole batch of ``x`` (ids, weights, a step's row updates: not
    differentiated), in data-index order, the same bits on every rank:
    under a model axis above 1 every rank's rows are gathered and model
    index 0's kept, so replicas that apply them stay equal even where the
    m ranks of a data index computed them apart (a card's unordered
    scatter-adds)."""
    mesh = active_mesh()
    if mesh is None:
        return x
    if mesh.model_size == 1:
        return all_gather_rows(x.contiguous(), mesh.data_group,
                               mesh.data_size)
    n, m = x.shape[0], mesh.model_size
    every = all_gather_rows(x.contiguous(), mesh.world, mesh.size)
    return torch.cat([every[i * m * n:(i * m + 1) * n]
                      for i in range(mesh.data_size)])


class _GatherBatch(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return all_gather_rows(x.contiguous(), mesh.data_group,
                               mesh.data_size)

    @staticmethod
    def backward(ctx, grad):
        mesh, n = ctx.mesh, ctx.rows
        grad = all_reduce_sum(grad.contiguous().clone(), mesh.data_group,
                              mesh.data_size)
        return grad[mesh.data_index * n:(mesh.data_index + 1) * n], None


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """The whole batch of the rows ``x`` on every rank, differentiable:
    the backward sums the cotangent over the data axis (each rank's loss
    reads every row) and keeps this rank's rows."""
    mesh = active_mesh()
    if mesh is None:
        return x
    return _GatherBatch.apply(x, mesh)


def once(x):
    """A term of the whole batch or of whole tables that every rank
    computes alike: kept on data index 0, times 0 elsewhere (the graph
    stays, so every rank runs the same collectives in the backward)."""
    mesh = active_mesh()
    if mesh is None or mesh.data_index == 0:
        return x
    return x * 0.0


def _all_reduce_flat(grads, group, size) -> None:
    """Sum the tensors ``grads`` over ``group`` in one all-reduce a dtype,
    in place."""
    by_dtype: Dict[torch.dtype, list] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in same])
        all_reduce_sum(flat, group, size)
        offset = 0
        for g in same:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


@torch.no_grad()
def sync_gradients(named_params: Iterable, mesh: Optional[Mesh],
                   whole=(), world=()) -> None:
    """Sum the ``.grad`` of each parameter of ``named_params`` over the
    data axis, skipping the names in ``whole`` (a gradient the backward's
    collectives made whole) and summing those in ``world`` (a parameter
    applied to the rank's own rows of a graph sharded over every rank) over
    every rank. A name matches itself and its dotted children."""
    if mesh is None or mesh.size == 1:
        return

    def matches(name, names):
        return any(name == n or name.startswith(n + ".") for n in names)
    data, every = [], []
    for name, p in named_params:
        if p.grad is None or matches(name, whole):
            continue
        (every if matches(name, world) else data).append(p.grad)
    if data and mesh.model_size > 1:
        # the m ranks of a data index hold the same sum but for rounding
        # (a card's scatter-adds are not ordered): the mean of the world's
        # sums, the same on every rank, keeps the replicas equal
        _all_reduce_flat(data, mesh.world, mesh.size)
        for g in data:
            g.mul_(1.0 / mesh.model_size)
    elif data and mesh.data_size > 1:
        _all_reduce_flat(data, mesh.data_group, mesh.data_size)
    if every:
        _all_reduce_flat(every, mesh.world, mesh.size)


class _GatherWhole(torch.autograd.Function):

    @staticmethod
    def forward(ctx, local, blocks, mesh):
        ctx.blocks, ctx.mesh = blocks, mesh
        return gather_rows(local, blocks)

    @staticmethod
    def backward(ctx, grad):
        blocks, mesh = ctx.blocks, ctx.mesh
        grad = grad.contiguous()
        if mesh.data_size > 1:
            grad = all_reduce_sum(grad.clone(), mesh.data_group,
                                  mesh.data_size)
        return grad[blocks.lo:blocks.hi], None, None


def gather_whole(local: torch.Tensor, blocks: Optional[RowBlocks],
                      mesh: Mesh) -> torch.Tensor:
    """The whole table of a parameter split over the mesh's ranks (this
    rank's rows ``local`` of ``blocks``: over the model axis, or every
    rank), differentiable: every rank of a model index reads the whole
    table for its slice of the batch, and the m ranks of a data index
    compute the same loss, so the backward sums the cotangent over the data
    axis only and keeps the rank's rows. A replicated one (``blocks`` None)
    as it is."""
    if blocks is None:
        return local
    return _GatherWhole.apply(local, blocks, mesh)
