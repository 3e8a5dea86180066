"""The (data, model) mesh of ranks and the row ownership of tables: the port
of ``skrx.parallel.mesh`` on ``torch.distributed``.

A mesh of shape (d, m) has ``d * m`` ranks, one process each. Rank r sits
at (data index r // m, model index r % m), the row-major order of JAX's
``np.asarray(devices).reshape(shape)``. Training batches are split over the
data axis; embedding tables are split by rows over the model axis (the
matrix-factorisation models) or over every rank (the graph family). A
rank holds only its own rows of such a table: what JAX's ``NamedSharding``
describes and XLA places, a :class:`RowBlocks` describes here and the
models keep. The JAX names ``P`` and ``NamedSharding`` have no counterpart.
"""
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from .distributed import all_gather_rows, all_reduce_sum

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh", "RowBlocks",
           "row_blocks", "take_rows", "gather_rows", "data_sharding",
           "model_row_sharding", "replicated", "model_parallel_size",
           "shard_params_for_mf", "mf_param_shardings", "lookup_rows",
           "gather_all_rows"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """This rank's place in a (data, model) grid of ranks and the process
    groups of its axes: ``world`` (every rank; None, the default group),
    ``model_group`` (the m ranks of this data index) and ``data_group``
    (the d ranks of this model index). ``shape`` maps each axis to its
    size, as a JAX mesh's does."""

    def __init__(self, shape: Tuple[int, int], rank: int,
                 device: torch.device, backend: str, model_group,
                 data_group):
        d, m = shape
        self.shape = {DATA_AXIS: d, MODEL_AXIS: m}
        self.axis_names = (DATA_AXIS, MODEL_AXIS)
        self.size = d * m
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, m)
        self.device = device
        self.backend = backend
        self.world = None
        self.model_group = model_group
        self.data_group = data_group

    @property
    def data_size(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def model_size(self) -> int:
        return self.shape[MODEL_AXIS]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data_size}, model={self.model_size}, "
                f"rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")


# one mesh per (process group, shape, device): every rank must create the
# groups of a mesh once, in the same order
_MESHES: Dict[tuple, Mesh] = {}


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              device=None) -> Mesh:
    """The (data, model) mesh over the ranks of the started process group
    (:func:`~skrx_torch.parallel.initialize_distributed`); ``shape=None``
    puts every rank on the data axis. Raises ``ValueError`` when ``d * m``
    is not the world size. ``device`` is this rank's (default: the
    current CUDA device, or the CPU under gloo without CUDA). A collective
    call: every rank makes the same meshes in the same order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = (world, 1)
    d, m = (int(a) for a in shape)
    if d * m != world:
        raise ValueError(f"mesh shape {tuple(shape)} does not match {world} "
                         f"ranks" + ("" if dist.is_initialized() else
                                     " (no process group: start the ranks "
                                     "with torchrun or initialize_"
                                     "distributed())"))
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    device = torch.device(device)
    if not dist.is_initialized():
        return Mesh((1, 1), 0, device, "none", None, None)
    key = (id(dist.group.WORLD), d, m, str(device))
    if key not in _MESHES:
        rank = dist.get_rank()
        model_groups = [dist.new_group([i * m + j for j in range(m)])
                        for i in range(d)]
        data_groups = [dist.new_group([i * m + j for i in range(d)])
                       for j in range(m)]
        _MESHES[key] = Mesh((d, m), rank, device, dist.get_backend(),
                            model_groups[rank // m], data_groups[rank % m])
    return _MESHES[key]


class RowBlocks(NamedTuple):
    """The split of a table of ``num_rows`` rows over a group of ranks:
    rank i of the group holds rows ``bounds[i][0]:bounds[i][1]``; this
    rank is ``index``."""
    num_rows: int
    bounds: Tuple[Tuple[int, int], ...]
    index: int
    group: object
    group_size: int

    @property
    def lo(self) -> int:
        return self.bounds[self.index][0]

    @property
    def hi(self) -> int:
        return self.bounds[self.index][1]


def row_blocks(num_rows: int, parts: int, index: int, group,
               offset: int = 0, span: Optional[int] = None) -> RowBlocks:
    """A table's rows ``offset .. offset + num_rows`` of a layout of
    ``span`` rows (default ``num_rows``) cut into ``parts`` blocks of
    ``-(-span // parts)`` rows, the last short or padded: block i of the
    layout holds the table's rows that fall in it."""
    span = num_rows if span is None else span
    per = -(-span // parts)
    bounds = tuple((min(max(i * per - offset, 0), num_rows),
                    min(max((i + 1) * per - offset, 0), num_rows))
                   for i in range(parts))
    return RowBlocks(num_rows, bounds, index, group, parts)


def take_rows(full: torch.Tensor, blocks: Optional[RowBlocks]
              ) -> torch.Tensor:
    """This rank's rows of ``full`` (all of them for a replicated one)."""
    if blocks is None:
        return full
    return full[blocks.lo:blocks.hi].clone()


def gather_rows(local: torch.Tensor, blocks: Optional[RowBlocks]
                ) -> torch.Tensor:
    """The whole table from each rank's rows (a collective over the
    blocks' group); a replicated one as it is."""
    if blocks is None:
        return local
    per = max(hi - lo for lo, hi in blocks.bounds)
    padded = local.new_zeros((per, *local.shape[1:]))
    padded[:local.shape[0]] = local
    parts = all_gather_rows(padded, blocks.group, blocks.group_size)
    return torch.cat([parts[i * per: i * per + hi - lo]
                      for i, (lo, hi) in enumerate(blocks.bounds)])


def data_sharding(mesh: Mesh, batch_rows: int) -> RowBlocks:
    """The rows of a batch of ``batch_rows`` that each data index takes;
    the batch must divide by the data axis."""
    if batch_rows % mesh.data_size:
        raise ValueError(f"a batch of {batch_rows} rows does not divide "
                         f"over the data axis of {mesh.data_size}")
    return row_blocks(batch_rows, mesh.data_size, mesh.data_index,
                      mesh.data_group)


def model_row_sharding(mesh: Mesh, num_rows: int) -> RowBlocks:
    """A table's rows split over the model axis, ``-(-n // m)`` a block."""
    return row_blocks(num_rows, mesh.model_size, mesh.model_index,
                      mesh.model_group)


def replicated(mesh: Mesh) -> None:
    """A tensor every rank holds whole (no :class:`RowBlocks`)."""
    return None


def model_parallel_size(mesh: Optional[Mesh]) -> int:
    """Size of the model axis (1 when no mesh)."""
    return 1 if mesh is None else mesh.model_size


def mf_param_shardings(mesh: Mesh, params: Dict[str, torch.Tensor]
                       ) -> Dict[str, Optional[RowBlocks]]:
    """Each parameter's row ownership for the matrix-factorisation models:
    a 2-D table of at least ``m`` rows split over the model axis, anything
    else (a bias) replicated."""
    m = mesh.model_size
    return {name: model_row_sharding(mesh, x.shape[0])
            if x.dim() == 2 and x.shape[0] >= m else replicated(mesh)
            for name, x in params.items()}


def shard_params_for_mf(mesh: Mesh, params: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """This rank's rows of each whole parameter, by
    :func:`mf_param_shardings`."""
    blocks = mf_param_shardings(mesh, params)
    return {name: take_rows(x, blocks[name]) for name, x in params.items()}


class _LookupRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, local, ids, blocks, mesh):
        ctx.save_for_backward(ids)
        ctx.blocks, ctx.mesh, ctx.shape = blocks, mesh, local.shape
        if blocks is None:                    # every rank holds the table
            return local[ids]
        own = (ids >= blocks.lo) & (ids < blocks.hi)
        rows = local.new_zeros((*ids.shape, *local.shape[1:]))
        if local.shape[0]:
            picked = local[torch.where(own, ids - blocks.lo, 0)]
            mask = own.reshape(*own.shape, *([1] * (local.dim() - 1)))
            rows = torch.where(mask, picked, rows)
        return all_reduce_sum(rows, mesh.model_group, mesh.model_size)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        blocks, mesh, shape = ctx.blocks, ctx.mesh, ctx.shape
        g = all_gather_rows(grad.reshape(-1, *shape[1:]).contiguous(),
                            mesh.data_group, mesh.data_size)
        at = all_gather_rows(ids.reshape(-1), mesh.data_group,
                             mesh.data_size)
        lo, hi = (0, shape[0]) if blocks is None else (blocks.lo, blocks.hi)
        # rows owned elsewhere land in a spare row past the end; the sum is
        # the indexing gradient's (index_put_ with accumulate, in batch
        # order), as one device forms it
        pos = torch.where((at >= lo) & (at < hi), at - lo, shape[0])
        out = grad.new_zeros((shape[0] + 1, *shape[1:]))
        out.index_put_((pos,), g, accumulate=True)
        return out[:shape[0]], None, None, None


def lookup_rows(local: torch.Tensor, ids: torch.Tensor,
                blocks: Optional[RowBlocks], mesh: Mesh) -> torch.Tensor:
    """Rows ``ids`` (any shape; global row ids) of a table, on every rank of
    the model group: of a table split over the model axis (this rank's
    rows ``local``, ``blocks`` from :func:`model_row_sharding`) each rank
    reads the ids it owns, zero elsewhere, and an all-reduce over the model
    group sums them; of a table every rank holds (``blocks`` None) the
    rank reads them. The m ranks of a data index look the same ids up for
    the same loss, which counts once: the backward gathers every data
    index's cotangent and ids and adds them into the rank's rows, so
    ``local`` gets the whole batch's gradient, summed as one device sums
    it."""
    return _LookupRows.apply(local, ids, blocks, mesh)


class _GatherAllRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x_local, mesh):
        ctx.mesh, ctx.rows = mesh, x_local.shape[0]
        return all_gather_rows(x_local, mesh.world, mesh.size)

    @staticmethod
    def backward(ctx, grad):
        mesh, n = ctx.mesh, ctx.rows
        grad = grad.contiguous()
        if mesh.data_size > 1:
            grad = all_reduce_sum(grad.clone(), mesh.data_group,
                                  mesh.data_size)
        return grad[mesh.rank * n:(mesh.rank + 1) * n], None


def gather_all_rows(x_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x_local`` (the same row count each), concatenated in
    rank order on every rank, differentiable: the backward sums the
    cotangent over the data axis (the m ranks of a data index compute the
    same loss, which counts once) and keeps this rank's rows."""
    return _GatherAllRows.apply(x_local, mesh)
