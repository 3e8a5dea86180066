"""Row sums in one fixed order: the gradients of the train path's gathers
and the sums a training step takes over a fixed index set. On a card the
gradient of ``index_select`` is one ``index_add_``, which adds through
atomics in no fixed order, so two runs from one seed part after a few
steps wherever a gradient nearly cancels (Adam magnifies its rounding).
The JAX package's gather gradient is an XLA scatter-add, which sums in one
fixed order on its chip; these sums give the port the same property.

- :func:`ordered_row_sum` sums the rows of ``grads`` into ``n_rows`` rows
  by ``ids``, repeated ids in batch order. On the CPU it is ``index_add_``,
  a serial loop in batch order there (the CPU's ``index_put_`` splits a
  large sum over threads). On a card, for up to ``PUT_ROWS`` rows, it is
  ``index_put_`` with ``accumulate=True``: the ids radix sorted (stable)
  and each run of equal ids summed by one warp, in batch order where a
  row has more than 32 features and by one fixed warp tree for a 1-D
  table. Above ``PUT_ROWS`` rows it is a stable sort and two
  ``torch.segment_reduce`` calls: each run cut into pieces of at most
  ``PIECE_ROWS`` rows in batch order, then each run's pieces summed in
  order. Both give the same bits from run to run. On an H100
  (``experiments/ordered_row_sum_designs.py``) ``index_put_`` walks a
  run serially, ~0.45 us a row: 0.02-0.1 ms at GRU4Rec's, the multimodal
  models' and BERT4Rec's gathers (128-2,176 rows), but 1.0 ms at SASRec's
  6,400 rows (a pad run of 2,175) and 18.7 ms at SRGNN's 51,200 (a pad
  run of 40,930), where lazy Adam's one-level sort and
  ``torch.segment_reduce`` (``dedup_rows``) takes 0.20 and 2.8 ms; that
  design takes five calls and ~0.4-0.7 ms of host time a call against
  ``index_put_``'s one, hence the split by size. ``index_put_`` also
  adds into a table in place (AOBPR's update).
  :func:`ordered_gather` is ``table[ids]`` with it as the gradient.
  The ``index_put_`` route reads nothing back to the host: on an H100
  (``experiments/epoch_routes.py``) neither it nor ``ordered_gather``'s
  backward, nor a plain ``table[ids]``'s backward (BPRMF's and
  LightGCN's gathers), raises under ``torch.cuda.set_sync_debug_mode
  ("error")`` at 1,024 and 2,048 rows, so a CUDA graph can hold them;
  nor do the whole steps of FPMC, TransRec, SGAT (plain gathers of up to
  5,120 rows) and MGCN (``gather_rows`` of 2,048). No captured step sums
  more than ``PUT_ROWS`` rows here, so the ``segment_reduce`` route's
  host reads stay unchecked.
- :func:`fixed_index` lays an index set that stays the same from step to
  step (SGAT's occurrences and edges, LATTICE's learned rows) out once as
  kernel #11's :class:`~skrx_torch.ops.kernels.segsum.Segments`;
  :func:`fixed_sum` sums rows into it through ``segsum`` and
  :func:`fixed_gather` gathers by it with ``segsum`` as its gradient, so
  no step sorts. A row's sum is the kernel's: the same from run to run,
  each row's edges in their given order on the CPU (bit-equal to
  ``index_add_`` there).
"""
from typing import NamedTuple, Optional

import numpy as np
import torch

from .kernels.runtime import on_cuda
from .kernels.segsum import MAX_DIM, Segments, build_segments, segsum

__all__ = ["ordered_row_sum", "ordered_gather", "FixedIndex",
           "fixed_index", "fixed_gather", "fixed_sum", "PUT_ROWS",
           "PIECE_ROWS"]

PUT_ROWS = 4_096        # most rows summed by index_put_ on a card
PIECE_ROWS = 128        # most rows of a run one segment_reduce slot adds


def ordered_row_sum(ids: torch.Tensor, grads: torch.Tensor, n_rows: int,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n_rows, *row) sums of the rows of ``grads`` (K, *row) by ``ids``
    (K,), repeated ids in batch order (see the module docstring); into
    ``out`` in place when it is given (its rows first, then the batch's,
    in order)."""
    ids = ids.reshape(-1).long()
    if out is None:
        out = grads.new_zeros((n_rows, *grads.shape[1:]))
    if not on_cuda(ids, grads, out):
        return out.index_add_(0, ids, grads)  # serial in batch order here
    if ids.shape[0] <= PUT_ROWS:
        return out.index_put_((ids,), grads, accumulate=True)
    return out.add_(sum_in_pieces(ids, grads, n_rows))


def sum_in_pieces(ids: torch.Tensor, grads: torch.Tensor,
                  n_rows: int) -> torch.Tensor:
    """:func:`ordered_row_sum`'s sum above ``PUT_ROWS`` rows (any device):
    the ids sorted (stable), each run of equal ids cut into pieces of at
    most ``PIECE_ROWS`` rows summed in batch order, then each run's pieces
    summed in order, two ``torch.segment_reduce`` calls that add in an
    order the ids fix. No step waits on the host: the K slots of each
    reduction past the last piece or run are empty."""
    k, dev = ids.shape[0], ids.device
    flat = grads.reshape(k, -1)
    ids_s, order = torch.sort(ids, stable=True)
    rows = flat.index_select(0, order)
    slot = torch.arange(k, device=dev)
    new_run = torch.ones(k, dtype=torch.bool, device=dev)
    new_run[1:] = ids_s[1:] != ids_s[:-1]
    start = torch.cummax(torch.where(new_run, slot, 0), 0).values
    piece = torch.cumsum(new_run | ((slot - start) % PIECE_ROWS == 0), 0) - 1
    run = torch.cumsum(new_run, 0) - 1

    def lengths(of, count):
        return torch.zeros(k, dtype=torch.int64, device=dev).scatter_add_(
            0, of, count)
    parts = torch.segment_reduce(rows, "sum", unsafe=True,
                                 lengths=lengths(piece, torch.ones_like(piece)))
    # every write to a slot carries one value: a piece's run, a run's id
    run_of_piece = torch.zeros_like(run).scatter_(0, piece, run)
    sums = torch.segment_reduce(parts, "sum", unsafe=True, lengths=lengths(
        run_of_piece, (slot <= piece[-1]).long()))
    row_of_run = torch.full_like(run, n_rows).scatter_(0, run, ids_s)
    # the empty runs' zeros land in a spare row past the end
    out = flat.new_zeros((n_rows + 1, flat.shape[1]))
    out.index_copy_(0, row_of_run, sums)
    return out[:n_rows].reshape(n_rows, *grads.shape[1:])


class _OrderedGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, ids):
        flat = ids.reshape(-1)
        ctx.save_for_backward(flat)
        ctx.n_rows, ctx.row = table.shape[0], table.shape[1:]
        return torch.index_select(table, 0, flat).reshape(
            *ids.shape, *ctx.row)

    @staticmethod
    def backward(ctx, grad):
        (flat,) = ctx.saved_tensors
        rows = grad.reshape(flat.shape[0], *ctx.row)
        return ordered_row_sum(flat, rows, ctx.n_rows), None


def ordered_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (ids of any shape) by ``index_select``, its gradient
    :func:`ordered_row_sum`."""
    return _OrderedGather.apply(table, ids)


class FixedIndex(NamedTuple):
    """An index set of K ids into ``n_rows`` rows, with the same edges
    (edge e from source row e into row ``ids[e]``) laid out for
    ``segsum``."""
    ids: torch.Tensor         # (K,) int64
    seg: Segments
    n_rows: int

    def to(self, device) -> "FixedIndex":
        return FixedIndex(self.ids.to(device), self.seg.to(device),
                          self.n_rows)


def fixed_index(ids, n_rows: int, device=None) -> FixedIndex:
    """The :class:`FixedIndex` of ``ids`` (K,) (a tensor or an array) into
    ``n_rows`` rows, built on the host once, on ``device`` (the ids'
    device by default)."""
    if device is None:
        device = ids.device if isinstance(ids, torch.Tensor) else "cpu"
    ids_np = (ids.detach().cpu().numpy() if isinstance(ids, torch.Tensor)
              else np.asarray(ids)).reshape(-1).astype(np.int64)
    k = len(ids_np)
    seg = build_segments(np.arange(k), ids_np, np.ones(k, np.float32),
                         np.arange(k), n_rows, k)
    return FixedIndex(torch.from_numpy(ids_np), seg, int(n_rows)).to(device)


def _segsum_rows(seg: Segments, rows: torch.Tensor) -> torch.Tensor:
    """``segsum`` of (K,) or (K, D) rows, D cut into columns of at most
    ``MAX_DIM``; (n_rows,) or (n_rows, D)."""
    flat = rows.reshape(rows.shape[0], -1)
    out = torch.cat([segsum(seg, flat[:, i:i + MAX_DIM].contiguous())
                     for i in range(0, flat.shape[1], MAX_DIM)], dim=1)
    return out.reshape(seg.num_nodes, *rows.shape[1:])


class _FixedSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, rows, index):
        ctx.index = index
        return _segsum_rows(index.seg, rows)

    @staticmethod
    def backward(ctx, grad):
        return grad.index_select(0, ctx.index.ids), None


class _FixedGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, index):
        ctx.index = index
        return table.index_select(0, index.ids)

    @staticmethod
    def backward(ctx, grad):
        return _segsum_rows(ctx.index.seg, grad), None


def fixed_sum(rows: torch.Tensor, index: FixedIndex) -> torch.Tensor:
    """(n_rows, *row) sums of f32 ``rows`` (K, *row) by ``index``'s ids,
    through kernel #11 (its plain version on the CPU); its gradient is the
    gather by the same ids."""
    return _FixedSum.apply(rows, index)


def fixed_gather(table: torch.Tensor, index: FixedIndex) -> torch.Tensor:
    """(K, *row) rows ``table[index.ids]`` of an f32 ``table`` (n_rows,
    *row); its gradient sums by the same ids through kernel #11."""
    return _FixedGather.apply(table, index)
