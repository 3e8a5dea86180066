"""Kernel #11: the sum of weighted messages into each destination row, the
port of ``skrx.ops.pallas.segsum_mxu._segsum_kernel`` together with the
gather and weighting that ``_run_direction`` does around it:

    out[d] = sum over edges e with dst_e == d of  x[src_e] * w_e,
    w_e = weight_e * edge_mask[orig_e]  (weight_e alone without a mask).

An edge with w_e == 0 adds an exact 0, whatever ``x[src_e]`` holds (inf and
NaN included); a row without edges is 0. With bf16 messages each message is
``bf16(bf16(x[src_e]) * bf16(w_e))``, summed in f32, as the JAX kernel's
one-hot matmul sums them.

Layout (:func:`build_segments`, once per graph and direction, on the host):
the edges grouped by destination, every row cut into segments of at most
``SEGMENT_EDGES`` edges, a row without edges given one empty segment. The
CUDA kernel (``csrc/segsum.cu``) gives one warp to a segment, so a hub row
of thousands of edges is many short work items and does not hold up the
launch. A row of one segment is written by its warp; a row of several
writes partial sums to scratch, and the warp that finishes the row's last
segment adds them in segment order (:func:`segsum_merge_plain` is that
step's contract) in the same launch. The segments of such rows come first,
the rows of most segments first, so that their merges run while the rest
of the grid is still at work rather than at its tail. Each such row has an
int32
arrival counter in :class:`Segments` (``merge_count``), 0 between launches:
two launches on one ``Segments`` must not run at once (use one stream). The
sum of a row is the same from run to run, whichever warp merges it.

:func:`segsum` runs :func:`segsum_plain` when its tensors lie on the CPU and
launches the kernel on CUDA tensors, or raises. It adds one to
``runtime.LAUNCHES["segsum"]`` per launch.

A CUDA graph can hold a launch, forward and backward (the captured epochs
of LightGCN and MGCN, and of SGAT: its attention as per-edge weights,
``edge_mask`` here, and the sums over its fixed index sets): the layout
is built on the host once, the output and partial rows come from
PyTorch's allocator (the graph's pool under a capture), the launch takes
the current stream, and the counters are back at 0 when a launch ends, so
each replay finds them at rest.
"""
from typing import NamedTuple, Optional

import numpy as np
import torch

from .runtime import LAUNCHES, check, launch, on_cuda

__all__ = ["Segments", "build_segments", "segsum", "segsum_plain",
           "segsum_merge_plain", "SEGMENT_EDGES", "MAX_DIM"]

SEGMENT_EDGES = 128          # most edges one warp walks
MAX_DIM = 256                # widest feature row the kernel takes
MSG_DTYPES = (torch.float32, torch.bfloat16)


class Segments(NamedTuple):
    """One direction of a graph, laid out for the kernel (E edges, R rows,
    S segments, M rows of several segments, P partial slots)."""
    src: torch.Tensor        # (E,) int32 source row, edges sorted by dst
    dst: torch.Tensor        # (E,) int32 destination row
    weight: torch.Tensor     # (E,) f32
    orig: torch.Tensor       # (E,) int32 original edge id (edge_mask index)
    seg_ptr: torch.Tensor    # (S + 1,) int32 first edge of each segment
    seg_dst: torch.Tensor    # (S,) int32 row written, or -(partial slot + 1)
    merge_row: torch.Tensor  # (M,) int32 rows summed from partial slots
    merge_ptr: torch.Tensor  # (M + 1,) int32 first partial slot of each
    part_merge: torch.Tensor   # (P,) int32 merged row (index < M) of a slot
    merge_count: torch.Tensor  # (M,) int32 arrival counters, 0 at rest
    num_nodes: int           # R, rows of the output
    num_src_nodes: int       # rows of x
    num_partials: int        # partial slots of one launch
    max_degree: int          # most edges into one row

    def to(self, device) -> "Segments":
        return self._replace(**{f: getattr(self, f).to(device)
                                for f in self._fields[:10]})


def build_segments(src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
                   orig: np.ndarray, num_nodes: int, num_src_nodes: int,
                   seg_edges: int = SEGMENT_EDGES) -> Segments:
    """Lay out COO edges (any order; ``orig`` their original ids) for
    :func:`segsum`: CSR by destination (a stable sort, so edges into one row
    keep their given order), then segments of at most ``seg_edges`` edges,
    reordered with their edges: the segments of rows of several segments
    first (the rows of most segments first, each row's segments in order),
    then the other rows in row order. Partial slots number the rows of
    several segments in row order. CPU tensors; ``.to(device)`` moves
    them."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    weight = np.asarray(weight, np.float32)
    orig = np.asarray(orig, np.int64)
    e = len(src)
    if not (len(dst) == len(weight) == len(orig) == e):
        raise ValueError("src, dst, weight and orig must have one length")
    if e >= 2 ** 31 or num_nodes >= 2 ** 31 or num_src_nodes >= 2 ** 31:
        raise ValueError("the kernel indexes edges and rows with int32")
    if e and (src.min() < 0 or src.max() >= num_src_nodes
              or dst.min() < 0 or dst.max() >= num_nodes):
        raise ValueError(f"edge endpoints out of range ({num_src_nodes} "
                         f"source rows, {num_nodes} destination rows)")
    order = np.argsort(dst, kind="stable")
    src, dst, weight, orig = src[order], dst[order], weight[order], orig[order]
    deg = np.bincount(dst, minlength=num_nodes)
    row_ptr = np.concatenate([[0], np.cumsum(deg)])
    per_row = np.maximum(1, -(-deg // seg_edges))
    seg_row = np.repeat(np.arange(num_nodes), per_row)
    first = np.cumsum(per_row) - per_row
    intra = np.arange(len(seg_row)) - np.repeat(first, per_row)
    seg_ptr = np.append(row_ptr[seg_row] + intra * seg_edges, e)
    multi = per_row[seg_row] > 1
    n_part = int(multi.sum())
    seg_dst = seg_row.copy()
    seg_dst[multi] = -1 - np.arange(n_part)
    merge_rows = np.flatnonzero(per_row > 1)
    merge_ptr = np.concatenate([[0], np.cumsum(per_row[merge_rows])])
    part_merge = np.repeat(np.arange(len(merge_rows)), per_row[merge_rows])
    # rows of several segments first, most segments first (a stable sort)
    seg_order = np.argsort(np.where(multi, -per_row[seg_row], 0),
                           kind="stable")
    lens = np.diff(seg_ptr)[seg_order]
    new_ptr = np.concatenate([[0], np.cumsum(lens)])
    edges = (np.arange(e) - np.repeat(new_ptr[:-1], lens)
             + np.repeat(seg_ptr[:-1][seg_order], lens))
    src, dst, weight, orig = src[edges], dst[edges], weight[edges], orig[edges]
    seg_ptr, seg_dst = new_ptr, seg_dst[seg_order]

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))

    return Segments(i32(src), i32(dst), torch.from_numpy(weight), i32(orig),
                    i32(seg_ptr), i32(seg_dst), i32(merge_rows),
                    i32(merge_ptr), i32(part_merge),
                    torch.zeros(len(merge_rows), dtype=torch.int32),
                    int(num_nodes), int(num_src_nodes),
                    n_part, int(deg.max()) if num_nodes else 0)


def _weights(seg: Segments, edge_mask: Optional[torch.Tensor]):
    if edge_mask is None:
        return seg.weight
    return seg.weight * edge_mask.index_select(0, seg.orig)


def segsum_plain(seg: Segments, x: torch.Tensor,
                 edge_mask: Optional[torch.Tensor] = None,
                 msg_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    w = _weights(seg, edge_mask)
    rows = x.index_select(0, seg.src)
    if msg_dtype == torch.bfloat16:
        msg = (rows.to(msg_dtype) * w.to(msg_dtype)[:, None]).to(x.dtype)
    else:
        msg = rows * w[:, None]
    msg = torch.where((w != 0)[:, None], msg, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
    out = torch.zeros((seg.num_nodes, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, seg.dst, msg)


def segsum(seg: Segments, x: torch.Tensor,
           edge_mask: Optional[torch.Tensor] = None,
           msg_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(num_nodes, D) f32 weighted message sums of ``x`` (num_src_nodes, D)
    f32 over the edges of ``seg`` (see the module docstring); ``edge_mask``
    (E,) f32 scales edge e's weight by ``edge_mask[orig_e]``. D in
    [1, MAX_DIM]."""
    check(x, "x", torch.float32, 2)
    n_src, d = x.shape
    if n_src != seg.num_src_nodes or not 1 <= d <= MAX_DIM:
        raise ValueError(f"x must be ({seg.num_src_nodes}, D) with 1 <= D <= "
                         f"{MAX_DIM}, got {tuple(x.shape)}")
    if edge_mask is not None:
        check(edge_mask, "edge_mask", torch.float32, 1)
        if edge_mask.shape[0] != seg.src.shape[0]:
            raise ValueError(f"edge_mask has {edge_mask.shape[0]} entries, "
                             f"the graph {seg.src.shape[0]} edges")
    if msg_dtype not in MSG_DTYPES:
        raise ValueError(f"msg_dtype must be one of {MSG_DTYPES}")
    if not on_cuda(x, seg.src, edge_mask):
        return segsum_plain(seg, x, edge_mask, msg_dtype)
    x = x.contiguous()
    if edge_mask is not None:
        edge_mask = edge_mask.contiguous()
    out = torch.empty((seg.num_nodes, d), dtype=torch.float32, device=x.device)
    partial = torch.empty((seg.num_partials, d), dtype=torch.float32,
                          device=x.device)
    merge = ((seg.part_merge, seg.merge_row, seg.merge_ptr, seg.merge_count)
             if seg.num_partials else (None,) * 4)
    if seg.num_nodes:
        launch("skrx_segsum", x.device, x, d, seg.seg_ptr, seg.seg_dst,
               seg.seg_dst.shape[0], seg.src, seg.weight, seg.orig, edge_mask,
               int(msg_dtype == torch.bfloat16), out, partial, *merge)
        LAUNCHES["segsum"] += 1
    return out


def segsum_merge_plain(partial: torch.Tensor, merge_row: torch.Tensor,
                       merge_ptr: torch.Tensor, out: torch.Tensor) -> None:
    """The merge step of the kernel: write into ``out`` (R, D), for each i,
    row ``merge_row[i]`` as the sum of partial rows ``merge_ptr[i] ..
    merge_ptr[i + 1] - 1`` of ``partial`` (P, D); other rows are left as
    they are."""
    counts = (merge_ptr[1:] - merge_ptr[:-1]).long()
    slot_row = torch.repeat_interleave(
        torch.arange(merge_row.shape[0], device=partial.device), counts)
    sums = torch.zeros((merge_row.shape[0], partial.shape[1]),
                       dtype=partial.dtype, device=partial.device)
    out[merge_row.long()] = sums.index_add_(0, slot_row, partial)
