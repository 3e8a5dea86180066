"""Fused score-and-select for dot models: the port of
``skrx.ops.pallas.dot_topk`` (``pack_items``, ``dot_topk_candidates``,
``dot_topk``, ``dot_topk_ranks``).

The scores ``uv @ items.T + bias`` of a batch are never stored: both passes
of the blockwise top-k compute their column block's scores inside the
kernel (``csrc/dot_topk.cu``):

1. :func:`dot_submax` — what :func:`~.topk_blocks.submax` computes, on the
   scores it computes itself; then tau by :func:`~.topk_blocks.kth_largest`
   on the folded group maxima, as the score-matrix route takes it;
2. :func:`dot_extract` — what :func:`~.topk_blocks.extract` computes, the
   same way; then :func:`~.topk_blocks.pruned_merge` (serving) or
   :func:`~.topk_blocks.rank_lookup_count` (evaluation, each test item's
   score looked up by id among the candidates, so it is the kernel's own).

The scores are summed in one fixed order, ``acc = 0; acc = acc + u[c] *
it[c]`` for c = 0 .. d-1, each operation rounded, then ``+ bias``, by the
kernels (no FMA) and by their plain versions (d tensor multiplies and adds):
the two agree bit for bit. They are not ``predict``'s scores, whose matmul
sums in another order. Selection contract as in ``topk_blocks``: (value
desc, id asc), empty slots (-inf, ``SENTINEL``). The kernels take d <= 512
and raise above, as the JAX package asserts.

Every kernel has a plain PyTorch version beside it (``*_plain``). A wrapper
runs it when its tensors lie on the CPU and launches the kernel on CUDA
tensors, or raises; it adds one to ``runtime.LAUNCHES[<kernel>]`` per launch.
"""
from typing import NamedTuple, Optional, Tuple

import torch

from .runtime import LAUNCHES, check as _check, launch as _launch
from .runtime import on_cuda as _on_cuda
from .topk_blocks import (GROUPS, _check_block_n, _check_mask,
                          extract_plain, fold_submaxes, kth_largest,
                          kth_largest_plain, pruned_merge, pruned_merge_plain,
                          rank_lookup_count, submax_plain)

__all__ = ["PackedItems", "pack_items", "dot_submax", "dot_extract",
           "dot_scores_plain", "dot_submax_plain", "dot_extract_plain",
           "dot_topk_candidates", "dot_topk", "dot_topk_plain",
           "dot_topk_ranks", "MAX_DIM"]

MAX_DIM = 512                        # widest factors the kernels take
_ROW_PAD = 32                        # uv rows padded to the largest row tile


class PackedItems(NamedTuple):
    """The item table as the kernels read it: ``table`` (d4 / 4, n_pad, 4)
    f32, each quad of dimensions with the columns' four values side by side
    (d4 = d rounded up to 4, zeros past d); ``bias`` (n_pad,) f32, zeros
    without a bias and -inf past ``n``; n_pad = ``n`` rounded up to
    ``block_n``."""
    table: torch.Tensor
    bias: torch.Tensor
    n: int
    d: int
    block_n: int


def pack_items(items: torch.Tensor, bias: Optional[torch.Tensor] = None,
               block_n: int = 4096) -> PackedItems:
    """Pack an (N, d) item table and its (N,) bias (or None) once, for
    repeated calls against one frozen table (serving, an evaluation)."""
    _check_block_n(block_n)
    items = items.detach().to(torch.float32)
    if items.dim() != 2:
        raise ValueError(f"items must be (N, d), got {tuple(items.shape)}")
    n, d = items.shape
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"dot_topk takes 1 <= d <= {MAX_DIM}, got d={d}")
    n_pad = max(-(-n // block_n), 1) * block_n
    d4 = -(-d // 4) * 4
    table = items.new_zeros((n_pad, d4))
    table[:n, :d] = items
    table = table.reshape(n_pad, d4 // 4, 4).transpose(0, 1).contiguous()
    b_pad = items.new_full((n_pad,), float("-inf"))
    if bias is None:
        b_pad[:n] = 0.0
    else:
        if tuple(bias.shape) != (n,):
            raise ValueError(f"bias must be ({n},), got {tuple(bias.shape)}")
        b_pad[:n] = bias.detach().to(torch.float32)
    return PackedItems(table, b_pad, n, d, block_n)


def _check_uv(uv: torch.Tensor, packed: PackedItems) -> None:
    _check(uv, "uv", torch.float32, 2)
    if uv.shape[1] != packed.d:
        raise ValueError(f"uv has d={uv.shape[1]}, the packed table "
                         f"d={packed.d}")


def _padded_uv(uv: torch.Tensor, packed: PackedItems) -> torch.Tensor:
    """(B rounded up to 32, d4) copy of uv, zeros past (B, d)."""
    b = uv.shape[0]
    out = uv.new_zeros((-(-b // _ROW_PAD) * _ROW_PAD,
                        packed.table.shape[0] * 4))
    out[:b, :packed.d] = uv
    return out


def _n_blocks(packed: PackedItems) -> int:
    return packed.table.shape[1] // packed.block_n


# ------------------------------------------------------- the scores, plain

def dot_scores_plain(uv: torch.Tensor, packed: PackedItems) -> torch.Tensor:
    """(B, N) f32 scores in the kernels' order: ``acc = 0``, then ``acc =
    acc + uv[:, c] * item[c]`` for c = 0 .. d-1 as separate f32 multiplies
    and adds, then ``+ bias``; one column block at a time."""
    b, n = uv.shape[0], packed.n
    out = uv.new_empty((b, n))
    for lo in range(0, n, packed.block_n):
        hi = min(lo + packed.block_n, n)
        acc = uv.new_zeros((b, hi - lo))
        for c in range(packed.d):
            acc.add_(uv[:, c:c + 1] * packed.table[c // 4, lo:hi, c % 4])
        out[:, lo:hi] = acc + packed.bias[lo:hi]
    return out


# ------------------------------------------------------------- kernel 9

def dot_submax_plain(uv: torch.Tensor, packed: PackedItems,
                     mask_table: Optional[torch.Tensor]) -> torch.Tensor:
    return submax_plain(dot_scores_plain(uv, packed), mask_table,
                        packed.block_n)


def dot_submax(uv: torch.Tensor, packed: PackedItems,
               mask_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, n_blocks * 128) masked strided-group maxima of the scores ``uv``
    (B, d) f32 gives against ``packed``: what :func:`~.topk_blocks.submax`
    returns for the score matrix, which is never built."""
    _check_uv(uv, packed)
    b = uv.shape[0]
    mask_table = _check_mask(mask_table, b)
    if not _on_cuda(uv, packed.table, packed.bias, mask_table):
        return dot_submax_plain(uv, packed, mask_table)
    out = torch.empty((b, _n_blocks(packed) * GROUPS), dtype=torch.float32,
                      device=uv.device)
    if b:
        _launch("skrx_dot_submax", uv.device, _padded_uv(uv, packed), b,
                packed.table.shape[0], packed.table, packed.bias, packed.n,
                packed.table.shape[1], packed.block_n, mask_table,
                0 if mask_table is None else mask_table.shape[1], out)
        LAUNCHES["dot_submax"] += 1
    return out


# ------------------------------------------------------------ kernel 10

def dot_extract_plain(uv: torch.Tensor, packed: PackedItems,
                      mask_table: Optional[torch.Tensor], tau: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return extract_plain(dot_scores_plain(uv, packed), mask_table, tau, k,
                         packed.block_n)


def dot_extract(uv: torch.Tensor, packed: PackedItems, tau: torch.Tensor,
                k: int, mask_table: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidates (B, n_blocks * k) f32 values and int32 global ids of the
    scores ``uv`` gives against ``packed``: what
    :func:`~.topk_blocks.extract` returns for the score matrix, which is
    never built."""
    _check_uv(uv, packed)
    _check(tau, "tau", torch.float32, 1)
    b = uv.shape[0]
    mask_table = _check_mask(mask_table, b)
    if tau.shape[0] != b or not 1 <= k <= packed.block_n:
        raise ValueError(f"need tau (B,) and 1 <= k <= block_n; got tau "
                         f"{tuple(tau.shape)}, k={k}, "
                         f"block_n={packed.block_n}")
    if not _on_cuda(uv, packed.table, packed.bias, tau, mask_table):
        return dot_extract_plain(uv, packed, mask_table, tau, k)
    w = _n_blocks(packed) * k
    out_v = torch.empty((b, w), dtype=torch.float32, device=uv.device)
    out_i = torch.empty((b, w), dtype=torch.int32, device=uv.device)
    if b:
        _launch("skrx_dot_extract", uv.device, _padded_uv(uv, packed), b,
                packed.table.shape[0], packed.table, packed.bias, packed.n,
                packed.table.shape[1], packed.block_n, mask_table,
                0 if mask_table is None else mask_table.shape[1],
                tau.contiguous(), k, out_v, out_i)
        LAUNCHES["dot_extract"] += 1
    return out_v, out_i


# ---------------------------------------------------------- composition

def dot_topk_candidates(uv: torch.Tensor, items: Optional[torch.Tensor],
                        bias: Optional[torch.Tensor], k: int,
                        mask_table: Optional[torch.Tensor] = None,
                        block_n: int = 4096,
                        packed: Optional[PackedItems] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(cand_vals, cand_ids, tau)`` of the scores ``uv @ items.T + bias``
    with ``mask_table`` items excluded, as
    :func:`~.topk_blocks.blockwise_candidates` returns them for the score
    matrix. ``packed`` (from :func:`pack_items`) replaces ``items`` and
    ``bias``."""
    if packed is None:
        packed = pack_items(items, bias, block_n)
    bm = dot_submax(uv, packed, mask_table)
    if bm.shape[1] >= k:
        tau = kth_largest(fold_submaxes(bm, k).contiguous(), k)
    else:
        tau = torch.full((uv.shape[0],), float("-inf"), device=uv.device)
    cand_v, cand_i = dot_extract(uv, packed, tau, k, mask_table)
    return cand_v, cand_i, tau


def dot_topk(uv: torch.Tensor, items: Optional[torch.Tensor],
             bias: Optional[torch.Tensor], k: int,
             mask_table: Optional[torch.Tensor] = None, block_n: int = 4096,
             packed: Optional[PackedItems] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (values (B, k) f32, ids (B, k) int32) top-k per row of ``uv
    @ items.T + bias`` with ``mask_table`` (B, L) int32 items excluded
    (entries outside [0, N) are padding), never building the (B, N)
    scores; ties to the lower id, slots past the row's unmasked items
    (-inf, SENTINEL)."""
    cand_v, cand_i, tau = dot_topk_candidates(uv, items, bias, k, mask_table,
                                              block_n, packed)
    return pruned_merge(cand_v, cand_i, k, tau)


def dot_topk_plain(uv: torch.Tensor, packed: PackedItems, k: int,
                   mask_table: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`dot_topk` through the plain versions alone, on any device."""
    scores = dot_scores_plain(uv, packed)
    bm = submax_plain(scores, mask_table, packed.block_n)
    if bm.shape[1] >= k:
        tau = kth_largest_plain(fold_submaxes(bm, k).contiguous(), k)
    else:
        tau = torch.full((uv.shape[0],), float("-inf"), device=uv.device)
    cand_v, cand_i = extract_plain(scores, mask_table, tau, k, packed.block_n)
    return pruned_merge_plain(cand_v, cand_i, k, tau)


def dot_topk_ranks(uv: torch.Tensor, items: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], k: int,
                   test_table: torch.Tensor,
                   mask_table: Optional[torch.Tensor] = None,
                   block_n: int = 4096,
                   packed: Optional[PackedItems] = None) -> torch.Tensor:
    """(B, T) int32 rank of each ``test_table`` item in its row's masked
    ranking of ``uv @ items.T + bias``, exact below k and k otherwise; the
    item's score is looked up by id among the candidates, so a masked,
    out-of-range or padding item (no candidate holds its id) gets k. Any
    T."""
    cand_v, cand_i, _ = dot_topk_candidates(uv, items, bias, k, mask_table,
                                            block_n, packed)
    ranks, found = rank_lookup_count(cand_v, cand_i,
                                     test_table.to(torch.int32))
    return torch.where(found, ranks, k)
