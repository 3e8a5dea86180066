"""Sharded full-catalog scoring and the two-stage top-k merge (kernels
#1-#5), the port of ``skrx.parallel.topk_merge``.

With the item catalog split by rows over the mesh's model axis, each rank
scores only its slice, takes a local top-k, and the candidate lists of the
model axis are all-gathered and merged into the global top-k: exact (the
global top-k lies in the union of the slices' top-k), and the (B, N) score
matrix never exists on one rank. The local selection is
:func:`~skrx_torch.ops.metrics.topk_scores_and_indices` (``blockwise_topk``,
#1-#4, on a card when the slice is wide enough); the merge is ``vmem_topk``
(#5, ``pruned_merge`` with tau = -inf). Every rank of a model group calls
these functions together, with the same users.
"""
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.kernels.topk_blocks import vmem_topk
from ..ops.metrics import topk_scores_and_indices
from .distributed import all_gather_rows
from .mesh import model_parallel_size

__all__ = ["sharded_topk_scores", "local_then_global_topk",
           "sharded_dot_topk"]


def _gather_candidates(mesh, vals: torch.Tensor, idx: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, m * k) values and int32 ids of the model axis's candidate lists,
    in shard order. One all-gather carries both: the ids travel as the
    float32 bits of their int32 (a collective copies, never computes)."""
    b, k, m = vals.shape[0], vals.shape[1], mesh.model_size
    both = torch.cat([vals, idx.view(torch.float32)], dim=1)
    parts = all_gather_rows(both, mesh.model_group, m).view(m, b, 2, k)
    all_vals = parts[:, :, 0].permute(1, 0, 2).reshape(b, m * k)
    all_idx = parts[:, :, 1].permute(1, 0, 2).reshape(b, m * k)
    return all_vals, all_idx.view(torch.int32)


def local_then_global_topk(scores_local: torch.Tensor, k: int, mesh,
                           shard_offset: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The local top-k of this rank's item slice (``scores_local`` (B,
    N_local), its first item's global id ``shard_offset``), then the
    global top-k of the model axis's candidates: (values (B, k), global
    ids (B, k) int32)."""
    vals, idx = topk_scores_and_indices(scores_local, k)
    all_vals, all_idx = _gather_candidates(mesh, vals, idx + shard_offset)
    return vmem_topk(all_vals, all_idx, k)


def sharded_topk_scores(mesh, score_fn: Callable, k: int) -> Callable:
    """``fn(params, users, n_items_total) -> (top-k values, global ids)``:
    ``score_fn(params, users, item_lo, n_local)`` scores this rank's
    slice of ``n_items_total // m`` items, which merge over the model
    axis."""

    def scores_local_fn(params, users, n_items_total):
        shard_size = n_items_total // mesh.model_size
        offset = mesh.model_index * shard_size
        local = score_fn(params, users, offset, shard_size)
        return local_then_global_topk(local, k, mesh, offset)

    return scores_local_fn


def _item_shard(cache: Dict, mesh, i_all: torch.Tensor,
                bias: Optional[torch.Tensor], shard: int):
    """This rank's ``shard`` rows of the item table and bias, zero-padded,
    kept in ``cache`` while ``i_all`` and ``bias`` are the same tensors
    at the same version."""
    refs = (i_all, bias)
    version = tuple(None if t is None else t._version for t in refs)
    hit = cache.get("shard")
    if hit is not None and all(a is b for a, b in zip(hit[0], refs)) \
            and hit[1] == (version, shard):
        return hit[2]
    lo = mesh.model_index * shard
    rows = i_all[lo:lo + shard].to(torch.float32)
    items = F.pad(rows, (0, 0, 0, shard - rows.shape[0]))
    if bias is None:
        b = torch.zeros(shard, device=i_all.device)
    else:
        b = bias[lo:lo + shard].to(torch.float32)
        b = F.pad(b, (0, shard - b.shape[0]))
    # the references held keep the tensors' ids from reuse
    cache["shard"] = (refs, (version, shard), (items, b))
    return items, b


def sharded_dot_topk(mesh, uv: torch.Tensor, i_all: torch.Tensor,
                     bias: Optional[torch.Tensor], k: int, n_items: int,
                     train_table: torch.Tensor, cache: Optional[Dict] = None,
                     score_fn: Optional[Callable] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact train-masked top-k of ``uv @ i_all.T + bias`` with the catalog
    split over the mesh's model axis (two-stage merge), on every rank of
    the model group: (values (B, k'), global ids (B, k') int32),
    ``k' = min(k, m * min(k, shard), n_items)``; -inf slots carry masked
    or padding ids.

    ``shard = -(-n_items // m)`` items a rank, the padding scored -inf;
    ``train_table`` (B, L) ids are shifted into the shard, a negative
    local id sent out of range (never wrapped) and dropped. ``i_all``
    (n_items, d) and ``bias`` (n_items,) or None are whole; this rank
    scores its rows. ``score_fn(uv, item_shard, bias_shard) -> (B, shard)``
    replaces the dot (SGAT's distance). ``cache``, a dict the caller owns,
    keeps this rank's padded item rows while the tables are unchanged."""
    m = model_parallel_size(mesh)
    if m <= 1:
        raise ValueError("sharded_dot_topk needs a mesh whose model axis is "
                         "above 1")
    cache = {} if cache is None else cache
    shard = -(-n_items // m)
    k_local = min(k, shard)
    k_glob = min(k, m * k_local, n_items)
    offset = mesh.model_index * shard
    items, b = _item_shard(cache, mesh, i_all, bias, shard)
    uv = uv.to(torch.float32)
    scores = score_fn(uv, items, b) if score_fn is not None \
        else uv @ items.T + b[None, :]
    ids = offset + torch.arange(shard, device=scores.device)
    # the catalog's padding rows never rank
    scores = torch.where(ids[None, :] < n_items, scores,
                         torch.full((), float("-inf"), device=scores.device))
    local = train_table.to(scores.device) - offset
    local = torch.where(local < 0, shard, local)
    vals, idx = topk_scores_and_indices(scores, k_local, mask_table=local)
    all_vals, all_idx = _gather_candidates(mesh, vals, idx + offset)
    # ties by id value: the lowest global index, as the single device
    return vmem_topk(all_vals, all_idx, k_glob)
