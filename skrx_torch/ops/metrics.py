"""Exact top-k of a score matrix with seen-item masking: the port of the
serving half of ``skrx.ops.metrics``."""
from typing import Optional, Tuple

import torch

from .kernels.topk_blocks import MAX_BLOCK_N, blockwise_topk, order_key

__all__ = ["mask_items", "topk_scores_and_indices"]


def mask_items(scores: torch.Tensor, item_table: torch.Tensor,
               fill_value: float = float("-inf")) -> torch.Tensor:
    """A copy of ``scores`` (B, N) with ``[b, item_table[b, :]]`` set to
    ``fill_value``; table entries outside [0, N) are padding and dropped
    (their writes land in a spare column that is cut off)."""
    b, n = scores.shape
    out = torch.cat([scores, scores.new_empty((b, 1))], dim=1)
    ids = torch.where((item_table >= 0) & (item_table < n), item_table, n)
    out.scatter_(1, ids.long(), fill_value)
    return out[:, :n]


def _use_blockwise(scores: torch.Tensor, k: int) -> bool:
    # the threshold prune needs n/128 >= k strided group maxima for a finite
    # tau, with margin so tau stays tight (the JAX package's structural
    # guard; its TPU-measured size threshold is not carried); extract keeps
    # a column block's top-k, so k may not exceed the 4096-column block
    return (scores.is_cuda and scores.shape[1] // 128 >= 2 * k
            and k <= MAX_BLOCK_N)


def topk_scores_and_indices(scores: torch.Tensor, k: int,
                            mask_table: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (values f32, ids int32) top-k per row of ``scores`` (B, N),
    with ``mask_table`` items excluded when given.

    A CUDA tensor with N // 128 >= 2k goes through the blockwise kernels
    (masking fused; slots past the unmasked items carry the sentinel id).
    Otherwise a masked top-k in ``lax.top_k``'s order (total float order,
    -0.0 below +0.0, ties to the lower index), as JAX's route for small
    catalogs: slots past the unmasked items carry masked items' ids, and a
    catalog smaller than k pads with -inf and the never-hit id ``N + 1``.
    """
    n = scores.shape[1]
    if _use_blockwise(scores, k):
        return blockwise_topk(scores, k, mask_table=mask_table)
    if mask_table is not None:
        scores = mask_items(scores, mask_table)
    kk = min(k, n)
    idx = torch.sort(order_key(scores.contiguous()), dim=1, descending=True,
                     stable=True).indices[:, :kk]
    vals, idx = scores.gather(1, idx), idx.to(torch.int32)
    if kk < k:
        b = scores.shape[0]
        vals = torch.cat([vals, vals.new_full((b, k - kk), float("-inf"))], 1)
        idx = torch.cat([idx, idx.new_full((b, k - kk), n + 1)], 1)
    return vals, idx
