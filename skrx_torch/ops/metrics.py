"""Exact top-k with seen-item masking, and the ranking metrics of
full-catalog evaluation: the port of ``skrx.ops.metrics``.

Metric semantics, as in the JAX package (and the reference's C++ kernel):
every metric is cumulative (column k is the metric of the length-(k+1)
ranking prefix); ``truth_len`` is clamped to >= 1; MAP divides by
min(truth_len, k+1); NDCG's ideal DCG adds 1/log2(i+2) only while
i < truth_len; MRR is the running max of hit[i]/(i+1). Metric ids:
{Precision: 1, Recall: 2, MAP: 3, NDCG: 4, MRR: 5}.
"""
from typing import Optional, Sequence, Tuple

import torch

from .kernels.topk_blocks import (MAX_BLOCK_N, blockwise_topk,
                                  masked_topk_ranks, masked_topk_ranks_small,
                                  order_key)

__all__ = ["METRIC2ID", "ID2METRIC", "mask_items", "topk_scores_and_indices",
           "topk_from_scores", "masked_topk_indices", "hits_from_ranks",
           "hits_against_padded_truth", "ranking_metrics_from_hits",
           "eval_score_matrix_device", "eval_score_matrix_device_paged"]

METRIC2ID = {"Precision": 1, "Recall": 2, "MAP": 3, "NDCG": 4, "MRR": 5}
ID2METRIC = {v: k for k, v in METRIC2ID.items()}


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


def topk_from_scores(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k) int32 top-k item ids per row, by descending score; the route
    of :func:`topk_scores_and_indices`."""
    return topk_scores_and_indices(scores, k)[1]


def masked_topk_indices(scores: torch.Tensor, mask_table: torch.Tensor,
                        k: int) -> torch.Tensor:
    """(B, k) int32 top-k item ids per row with ``mask_table`` items
    excluded; the route of :func:`topk_scores_and_indices`."""
    return topk_scores_and_indices(scores, k, mask_table=mask_table)[1]


def hits_from_ranks(ranks: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k) f32 hit matrix from (B, T) test-item ranks: position r is a
    hit iff some test item's rank is r; ranks >= k (the miss of masked,
    out-of-range and non-finite items) fall outside."""
    hits = torch.zeros((ranks.shape[0], k + 1), dtype=torch.float32,
                       device=ranks.device)
    hits.scatter_(1, ranks.clamp(0, k).long(), 1.0)
    return hits[:, :k]


def hits_against_padded_truth(topk_items: torch.Tensor,
                              truth_table: torch.Tensor) -> torch.Tensor:
    """(B, K) f32: whether each top-k item is in its row of ``truth_table``
    (B, T), padded with an id no ranking holds (the catalog size)."""
    eq = topk_items[:, :, None] == truth_table[:, None, :]
    return eq.any(dim=-1).to(torch.float32)


def ranking_metrics_from_hits(hits: torch.Tensor, truth_len: torch.Tensor,
                              metric_ids: Sequence[int]) -> torch.Tensor:
    """Cumulative metrics (B, len(metric_ids), K) from a (B, K) 0/1 hit
    matrix and (B,) test-list lengths."""
    k = hits.shape[1]
    pos = torch.arange(1, k + 1, dtype=torch.float32, device=hits.device)
    truth = truth_len.to(torch.float32).clamp(min=1.0)[:, None]
    cum_hits = torch.cumsum(hits, dim=-1)
    precision = cum_hits / pos
    recall = cum_hits / truth
    ap = torch.cumsum(hits * precision, dim=-1) / torch.minimum(truth, pos)
    inv_log = 1.0 / torch.log2(pos + 1.0)
    dcg = torch.cumsum(hits * inv_log, dim=-1)
    idcg = torch.cumsum(torch.where(pos[None, :] <= truth, inv_log[None, :],
                                    0.0), dim=-1)
    ndcg = dcg / idcg
    mrr = torch.cummax(hits / pos, dim=1).values
    by_id = {1: precision, 2: recall, 3: ap, 4: ndcg, 5: mrr}
    return torch.stack([by_id[m] for m in metric_ids], dim=1)


def use_blockwise_ranks(n: int, k: int) -> bool:
    """The evaluation route, chosen by shape alone so that a CPU tensor
    takes the plain versions of the route a card takes: the candidate
    prune (kernels #1-#3 and rank_count) needs n/128 >= k group maxima,
    with margin, and k within a column block; below that, the direct count
    over the whole row (direct_rank)."""
    return n // 128 >= 2 * k and k <= MAX_BLOCK_N


def eval_score_matrix_device(scores: torch.Tensor, train_table: torch.Tensor,
                             test_table: torch.Tensor, test_len: torch.Tensor,
                             metric_ids: Tuple[int, ...],
                             top_k: int) -> torch.Tensor:
    """(B, len(metric_ids), top_k) f32 per-user metrics of one batch, on the
    scores' device: ``scores`` (B, N) f32, ``train_table`` (B, L) int32
    items to mask, ``test_table`` (B, T) int32 test items, both padded with
    an id >= N, ``test_len`` (B,). Each test item's rank in the masked row
    is counted (exact below top_k) and one-hot into the hit matrix; the
    sorted top-k ids are never built."""
    n = scores.shape[1]
    route = (masked_topk_ranks if use_blockwise_ranks(n, top_k)
             else masked_topk_ranks_small)
    ranks = route(scores, top_k, test_table, mask_table=train_table)
    return ranking_metrics_from_hits(hits_from_ranks(ranks, top_k), test_len,
                                     metric_ids)


def eval_score_matrix_device_paged(scores_g: torch.Tensor,
                                   train_g: torch.Tensor,
                                   test_g: torch.Tensor,
                                   test_len_g: torch.Tensor,
                                   metric_ids: Tuple[int, ...],
                                   top_k: int) -> torch.Tensor:
    """:func:`eval_score_matrix_device` over G stacked pages in one call:
    ``scores_g`` (G, B, N), ``train_g`` / ``test_g`` (G, B, L*),
    ``test_len_g`` (G, B); returns (G, B, len(metric_ids), top_k). The
    pages flatten into one (G * B, N) batch, as the JAX function does:
    every row is independent, so the numbers equal G separate calls."""
    g, b, n = scores_g.shape
    out = eval_score_matrix_device(
        scores_g.reshape(g * b, n), train_g.reshape(g * b, -1),
        test_g.reshape(g * b, -1), test_len_g.reshape(g * b), metric_ids,
        top_k)
    return out.reshape(g, b, len(metric_ids), top_k)
