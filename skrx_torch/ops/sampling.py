"""Negative sampling on the model's device: the port of
``skrx.ops.sampling``.

Semantics, as in the JAX package: uniform over [0, num_items) minus the
user's positives, resampled every epoch. Each negative gets ``num_trials``
candidates at once, tested against the user's row of the sorted padded
positive table by binary search (``torch.searchsorted``); the first
candidate that is not a positive is kept, and the last one when all collide
(probability (n_pos / N) ** num_trials, 0.4% at T = 8 for a user holding
half the catalog).

Randomness comes from an explicit ``torch.Generator`` on the tensors'
device. JAX keys and torch generators give different streams from one seed,
so the tests check the contract (exclusion, fallback, uniformity), not the
bits.

Draws with replacement from a weighted catalog (:func:`draw_with_replacement`)
take ``torch.multinomial`` on the CPU. On a card ``torch.multinomial``
builds its CDF with a scan whose float sums take no fixed order, so two
runs from one seed draw other ids now and then; there the draws are
uniforms from the generator searched in a CDF summed once, in float64 on
the host (:func:`categorical_cdf`): the same ids from run to run.
"""
import numpy as np
import torch

__all__ = ["is_member_sorted", "sample_negatives", "sample_negatives_weighted",
           "gumbel_topk_without_replacement", "categorical_cdf",
           "draw_with_replacement"]


def is_member_sorted(sorted_rows: torch.Tensor,
                     queries: torch.Tensor) -> torch.Tensor:
    """(B, Q) bool: ``queries[b, j]`` is in ``sorted_rows[b, :]``.

    ``sorted_rows`` (B, P) ascending (padding larger than any query),
    ``queries`` (B, Q) of the same integer type. A binary search per query,
    so memory stays (B, Q) whatever P is."""
    p = sorted_rows.shape[1]
    if p == 0:
        return torch.zeros(queries.shape, dtype=torch.bool,
                           device=queries.device)
    pos = torch.searchsorted(sorted_rows, queries).clamp_(max=p - 1)
    return sorted_rows.gather(1, pos) == queries


def _first_valid(cand: torch.Tensor, rows: torch.Tensor, b: int, num_neg: int,
                 num_trials: int) -> torch.Tensor:
    """(B, num_neg): per negative, its first candidate outside the row, or
    its last candidate when every trial is a positive."""
    valid = ~is_member_sorted(rows, cand).reshape(b, num_neg, num_trials)
    cand = cand.reshape(b, num_neg, num_trials)
    first = valid.to(torch.int8).argmax(dim=-1)   # first True, 0 if none
    pick = torch.where(valid.any(dim=-1), first, num_trials - 1)
    return cand.gather(-1, pick[..., None])[..., 0]


def sample_negatives(generator: torch.Generator, users: torch.Tensor,
                     pos_table: torch.Tensor, num_items: int,
                     num_neg: int = 1, num_trials: int = 8) -> torch.Tensor:
    """(B, num_neg) int32 uniform negatives of ``users`` (B,), excluding each
    user's row of ``pos_table`` (U, P) int32 (sorted ascending, padded with
    ``num_items``)."""
    b = users.shape[0]
    rows = pos_table[users]
    cand = torch.randint(0, num_items, (b, num_neg * num_trials),
                         generator=generator, device=pos_table.device,
                         dtype=torch.int32)
    return _first_valid(cand, rows, b, num_neg, num_trials)


def sample_negatives_weighted(generator: torch.Generator, users: torch.Tensor,
                              pos_table: torch.Tensor,
                              log_weights: torch.Tensor, num_neg: int = 1,
                              num_trials: int = 8) -> torch.Tensor:
    """Like :func:`sample_negatives`, with candidates drawn from
    ``softmax(log_weights)`` (N,) (e.g. ``alpha * log(count)`` for
    popularity ** alpha)."""
    b = users.shape[0]
    rows = pos_table[users]
    probs = torch.softmax(log_weights.float(), dim=0)
    cand = draw_with_replacement(probs, b * num_neg * num_trials, generator)
    return _first_valid(cand.to(torch.int32).reshape(b, -1), rows, b, num_neg,
                        num_trials)


def categorical_cdf(probs: torch.Tensor) -> torch.Tensor:
    """(N,) float64 running sums of ``probs`` (N,) (unnormalised weights),
    summed in order on the host, on ``probs``' device."""
    return torch.as_tensor(np.cumsum(probs.detach().cpu().double().numpy()),
                           device=probs.device)


def draw_with_replacement(probs: torch.Tensor, n: int,
                          generator: torch.Generator,
                          cdf: torch.Tensor = None) -> torch.Tensor:
    """(n,) int64 ids drawn with replacement with probabilities
    proportional to ``probs`` (N,): ``torch.multinomial`` on the CPU; on a
    card ``n`` uniforms from ``generator`` searched in ``cdf``
    (:func:`categorical_cdf` of ``probs``, taken here when None), so that
    a run's draws are the same from run to run (see the module
    docstring)."""
    if probs.device.type == "cpu":
        return torch.multinomial(probs, n, replacement=True,
                                 generator=generator)
    if cdf is None:
        cdf = categorical_cdf(probs)
    u = torch.rand(n, generator=generator, dtype=torch.float64,
                   device=cdf.device) * cdf[-1]
    # the first id whose running sum is above u: an id of weight 0 never
    return torch.searchsorted(cdf, u, right=True).clamp_(
        max=cdf.shape[0] - 1)


def gumbel_topk_without_replacement(generator: torch.Generator,
                                    log_weights: torch.Tensor,
                                    k: int) -> torch.Tensor:
    """k indices drawn without replacement with probabilities proportional
    to ``exp(log_weights)`` (the Gumbel top-k trick)."""
    u = torch.rand(log_weights.shape, generator=generator,
                   device=log_weights.device).clamp_(min=1e-20)
    return torch.topk(log_weights - torch.log(-torch.log(u)), k).indices
