"""Exact blockwise top-k of a (B, N) score matrix with fused seen-item
masking, and the rank counts of full-catalog evaluation: the port of
``skrx.ops.pallas.topk_blocks`` (``blockwise_topk``, ``masked_topk_ranks``,
``masked_topk_ranks_small``, ``_rank_lookup_counts``).

Top-k in three passes, each a hand-written CUDA kernel
(``csrc/topk_blocks.cu``):

1. :func:`submax` — per row, the max of every strided column group (group l
   of column block j = columns c of the block with c % 128 == l), masked.
2. :func:`kth_largest` — tau = the exact k-th largest group max (after
   :func:`fold_submaxes`). At least k groups reach tau, each through one
   element, so every element of the row's top-k is >= tau.
3. :func:`extract` — per column block, its top-min(k, #>=tau) finite
   elements; then :func:`pruned_merge` takes the sorted top-k of those
   (B, n_blocks * k) candidates.

Evaluation ranks (``csrc/rank_counts.cu``): :func:`masked_topk_ranks` runs
the first passes and then :func:`rank_count` (each test item's position among
the candidates); :func:`masked_topk_ranks_small` is one kernel,
:func:`direct_rank`, that counts over the whole masked row;
:func:`rank_lookup_count` counts as :func:`rank_count` with each probe's
score looked up by id among the candidates (the fused route of
``dot_topk``). All take any number of test items per row.

Contract, as in the JAX package: ties rank by (value desc, id asc); slots
beyond the row's unmasked items hold (-inf, ``SENTINEL`` = int32max // 2);
``tau`` equals JAX's ``blockwise_candidates`` tau bit for bit.

Every kernel has a plain PyTorch version of the same function beside it
(``*_plain``). A wrapper runs the plain version when its tensor lies on the
CPU (the tests) and launches the kernel on a CUDA tensor, or raises. The
kernels of the rank tail (submax, kth_largest, extract, pruned_merge and
vmem_topk) are the operators ``torch.ops.skrx.*`` of ``operators``: their
wrappers check the arguments and call the operator, whose CUDA
implementation launches the kernel and counts it, so that
``torch.export`` can record them. The rank kernels' wrappers launch and
count (``runtime.LAUNCHES[<kernel>]``) themselves.
"""
from typing import Optional, Tuple

import torch

from ..sampling import is_member_sorted
from .runtime import LAUNCHES, check as _check, launch as _launch
from .runtime import check_device as _check_device, on_cuda as _on_cuda

__all__ = ["blockwise_topk", "blockwise_candidates", "kth_largest",
           "pruned_merge", "vmem_topk", "submax", "extract",
           "submax_plain", "kth_largest_plain", "extract_plain",
           "pruned_merge_plain", "fold_submaxes", "order_key", "rank_count",
           "rank_count_plain", "rank_key", "rank_lookup_count",
           "rank_lookup_count_plain", "direct_rank", "direct_rank_plain",
           "masked_topk_ranks", "masked_topk_ranks_small", "SENTINEL",
           "MAX_BLOCK_N"]

SENTINEL = 2 ** 31 // 2 - 1          # int32max // 2, id of an empty slot
GROUPS = 128                         # strided column groups per block
MAX_BLOCK_N = 4096                  # widest column block the kernels take
_TAU_MAX_W = 4096                    # fold group maxima down to this width


def _check_block_n(block_n: int) -> None:
    if block_n < GROUPS or block_n > MAX_BLOCK_N or block_n & (block_n - 1):
        raise ValueError(f"block_n must be a power of two in [{GROUPS}, "
                         f"{MAX_BLOCK_N}], got {block_n}")


def _check_mask(mask_table: Optional[torch.Tensor], b: int):
    if mask_table is None:
        return None
    _check(mask_table, "mask_table", torch.int32, 2)
    if mask_table.shape[0] != b:
        raise ValueError(f"mask_table has {mask_table.shape[0]} rows, "
                         f"scores {b}")
    return mask_table.contiguous()


def _masked_padded(scores: torch.Tensor, mask_table: Optional[torch.Tensor],
                   block_n: int) -> torch.Tensor:
    """(B, n_blocks * block_n) copy of ``scores`` with masked and padding
    columns at -inf (mask ids outside [0, N) are ignored)."""
    b, n = scores.shape
    n_blocks = -(-n // block_n)
    out = scores.new_full((b, n_blocks * block_n + 1), float("-inf"))
    out[:, :n] = scores
    if mask_table is not None:
        ids = torch.where((mask_table >= 0) & (mask_table < n), mask_table,
                          n_blocks * block_n).long()
        out.scatter_(1, ids, float("-inf"))
    return out[:, :-1]


# ------------------------------------------------------------- kernel 1

def _jax_amax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Max of f32 ``x`` over ``dim`` as ``jnp.max`` and ``jnp.maximum`` take
    it: NaN where any is NaN, otherwise the largest in the order -inf < ...
    < -0.0 < +0.0 (``amax`` and ``torch.maximum`` may return -0.0 beside
    +0.0)."""
    m = order_key(order_key(x).amax(dim=dim).contiguous()).view(torch.float32)
    return torch.where(x.isnan().any(dim=dim), float("nan"), m)


def submax_plain(scores: torch.Tensor, mask_table: Optional[torch.Tensor],
                 block_n: int) -> torch.Tensor:
    b = scores.shape[0]
    s = _masked_padded(scores, mask_table, block_n)
    s = s.reshape(b, -1, block_n // GROUPS, GROUPS)
    return _jax_amax(s, 2).reshape(b, -1)


def submax(scores: torch.Tensor, mask_table: Optional[torch.Tensor] = None,
           block_n: int = 4096) -> torch.Tensor:
    """(B, n_blocks * 128) masked strided-group maxima of (B, N) f32
    ``scores``: column j * 128 + l is the max of block j's group l, as
    JAX's fold takes it (NaN when the group holds one, -0.0 below +0.0)."""
    _check(scores, "scores", torch.float32, 2)
    mask_table = _check_mask(mask_table, scores.shape[0])
    _check_block_n(block_n)
    _check_device(scores, mask_table)
    return torch.ops.skrx.submax(scores, mask_table, block_n)


# ------------------------------------------------------------- kernel 2

def order_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving f32 -> int32 map (-inf lowest, -0.0 < +0.0), the
    total order of JAX's ``kth_largest`` and ``lax.top_k``; an involution
    on int32."""
    i = x.view(torch.int32) if x.dtype == torch.float32 else x
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def kth_largest_plain(vals: torch.Tensor, k: int) -> torch.Tensor:
    keys = torch.sort(order_key(vals), dim=1).values[:, vals.shape[1] - k]
    return order_key(keys.contiguous()).view(torch.float32)


def kth_largest(vals: torch.Tensor, k: int) -> torch.Tensor:
    """(B,) exact per-row k-th largest value of (B, W) f32 ``vals`` in the
    total order of the JAX kernel (-inf lowest, -0.0 below +0.0). Requires
    1 <= k <= W and no NaNs."""
    _check(vals, "vals", torch.float32, 2)
    w = vals.shape[1]
    if not 1 <= k <= w:
        raise ValueError(f"need 1 <= k <= W, got k={k}, W={w}")
    _check_device(vals)
    return torch.ops.skrx.kth_largest(vals, k)


# ------------------------------------------------------------- kernel 3

def extract_plain(scores: torch.Tensor, mask_table: Optional[torch.Tensor],
                  tau: torch.Tensor, k: int, block_n: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    b = scores.shape[0]
    s = _masked_padded(scores, mask_table, block_n).reshape(b, -1, block_n)
    keep = (s >= tau[:, None, None]) & (s != float("-inf"))
    s = torch.where(keep, s, float("-inf"))
    vals, order = torch.sort(s, dim=2, descending=True, stable=True)
    vals, order = vals[:, :, :k], order[:, :, :k]
    ids = order + torch.arange(0, s.shape[1] * block_n, block_n,
                               device=s.device)[None, :, None]
    ids = torch.where(vals == float("-inf"), SENTINEL, ids)
    return vals.reshape(b, -1), ids.to(torch.int32).reshape(b, -1)


def extract(scores: torch.Tensor, tau: torch.Tensor, k: int,
            mask_table: Optional[torch.Tensor] = None, block_n: int = 4096
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidates (B, n_blocks * k) f32 values and int32 global ids: slots
    j*k .. j*k+k-1 hold column block j's top-min(k, #) finite masked
    elements >= ``tau`` (B,) by (value desc, id asc), then (-inf,
    SENTINEL)."""
    _check(scores, "scores", torch.float32, 2)
    _check(tau, "tau", torch.float32, 1)
    b = scores.shape[0]
    mask_table = _check_mask(mask_table, b)
    _check_block_n(block_n)
    if tau.shape[0] != b or not 1 <= k <= block_n:
        raise ValueError(f"need tau (B,) and 1 <= k <= block_n; got tau "
                         f"{tuple(tau.shape)}, k={k}, block_n={block_n}")
    _check_device(scores, tau, mask_table)
    return torch.ops.skrx.extract(scores, tau, k, mask_table, block_n)


# ------------------------------------------------------------- kernel 4

def pruned_merge_plain(vals: torch.Tensor, idx: torch.Tensor, k: int,
                       tau: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    neg_inf = float("-inf")
    v = torch.where(vals >= tau[:, None], vals, neg_inf)

    def by_key(v, i):                      # (value desc, id asc)
        o = torch.sort(i, dim=1, stable=True).indices
        v, i = v.gather(1, o), i.gather(1, o)
        o = torch.sort(v, dim=1, descending=True, stable=True).indices
        return v.gather(1, o), i.gather(1, o)

    v, i = by_key(v, idx)
    dup = torch.zeros_like(v, dtype=torch.bool)
    dup[:, 1:] = (v[:, 1:] == v[:, :-1]) & (i[:, 1:] == i[:, :-1])
    v, i = by_key(torch.where(dup, neg_inf, v), i)
    v, i = v[:, :k], i[:, :k]
    return v, torch.where(v == neg_inf, SENTINEL, i).to(torch.int32)


def pruned_merge(vals: torch.Tensor, idx: torch.Tensor, k: int,
                 tau: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact sorted top-k (B, k) of a (B, W) candidate matrix of f32 values
    and int32 ids: (value desc, id asc), a (value, id) pair repeated across
    lanes taken once, -inf slots with id SENTINEL. ``tau`` (B,) must bound
    each row's k-th largest distinct pair from below (or be -inf)."""
    _check_merge(vals, idx, k, tau)
    return torch.ops.skrx.pruned_merge(vals, idx, k, tau)


def _check_merge(vals: torch.Tensor, idx: torch.Tensor, k: int,
                 tau: Optional[torch.Tensor] = None) -> None:
    """The merge's arguments; ``tau`` None is vmem_topk's -inf."""
    _check(vals, "vals", torch.float32, 2)
    _check(idx, "idx", torch.int32, 2)
    b, w = vals.shape
    if tau is not None:
        _check(tau, "tau", torch.float32, 1)
    tau_shape = (b,) if tau is None else tuple(tau.shape)
    if idx.shape != vals.shape or tau_shape[0] != b or not 1 <= k <= w:
        raise ValueError(f"need idx {tuple(vals.shape)}, tau ({b},) and "
                         f"1 <= k <= W; got idx {tuple(idx.shape)}, tau "
                         f"{tau_shape}, k={k}")
    _check_device(vals, idx, tau)


def vmem_topk(vals: torch.Tensor, idx: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`pruned_merge` without pruning (tau = -inf): the contract of
    ``skrx.ops.pallas.vmem_topk`` (#5), its launches counted as
    ``LAUNCHES["vmem_topk"]``."""
    _check_merge(vals, idx, k)
    return torch.ops.skrx.vmem_topk(vals, idx, k)


# ------------------------------------------------------------- composition

def fold_submaxes(bm: torch.Tensor, k: int) -> torch.Tensor:
    """Fold (B, n_sub) group maxima to width <= max(4096, 2 * k rounded up
    to 128) by pairwise maxima of halves as jnp.maximum takes them (odd
    128-lane counts padded with -inf), as the JAX package does: still a partition of the columns, so tau
    stays a lower bound, and the width stays >= k."""
    max_w = max(_TAU_MAX_W, 2 * (-(-k // GROUPS) * GROUPS))
    w = bm.shape[1]
    while w > max_w:
        if (w // GROUPS) % 2:
            bm = torch.nn.functional.pad(bm, (0, GROUPS), value=float("-inf"))
            w += GROUPS
        half = w // 2
        bm = _jax_amax(torch.stack([bm[:, :half], bm[:, half:]]), 0)
        w = half
    return bm


def blockwise_candidates(scores: torch.Tensor, k: int, block_n: int = 4096,
                         mask_table: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(cand_vals, cand_ids, tau)``: the (B, n_blocks * k) candidate
    superset of each row's masked top-k (see :func:`extract`) and tau (B,),
    the lower bound on the k-th largest masked element that JAX's
    ``blockwise_candidates`` computes (there lane-broadcast to (B, 128))."""
    bm = submax(scores, mask_table, block_n)
    if bm.shape[1] >= k:
        tau = kth_largest(fold_submaxes(bm, k).contiguous(), k)
    else:
        tau = torch.full((scores.shape[0],), float("-inf"),
                         device=scores.device)
    cand_v, cand_i = extract(scores, tau, k, mask_table, block_n)
    return cand_v, cand_i, tau


def blockwise_topk(scores: torch.Tensor, k: int, block_n: int = 4096,
                   mask_table: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (values (B, k) f32, ids (B, k) int32) top-k per row of
    ``scores`` (B, N) f32, excluding ``scores[b, mask_table[b, :]]``
    (entries outside [0, N) are padding; duplicates allowed). Ties break
    toward the lower id; slots beyond the row's unmasked items are (-inf,
    SENTINEL). ``block_n`` is a power of two in [128, 4096] with
    k <= block_n. ``scores`` is read, never written."""
    cand_v, cand_i, tau = blockwise_candidates(scores, k, block_n, mask_table)
    return pruned_merge(cand_v, cand_i, k, tau)


# ------------------------------------------------------------- kernel 6

def _check_probes(b: int, t_ids: torch.Tensor) -> None:
    _check(t_ids, "test ids", torch.int32, 2)
    if t_ids.shape[0] != b:
        raise ValueError(f"test ids have {t_ids.shape[0]} rows, scores {b}")


def rank_count_plain(vals: torch.Tensor, ids: torch.Tensor,
                     s_t: torch.Tensor, t_ids: torch.Tensor) -> torch.Tensor:
    # (B, T, W) compare in slices of 64 probes, so memory stays B x 64 x W
    b, t = s_t.shape
    out = torch.empty((b, t), dtype=torch.int32, device=vals.device)
    v, i = vals[:, None, :], ids[:, None, :]
    for lo in range(0, t, 64):
        s, ti = s_t[:, lo:lo + 64, None], t_ids[:, lo:lo + 64, None]
        above = (v > s) | ((v == s) & (i < ti))
        out[:, lo:lo + 64] = above.sum(2, dtype=torch.int32)
    return out


def rank_key(vals: torch.Tensor, ids: torch.Tensor,
             probe: bool = False) -> torch.Tensor:
    """int64 keys of ``csrc/rank_counts.cu``'s packed key (``rank_key``,
    and ``rank_probe_key`` with ``probe``), top bit flipped so that they
    order as signed int64: a candidate (v, i) counts before a probe (s, t)
    in :func:`rank_count_plain` exactly when key(v, i) < key(s, t, probe).
    High word: a descending order map of the value, -0.0 and +0.0 one;
    low word: the id biased by 2**31. A NaN candidate gets the largest key,
    a NaN probe the smallest. The kernel's map in plain PyTorch; the
    kernel's wrapper does not use it."""
    u = vals.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    mag = u & 0x7FFFFFFF
    u = torch.where(mag == 0, 0, u)
    asc = torch.where(u >= 2 ** 31, u ^ 0xFFFFFFFF, u ^ 0x80000000)
    hi = 0xFFFFFFFF - asc
    key = (hi - 2 ** 31) * 2 ** 32 + (ids.to(torch.int64) + 2 ** 31)
    nan = torch.iinfo(torch.int64).min if probe else torch.iinfo(
        torch.int64).max
    return torch.where(mag > 0x7F800000, nan, key)


def rank_count(vals: torch.Tensor, ids: torch.Tensor, s_t: torch.Tensor,
               t_ids: torch.Tensor) -> torch.Tensor:
    """(B, T) int32: for each probe (``s_t`` (B, T) f32, ``t_ids`` (B, T)
    int32), the number of candidates of its row (``vals`` (B, W) f32,
    ``ids`` (B, W) int32) with value > s or (value == s and id < t). The
    contract of JAX's ``_rank_counts``, for any T."""
    _check(vals, "vals", torch.float32, 2)
    _check(ids, "ids", torch.int32, 2)
    _check(s_t, "s_t", torch.float32, 2)
    b, w = vals.shape
    _check_probes(b, t_ids)
    if ids.shape != vals.shape or s_t.shape != t_ids.shape:
        raise ValueError(f"need ids {tuple(vals.shape)} and s_t == t_ids in "
                         f"shape; got ids {tuple(ids.shape)}, s_t "
                         f"{tuple(s_t.shape)}, t_ids {tuple(t_ids.shape)}")
    if not _on_cuda(vals, ids, s_t, t_ids):
        return rank_count_plain(vals, ids, s_t, t_ids)
    vals, ids = vals.contiguous(), ids.contiguous()
    s_t, t_ids = s_t.contiguous(), t_ids.contiguous()
    t = s_t.shape[1]
    out = torch.empty((b, t), dtype=torch.int32, device=vals.device)
    if b and t:
        _launch("skrx_rank_count", vals.device, vals, ids, b, w, s_t, t_ids,
                t, out)
        LAUNCHES["rank_count"] += 1
    return out


# ------------------------------------------------------------- kernel 7

def rank_lookup_count_plain(vals: torch.Tensor, ids: torch.Tensor,
                            t_ids: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, t = t_ids.shape
    out = torch.empty((b, t), dtype=torch.int32, device=vals.device)
    s_t = torch.empty((b, t), dtype=vals.dtype, device=vals.device)
    v, i = vals[:, None, :], ids[:, None, :]
    for lo in range(0, t, 64):
        ti = t_ids[:, lo:lo + 64, None]
        s = torch.where(i == ti, v, float("-inf")).amax(2, keepdim=True)
        above = (v > s) | ((v == s) & (i < ti))
        out[:, lo:lo + 64] = above.sum(2, dtype=torch.int32)
        s_t[:, lo:lo + 64] = s[:, :, 0]
    return out, torch.isfinite(s_t)


def rank_lookup_count(vals: torch.Tensor, ids: torch.Tensor,
                      t_ids: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ranks (B, T) int32, found (B, T) bool)``: each probe id's score is
    the max value among its row's candidates (``vals`` (B, W) f32, ``ids``
    (B, W) int32) with that id, -inf when none has it; its rank counts the
    candidates with value > s or (value == s and id < t); found means s is
    finite. The contract of JAX's ``_rank_lookup_counts``, for any T."""
    _check(vals, "vals", torch.float32, 2)
    _check(ids, "ids", torch.int32, 2)
    b, w = vals.shape
    _check_probes(b, t_ids)
    if ids.shape != vals.shape:
        raise ValueError(f"need ids {tuple(vals.shape)}, got "
                         f"{tuple(ids.shape)}")
    if not _on_cuda(vals, ids, t_ids):
        return rank_lookup_count_plain(vals, ids, t_ids)
    vals, ids, t_ids = vals.contiguous(), ids.contiguous(), t_ids.contiguous()
    t = t_ids.shape[1]
    out = torch.empty((b, t), dtype=torch.int32, device=vals.device)
    found = torch.empty((b, t), dtype=torch.bool, device=vals.device)
    if b and t:
        _launch("skrx_rank_lookup_count", vals.device, vals, ids, b, w, t_ids,
                t, out, found)
        LAUNCHES["rank_lookup_count"] += 1
    return out, found


def _in_rows(table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(B, T) bool: ``queries[b, j]`` is among ``table[b, :]`` (any order,
    duplicates allowed): a binary search on the sorted rows, no (B, T, L)
    broadcast."""
    return is_member_sorted(torch.sort(table, dim=1).values.contiguous(),
                            queries.contiguous())


def masked_topk_ranks(scores: torch.Tensor, k: int, test_table: torch.Tensor,
                      mask_table: Optional[torch.Tensor] = None,
                      block_n: int = 4096) -> torch.Tensor:
    """(B, T) int32 rank of each ``test_table`` item in its row's masked
    (value desc, id asc) order, exact where it is below k and >= k
    otherwise; an item out of [0, N), in ``mask_table`` or scored -inf,
    +inf or NaN gets k. Counts over the candidates of
    :func:`blockwise_candidates` (every element above a rank-<k item is
    one), so the kernels are submax, kth_largest, extract and
    :func:`rank_count`. Needs N // 128 >= k and k <= block_n."""
    _check(scores, "scores", torch.float32, 2)
    b, n = scores.shape
    _check_probes(b, test_table)
    cand_v, cand_i, _ = blockwise_candidates(scores, k, block_n, mask_table)
    valid = (test_table >= 0) & (test_table < n)
    safe = torch.where(valid, test_table, 0)
    s_t = scores.gather(1, safe.long())
    if mask_table is not None:
        valid &= ~_in_rows(mask_table, safe)
    valid &= torch.isfinite(s_t)
    ranks = rank_count(cand_v, cand_i, s_t, safe)
    return torch.where(valid, ranks, k)


# ------------------------------------------------------------- kernel 8

def direct_rank_plain(scores: torch.Tensor, mask_table: Optional[torch.Tensor],
                      t_ids: torch.Tensor, k: int) -> torch.Tensor:
    b, n = scores.shape
    out = torch.full_like(t_ids, k)
    if not n:
        return out
    s = scores if mask_table is None else _masked_padded(scores, mask_table, n)
    valid = (t_ids >= 0) & (t_ids < n)
    s_t = s.gather(1, torch.where(valid, t_ids, 0).long())
    rows, cols = (valid & torch.isfinite(s_t)).nonzero(as_tuple=True)
    # each found probe counts the columns whose packed key is below its own
    # (a NaN column has the largest key, so it never counts), in slices of
    # probes that compare at most 2**20 keys at once
    keys = rank_key(s, torch.arange(n, dtype=torch.int32,
                                    device=s.device).expand(b, n))
    probes = rank_key(s_t[rows, cols], t_ids[rows, cols], probe=True)
    step = max(1, 2 ** 20 // n)
    for lo in range(0, rows.numel(), step):
        r = rows[lo:lo + step]
        out[r, cols[lo:lo + step]] = (keys[r] < probes[lo:lo + step, None]
                                      ).sum(1, dtype=torch.int32)
    return out


def direct_rank(scores: torch.Tensor, t_ids: torch.Tensor, k: int,
                mask_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T) int32 exact rank of each test id over its whole masked row of
    ``scores`` (B, N) f32, in (value desc, id asc) order; a test id out of
    [0, N), in ``mask_table`` (B, L) int32 (entries outside [0, N) are
    padding) or scored -inf, +inf or NaN gets ``k``. The contract of JAX's
    ``masked_topk_ranks_small``, for any T and N."""
    _check(scores, "scores", torch.float32, 2)
    b, n = scores.shape
    _check_probes(b, t_ids)
    mask_table = _check_mask(mask_table, b)
    if not _on_cuda(scores, t_ids, mask_table):
        return direct_rank_plain(scores, mask_table, t_ids, k)
    scores, t_ids = scores.contiguous(), t_ids.contiguous()
    t = t_ids.shape[1]
    out = torch.empty((b, t), dtype=torch.int32, device=scores.device)
    if b and t:
        _launch("skrx_direct_rank", scores.device, scores, b, n, mask_table,
                0 if mask_table is None else mask_table.shape[1], t_ids, t, k,
                out)
        LAUNCHES["direct_rank"] += 1
    return out


def masked_topk_ranks_small(scores: torch.Tensor, k: int,
                            test_table: torch.Tensor,
                            mask_table: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """:func:`masked_topk_ranks` by a direct count over the whole row
    (kernel :func:`direct_rank`): exact at any rank, for catalogs too small
    for the candidate prune."""
    return direct_rank(scores, test_table, k, mask_table)
