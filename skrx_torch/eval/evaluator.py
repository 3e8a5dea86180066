"""Ranking evaluation: MetricReport, RankingEvaluator, EarlyStopping (the
port of ``skrx.eval.evaluator``).

The whole loop stays on the evaluator's device: per batch of users the
ranks or top-k of the test items are taken, the cumulative metrics computed
and the per-batch sums accumulated on the device; one copy to the host ends
the call. Metrics are averaged over users, with ``top_show`` columns
selected, as in the JAX package. Strategies (``eval_mode``):

- "full": the model's ``predict`` gives (B, N) scores per batch;
  :func:`eval_score_matrix_device` masks train items and ranks each test
  item (the rank-count CUDA kernels on a card);
- "chunked": ``predict_chunk`` scores ``chunk_size`` items at a time; each
  chunk's masked top-k merges into the running (B, k) best through
  ``vmem_topk``, then the hits against the test table;
- "fused": dot models and towers (:func:`fused_family`);
  :func:`~skrx_torch.ops.kernels.dot_topk.dot_topk_ranks` ranks each test
  item without any (B, N) scores (the fused score-and-select kernels and
  ``rank_lookup_count``);
- "topk": the model's ``predict_topk`` gives each batch's train-masked
  top-k, the catalog split over the mesh's model axis (two-stage merge,
  :func:`~skrx_torch.parallel.sharded_dot_topk`), then the hits against
  the test table; it needs a mesh whose model axis is above 1;
- "auto": "topk" under such a mesh for a model with ``predict_topk``;
  else "chunked" for a model with ``predict_chunk`` when the catalog has
  ``chunk_threshold`` items or more (a memory rule), else "full", as the
  JAX package routes off a TPU (its TPU-measured choice of "fused" is not
  carried).

Under a mesh (``mesh``) every rank evaluates together. When the batch size
divides by the data axis, each data index scores its rows of every batch
and the metric sums are all-reduced over the data axis, so every rank
returns the same report; otherwise every rank scores whole batches. The
fused route does not run under a model axis above 1.
"""
import itertools
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.kernels.dot_topk import dot_topk_ranks, pack_items
from ..ops.kernels.topk_blocks import vmem_topk
from ..ops.metrics import (ID2METRIC, METRIC2ID, eval_score_matrix_device,
                           hits_against_padded_truth, hits_from_ranks,
                           ranking_metrics_from_hits,
                           topk_scores_and_indices)
from ..parallel import data_sharding, model_parallel_size
from ..parallel.distributed import all_reduce_sum
from ..utils import resolve_device

__all__ = ["MetricReport", "RankingEvaluator", "EarlyStopping",
           "fused_family"]

# ANSI colors (the file handler strips these)
_COLORS = ["\x1b[31m", "\x1b[32m", "\x1b[33m", "\x1b[34m", "\x1b[35m",
           "\x1b[36m"]
_RESET = "\x1b[0m"
_EVAL_MODES = ("auto", "full", "chunked", "fused", "topk")


def fused_family(model) -> Optional[str]:
    """How the fused route gets a model's (or model class's) dot factors:
    "dot" from ``_chunk_embeddings() -> (u_all, i_all)`` (and
    ``_chunk_bias``), "tower" from ``_topk_factors(None) -> (None, table,
    bias)`` with each batch's ``_cached_user_vectors``; None when it has
    neither, or applies a transform after the dot (``_topk_score_fn``)."""
    if getattr(model, "_topk_score_fn", None) is not None:
        return None
    if hasattr(model, "_chunk_embeddings"):
        return "dot"
    if hasattr(model, "_topk_factors") and hasattr(model,
                                                   "_cached_user_vectors"):
        return "tower"
    return None


def _colored(cells) -> str:
    return "\t".join(c + f"{cell}".ljust(12) + _RESET
                     for c, cell in zip(itertools.cycle(_COLORS), cells))


class MetricReport:
    """Ordered metric -> value mapping with colored string rendering."""

    def __init__(self, metrics: Sequence[str], values: Sequence[float]):
        if len(metrics) != len(values):
            raise ValueError(f"lengths of metrics and values differ "
                             f"({len(metrics)}!={len(values)})")
        self._results = OrderedDict(zip(metrics, [float(v) for v in values]))

    def metrics(self):
        return self._results.keys()

    def values(self):
        return self._results.values()

    def items(self):
        return self._results.items()

    @property
    def results(self) -> Dict[str, float]:
        return self._results

    @property
    def metrics_str(self) -> str:
        return _colored(self.metrics())

    @property
    def values_str(self) -> str:
        return _colored(f"{v:.8f}" for v in self.values())

    def __getitem__(self, item):
        if item not in self._results:
            raise KeyError(item)
        return self._results[item]

    def __str__(self):
        return str(self._results)


def _pad_table(user_dict: Dict[int, np.ndarray], users: np.ndarray,
               pad_id: int, bucket: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """(len(users), maxLen) padded item table + lengths for the given users;
    maxLen is rounded up to a multiple of ``bucket``."""
    lengths = np.array([len(user_dict.get(int(u), ())) for u in users],
                       dtype=np.int32)
    max_len = max(int(lengths.max()) if len(lengths) else 1, 1)
    max_len = ((max_len + bucket - 1) // bucket) * bucket
    table = np.full((len(users), max_len), pad_id, dtype=np.int32)
    for i, u in enumerate(users):
        items = user_dict.get(int(u))
        if items is not None and len(items):
            table[i, : len(items)] = items
    return table, lengths


class RankingEvaluator:
    """Evaluate a model's top-K ranking quality on ``device`` (``cuda`` unless
    given; absent CUDA raises), on one rank of ``mesh`` when given.

    The model must provide ``predict(users) -> (B, N) scores``.
    """

    # device-resident batch tables kept for this many user sets (fit()
    # alternates validation and test users)
    _LRU_SLOTS = 4
    # above this many bytes of batch tables, upload them one batch at a time
    table_cache_budget = 1 << 30

    def __init__(self, user_train_dict: Optional[Dict[int, np.ndarray]],
                 user_test_dict: Dict[int, np.ndarray],
                 metric: Union[None, str, Tuple[str, ...], List[str]] = None,
                 top_k: Union[int, List[int], Tuple[int, ...]] = 50,
                 batch_size: int = 256, num_thread: int = 8,
                 eval_mode: str = "auto", chunk_size: int = 65536,
                 chunk_threshold: int = 131072,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None):
        if metric is None:
            metric = ["Precision", "Recall", "MAP", "NDCG", "MRR"]
        elif isinstance(metric, str):
            metric = [metric]
        elif isinstance(metric, (tuple, list)):
            metric = list(metric)
        else:
            raise TypeError(f"invalid 'metric' type: {type(metric).__name__}")
        for m in metric:
            if m not in METRIC2ID:
                raise ValueError(f"'{m}' is not in {tuple(METRIC2ID)}")
        if eval_mode not in _EVAL_MODES:
            raise ValueError(f"unknown eval_mode {eval_mode!r}")
        tp = model_parallel_size(mesh) > 1
        if eval_mode == "topk" and not tp:
            raise ValueError("eval_mode='topk' needs a mesh whose model axis "
                             "is above 1")
        if eval_mode == "fused" and tp:
            raise ValueError("eval_mode='fused' runs on one rank's whole "
                             "catalog; under a model axis above 1 use "
                             "'topk' or 'auto'")
        if chunk_size <= 0 or chunk_threshold <= 0:
            raise ValueError(f"chunk_size and chunk_threshold must be > 0, "
                             f"got {chunk_size}, {chunk_threshold}")
        if not user_test_dict:
            raise ValueError("'user_test_dict' cannot be empty.")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.user_pos_train = user_train_dict if user_train_dict is not None \
            else {}
        self.user_pos_test = user_test_dict
        self.metrics_num = len(metric)
        self.metrics = tuple(METRIC2ID[m] for m in metric)
        self.num_thread = num_thread        # API parity; unused
        self.batch_size = batch_size
        self.eval_mode = eval_mode
        self.chunk_size = int(chunk_size)
        self.chunk_threshold = int(chunk_threshold)
        if isinstance(top_k, int):
            self.max_top = top_k
            self.top_show = np.arange(top_k) + 1
        else:
            self.max_top = max(top_k)
            self.top_show = np.sort(top_k)
        self._table_key = None
        self._lru: "OrderedDict[tuple, list]" = OrderedDict()

    def set_train_data(self, user_train_dict: Optional[
            Dict[int, np.ndarray]] = None) -> None:
        """Mask these training items from now on; the padded tables and the
        device batches built from the old ones are dropped."""
        self.user_pos_train = user_train_dict if user_train_dict is not None \
            else {}
        self._drop_tables()

    def set_test_data(self, user_test_dict: Dict[int, np.ndarray]) -> None:
        """Rank these test items from now on; the padded tables and the
        device batches built from the old ones are dropped."""
        if not user_test_dict:
            raise ValueError("'user_test_dict' cannot be empty.")
        self.user_pos_test = user_test_dict
        self._drop_tables()

    def _drop_tables(self) -> None:
        self._table_key = None
        self._lru.clear()

    @property
    def metrics_list(self) -> List[str]:
        return [f"{ID2METRIC[mid]}@{k}" for mid in self.metrics
                for k in self.top_show]

    @property
    def metrics_str(self) -> str:
        return _colored(self.metrics_list)

    def _tables_for(self, users: np.ndarray, num_items: int):
        """Padded train/test tables for the given users, built once at the
        full width (the widest list of any user), so every batch has one
        shape."""
        if self._table_key != num_items:
            all_users = np.arange(
                max((max(self.user_pos_test, default=0),
                     max(self.user_pos_train, default=0))) + 1, dtype=np.int32)
            self._train_table, _ = _pad_table(self.user_pos_train, all_users,
                                              num_items)
            self._test_table, self._test_len = _pad_table(self.user_pos_test,
                                                          all_users, num_items)
            self._table_key = num_items
        return (self._train_table[users], self._test_table[users],
                self._test_len[users])

    def _batch_rows(self) -> slice:
        """The rows of every batch this rank scores: its data index's
        under a mesh whose data axis divides the batch size, else all."""
        mesh, bs = self.mesh, self.batch_size
        if mesh is None or mesh.data_size == 1 or bs % mesh.data_size:
            return slice(None)
        blocks = data_sharding(mesh, bs)
        return slice(blocks.lo, blocks.hi)

    def _dev_batches(self, users: np.ndarray, num_items: int):
        """Per batch ``(batch_users, train_t, test_t, test_len (>= 1),
        weight)`` on the device, the last batch padded with its last user
        (weight 0), this rank's rows of each (:meth:`_batch_rows`). Kept
        across evaluations of the same users (LRU of ``_LRU_SLOTS``); above
        ``table_cache_budget`` bytes a generator uploads one batch at a
        time."""
        bs = self.batch_size
        n_users = len(users)
        rows = self._batch_rows()

        def put(x):
            return torch.as_tensor(x).to(self.device)

        def build():
            for lo in range(0, n_users, bs):
                batch_users = users[lo: lo + bs]
                n_real = len(batch_users)
                if n_real < bs:
                    batch_users = np.concatenate(
                        [batch_users,
                         np.full(bs - n_real, batch_users[-1], np.int32)])
                train_table, test_table, test_len = self._tables_for(
                    batch_users, num_items)
                weight = (np.arange(bs) < n_real) & (test_len > 0)
                yield (put(batch_users[rows].astype(np.int64)),
                       put(train_table[rows]), put(test_table[rows]),
                       put(np.maximum(test_len[rows], 1)),
                       put(weight[rows].astype(np.float32)))

        self._tables_for(users[:1], num_items)      # width probe
        w = self._train_table.shape[1] + self._test_table.shape[1]
        total_bytes = 4 * (-(-n_users // bs) * bs) * (w + 3)
        if total_bytes > self.table_cache_budget:
            return build()
        key = (num_items, bs, hash(users.tobytes()))
        if key in self._lru:
            self._lru.move_to_end(key)
        else:
            self._lru[key] = list(build())
            while len(self._lru) > self._LRU_SLOTS:
                self._lru.popitem(last=False)
        return self._lru[key]

    def per_user_metrics(self, scores: torch.Tensor, train_table: torch.Tensor,
                         test_table: torch.Tensor,
                         test_len: torch.Tensor) -> torch.Tensor:
        """(B, n_metrics, max_top) f32 metrics of one batch of scores."""
        return eval_score_matrix_device(scores, train_table, test_table,
                                        test_len, self.metrics, self.max_top)

    def _test_users(self, test_users: Optional[Iterable[int]]) -> np.ndarray:
        """The users to evaluate: those given that have test items, or every
        user with test items."""
        if test_users is not None:
            users = [int(u) for u in test_users if int(u) in self.user_pos_test]
        else:
            users = [int(u) for u in self.user_pos_test.keys()]
        if not users:
            raise ValueError("no test users")
        return np.asarray(users, dtype=np.int32)

    def evaluate(self, model, test_users: Optional[Iterable[int]] = None
                 ) -> MetricReport:
        """Metrics of ``model`` over ``test_users`` (default: every user with
        test items), by the strategy of ``eval_mode`` (see the module
        docstring); every strategy computes the same metrics."""
        num_items = (getattr(model, "_eval_width", None)
                     or getattr(model, "num_items", None))
        mode = self.eval_mode
        if mode in ("fused", "chunked", "topk") and num_items is None:
            raise ValueError(f"eval_mode={mode!r} needs model.num_items")
        if mode == "topk" or (mode == "auto" and num_items is not None
                              and model_parallel_size(self.mesh) > 1
                              and hasattr(model, "predict_topk")):
            return self.evaluate_topk(model, num_items, test_users)
        if mode == "fused":
            return self.evaluate_fused(model, num_items, test_users)
        if mode == "chunked" or (
                mode == "auto" and num_items is not None
                and num_items >= self.chunk_threshold
                and hasattr(model, "predict_chunk")):
            return self.evaluate_chunked(model, num_items, self.chunk_size,
                                         test_users)
        return self._evaluate_full(model, test_users)

    def _sum_batches(self, users: np.ndarray, num_items: int,
                     per_user) -> MetricReport:
        """The report of ``per_user(bi, batch_users, train_t, test_t,
        test_len) -> (B, n_metrics, max_top)`` over the batches of
        ``users``, summed on the device (padding rows weigh 0)."""
        metric_sum = None
        for bi, (batch_users, train_t, test_t, test_len, weight) in \
                enumerate(self._dev_batches(users, num_items)):
            batch_sum = torch.sum(
                per_user(bi, batch_users, train_t, test_t, test_len)
                * weight[:, None, None], dim=0)
            metric_sum = batch_sum if metric_sum is None \
                else metric_sum + batch_sum
        if self._batch_rows() != slice(None):    # each data index's rows
            all_reduce_sum(metric_sum, self.mesh.data_group,
                           self.mesh.data_size)
        final = metric_sum.double().cpu().numpy() / len(users)  # (M, top)
        return MetricReport(self.metrics_list,
                            final[:, self.top_show - 1].reshape(-1))

    def _evaluate_full(self, model, test_users: Optional[Iterable[int]] = None
                       ) -> MetricReport:
        if not hasattr(model, "predict"):
            raise TypeError("the model must have a 'predict' method")
        users = self._test_users(test_users)
        bs = self.batch_size

        def predict(batch_users):
            return torch.as_tensor(model.predict(batch_users)).to(
                device=self.device, dtype=torch.float32)

        # the catalog width comes from the first batch's scores
        first_users = users[:bs] if len(users) >= bs else np.concatenate(
            [users, np.full(bs - len(users), users[-1], np.int32)])
        first_scores = predict(first_users[self._batch_rows()].astype(
            np.int64))
        return self._sum_batches(
            users, int(first_scores.shape[1]),
            lambda bi, batch_users, *tables: self.per_user_metrics(
                first_scores if bi == 0 else predict(batch_users), *tables))

    def evaluate_chunked(self, model, num_items: int,
                         chunk_size: Optional[int] = None,
                         test_users: Optional[Iterable[int]] = None
                         ) -> MetricReport:
        """Metrics without the (B, N) score matrix: per batch, the model's
        ``predict_chunk(users, lo, hi)`` scores ``chunk_size`` items at a
        time (default ``self.chunk_size``); each chunk's masked top-k
        (train ids shifted by the chunk's offset) merges into the running
        (B, k) best through ``vmem_topk``, whose empty slots never hit a
        test item; then the hits against the test table."""
        if not hasattr(model, "predict_chunk"):
            raise TypeError("chunked evaluation needs the model's "
                            "predict_chunk(users, lo, hi)")
        chunk_size = int(chunk_size or self.chunk_size)
        k = self.max_top

        def per_user(bi, batch_users, train_t, test_t, test_len):
            bs = batch_users.shape[0]
            best_v = torch.full((bs, k), float("-inf"), device=self.device)
            # never a test id nor the tables' pad id (num_items)
            best_i = torch.full((bs, k), num_items + 1, dtype=torch.int32,
                                device=self.device)
            for lo in range(0, num_items, chunk_size):
                hi = min(lo + chunk_size, num_items)
                scores = torch.as_tensor(model.predict_chunk(
                    batch_users, lo, hi)).to(device=self.device,
                                             dtype=torch.float32)
                shifted = train_t - lo      # ids of other chunks: padding
                shifted = torch.where(shifted < 0, hi - lo, shifted)
                vals, idx = topk_scores_and_indices(scores, min(k, hi - lo),
                                                    mask_table=shifted)
                best_v, best_i = vmem_topk(torch.cat([best_v, vals], 1),
                                           torch.cat([best_i, idx + lo], 1), k)
            return ranking_metrics_from_hits(
                hits_against_padded_truth(best_i, test_t), test_len,
                self.metrics)

        return self._sum_batches(self._test_users(test_users), num_items,
                                 per_user)

    def evaluate_topk(self, model, num_items: int,
                      test_users: Optional[Iterable[int]] = None
                      ) -> MetricReport:
        """Metrics from the model's ``predict_topk(users, k, train_table)
        -> (values, global ids)``, the train-masked top-k with the catalog
        split over the mesh's model axis, so no rank builds the (B, N)
        scores: -inf slots and a top-k shorter than k (a catalog below k)
        never hit a test item; then the hits against the test table."""
        if not hasattr(model, "predict_topk"):
            raise TypeError("topk evaluation needs the model's "
                            "predict_topk(users, k, train_table)")
        k = self.max_top
        sentinel = num_items + 1   # never a test id nor the pad id

        def per_user(bi, batch_users, train_t, test_t, test_len):
            vals, idx = model.predict_topk(batch_users, k, train_t)
            idx = torch.where(torch.isneginf(vals), sentinel, idx)
            if idx.shape[1] < k:
                idx = torch.cat([idx, idx.new_full(
                    (idx.shape[0], k - idx.shape[1]), sentinel)], 1)
            return ranking_metrics_from_hits(
                hits_against_padded_truth(idx, test_t), test_len,
                self.metrics)

        return self._sum_batches(self._test_users(test_users), num_items,
                                 per_user)

    def evaluate_fused(self, model, num_items: int,
                       test_users: Optional[Iterable[int]] = None
                       ) -> MetricReport:
        """Metrics of a model with plain dot factors (:func:`fused_family`)
        without any (B, N) scores: the item table (and bias) is packed once,
        then per batch :func:`dot_topk_ranks` ranks each test item with the
        batch's train table as the mask; hits and metrics follow on the
        device. A dot model's user vectors are rows of ``u_all``, a tower's
        its encoder's output for the batch."""
        family = fused_family(model)
        if family is None:
            raise TypeError("fused evaluation needs the model's plain dot "
                            "factors (_chunk_embeddings or _topk_factors, "
                            "no _topk_score_fn)")
        users = self._test_users(test_users)
        k = self.max_top
        if family == "dot":
            u_all, i_all = model._chunk_embeddings()
            u_all = u_all.detach().to(device=self.device, dtype=torch.float32)
            bias = model._chunk_bias() if hasattr(model, "_chunk_bias") \
                else None

            def user_vectors(batch_users):
                return u_all[batch_users]
        else:
            _, i_all, bias = model._topk_factors(None)

            def user_vectors(batch_users):
                return model._cached_user_vectors(batch_users).to(
                    device=self.device, dtype=torch.float32)
        packed = pack_items(i_all.to(self.device),
                            None if bias is None else bias.to(self.device))

        def per_user(bi, batch_users, train_t, test_t, test_len):
            ranks = dot_topk_ranks(user_vectors(batch_users), None, None, k,
                                   test_t, mask_table=train_t, packed=packed)
            return ranking_metrics_from_hits(hits_from_ranks(ranks, k),
                                             test_len, self.metrics)

        return self._sum_batches(users, num_items, per_user)


class EarlyStopping:
    """Track the best MetricReport on one key metric with patience."""

    def __init__(self, metric: str = "NDCG@10", patience: int = 100):
        self._metric = metric
        self._patience = patience
        self._best_score: Optional[MetricReport] = None
        self._counter = 0

    def __call__(self, val_result: MetricReport) -> bool:
        if self._best_score is None:
            self._best_score = val_result
        elif val_result[self.key_metric] <= self._best_score[self.key_metric]:
            self._counter += 1
            if self._counter >= self._patience > 0:
                return True
        else:
            self._best_score = val_result
            self._counter = 0
        return False

    @property
    def key_metric(self) -> str:
        return self._metric

    @property
    def best_result(self) -> MetricReport:
        if self._best_score is not None:
            return self._best_score
        return MetricReport(["None"], [0])

    def get_state(self) -> dict:
        best = None
        if self._best_score is not None:
            best = (list(self._best_score.metrics()),
                    list(self._best_score.values()))
        return {"counter": self._counter, "best": best}

    def set_state(self, state: dict) -> None:
        self._counter = state.get("counter", 0)
        best = state.get("best")
        if best is not None:
            self._best_score = MetricReport(best[0], best[1])
