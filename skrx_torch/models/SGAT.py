"""SGAT — sequence-graph attention with translation scoring: the port of
``skrx.models.SGAT``.

Same config fields, defaults and checks. The item-transition graph is built
on the host from each user's consecutive training items (head -> tail):
one occurrence per (tail, head, user) step, grouped by edge, the edges
sorted by (tail, head) (:func:`build_sgat_graph`); it is cached as
``_sgat_data/<data name>/graph_elem.npz`` beside the data directory, the
JAX package's file and keys. Parameters ``user_emb`` (U, d) and
``item_emb`` (N, d), 0.01 times a normal truncated at 2, and ``item_bias``
(N,) zeros.

Each of ``n_layers`` layers (:func:`sgat_propagate`) scores every
occurrence by ``-l2d(item[head] + user[u], item[tail])`` (``l2d(a, b) =
sqrt(|a - b|^2 + 1e-12)``), min-max normalises the scores over the whole
graph (``(s - min) / (max - min + 1e-12)``, ``mexp``), sums their
exponentials into each edge and each edge's into its tail row, and adds
``A(att) @ items`` with ``att = edge_sum / (row_sum + 1e-6)[tail]``:
kernel #11 with the attention as traced per-edge weights
(:func:`~skrx_torch.ops.graph.propagate_weighted`), differentiable in both.
Every ``graph_impl`` runs the kernel ("mxu_bf16" with bf16 messages).
The attention's two sums and the gradients of its four gathers go
through the kernel too, over the five index sets the graph fixes
(occurrences by head, user, tail and edge, edges by tail), each laid out
once with the graph (:func:`~skrx_torch.ops.scatter.fixed_index`): every
sum in one order from run to run, and no step sorts. The
epochs come from :class:`SequentialPairwiseEpochPipeline` (``n_seqs``
previous items, pre-padded with id N, ``n_next`` next items and as many
negatives); a step propagates the whole graph, and takes the summed BPR
loss of ``-l2d(head + user, item) + bias`` over the next slots (head: the
last item plus the mean of the sequence's real items) plus ``reg * 0.5``
times the weighted L2 of the batch's rows, then one dense Adam step (on
one device over the three tables as one flat vector in JAX's ravel order
``item_bias, item_emb, user_emb``, JAX's flat step:
:class:`~skrx_torch.models.common.FlatTrainStep`; on a card each epoch a
CUDA graph of the whole step, the graph's five layers of kernel #11
inside it, replayed a batch).

``evaluate()`` propagates once and freezes the table that scoring and
serving reuse until the next epoch. ``predict`` scores by the direct
``l2d`` a chunk of items at a time (never a (B, N, d) tensor); test
sequences are each user's last ``n_seqs`` training items, pre-padded (a
user without training items: all pad). ``_topk_score_fn``, the expanded
form, takes the fused route off this model: it evaluates full and chunked.

Under a mesh whose model axis is above 1 ``user_emb`` and ``item_emb``
keep only their rank's rows over the model axis (the JAX package's
tensor-parallel ``_finalize_setup_flat``): a step gathers both whole
(differentiable, the backward summing over the data axis) for the graph
over every item and user, scoring gathers them once, and ``item_bias``
stays whole. Each rank trains on its data index's slice of the batch. The
graph cache is written under a name of the process's own and then moved
into place, so the ranks of a mesh may build it at once.
"""
import os
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..convert import bprmf_params_from_jax
from ..ops.graph import WeightedGraph, propagate_weighted, \
    weighted_graph_from_coo
from ..ops.initializers import get_initializer
from ..ops.scatter import FixedIndex, fixed_gather, fixed_index, fixed_sum
from ..run_config import RunConfig
from ..utils import ModelConfig, pad_sequences
from .common import (GRAPH_IMPLS, CachedUserVecChunkMixin,
                     EpochTrainedRecommender, FlatTrainStep, as_user_tensor,
                     make_optimizer, make_train_step, mxu_msg_dtype,
                     resolve_graph_impl)
from .pipeline import SequentialPairwiseEpochPipeline

__all__ = ["SGAT", "SGATConfig", "SGATGraph", "build_sgat_graph",
           "sgat_propagate", "sgat_loss", "l2d"]

_GRAPH_KEYS = ("occ_user", "occ_head", "occ_tail", "occ_edge", "edge_tail",
               "edge_head")
# items scored at once by predict: (B, chunk, d) f32 differences
_PREDICT_CHUNK = 8192


class SGATConfig(ModelConfig):
    lr: float = 0.001
    reg: float = 1e-4
    n_layers: int = 5
    n_seqs: int = 5
    n_next: int = 3
    embed_size: int = 64
    graph_impl: str = "auto"  # auto | segment | mxu | mxu_bf16
    batch_size: int = 1024
    epochs: int = 500
    early_stop: int = 100

    def _validate(self):
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.reg, float) and self.reg >= 0
              and isinstance(self.n_layers, int) and self.n_layers >= 0
              and isinstance(self.n_seqs, int) and self.n_seqs > 0
              and isinstance(self.n_next, int) and self.n_next > 0
              and isinstance(self.embed_size, int) and self.embed_size > 0
              and self.graph_impl in GRAPH_IMPLS
              and isinstance(self.batch_size, int) and self.batch_size > 0)
        if not ok:
            raise ValueError(f"invalid SGAT config: {self}")


def build_sgat_graph(user_pos_train: Dict[int, np.ndarray]
                     ) -> Tuple[np.ndarray, ...]:
    """``(occ_user, occ_head, occ_tail, occ_edge, edge_tail, edge_head)``
    int32, as JAX's ``_build_sgat_graph``: one occurrence per consecutive
    (head, tail) of a user's sequence, grouped by edge with the edges in
    (tail, head) order; within an edge, users ascending and each user's
    steps in time order."""
    heads, tails, users = [], [], []
    for user, seq in user_pos_train.items():
        seq = np.asarray(seq, np.int64)
        heads.append(seq[:-1])
        tails.append(seq[1:])
        users.append(np.full(max(len(seq) - 1, 0), user, np.int64))
    if not heads:
        empty = np.zeros(0, np.int32)
        return (empty,) * 6
    h, t, u = (np.concatenate(a) for a in (heads, tails, users))
    # a stable sort by (tail, head) keeps each edge's occurrences in the
    # order of the users and their steps
    order = np.argsort(h, kind="stable")
    order = order[np.argsort(t[order], kind="stable")]
    h, t, u = h[order], t[order], u[order]
    first = np.ones(len(h), bool)
    first[1:] = (h[1:] != h[:-1]) | (t[1:] != t[:-1])
    occ_edge = np.cumsum(first) - 1
    i32 = lambda a: a.astype(np.int32)  # noqa: E731
    return (i32(u), i32(h), i32(t), i32(occ_edge), i32(t[first]),
            i32(h[first]))


class SGATGraph(NamedTuple):
    """The occurrences and edges on a device: the (tail, head, user)
    occurrences with their edge, each edge's tail, the edges as a
    :class:`WeightedGraph` (src = head, dst = tail), and the first five
    as the index sets the attention sums over (``fixed``: occurrences into
    users, items by head, items by tail and edges; edges into items)."""
    occ_user: torch.Tensor        # (O,) int64
    occ_head: torch.Tensor
    occ_tail: torch.Tensor
    occ_edge: torch.Tensor        # (O,) int64, ascending
    edge_tail: torch.Tensor       # (E,) int64, ascending
    items: WeightedGraph
    fixed: Tuple[FixedIndex, ...]

    def to(self, device) -> "SGATGraph":
        return SGATGraph(*(t.to(device) for t in self[:5]),
                         self.items.to(device),
                         tuple(f.to(device) for f in self.fixed))


def sgat_graph(arrays: Tuple[np.ndarray, ...], num_items: int,
               num_users: int, msg_dtype: torch.dtype = torch.float32,
               device="cpu") -> SGATGraph:
    """The :class:`SGATGraph` of :func:`build_sgat_graph`'s arrays over
    ``num_users`` users and ``num_items`` items."""
    *occurrences, edge_tail, edge_head = arrays

    def put(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)
    rows = (num_users, num_items, num_items, len(edge_tail), num_items)
    return SGATGraph(
        *map(put, occurrences), put(edge_tail),
        weighted_graph_from_coo(edge_head, edge_tail, num_items, msg_dtype,
                                device=device),
        tuple(fixed_index(ids, n, device)
              for ids, n in zip((*occurrences, edge_tail), rows)))


def l2d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sqrt(sum((a - b)^2, -1) + 1e-12)``: finite, with a zero gradient,
    where a == b."""
    return torch.sqrt(torch.sum((a - b) ** 2, -1) + 1e-12)


def sgat_attention(graph: SGATGraph, items: torch.Tensor,
                   user_emb: torch.Tensor) -> torch.Tensor:
    """(E,) attention of each edge for one layer: the occurrences' scores
    min-max normalised over the graph, exponentiated, summed into their
    edge and normalised by their tail row's sum (``+ 1e-6``). The min and
    max split their gradient evenly among ties, as ``jnp.min`` and
    ``jnp.max`` do. The sums, and the gradients of the gathers, run
    through kernel #11 over the graph's fixed index sets (an indexing
    gradient would sort its indices every step, slow on hub items of
    thousands of occurrences)."""
    by_user, by_head, by_tail, by_edge, edge_by_tail = graph.fixed
    h_e = fixed_gather(items, by_head) + fixed_gather(user_emb, by_user)
    logit = -l2d(h_e, fixed_gather(items, by_tail))
    lo, hi = torch.amin(logit), torch.amax(logit)
    exp_logit = torch.exp((logit - lo) / (hi - lo + 1e-12))
    edge_sum = fixed_sum(exp_logit, by_edge)
    row_sum = fixed_sum(edge_sum, edge_by_tail)
    return edge_sum / fixed_gather(row_sum + 1e-6, edge_by_tail)


def sgat_propagate(graph: SGATGraph, item_emb: torch.Tensor,
                   user_emb: torch.Tensor, n_layers: int) -> torch.Tensor:
    """(N, d) item table after ``n_layers`` attention layers, each
    ``items + A(att) @ items`` through kernel #11."""
    items = item_emb
    for _ in range(n_layers):
        att = sgat_attention(graph, items, user_emb)
        items = items + propagate_weighted(graph.items, items, att)
    return items


def head_embedding(items: torch.Tensor, head_seq: torch.Tensor,
                   pad_id: int) -> torch.Tensor:
    """(B, d): the sequence's last item plus the mean of its real items
    (pad id rows are zero)."""
    padded = torch.cat([items, items.new_zeros((1, items.shape[1]))])
    seq_embs = padded[head_seq]
    n_real = torch.sum((head_seq != pad_id).to(items.dtype), 1, keepdim=True)
    his = torch.sum(seq_embs, 1) / torch.clamp(n_real, min=1.0)
    return padded[head_seq[:, -1]] + his


def sgat_loss(graph: SGATGraph, params: Dict[str, torch.Tensor],
              cfg: SGATConfig, users: torch.Tensor, pos: torch.Tensor,
              neg: torch.Tensor, w: torch.Tensor,
              head_seq: torch.Tensor) -> torch.Tensor:
    """One batch's loss; ``params`` by the model's parameter names (the
    whole graph is propagated)."""
    user_emb, bias = params["user_emb"], params["item_bias"]
    items = sgat_propagate(graph, params["item_emb"], user_emb,
                           cfg.n_layers)
    b = users.shape[0]
    pos, neg = pos.reshape(b, -1), neg.reshape(b, -1)
    user_e = user_emb[users]
    head_e = head_embedding(items, head_seq, items.shape[0])
    pre = (head_e + user_e)[:, None, :]
    pos_e, neg_e = items[pos], items[neg]
    y_pos = -l2d(pre, pos_e) + bias[pos]
    y_neg = -l2d(pre, neg_e) + bias[neg]
    loss = torch.sum(torch.sum(-torch.nn.functional.logsigmoid(
        y_pos - y_neg), 1) * w)
    reg_term = 0.5 * torch.sum(
        (torch.sum(user_e ** 2 + head_e ** 2, -1)
         + torch.sum(pos_e ** 2 + neg_e ** 2, (1, 2))
         + torch.sum(bias[pos] ** 2 + bias[neg] ** 2, 1)) * w)
    return loss + cfg.reg * reg_term


class SGAT(CachedUserVecChunkMixin, EpochTrainedRecommender):
    _JAX_PARAMS = ("user_emb", "item_emb", "item_bias")

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, SGATConfig(**model_config), device)
        cfg = self.config
        n, d = self.num_items, cfg.embed_size
        user_pos = self.dataset.train_data.to_user_dict_by_time()
        impl = resolve_graph_impl(cfg.graph_impl)
        self.graph = sgat_graph(self._load_graph(user_pos), n,
                                self.num_users, mxu_msg_dtype(impl),
                                device=self.device)
        gen = torch.Generator().manual_seed(run_config.seed)
        init = get_initializer("truncated_normal")
        self.user_emb = nn.Parameter(
            init((self.num_users, d), gen).to(self.device))
        self.item_emb = nn.Parameter(init((n, d), gen).to(self.device))
        self.item_bias = nn.Parameter(torch.zeros(n, device=self.device))
        self._split_over_model_axis()
        if self.mesh is None:
            self._flat_step = FlatTrainStep(self, self._JAX_PARAMS,
                                            self._loss, cfg.lr)
            self.train_step = self._flat_step
            self.optimizer = self._flat_step.optimizer
        else:
            self.optimizer = make_optimizer(
                "adam", dict(self.named_parameters()), cfg.lr)
            self.train_step = make_train_step(self.optimizer, self._loss,
                                              self.sync_gradients)
        self.pipeline = SequentialPairwiseEpochPipeline(
            self.dataset.train_data, cfg.batch_size, self.device,
            num_previous=cfg.n_seqs, num_next=cfg.n_next, pad=n,
            mesh=self.mesh)
        seqs = [user_pos[u][-cfg.n_seqs:] if u in user_pos else [n]
                for u in range(self.num_users)]
        self.test_seqs = torch.as_tensor(pad_sequences(
            seqs, value=n, max_len=cfg.n_seqs, padding="pre",
            truncating="pre").astype(np.int64), device=self.device)

    def _load_graph(self, user_pos) -> Tuple[np.ndarray, ...]:
        """The graph's six arrays from the JAX package's cache file, built
        and saved there when it is missing."""
        data_dir = self.dataset.data_dir
        cache_dir = os.path.join(os.path.dirname(data_dir) or ".",
                                 "_sgat_data", self.dataset.data_name)
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, "graph_elem.npz")
        if os.path.exists(path):
            with np.load(path) as blob:
                return tuple(blob[k] for k in _GRAPH_KEYS)
        arrays = build_sgat_graph(user_pos)
        # written under a name of this process's own, then moved into
        # place: the ranks of a mesh may build it at once
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **dict(zip(_GRAPH_KEYS, arrays)))
        os.replace(tmp, path)
        return arrays

    def _loss(self, users, pos, neg, w, prev) -> torch.Tensor:
        params = {name: self.whole_param(name) for name in self._JAX_PARAMS}
        return sgat_loss(self.graph, params, self.config, users, pos, neg, w,
                         prev)

    def load_jax_params(self, params: Dict[str, np.ndarray]) -> None:
        """Copy a JAX SGAT's ``params`` (arrays taken with ``np.asarray``;
        BPRMF's three tables) into this model."""
        self._copy_params(bprmf_params_from_jax(params))
        self._final_emb = None

    # the propagated item table, frozen by evaluate() (and dropped after
    # every epoch with the other predict caches)
    _final_emb: Optional[torch.Tensor] = None

    @torch.no_grad()
    def _items(self) -> torch.Tensor:
        if self._final_emb is None:
            self._final_emb = sgat_propagate(
                self.graph, self.eval_param("item_emb"),
                self.eval_param("user_emb"), self.config.n_layers)
        return self._final_emb

    def _train_epoch(self, epoch: int):
        self._final_emb = None            # the parameters move
        return super()._train_epoch(epoch)

    def evaluate(self, test_users=None):
        self._final_emb = None
        self._items()                     # propagated once per evaluation
        return super().evaluate(test_users)

    def _uv_state_refs(self) -> tuple:
        return (*self.parameters(), self._items())

    def _user_vectors(self, users: torch.Tensor) -> torch.Tensor:
        head_e = head_embedding(self._items(), self.test_seqs[users],
                                self.num_items)
        return head_e + self.eval_param("user_emb")[users]

    def _score_user_chunk(self, uv: torch.Tensor, item_lo: int,
                          item_hi: int) -> torch.Tensor:
        """``-l2d(uv, item) + bias`` for items [lo, hi), a chunk of items at
        a time."""
        items, bias = self._items(), self.item_bias
        parts = []
        for lo in range(item_lo, item_hi, _PREDICT_CHUNK):
            hi = min(lo + _PREDICT_CHUNK, item_hi)
            parts.append(-l2d(uv[:, None, :], items[None, lo:hi])
                         + bias[None, lo:hi])
        return torch.cat(parts, dim=1)

    def _topk_factors(self, uv):
        return uv, self._items(), self.item_bias

    @staticmethod
    def _topk_score_fn(uv: torch.Tensor, items: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
        """The expanded form, ``-sqrt(max(|u|^2 - 2 u.i + |i|^2, 0) +
        1e-12) + bias``: equal to ``predict``'s direct ``l2d`` up to
        rounding."""
        d2 = (torch.sum(uv * uv, -1)[:, None] - 2.0 * (uv @ items.T)
              + torch.sum(items * items, -1)[None, :])
        return -torch.sqrt(torch.clamp(d2, min=0.0) + 1e-12) + bias[None, :]

    @torch.no_grad()
    def predict(self, users) -> torch.Tensor:
        """(B, N) f32 scores on the model's device."""
        uv = self._user_vectors(as_user_tensor(users, self.device))
        return self._score_user_chunk(uv, 0, self.num_items)
