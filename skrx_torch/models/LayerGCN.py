"""LayerGCN — layer-refined graph convolution with edge pruning (Zhou et
al., ICDE 2023): the port of ``skrx.models.LayerGCN``.

Same config fields, defaults, checks and ``param_space``. One static
symmetric graph over the E training pairs (items offset by U; edge e < E
runs item -> user, edge E + e user -> item), both halves weighted by the
base normalisation ``(rowdeg + 1e-7)^-1/2 (coldeg + 1e-7)^-1/2``, lowered
once for :func:`skrx_torch.ops.graph.propagate` (kernel #11 on a card).

With ``dropout`` > 0 every training epoch keeps ``keep_len = int(E * (1 -
dropout))`` pairs: by degree on even epochs (Gumbel top-k over the log
base weights, without replacement) and uniformly at random on odd ones.
The kept set becomes an edge mask over the static graph (JAX's "mxu" and
mesh form): the kept pairs renormalised on the device by their kept
degrees and divided by the base weight, 0 elsewhere, so that ``base *
mask`` is the pruned subgraph's normalisation and a pruned edge adds an
exact 0. JAX's "segment" path rebuilds the pruned edge list each epoch
instead; the tests hold the port to it. The draws come from
``epoch_generator(seed + 1, epoch, stream=1)``, independent of the
pipeline's stream 0, so a resumed ``fit()`` prunes as an uninterrupted one.

The forward: ``h_l = A h_{l-1}`` scaled per node by ``cos(h_l, ego)``, the
layers 1..L summed (ego excluded). The loss: the summed BPR over the batch
plus ``reg * 0.5 * sum(w * (|ue|^2 + |pe|^2 + |ne|^2))`` on the ego rows;
dense Adam. ``evaluate()`` propagates over the unpruned graph under
``no_grad`` and freezes the embeddings that ``predict``,
``_chunk_embeddings`` and serving reuse until the next epoch.

Under a mesh the static graph is a
:class:`~skrx_torch.parallel.ShardedPropGraph` of the same COO edges (JAX's
mesh branch): destination rows split over every rank, segsum on each
rank's edges, the epoch's (2E,) mask read through each edge's original id;
each rank holds the tables' rows in its block, and the layer sum and the
ego rows are gathered whole for the rank's slice of the batch.
"""
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..convert import two_tables_from_jax
from ..ops.graph import Graph, graph_from_coo, propagate
from ..ops.initializers import get_initializer
from ..ops.losses import bpr_loss
from ..ops.sampling import gumbel_topk_without_replacement
from ..run_config import RunConfig
from ..utils import ModelConfig
from ..parallel import ShardedPropGraph
from .common import (GRAPH_IMPLS, EpochTrainedRecommender,
                     FrozenEmbeddingMixin, graph_sharding_enabled,
                     make_optimizer, make_train_step, mxu_msg_dtype,
                     node_rows, node_table_rows, resolve_graph_impl,
                     whole_nodes)
from .pipeline import PairwiseEpochPipeline, epoch_generator

__all__ = ["LayerGCN", "LayerGCNConfig", "layergcn_base_weights",
           "layergcn_keep", "layergcn_mask_from_keep", "layergcn_embeddings",
           "layergcn_loss"]


class LayerGCNConfig(ModelConfig):
    lr: float = 1e-3
    reg: float = 1e-2
    embed_dim: int = 64
    n_layers: int = 4
    dropout: float = 0.0
    graph_impl: str = "auto"  # auto | segment | mxu | mxu_bf16
    batch_size: int = 2048
    epochs: int = 1000
    early_stop: int = 200

    @classmethod
    def param_space(cls):
        return {"n_layers": [4],
                "reg": [1e-02, 1e-03, 1e-04, 1e-05],
                "dropout": [0.0, 0.1, 0.2]}

    def _validate(self):
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.reg, float) and self.reg >= 0
              and isinstance(self.embed_dim, int) and self.embed_dim > 0
              and isinstance(self.n_layers, int) and self.n_layers > 0
              and isinstance(self.dropout, float) and 0 <= self.dropout < 1
              and self.graph_impl in GRAPH_IMPLS
              and isinstance(self.batch_size, int) and self.batch_size > 0)
        if not ok:
            raise ValueError(f"invalid LayerGCN config: {self}")


def layergcn_base_weights(rows: np.ndarray, cols: np.ndarray,
                          num_users: int, num_items: int) -> np.ndarray:
    """(E,) f32 ``(rowdeg + 1e-7)^-1/2 (coldeg + 1e-7)^-1/2`` of the pairs
    (rows, cols), the degrees counted in float64."""
    rd = np.bincount(rows, minlength=num_users) + 1e-7
    cd = np.bincount(cols, minlength=num_items) + 1e-7
    return ((rd[rows] ** -0.5) * (cd[cols] ** -0.5)).astype(np.float32)


def layergcn_keep(generator: torch.Generator, log_base: torch.Tensor,
                  keep_len: int, by_degree: bool) -> torch.Tensor:
    """The ids of the ``keep_len`` pairs an epoch keeps: drawn without
    replacement with probability proportional to the base weight
    (``by_degree``), else a uniform random subset."""
    if by_degree:
        return gumbel_topk_without_replacement(generator, log_base, keep_len)
    return torch.randperm(log_base.shape[0], generator=generator,
                          device=log_base.device)[:keep_len]


def layergcn_mask_from_keep(keep: torch.Tensor, rows: torch.Tensor,
                            cols: torch.Tensor, base: torch.Tensor,
                            num_users: int, num_items: int) -> torch.Tensor:
    """(2E,) f32 edge mask of the pairs ``keep`` over the static graph: a
    kept pair's weight renormalised by the kept degrees, ``(rowdeg_kept +
    1e-7)^-1/2 (coldeg_kept + 1e-7)^-1/2``, over its base weight; 0 for a
    pruned pair. Both halves of the graph take the same values."""
    ind = torch.zeros_like(base).index_fill_(0, keep, 1.0)
    row_sum = torch.zeros(num_users, dtype=base.dtype,
                          device=base.device).index_add_(0, rows, ind) + 1e-7
    col_sum = torch.zeros(num_items, dtype=base.dtype,
                          device=base.device).index_add_(0, cols, ind) + 1e-7
    val = ind * (row_sum[rows] ** -0.5) * (col_sum[cols] ** -0.5)
    half = val / base
    return torch.cat([half, half])


def layergcn_embeddings(graph: Graph, user_emb: torch.Tensor,
                        item_emb: torch.Tensor, n_layers: int,
                        edge_mask: Optional[torch.Tensor] = None,
                        num_users: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(users, items): the sum of layers 1..n_layers, each propagated layer
    scaled per node by its cosine with the ego embedding. On a sharded
    graph the tables are the rank's rows and ``num_users`` the whole
    count."""
    ego = node_rows(graph, user_emb, item_emb)
    ego_norm = torch.linalg.vector_norm(ego, dim=-1)
    h, total = ego, torch.zeros_like(ego)
    for _ in range(n_layers):
        h = propagate(graph, h, edge_mask)
        cos_w = torch.sum(h * ego, dim=-1) / (
            torch.linalg.vector_norm(h, dim=-1) * ego_norm + 1e-12)
        h = cos_w[:, None] * h
        total = total + h
    total = whole_nodes(graph, total)
    num_users = user_emb.shape[0] if num_users is None else num_users
    return total[:num_users], total[num_users:]


def layergcn_loss(graph: Graph, params: Dict[str, torch.Tensor],
                  cfg: LayerGCNConfig, users: torch.Tensor, pos: torch.Tensor,
                  neg: torch.Tensor, w: torch.Tensor,
                  edge_mask: Optional[torch.Tensor] = None,
                  num_users: Optional[int] = None) -> torch.Tensor:
    """One batch's loss (summed BPR plus ``reg`` times the L2 of the batch's
    ego rows) over ``graph`` pruned by ``edge_mask``; ``params`` holds
    ``user_emb`` and ``item_emb``; ``num_users`` as
    :func:`layergcn_embeddings`."""
    user_emb, item_emb = params["user_emb"], params["item_emb"]
    neg = neg[:, 0]
    u_all, i_all = layergcn_embeddings(graph, user_emb, item_emb,
                                       cfg.n_layers, edge_mask, num_users)
    if isinstance(graph, ShardedPropGraph):     # the ego rows, whole
        ego = whole_nodes(graph, node_rows(graph, user_emb, item_emb))
        user_emb, item_emb = ego[:num_users], ego[num_users:]
    ue = u_all[users]
    y_pos = torch.sum(ue * i_all[pos], dim=-1)
    y_neg = torch.sum(ue * i_all[neg], dim=-1)
    loss = torch.sum(bpr_loss(y_pos, y_neg) * w)
    reg_term = 0.5 * torch.sum(torch.sum(
        user_emb[users] ** 2 + item_emb[pos] ** 2 + item_emb[neg] ** 2,
        dim=-1) * w)
    return loss + cfg.reg * reg_term


class LayerGCN(FrozenEmbeddingMixin, EpochTrainedRecommender):
    _JAX_PARAMS = ("user_emb", "item_emb")

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, LayerGCNConfig(**model_config), device)
        cfg = self.config
        num_users, num_items = self.num_users, self.num_items
        pairs = self.dataset.train_data.to_user_item_pairs()
        rows, cols = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
        base = layergcn_base_weights(rows, cols, num_users, num_items)
        self.num_pairs = len(pairs)
        self.keep_len = int(self.num_pairs * (1.0 - cfg.dropout))
        edges = (np.concatenate([cols + num_users, rows]),
                 np.concatenate([rows, cols + num_users]),
                 np.concatenate([base, base]))
        msg_dtype = mxu_msg_dtype(resolve_graph_impl(cfg.graph_impl))
        if graph_sharding_enabled(self.mesh):
            self.graph = ShardedPropGraph(
                self.mesh, msg_dtype=msg_dtype, coo_edges=edges,
                num_nodes=num_users + num_items, device=self.device)
        else:
            self.graph = graph_from_coo(*edges, num_users + num_items,
                                        msg_dtype=msg_dtype,
                                        device=self.device)
        self._rows = torch.as_tensor(rows, device=self.device)
        self._cols = torch.as_tensor(cols, device=self.device)
        self._base = torch.as_tensor(base, device=self.device)
        self._log_base = torch.log(self._base)
        gen = torch.Generator().manual_seed(run_config.seed)
        init = get_initializer("xavier_uniform")
        tables = node_table_rows(self, self.graph, {
            "user_emb": init((num_users, cfg.embed_dim), gen),
            "item_emb": init((num_items, cfg.embed_dim), gen)})
        for name, table in tables.items():
            setattr(self, name, nn.Parameter(table.to(self.device)))
        self.optimizer = make_optimizer("adam", {"user_emb": self.user_emb,
                                                 "item_emb": self.item_emb},
                                        cfg.lr)
        self.train_step = make_train_step(self.optimizer, self._loss,
                                          self.sync_gradients)
        self.pipeline = PairwiseEpochPipeline(
            self.dataset.train_data, cfg.batch_size, self.device, num_neg=1,
            mesh=self.mesh)
        self._epoch_mask: Optional[torch.Tensor] = None

    def epoch_mask(self, epoch: int) -> Optional[torch.Tensor]:
        """The (2E,) edge mask that training epoch ``epoch`` propagates
        under (None, the full graph, when ``dropout`` is 0): pruned by
        degree on even epochs, at random on odd ones."""
        if self.config.dropout <= 0.0:
            return None
        gen = epoch_generator(self.run_config.seed + 1, epoch, self.device,
                              stream=1)
        keep = layergcn_keep(gen, self._log_base, self.keep_len,
                             by_degree=epoch % 2 == 0)
        return layergcn_mask_from_keep(keep, self._rows, self._cols,
                                       self._base, self.num_users,
                                       self.num_items)

    def _loss(self, users, pos, neg, w, edge_mask=None) -> torch.Tensor:
        """The batch's loss under ``edge_mask``, by default the epoch's."""
        mask = self._epoch_mask if edge_mask is None else edge_mask
        return layergcn_loss(self.graph, dict(self.named_parameters()),
                             self.config, users, pos, neg, w, mask,
                             self.num_users)

    def _train_epoch(self, epoch: int) -> float:
        self._epoch_mask = self.epoch_mask(epoch)
        try:
            return super()._train_epoch(epoch)
        finally:
            self._epoch_mask = None

    def _embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return layergcn_embeddings(self.graph, self.user_emb, self.item_emb,
                                   self.config.n_layers,   # unpruned
                                   num_users=self.num_users)

    def load_jax_params(self, params: Dict[str, np.ndarray]) -> None:
        """Copy a JAX LayerGCN's ``params`` (arrays taken with
        ``np.asarray``) into this model."""
        self._copy_params(two_tables_from_jax(params))
        self._final_emb = None
