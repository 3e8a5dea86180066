"""LightGCN — simplified graph convolution for collaborative filtering (He
et al., SIGIR 2020): the port of ``skrx.models.LightGCN``.

Same config fields, defaults and checks. The bipartite adjacency in its
four variants (plain, norm, gcmc, pre) is cached as
``_LightGCN_data/<adj_type>_adj.npz`` under the data directory and lowered
once for :func:`skrx_torch.ops.graph.propagate` (kernel #11 on a card).
Parameters: the ego embeddings ``user_emb`` (U, d) and ``item_emb`` (N, d),
Xavier-uniform. A training step propagates ``n_layers`` times over the
whole graph, averages the layers, and takes the mean BPR loss over the
batch's valid rows plus ``reg * 0.5 * sum(w * (|ue|^2 + |pe|^2 + |ne|^2)) /
batch_size`` on the ego rows; then one dense Adam step, on one device
over both tables as one flat vector (JAX's flat step,
:class:`~skrx_torch.models.common.FlatTrainStep`; on a card each
epoch a CUDA graph of the step, kernel #11 inside it, replayed a batch).
``evaluate()``
propagates once under ``no_grad`` and scores from those frozen embeddings,
which ``predict`` and ``_chunk_embeddings`` reuse until the next epoch.

Under a mesh of several ranks (``RunConfig.mesh_shape``) the graph's
destination rows split over every rank (``ShardedPropGraph``, segsum on
each rank's edges) and each rank holds the rows of ``user_emb`` and
``item_emb`` that fall in its block of the node table
(``graph_param_shardings``). A step propagates the rank's rows through
the layers, all-gathers the layer mean and the ego rows (the gather's
backward sums over the data axis) and takes the loss of the rank's slice
of the batch (:func:`sharded_lightgcn_loss`); the mean BPR divides by the
whole batch's valid rows. ``evaluate()`` gathers the propagated tables
whole on every rank and ranks through ``predict_topk`` when the model axis
is above 1.
"""
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from ..convert import two_tables_from_jax
from ..ops.graph import Graph, propagate_layers
from ..ops.initializers import get_initializer
from ..ops.losses import bpr_loss
from ..parallel import ShardedPropGraph, gather_all_rows, take_rows
from ..parallel.distributed import all_reduce_sum
from ..run_config import RunConfig
from ..utils import ModelConfig, normalize_adj_matrix
from .common import (GRAPH_IMPLS, EpochTrainedRecommender, FlatTrainStep,
                     FrozenEmbeddingMixin, build_prop_graph,
                     graph_param_shardings, make_optimizer, make_train_step,
                     node_rows, whole_nodes)
from .pipeline import PairwiseEpochPipeline

__all__ = ["LightGCN", "LightGCNConfig", "build_bipartite_adj",
           "lightgcn_embeddings", "lightgcn_loss", "sharded_lightgcn_loss"]


class LightGCNConfig(ModelConfig):
    lr: float = 1e-3
    reg: float = 1e-3
    embed_size: int = 64
    n_layers: int = 3
    adj_type: str = "pre"     # plain | norm | gcmc | pre
    graph_impl: str = "auto"  # auto | segment | mxu | mxu_bf16
    batch_size: int = 1024
    epochs: int = 1000
    early_stop: int = 100

    def _validate(self):
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.reg, float) and self.reg >= 0
              and isinstance(self.embed_size, int) and self.embed_size > 0
              and isinstance(self.n_layers, int) and self.n_layers > 0
              and self.adj_type in ("plain", "norm", "gcmc", "pre")
              and self.graph_impl in GRAPH_IMPLS
              and isinstance(self.batch_size, int) and self.batch_size > 0
              and isinstance(self.epochs, int) and self.epochs >= 0
              and isinstance(self.early_stop, int))
        if not ok:
            raise ValueError(f"invalid LightGCN config: {self}")


def build_bipartite_adj(user_item_pairs: np.ndarray, num_users: int,
                        num_items: int, adj_type: str) -> sp.csr_matrix:
    """The (U + N)^2 user-item adjacency, items offset by U, in LightGCN's
    four variants: plain (0/1), norm (left-normalised with self-loops),
    gcmc (left-normalised), pre (symmetric-normalised)."""
    users, items = user_item_pairs[:, 0], user_item_pairs[:, 1]
    ones = np.ones(len(users), dtype=np.float32)
    n = num_users + num_items
    upper = sp.csr_matrix((ones, (users, items + num_users)), shape=(n, n))
    adj = upper + upper.T
    if adj_type == "plain":
        return adj.tocsr()
    if adj_type == "norm":
        return normalize_adj_matrix(adj + sp.eye(n), norm_method="left")
    if adj_type == "gcmc":
        return normalize_adj_matrix(adj, norm_method="left")
    if adj_type == "pre":
        return normalize_adj_matrix(adj, norm_method="symmetric")
    raise ValueError(adj_type)


def lightgcn_embeddings(graph: Graph, user_emb: torch.Tensor,
                        item_emb: torch.Tensor, n_layers: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(users, items): the mean of layers 0..n_layers of the propagation of
    the ego embeddings."""
    ego = torch.cat([user_emb, item_emb], dim=0)
    combined = propagate_layers(graph, ego, n_layers, "mean")
    num_users = user_emb.shape[0]
    return combined[:num_users], combined[num_users:]


def lightgcn_loss(graph: Graph, user_emb: torch.Tensor,
                  item_emb: torch.Tensor, n_layers: int, reg: float,
                  batch_size: int, users: torch.Tensor, pos: torch.Tensor,
                  neg: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One batch's loss: the mean BPR over rows of weight 1 plus the L2 of
    the batch's ego rows times ``reg / batch_size``."""
    neg = neg[:, 0]
    u_all, i_all = lightgcn_embeddings(graph, user_emb, item_emb, n_layers)
    ue, pe, ne = u_all[users], i_all[pos], i_all[neg]
    y_pos = torch.sum(ue * pe, dim=-1)
    y_neg = torch.sum(ue * ne, dim=-1)
    n_valid = torch.clamp(torch.sum(w), min=1.0)
    loss = torch.sum(bpr_loss(y_pos, y_neg) * w) / n_valid
    reg_term = 0.5 * torch.sum(torch.sum(
        user_emb[users] ** 2 + item_emb[pos] ** 2 + item_emb[neg] ** 2,
        dim=-1) * w)
    return loss + reg * reg_term / batch_size


def sharded_lightgcn_loss(graph: ShardedPropGraph, user_emb: torch.Tensor,
                          item_emb: torch.Tensor, num_users: int,
                          n_layers: int, reg: float, batch_size: int,
                          users: torch.Tensor, pos: torch.Tensor,
                          neg: torch.Tensor, w: torch.Tensor
                          ) -> torch.Tensor:
    """This rank's share of :func:`lightgcn_loss` on a mesh: its rows of
    the tables (``user_emb``, ``item_emb``) propagated through the sharded
    graph, the layer mean and the ego rows gathered from every rank, and
    the loss of its slice of the batch (``users``, ``pos``, ``neg``,
    ``w``), the mean BPR over the whole batch's valid rows. The slices'
    losses sum to the single device's."""
    mesh = graph.mesh
    ego = node_rows(graph, user_emb, item_emb)
    combined = propagate_layers(graph, ego, n_layers, "mean")
    table = gather_all_rows(torch.cat([combined, ego], dim=1), mesh)
    d = ego.shape[1]
    neg = neg[:, 0]
    items = num_users + torch.stack([pos, neg])
    ue, pe, ne = table[users], table[items[0]], table[items[1]]
    y_pos = torch.sum(ue[:, :d] * pe[:, :d], dim=-1)
    y_neg = torch.sum(ue[:, :d] * ne[:, :d], dim=-1)
    n_valid = all_reduce_sum(torch.sum(w), mesh.data_group, mesh.data_size)
    loss = torch.sum(bpr_loss(y_pos, y_neg) * w) / torch.clamp(n_valid,
                                                               min=1.0)
    reg_term = 0.5 * torch.sum(torch.sum(
        ue[:, d:] ** 2 + pe[:, d:] ** 2 + ne[:, d:] ** 2, dim=-1) * w)
    return loss + reg * reg_term / batch_size


class LightGCN(FrozenEmbeddingMixin, EpochTrainedRecommender):
    _JAX_PARAMS = ("user_emb", "item_emb")

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, LightGCNConfig(**model_config), device)
        cfg = self.config
        adj = self._load_adj_mat(cfg.adj_type)
        self.graph = build_prop_graph(adj, cfg.graph_impl, mesh=self.mesh,
                                      device=self.device)
        gen = torch.Generator().manual_seed(run_config.seed)
        init = get_initializer("xavier_uniform")
        tables = {"user_emb": init((self.num_users, cfg.embed_size), gen),
                  "item_emb": init((self.num_items, cfg.embed_size), gen)}
        if isinstance(self.graph, ShardedPropGraph):
            self._row_blocks = graph_param_shardings(
                self.mesh, {"user_emb": self.num_users,
                            "item_emb": self.num_items})
        for name, full in tables.items():
            local = take_rows(full, self._row_blocks.get(name))
            setattr(self, name, nn.Parameter(local.to(self.device)))
        if self.mesh is None:
            self._flat_step = FlatTrainStep(self, self._JAX_PARAMS,
                                            self._loss, cfg.lr)
            self.train_step = self._flat_step
            self.optimizer = self._flat_step.optimizer
        else:
            self.optimizer = make_optimizer(
                "adam", {"user_emb": self.user_emb,
                         "item_emb": self.item_emb}, cfg.lr)
            self.train_step = make_train_step(self.optimizer, self._loss,
                                              self.sync_gradients)
        self.pipeline = PairwiseEpochPipeline(
            self.dataset.train_data, cfg.batch_size, self.device, num_neg=1,
            mesh=self.mesh)

    def _load_adj_mat(self, adj_type: str) -> sp.csr_matrix:
        out_dir = os.path.join(self.dataset.data_dir,
                               f"_{type(self).__name__}_data")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{adj_type}_adj.npz")
        if os.path.exists(path):
            return sp.load_npz(path)
        adj = build_bipartite_adj(self.dataset.train_data.to_user_item_pairs(),
                                  self.num_users, self.num_items, adj_type)
        # written under a name of this process's own, then moved into
        # place: the ranks of a mesh may write it at once
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        sp.save_npz(tmp, adj)
        os.replace(tmp, path)
        return adj

    def _loss(self, users, pos, neg, w) -> torch.Tensor:
        cfg = self.config
        if isinstance(self.graph, ShardedPropGraph):
            return sharded_lightgcn_loss(
                self.graph, self.user_emb, self.item_emb, self.num_users,
                cfg.n_layers, cfg.reg, cfg.batch_size, users, pos, neg, w)
        return lightgcn_loss(self.graph, self.user_emb, self.item_emb,
                             cfg.n_layers, cfg.reg, cfg.batch_size, users,
                             pos, neg, w)

    def _embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The propagated (users, items) tables, whole on every rank under
        a mesh (gathered from the ranks' rows)."""
        if not isinstance(self.graph, ShardedPropGraph):
            return lightgcn_embeddings(self.graph, self.user_emb,
                                       self.item_emb, self.config.n_layers)
        ego = node_rows(self.graph, self.user_emb, self.item_emb)
        table = whole_nodes(self.graph, propagate_layers(
            self.graph, ego, self.config.n_layers, "mean"))
        return table[:self.num_users], table[self.num_users:]

    def load_jax_params(self, params: Dict[str, np.ndarray]) -> None:
        """Copy a JAX LightGCN's ``params`` (arrays taken with
        ``np.asarray``) into this model."""
        self._copy_params(two_tables_from_jax(params))
        self._final_emb = None
