"""SelfCF — self-supervised collaborative filtering without negatives (Zhou
et al., ACM TORS 2023), its LightGCN-encoder variant: the port of
``skrx.models.SelfCF``.

Same config fields, defaults, checks and ``param_space``. The adjacency is
symmetric-normalised with degrees that count the nonzero entries plus
1e-7 (:func:`selfcf_norm_adj`), lowered once for
:func:`skrx_torch.ops.graph.propagate` (kernel #11 on a card; edge ids in
CSR order, as in the JAX package). Parameters: ``user_emb`` (U, d) and
``item_emb`` (N, d), Xavier-uniform, and the predictor ``nn.Linear(d, d)``
at torch's default init, holding JAX's ``x @ pred_w + pred_b`` as
``weight = pred_w.T``.

Each training step draws, in this order, an edge-dropout rate ``rate ~
U[0, 1)``, an (E,) edge mask ``(u >= rate) / max(1 - rate, 1e-8)`` and the
targets' element-dropout keep masks (B, d) of the users and of the items
(:func:`selfcf_draws`, from the epoch's step generator). The encoder is the
mean of layers 0..L of the propagation under that mask. The targets are
detached copies of the batch's online rows, dropped out and scaled by ``1 /
(1 - dropout)``; the loss is the negative cosine (``a / (|a| + 1e-12)``)
of each prediction against the other side's target, each direction halved
and averaged over the valid rows, plus ``reg`` times the weighted L2 of the
online rows; dense Adam. ``evaluate()`` encodes once without a mask and
freezes ``[u_pred | u_on]`` and ``[i_on | i_pred]``: ``predict``, the
chunked and fused routes and serving score that one concatenated dot,
``u_pred . i_on + u_on . i_pred`` (JAX's ``predict`` sums the two dots
apart, which rounds differently).

Under a mesh the graph's destination rows split over every rank (segsum on
each rank's edges) with the tables' rows in the rank's block; the layer
mean is gathered whole, the step's draws are made at the whole batch's
shape (each rank takes its rows), the means are over the whole batch's
valid rows and the predictor's gradient sums over the data axis.
"""
from typing import Dict, Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn

from ..convert import selfcf_params_from_jax
from ..ops.graph import Graph, propagate_layers
from ..ops.initializers import get_initializer, torch_layer_default
from ..run_config import RunConfig
from ..utils import ModelConfig
from ..parallel import batch_total, global_rows, local_rows
from .common import (GRAPH_IMPLS, EpochTrainedRecommender,
                     FrozenEmbeddingMixin, build_prop_graph, make_optimizer,
                     make_train_step, node_rows, node_table_rows,
                     whole_nodes)
from .pipeline import InteractionEpochPipeline

__all__ = ["SelfCF", "SelfCFConfig", "selfcf_norm_adj", "selfcf_encode",
           "selfcf_draws", "selfcf_loss"]

_Draws = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


class SelfCFConfig(ModelConfig):
    lr: float = 1e-3
    reg: float = 0.0
    embed_dim: int = 64
    n_layers: int = 2
    dropout: float = 0.5
    graph_impl: str = "auto"  # auto | segment | mxu | mxu_bf16
    batch_size: int = 2048
    epochs: int = 1000
    early_stop: int = 200

    @classmethod
    def param_space(cls):
        return {"n_layers": [2], "reg": [0.0], "dropout": [0.5]}

    def _validate(self):
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.reg, float) and self.reg >= 0
              and isinstance(self.embed_dim, int) and self.embed_dim > 0
              and isinstance(self.n_layers, int) and self.n_layers > 0
              and isinstance(self.dropout, float) and 0 <= self.dropout < 1
              and isinstance(self.batch_size, int) and self.batch_size > 0
              and self.graph_impl in GRAPH_IMPLS)
        if not ok:
            raise ValueError(f"invalid SelfCF config: {self}")


def selfcf_norm_adj(pairs: np.ndarray, num_users: int,
                    num_items: int) -> sp.csr_matrix:
    """The (U + N)^2 user-item adjacency, items offset by U, normalised as
    ``D^-1/2 A D^-1/2`` with D the count of each row's nonzero entries plus
    1e-7."""
    n = num_users + num_items
    ones = np.ones(len(pairs), dtype=np.float32)
    upper = sp.csr_matrix((ones, (pairs[:, 0], pairs[:, 1] + num_users)),
                          shape=(n, n))
    adj = (upper + upper.T).tocsr()
    deg = np.asarray((adj > 0).sum(axis=1)).flatten() + 1e-7
    d_inv = sp.diags(np.power(deg, -0.5))
    return (d_inv @ adj @ d_inv).tocsr()


def selfcf_encode(graph: Graph, user_emb: torch.Tensor,
                  item_emb: torch.Tensor, n_layers: int,
                  edge_mask: Optional[torch.Tensor] = None,
                  num_users: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(users, items): the mean of layers 0..n_layers of the propagation
    of the ego embeddings under ``edge_mask``. On a sharded graph the
    tables are the rank's rows and ``num_users`` the whole count."""
    ego = node_rows(graph, user_emb, item_emb)
    combined = whole_nodes(graph, propagate_layers(graph, ego, n_layers,
                                                   "mean", edge_mask))
    num_users = user_emb.shape[0] if num_users is None else num_users
    return combined[:num_users], combined[num_users:]


def selfcf_draws(generator: torch.Generator, num_edges: int, batch: int,
                 dim: int, dropout: float) -> _Draws:
    """One step's draws, in order: the rate ~ U[0, 1), the (E,) f32 edge
    mask ``(u >= rate) / max(1 - rate, 1e-8)``, and the (batch, dim) bool
    keep masks (probability ``1 - dropout``) of the user and the item
    targets (None without dropout)."""
    dev = generator.device
    rate = torch.rand((), generator=generator, device=dev)
    keep = torch.rand(num_edges, generator=generator, device=dev) >= rate
    edge_mask = keep.to(torch.float32) / torch.clamp(1.0 - rate, min=1e-8)
    if dropout <= 0:
        return edge_mask, None, None
    mask_u, mask_i = (torch.rand((batch, dim), generator=generator,
                                 device=dev) < 1 - dropout
                      for _ in range(2))
    return edge_mask, mask_u, mask_i


def _cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a / (torch.linalg.norm(a, dim=-1, keepdim=True) + 1e-12)
    b = b / (torch.linalg.norm(b, dim=-1, keepdim=True) + 1e-12)
    return torch.sum(a * b, dim=-1)


def selfcf_loss(graph: Graph, params: Dict[str, torch.Tensor],
                cfg: SelfCFConfig, users: torch.Tensor, pos: torch.Tensor,
                w: torch.Tensor, edge_mask: Optional[torch.Tensor],
                mask_u: Optional[torch.Tensor],
                mask_i: Optional[torch.Tensor],
                num_users: Optional[int] = None) -> torch.Tensor:
    """One batch's BYOL loss under one step's draws
    (:func:`selfcf_draws`; the keep masks of the batch's rows); ``params``
    by the model's parameter names (``user_emb``, ``item_emb``,
    ``predictor.weight``, ``predictor.bias``); ``num_users`` as
    :func:`selfcf_encode`."""
    u_all, i_all = selfcf_encode(graph, params["user_emb"],
                                 params["item_emb"], cfg.n_layers, edge_mask,
                                 num_users)
    u_on, i_on = u_all[users], i_all[pos]
    u_tgt, i_tgt = u_on.detach(), i_on.detach()
    if cfg.dropout > 0:
        keep = 1 - cfg.dropout
        u_tgt = torch.where(mask_u, u_tgt / keep, 0.0)
        i_tgt = torch.where(mask_i, i_tgt / keep, 0.0)
    reg_term = 0.5 * torch.sum((torch.sum(u_on ** 2, -1)
                                + torch.sum(i_on ** 2, -1)) * w)
    weight, bias = params["predictor.weight"], params["predictor.bias"]
    u_pred, i_pred = F.linear(u_on, weight, bias), F.linear(i_on, weight, bias)
    n_valid = torch.clamp(batch_total(w), min=1.0)
    loss_ui = -torch.sum(_cos(u_pred, i_tgt) * w) / n_valid / 2
    loss_iu = -torch.sum(_cos(i_pred, u_tgt) * w) / n_valid / 2
    return loss_ui + loss_iu + cfg.reg * reg_term


class SelfCF(FrozenEmbeddingMixin, EpochTrainedRecommender):
    _CAPTURED_STEP = True

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, SelfCFConfig(**model_config), device)
        cfg = self.config
        adj = selfcf_norm_adj(self.dataset.train_data.to_user_item_pairs(),
                              self.num_users, self.num_items)
        self.graph = build_prop_graph(adj, cfg.graph_impl, mesh=self.mesh,
                                      device=self.device)
        gen = torch.Generator().manual_seed(run_config.seed)
        init = get_initializer("xavier_uniform")
        d = cfg.embed_dim
        tables = node_table_rows(self, self.graph, {
            "user_emb": init((self.num_users, d), gen),
            "item_emb": init((self.num_items, d), gen)})
        for name, table in tables.items():
            setattr(self, name, nn.Parameter(table.to(self.device)))
        self.predictor = nn.Linear(d, d, device="meta")  # no init drawn
        self.predictor.weight = nn.Parameter(
            torch_layer_default((d, d), d, gen).T.contiguous().to(self.device))
        self.predictor.bias = nn.Parameter(
            torch_layer_default((d,), d, gen).to(self.device))
        self.optimizer = make_optimizer("adam", dict(self.named_parameters()),
                                        cfg.lr)
        self.train_step = make_train_step(self.optimizer, self._loss,
                                          self.sync_gradients)
        self.pipeline = InteractionEpochPipeline(
            self.dataset.train_data, cfg.batch_size, self.device,
            mesh=self.mesh)

    def step_draws(self, batch: int) -> _Draws:
        """The next training step's draws, from the epoch's generator."""
        cfg = self.config
        return selfcf_draws(self.step_generator(), self.graph.num_edges,
                            batch, cfg.embed_dim, cfg.dropout)

    def _loss(self, users, pos, w, draws: Optional[_Draws] = None
              ) -> torch.Tensor:
        """The batch's loss under ``draws`` (edge mask, user and item keep
        masks of the whole batch), by default the next drawn; each rank of
        a mesh takes its rows of the keep masks."""
        if draws is None:
            draws = self.step_draws(global_rows(users.shape[0]))
        edge_mask, mask_u, mask_i = draws
        return selfcf_loss(self.graph, dict(self.named_parameters()),
                           self.config, users, pos, w, edge_mask,
                           local_rows(mask_u), local_rows(mask_i),
                           self.num_users)

    def _embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        u_on, i_on = selfcf_encode(self.graph, self.user_emb, self.item_emb,
                                   self.config.n_layers,
                                   num_users=self.num_users)
        u_pred, i_pred = self.predictor(u_on), self.predictor(i_on)
        return torch.cat([u_pred, u_on], 1), torch.cat([i_on, i_pred], 1)

    def _jax_leaves(self) -> Dict[str, Tuple[str, bool]]:
        """``pred_w`` is the predictor's weight, transposed."""
        return {"user_emb": ("user_emb", False),
                "item_emb": ("item_emb", False),
                "pred_w": ("predictor.weight", True),
                "pred_b": ("predictor.bias", False)}

    def load_jax_params(self, params: Dict[str, np.ndarray]) -> None:
        """Copy a JAX SelfCF's ``params`` (arrays taken with
        ``np.asarray``) into this model."""
        self._copy_params(selfcf_params_from_jax(params))
        self._final_emb = None
