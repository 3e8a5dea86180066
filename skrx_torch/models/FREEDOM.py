"""FREEDOM — a frozen modality graph and a denoised user-item graph (Zhou
and Shen, MM 2023): the port of ``skrx.models.FREEDOM``.

Same config fields, defaults, checks and ``param_space``. Parameters, in
the JAX package's layout: ``user_emb``, ``item_emb`` (Xavier uniform) and
per modality its trainable feature table (``v_feat``, ``t_feat``) and
projector to ``feat_dim`` (``image_trs``, ``text_trs``: ``w`` and ``b`` at
torch's default U(+-1/sqrt(fan_in))).

Two graphs run through kernel #11. The item graph is the blended kNN
graph of the features (:func:`~skrx_torch.ops.mm_graph.cached_mm_edges`,
``mm_image_weight`` on the image graph; built once and cached as edges
under ``<data_dir>/_data_cache/torch_mm_adj_freedomdsp_*``), frozen,
propagated ``n_mm_layers`` times over the item-id embeddings. The user-item
graph is one static symmetric graph over the E training pairs (edge e < E
item -> user, E + e user -> item) at the base normalisation
``(rowdeg + 1e-7)^-1/2 (coldeg + 1e-7)^-1/2``, as JAX's "mxu" route: each
training epoch keeps ``int(E * (1 - dropout))`` pairs drawn without
replacement by base weight (Gumbel top-k over the log base, from
``epoch_generator(seed + 1, epoch, stream=1)``), recounts the degrees over
the kept pairs (+ 1e-7) and propagates under the mask ``renormalised /
base`` (0 for a dropped pair), the same on both halves
(:meth:`FREEDOM.epoch_mask`, :func:`~skrx_torch.models.LayerGCN.
layergcn_mask_from_keep`). The encoder is the mean of layers 0..n_ui_layers
of that graph, the items plus the propagated item graph's output.

The loss: the weighted mean BPR of the batch, plus ``reg`` times the same
BPR of the users against the projected text, then image, features of the
positive and negative items (projected for the batch's rows only); dense
Adam. ``evaluate()`` propagates the unpruned graph and freezes the
embeddings that ``predict``, the chunked and fused routes and serving
reuse until the next epoch.

Under a mesh FREEDOM trains data-parallel (the JAX package has no
tensor-parallel setup for it): every rank holds the graphs and the
parameters whole and draws the epoch's mask alike, takes its data index's
slice of each batch, the BPR means divide by the whole batch's valid rows,
and the gradients sum over the data axis.
"""
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..convert import freedom_params_from_jax
from ..ops.attention import dense
from ..ops.graph import graph_from_coo, propagate
from ..ops.initializers import get_initializer, torch_layer_default
from ..ops.mm_graph import cached_mm_edges
from ..ops.sampling import gumbel_topk_without_replacement
from ..run_config import RunConfig
from ..utils import ModelConfig
from .LayerGCN import layergcn_base_weights, layergcn_mask_from_keep
from .common import (GRAPH_IMPLS, add_param_tree, gather_rows,
                     make_optimizer, make_train_step, mxu_msg_dtype,
                     resolve_graph_impl)
from .multimodal import (MultimodalRecommender, bpr_mean, cache_dir_of,
                         item_features)
from .pipeline import PairwiseEpochPipeline, epoch_generator

__all__ = ["FREEDOM", "FREEDOMConfig", "freedom_forward", "freedom_loss"]


class FREEDOMConfig(ModelConfig):
    lr: float = 1e-3
    reg: float = 0.0
    embed_dim: int = 64
    feat_dim: int = 64
    lambda_coeff: float = 0.9
    n_mm_layers: int = 1
    n_ui_layers: int = 2
    knn_k: int = 10
    mm_image_weight: float = 0.1
    dropout: float = 0.8
    graph_impl: str = "auto"  # auto | segment | mxu | mxu_bf16
    batch_size: int = 2048
    epochs: int = 1000
    early_stop: int = 200

    @classmethod
    def param_space(cls):
        return {"reg": [0.0, 1e-05, 1e-04, 1e-03], "dropout": [0.8, 0.9]}

    def _validate(self):
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.reg, float) and self.reg >= 0
              and isinstance(self.embed_dim, int) and self.embed_dim > 0
              and isinstance(self.n_mm_layers, int) and self.n_mm_layers >= 0
              and isinstance(self.n_ui_layers, int) and self.n_ui_layers > 0
              and isinstance(self.knn_k, int) and self.knn_k > 0
              and isinstance(self.dropout, float) and 0 <= self.dropout < 1
              and self.graph_impl in GRAPH_IMPLS
              and isinstance(self.batch_size, int) and self.batch_size > 0)
        if not ok:
            raise ValueError(f"invalid FREEDOM config: {self}")


def freedom_forward(ui_graph, mm_graph, p: Dict, cfg: FREEDOMConfig,
                    edge_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(users, items) under the user-item ``edge_mask`` (None: unpruned)."""
    h = p["item_emb"]
    for _ in range(cfg.n_mm_layers):
        h = propagate(mm_graph, h)
    x = torch.cat([p["user_emb"], p["item_emb"]], dim=0)
    layers = [x]
    for _ in range(cfg.n_ui_layers):
        x = propagate(ui_graph, x, edge_mask)
        layers.append(x)
    combined = torch.stack(layers, dim=1).mean(dim=1)
    num_users = p["user_emb"].shape[0]
    return combined[:num_users], combined[num_users:] + h


def freedom_loss(ui_graph, mm_graph, p: Dict, cfg: FREEDOMConfig,
                 users: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
                 w: torch.Tensor, edge_mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """One batch's loss under the epoch's ``edge_mask``."""
    neg = neg[:, 0]
    u_all, i_all = freedom_forward(ui_graph, mm_graph, p, cfg, edge_mask)
    ue = gather_rows(u_all, users)
    loss = bpr_mean(ue, gather_rows(i_all, pos), gather_rows(i_all, neg), w)
    mm_loss = 0.0
    for feat, trs in (("t_feat", "text_trs"), ("v_feat", "image_trs")):
        if feat in p:
            mm_loss = mm_loss + bpr_mean(
                ue, dense(gather_rows(p[feat], pos), p[trs]),
                dense(gather_rows(p[feat], neg), p[trs]), w)
    return loss + cfg.reg * mm_loss


class FREEDOM(MultimodalRecommender):
    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, FREEDOMConfig(**model_config), device)
        cfg = self.config
        num_users, num_items = self.num_users, self.num_items
        v_feat, t_feat = item_features(self.dataset)
        msg = mxu_msg_dtype(resolve_graph_impl(cfg.graph_impl))

        def on_device(x):
            return None if x is None else torch.as_tensor(x,
                                                          device=self.device)
        mm_r, mm_c, mm_v = cached_mm_edges(
            cache_dir_of(self.dataset), "freedomdsp", cfg.knn_k,
            on_device(v_feat), on_device(t_feat), cfg.mm_image_weight,
            self.device)
        self.mm_graph = graph_from_coo(
            mm_c.cpu().numpy(), mm_r.cpu().numpy(), mm_v.cpu().numpy(),
            num_items, msg_dtype=msg, device=self.device)
        pairs = self.dataset.train_data.to_user_item_pairs()
        rows, cols = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
        base = layergcn_base_weights(rows, cols, num_users, num_items)
        self.num_pairs = len(pairs)
        self.keep_len = int(self.num_pairs * (1.0 - cfg.dropout))
        self.ui_graph = graph_from_coo(
            np.concatenate([cols + num_users, rows]),
            np.concatenate([rows, cols + num_users]),
            np.concatenate([base, base]), num_users + num_items,
            msg_dtype=msg, device=self.device)
        self._rows = torch.as_tensor(rows, device=self.device)
        self._cols = torch.as_tensor(cols, device=self.device)
        self._base = torch.as_tensor(base, device=self.device)
        self._log_base = torch.log(self._base)
        gen = torch.Generator().manual_seed(run_config.seed)
        xavier = get_initializer("xavier_uniform")
        d = cfg.embed_dim
        tree = {"user_emb": xavier((num_users, d), gen),
                "item_emb": xavier((num_items, d), gen)}
        for feat, trs, x in (("v_feat", "image_trs", v_feat),
                             ("t_feat", "text_trs", t_feat)):
            if x is not None:
                f = x.shape[1]
                tree[feat] = torch.from_numpy(x)
                tree[trs] = {
                    "w": torch_layer_default((f, cfg.feat_dim), f, gen),
                    "b": torch_layer_default((cfg.feat_dim,), f, gen)}
        add_param_tree(self, tree, self.device)
        self.optimizer = make_optimizer("adam", dict(self.named_parameters()),
                                        cfg.lr)
        self.train_step = make_train_step(self.optimizer, self._loss,
                                          self.sync_gradients)
        self.pipeline = PairwiseEpochPipeline(
            self.dataset.train_data, cfg.batch_size, self.device, num_neg=1,
            mesh=self.mesh)
        self._epoch_mask: Optional[torch.Tensor] = None

    def mask_from_keep(self, keep: torch.Tensor) -> torch.Tensor:
        """The (2E,) edge mask of the kept pair ids ``keep``."""
        return layergcn_mask_from_keep(keep, self._rows, self._cols,
                                       self._base, self.num_users,
                                       self.num_items)

    def epoch_mask(self, epoch: int) -> Optional[torch.Tensor]:
        """The (2E,) edge mask that training epoch ``epoch`` propagates
        under (None, the full graph, at dropout 0)."""
        if self.config.dropout <= 0.0:
            return None
        gen = epoch_generator(self.run_config.seed + 1, epoch, self.device,
                              stream=1)
        return self.mask_from_keep(gumbel_topk_without_replacement(
            gen, self._log_base, self.keep_len))

    def _loss(self, users, pos, neg, w, edge_mask=None) -> torch.Tensor:
        """The batch's loss under ``edge_mask``, by default the epoch's."""
        mask = self._epoch_mask if edge_mask is None else edge_mask
        return freedom_loss(self.ui_graph, self.mm_graph, self.params_tree(),
                            self.config, users, pos, neg, w, mask)

    def _train_epoch(self, epoch: int) -> float:
        self._epoch_mask = self.epoch_mask(epoch)
        try:
            return super()._train_epoch(epoch)
        finally:
            self._epoch_mask = None

    def _embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return freedom_forward(self.ui_graph, self.mm_graph,
                               self.params_tree(), self.config)

    @staticmethod
    def _params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
        return freedom_params_from_jax(params)
