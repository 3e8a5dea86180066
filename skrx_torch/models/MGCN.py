"""MGCN — a multi-view graph convolutional network for multimedia
recommendation (Yu et al., MM 2023): the port of ``skrx.models.MGCN``.

Same config fields, defaults and checks. Parameters, in the JAX package's
layout: ``user_emb``, ``item_emb`` (Xavier uniform), the trainable feature
tables ``v_feat``, ``t_feat``, and at torch's default U(+-1/sqrt(fan_in))
the projectors ``image_trs``, ``text_trs``, the purifier gates ``gate_v``,
``gate_t``, the fuser's ``query1`` and bias-free ``query2`` and the
preference gates ``gate_image_prefer``, ``gate_text_prefer``.

Four graphs run through kernel #11: the symmetric-normalised bipartite
graph ``D^-1/2 A D^-1/2`` (a node without edges 0), its rectangular user <-
item block R (``num_src_nodes`` = N), and the image and text kNN graphs
valued by similarity (:func:`~skrx_torch.ops.mm_graph.weighted_knn_edges`,
cached as edges under ``<data_dir>/_data_cache/torch_<modality>_mgcn_adj_
<k>.npz``). The forward: the item-id embedding gated by each projected
modality, each propagated ``n_layers`` times over its kNN graph and lifted
to the users by R; the LightGCN mean over ``n_ui_layers`` of the bipartite
graph (the content); attention over the two modal views (the common part)
and preference gates over what each adds (side = (image + text + common)
/ 3); the output content + side.

The loss: the weighted mean BPR, ``reg`` times half the weighted squared
norms of the batch's rows over the valid rows, and ``cl_loss`` times two
InfoNCEs at 0.2 (side against content for the positive items and for the
users; a padded row leaves every denominator). The learning rate is
LambdaLR's ``lr * rate ** ((count // spe) / period)`` (``lr_scheduler =
[rate, period]``, ``spe`` the pipeline's batches an epoch when the model
is built, as JAX fixes it), ``count`` the updates taken before this one
(optax's count; ``update_count``, which rides in checkpoints). Dense Adam
otherwise. On one device the whole nested tree, the 4,096-d and 384-d
feature tables included, is one flat vector in JAX's ravel order (JAX's
flat step, :class:`~skrx_torch.models.common.FlatTrainStep`), the rate is
computed inside the step, on the device in f32, from Adam's step count
(:func:`mgcn_lr_f32`, as optax's ``scale_by_schedule`` reads its count),
and on a card each epoch is a CUDA graph of the step, the four graphs'
kernel #11 inside it, replayed a batch; ``update_count`` is Adam's step
count. Under a mesh the rate is set from a host count before each
per-parameter Adam update (:meth:`MGCN.lr_at`). ``evaluate()`` freezes
the embeddings that ``predict``, the chunked and fused routes and serving
reuse until the next epoch.

Under a mesh whose model axis is above 1 every 2-D parameter of at least m
rows keeps only its rank's rows over the model axis (the JAX package's
tensor-parallel ``_finalize_setup_flat``: the tables, the features and the
projection weights); a step gathers each whole (differentiable, the
backward summing over the data axis) and runs the rank's slice of the
batch. The means divide by the whole batch's valid rows, the InfoNCEs of
the rank's rows run against the whole batch (gathered over the data axis),
and the replicated parameters' gradients sum over the data axis.
"""
import os
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch

from ..convert import mgcn_params_from_jax
from ..ops.attention import dense
from ..ops.graph import Graph, graph_from_coo, graph_from_sp_matrix, propagate
from ..ops.initializers import get_initializer, torch_layer_default
from ..ops.mm_graph import cached_edges, weighted_knn_edges
from ..run_config import RunConfig
from ..utils import ModelConfig
from ..parallel import batch_total, gather_batch, gather_batch_ids
from .common import (GRAPH_IMPLS, FlatTrainStep, add_param_tree,
                     gather_rows, make_optimizer, make_train_step,
                     mxu_msg_dtype, nest_params, resolve_graph_impl)
from .multimodal import (MultimodalRecommender, bpr_mean, cache_dir_of,
                         item_features)
from .pipeline import PairwiseEpochPipeline

__all__ = ["MGCN", "MGCNConfig", "MGCNGraphs", "mgcn_graphs",
           "mgcn_forward", "mgcn_info_nce", "mgcn_loss", "mgcn_lr",
           "mgcn_lr_f32"]


class MGCNConfig(ModelConfig):
    lr: float = 1e-3
    reg: float = 1e-4
    embed_dim: int = 64
    n_ui_layers: int = 2
    n_layers: int = 1
    lambda_coeff: float = 0.9
    knn_k: int = 10
    cl_loss: float = 0.001
    lr_scheduler: Optional[List[float]] = None   # default [0.96, 50]
    graph_impl: str = "auto"  # auto | segment | mxu | mxu_bf16
    batch_size: int = 2048
    epochs: int = 1000
    early_stop: int = 200

    @classmethod
    def param_space(cls):
        return {"cl_loss": [0.001, 0.01, 0.1]}

    def _validate(self):
        if self.lr_scheduler is None:
            self.lr_scheduler = [0.96, 50]
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.reg, float) and self.reg >= 0
              and isinstance(self.embed_dim, int) and self.embed_dim > 0
              and isinstance(self.lr_scheduler, list)
              and len(self.lr_scheduler) == 2
              and isinstance(self.knn_k, int) and self.knn_k > 0
              and self.graph_impl in GRAPH_IMPLS
              and isinstance(self.batch_size, int) and self.batch_size > 0)
        if not ok:
            raise ValueError(f"invalid MGCN config: {self}")


class MGCNGraphs(NamedTuple):
    """MGCN's four propagation operators."""
    adj: Graph                    # the bipartite graph, (U + N)^2
    R: Graph                      # its user <- item block, U x N
    image: Graph                  # the image kNN graph, N^2
    text: Graph                   # the text kNN graph, N^2


def mgcn_graphs(pairs: np.ndarray, num_users: int, num_items: int,
                img_edges, txt_edges, msg_dtype=torch.float32,
                device="cpu") -> MGCNGraphs:
    """The bipartite graph ``D^-1/2 A D^-1/2`` (U + N nodes, float64
    degrees), its user <- item block R, and the image and text kNN graphs
    from their ``(rows, cols, vals)`` edges (``h[cols]`` into ``rows``)."""
    n = num_users + num_items
    ones = np.ones(len(pairs), dtype=np.float64)
    upper = sp.csr_matrix((ones, (pairs[:, 0], pairs[:, 1] + num_users)),
                          shape=(n, n))
    adj = (upper + upper.T).tocsr()
    deg = np.asarray(adj.sum(axis=1)).flatten()
    with np.errstate(divide="ignore"):
        d_inv_sqrt = np.power(deg, -0.5)
    d_inv_sqrt[np.isinf(d_inv_sqrt)] = 0.0
    norm_adj = (sp.diags(d_inv_sqrt) @ adj @ sp.diags(d_inv_sqrt)).tocsr()
    g_adj = graph_from_sp_matrix(norm_adj.astype(np.float32), msg_dtype,
                                 device)
    r = sp.coo_matrix(norm_adj[:num_users, num_users:])
    g_r = graph_from_coo(r.col, r.row, r.data.astype(np.float32), num_users,
                         msg_dtype, num_src_nodes=num_items, device=device)

    def knn(edges):
        rows, cols, vals = (t.cpu().numpy() for t in edges)
        return graph_from_coo(cols, rows, vals, num_items, msg_dtype,
                              device=device)
    return MGCNGraphs(g_adj, g_r, knn(img_edges), knn(txt_edges))


def mgcn_forward(graphs: MGCNGraphs, p: Dict, cfg: MGCNConfig):
    """(users, items, side, content) over all rows (users first in side
    and content)."""
    num_users = p["user_emb"].shape[0]
    image_feats = dense(p["v_feat"], p["image_trs"])
    text_feats = dense(p["t_feat"], p["text_trs"])
    img_item = p["item_emb"] * torch.sigmoid(dense(image_feats, p["gate_v"]))
    txt_item = p["item_emb"] * torch.sigmoid(dense(text_feats, p["gate_t"]))
    x = torch.cat([p["user_emb"], p["item_emb"]], dim=0)
    layers = [x]
    for _ in range(cfg.n_ui_layers):
        x = propagate(graphs.adj, x)
        layers.append(x)
    content = torch.stack(layers, dim=1).mean(dim=1)
    for _ in range(cfg.n_layers):
        img_item = propagate(graphs.image, img_item)
    image_embeds = torch.cat([propagate(graphs.R, img_item), img_item])
    for _ in range(cfg.n_layers):
        txt_item = propagate(graphs.text, txt_item)
    text_embeds = torch.cat([propagate(graphs.R, txt_item), txt_item])

    def query(x):
        return torch.matmul(torch.tanh(dense(x, p["query1"])),
                            p["query2"]["w"])
    att = torch.cat([query(image_embeds), query(text_embeds)], dim=-1)
    w_common = torch.softmax(att, dim=-1)
    common = w_common[:, 0:1] * image_embeds + w_common[:, 1:2] * text_embeds
    sep_img, sep_txt = image_embeds - common, text_embeds - common
    img_prefer = torch.sigmoid(dense(content, p["gate_image_prefer"]))
    txt_prefer = torch.sigmoid(dense(content, p["gate_text_prefer"]))
    side = (img_prefer * sep_img + txt_prefer * sep_txt + common) / 3
    out = content + side
    return out[:num_users], out[num_users:], side, content


def mgcn_info_nce(v1: torch.Tensor, v2: torch.Tensor, temp: float,
                  w: torch.Tensor) -> torch.Tensor:
    """The weighted InfoNCE of rows ``v1`` against ``v2``, the padded
    (zero-weight) rows out of every denominator; data-parallel, the rank's
    rows against the whole batch's ``v2``, the mean over the whole batch's
    valid rows."""
    v1 = v1 / (torch.linalg.vector_norm(v1, dim=1, keepdim=True) + 1e-12)
    v2 = v2 / (torch.linalg.vector_norm(v2, dim=1, keepdim=True) + 1e-12)
    pos = torch.exp(torch.sum(v1 * v2, dim=-1) / temp)
    ttl = torch.sum(torch.exp(v1 @ gather_batch(v2).T / temp)
                    * gather_batch_ids(w)[None, :], dim=1)
    n_valid = torch.clamp(batch_total(w), min=1.0)
    return torch.sum(-torch.log(pos / torch.clamp(ttl, min=1e-12)) * w) \
        / n_valid


def mgcn_loss(graphs: MGCNGraphs, p: Dict, cfg: MGCNConfig,
              users: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """One batch's loss (MGCN draws nothing in a step)."""
    neg = neg[:, 0]
    num_users = p["user_emb"].shape[0]
    u_all, i_all, side, content = mgcn_forward(graphs, p, cfg)
    ue, pe, ne = (gather_rows(t, ids) for t, ids in
                  ((u_all, users), (i_all, pos), (i_all, neg)))
    n_valid = torch.clamp(batch_total(w), min=1.0)
    mf = bpr_mean(ue, pe, ne, w)
    reg = 0.5 * torch.sum(torch.sum(ue ** 2 + pe ** 2 + ne ** 2, dim=-1)
                          * w) / n_valid
    cl = (mgcn_info_nce(gather_rows(side[num_users:], pos),
                        gather_rows(content[num_users:], pos), 0.2, w)
          + mgcn_info_nce(gather_rows(side[:num_users], users),
                          gather_rows(content[:num_users], users), 0.2, w))
    return mf + cfg.reg * reg + cfg.cl_loss * cl


def mgcn_lr(lr: float, rate: float, period: float, steps_per_epoch: int,
            count: int) -> float:
    """LambdaLR's per-epoch decay by update count: ``lr * rate **
    ((count // steps_per_epoch) / period)``."""
    return lr * rate ** ((count // steps_per_epoch) / period)


def mgcn_lr_f32(lr: float, rate: float, period: float, steps_per_epoch: int,
                count: torch.Tensor) -> torch.Tensor:
    """:func:`mgcn_lr` on ``count``'s device in f32 from an f32 update
    count (Adam's step count), optax's arithmetic: the epoch by floor
    division (exact below 2^24 updates), over ``period``, ``rate`` to its
    power, times ``lr``. Its power rounds as the device's ``powf`` does:
    within an ulp of XLA's."""
    epochs = torch.div(count, steps_per_epoch, rounding_mode="floor")
    return lr * torch.pow(rate, epochs / period)


class MGCN(MultimodalRecommender):
    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, MGCNConfig(**model_config), device)
        cfg = self.config
        v_feat, t_feat = item_features(self.dataset)
        if v_feat is None or t_feat is None:
            raise ValueError("MGCN requires both image and text features")
        cache = cache_dir_of(self.dataset)

        def knn(feats, tag):
            return cached_edges(
                os.path.join(cache, f"torch_{tag}_mgcn_adj_{cfg.knn_k}.npz"),
                lambda: weighted_knn_edges(
                    torch.as_tensor(feats, device=self.device), cfg.knn_k),
                self.device)
        self.graphs = mgcn_graphs(
            self.dataset.train_data.to_user_item_pairs(), self.num_users,
            self.num_items, knn(v_feat, "image"), knn(t_feat, "text"),
            mxu_msg_dtype(resolve_graph_impl(cfg.graph_impl)), self.device)
        gen = torch.Generator().manual_seed(run_config.seed)
        xavier = get_initializer("xavier_uniform")
        d = cfg.embed_dim

        def lin(d_in, d_out, bias=True):
            p = {"w": torch_layer_default((d_in, d_out), d_in, gen)}
            if bias:
                p["b"] = torch_layer_default((d_out,), d_in, gen)
            return p
        add_param_tree(self, {
            "user_emb": xavier((self.num_users, d), gen),
            "item_emb": xavier((self.num_items, d), gen),
            "v_feat": torch.from_numpy(v_feat),
            "t_feat": torch.from_numpy(t_feat),
            "image_trs": lin(v_feat.shape[1], d),
            "text_trs": lin(t_feat.shape[1], d),
            "query1": lin(d, d), "query2": lin(d, 1, bias=False),
            "gate_v": lin(d, d), "gate_t": lin(d, d),
            "gate_image_prefer": lin(d, d), "gate_text_prefer": lin(d, d)},
            self.device)
        self._split_over_model_axis()
        self.pipeline = PairwiseEpochPipeline(
            self.dataset.train_data, cfg.batch_size, self.device, num_neg=1,
            mesh=self.mesh)
        # the schedule's steps an epoch, fixed here as JAX's
        self.steps_per_epoch = self.pipeline.num_batches
        rate, period = cfg.lr_scheduler
        if self.mesh is None:
            self._flat_step = FlatTrainStep(
                self, [n for n, _ in self.named_parameters()], self._loss,
                cfg.lr, lambda count: mgcn_lr_f32(
                    cfg.lr, rate, period, self.steps_per_epoch, count))
            self.train_step = self._flat_step
            self.optimizer = self._flat_step.optimizer
        else:
            self.optimizer = make_optimizer(
                "adam", dict(self.named_parameters()), cfg.lr)
            self._adam_step = make_train_step(self.optimizer, self._loss,
                                              self.sync_gradients)
            self.train_step = self._scheduled_step

    _updates = 0        # a mesh's Adam updates taken

    @property
    def update_count(self) -> int:
        """Adam updates taken: the schedule's count (on one device Adam's
        step count, read from the device)."""
        if self._flat_step is None:
            return self._updates
        return int(self._flat_step.optimizer.state[
            self._flat_step.flat]["step"])

    @update_count.setter
    def update_count(self, count: int) -> None:
        if self._flat_step is None:
            self._updates = int(count)
            return
        self._flat_step.optimizer.state[self._flat_step.flat]["step"].fill_(
            float(count))

    def lr_at(self, count: int) -> float:
        """The learning rate of update ``count`` (in float64 on the host;
        a mesh's step takes it)."""
        rate, period = self.config.lr_scheduler
        return mgcn_lr(self.config.lr, rate, period, self.steps_per_epoch,
                       count)

    def params_tree(self):
        """The parameters as the JAX package's nested tree, the ones split
        over the model axis gathered whole (differentiable)."""
        if not self._row_blocks:
            return super().params_tree()
        return nest_params({name: self.whole_param(name)
                            for name, _ in self.named_parameters()})

    def _loss(self, users, pos, neg, w) -> torch.Tensor:
        return mgcn_loss(self.graphs, self.params_tree(), self.config, users,
                         pos, neg, w)

    def _scheduled_step(self, batch) -> torch.Tensor:
        """A mesh's step: one Adam step at the schedule's learning rate for
        this update; the loss before it."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_at(self._updates)
        loss = self._adam_step(batch)
        self._updates += 1
        return loss

    def _train_state(self) -> Dict:
        state = super()._train_state()
        state["update_count"] = self.update_count
        return state

    def _load_train_state(self, state: Dict) -> None:
        super()._load_train_state(state)
        self.update_count = int(state.get("update_count", 0))

    def load_jax_opt_state(self, count: int, mu: np.ndarray,
                           nu: np.ndarray) -> None:
        """Adam's state from JAX's flat state over the raveled parameters
        (``_finalize_setup_flat``): ``count`` also sets ``update_count``,
        the schedule's count."""
        super().load_jax_opt_state(count, mu, nu)
        self.update_count = int(count)

    def _embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        u_all, i_all, _, _ = mgcn_forward(self.graphs, self.params_tree(),
                                          self.config)
        return u_all, i_all

    @staticmethod
    def _params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
        return mgcn_params_from_jax(params)
