"""BM3 — bootstrapped multimodal recommendation without negatives (Zhou et
al., WWW 2023): the port of ``skrx.models.BM3``.

Same config fields, defaults, checks and ``param_space`` (``feat_dim`` is
accepted and, as in the reference, unused: the projectors are
``embed_dim`` wide). Parameters, in the JAX package's layout:
``user_emb``, ``item_emb`` (Xavier uniform), the shared predictor
``pred_w`` (Xavier normal), ``pred_b`` (0), and per modality its trainable
feature table (``v_feat``, ``t_feat``) and projector (``image_trs``,
``text_trs``: ``w`` Xavier normal, ``b`` 0).

The encoder is LightGCN over :func:`~skrx_torch.models.SelfCF.
selfcf_norm_adj` (kernel #11): the mean of layers 0..L, the item rows plus
the item-id embedding. The loss: each side's prediction against the
other's dropped-out, detached target (``1 - cos``), for text and image the
projected features' prediction against the item target and against their
own target, ``reg`` times ``(|U|_F + |I|_F) / N`` of the encoder's outputs,
the modality terms times ``cl_weight``; every term a weighted mean over
the batch. A target's keep mask is drawn over its whole table, (U, d) or
(N, d), and then gathered, as JAX draws it, so a user or item that appears
twice in a batch keeps one mask row (:func:`bm3_draws`, in the order users,
items, text, image; ``_loss`` takes them as tensors). The projections and
the predictor are applied to the batch's rows only (JAX projects whole
tables; the other rows get no gradient either way); dense Adam.
``evaluate()`` freezes the predictor's outputs of the encoder, which
``predict``, the chunked and fused routes and serving score by a dot.

Under a mesh the graph's destination rows split over every rank (segsum on
each rank's edges) with the rows of ``user_emb`` and ``item_emb`` in the
rank's block; the encoder's outputs are gathered whole for the rank's
slice of the batch, the means are over the whole batch's valid rows, the
``reg`` term of the whole tables counts once, and the other parameters'
gradients sum over the data axis.
"""
from typing import Dict, Optional, Tuple, Union

import torch

from ..convert import bm3_params_from_jax
from ..ops.attention import dense
from ..ops.graph import Graph, propagate_layers
from ..ops.initializers import get_initializer
from ..run_config import RunConfig
from ..utils import ModelConfig
from .SelfCF import selfcf_norm_adj
from ..parallel import batch_total, once
from .common import (GRAPH_IMPLS, add_param_tree, build_prop_graph,
                     gather_rows, make_optimizer, make_train_step, node_rows,
                     node_table_rows, whole_nodes)
from .multimodal import MultimodalRecommender, item_features
from .pipeline import InteractionEpochPipeline

__all__ = ["BM3", "BM3Config", "bm3_forward", "bm3_draws", "bm3_loss"]

_Draws = Tuple[Optional[torch.Tensor], ...]


class BM3Config(ModelConfig):
    lr: float = 1e-3
    reg: float = 0.1
    embed_dim: int = 64
    feat_dim: int = 64                # accepted, unused (as the reference)
    n_layers: int = 1
    dropout: float = 0.3
    cl_weight: float = 2.0
    graph_impl: str = "auto"  # auto | segment | mxu | mxu_bf16
    batch_size: int = 2048
    epochs: int = 1000
    early_stop: int = 200

    @classmethod
    def param_space(cls):
        return {"n_layers": [1, 2], "reg": [0.1, 0.01],
                "dropout": [0.3, 0.5]}

    def _validate(self):
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.reg, float) and self.reg >= 0
              and isinstance(self.embed_dim, int) and self.embed_dim > 0
              and isinstance(self.n_layers, int) and self.n_layers > 0
              and isinstance(self.dropout, float) and 0 <= self.dropout < 1
              and isinstance(self.cl_weight, float) and self.cl_weight >= 0
              and self.graph_impl in GRAPH_IMPLS
              and isinstance(self.batch_size, int) and self.batch_size > 0)
        if not ok:
            raise ValueError(f"invalid BM3 config: {self}")


def bm3_forward(graph: Graph, p: Dict, n_layers: int,
                num_users: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(users, items): the mean of layers 0..n_layers of the propagated
    ego embeddings, the items plus ``item_emb``. On a sharded graph the
    tables are the rank's rows, ``num_users`` the whole count, and both
    come out whole."""
    if num_users is None:
        num_users = p["user_emb"].shape[0]
    ego = node_rows(graph, p["user_emb"], p["item_emb"])
    combined = propagate_layers(graph, ego, n_layers, "mean")
    d = ego.shape[1]
    both = whole_nodes(graph, torch.cat([combined, ego], dim=1))
    return both[:num_users, :d], (both[num_users:, :d]
                                  + both[num_users:, d:])


def bm3_draws(generator: torch.Generator, num_users: int, num_items: int,
              dim: int, dropout: float, has_t: bool, has_v: bool) -> _Draws:
    """One step's bool keep masks (probability ``1 - dropout``) over whole
    tables: users (U, d), items (N, d), then text and image (N, d) where
    the modality exists (None otherwise, and all None at dropout 0)."""
    dev = generator.device
    shapes = [(num_users, dim), (num_items, dim),
              (num_items, dim) if has_t else None,
              (num_items, dim) if has_v else None]
    if dropout <= 0:
        return (None,) * 4
    return tuple(None if s is None else
                 torch.rand(s, generator=generator, device=dev) < 1 - dropout
                 for s in shapes)


def _target(x: torch.Tensor, keep: Optional[torch.Tensor],
            ids: torch.Tensor, dropout: float) -> torch.Tensor:
    """Rows ``ids`` of ``x`` detached, under rows ``ids`` of the table-wide
    keep mask, scaled by ``1 / (1 - dropout)``."""
    x = x.detach()
    if dropout <= 0:
        return x
    return torch.where(keep[ids], x / (1 - dropout), 0.0)


def _cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-12)
    b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-12)
    return torch.sum(a * b, dim=-1)


def bm3_loss(graph: Graph, p: Dict, cfg: BM3Config, users: torch.Tensor,
             items: torch.Tensor, w: torch.Tensor, draws: _Draws,
             num_users: Optional[int] = None) -> torch.Tensor:
    """One batch's loss under one step's keep masks (:func:`bm3_draws`);
    ``p`` the nested parameters; ``num_users`` as :func:`bm3_forward`."""
    mask_u, mask_i, mask_t, mask_v = draws
    u_ori, i_ori = bm3_forward(graph, p, cfg.n_layers, num_users)
    u_rows, i_rows = gather_rows(u_ori, users), gather_rows(i_ori, items)
    u_tgt = _target(u_rows, mask_u, users, cfg.dropout)
    i_tgt = _target(i_rows, mask_i, items, cfg.dropout)
    pred = {"w": p["pred_w"], "b": p["pred_b"]}
    u_on, i_on = dense(u_rows, pred), dense(i_rows, pred)
    n_valid = torch.clamp(batch_total(w), min=1.0)

    def wmean(x):
        return torch.sum(x * w) / n_valid

    loss = wmean(1 - _cos(u_on, i_tgt)) + wmean(1 - _cos(i_on, u_tgt))
    cl = 0.0
    for feat, trs, mask in (("t_feat", "text_trs", mask_t),
                            ("v_feat", "image_trs", mask_v)):
        if feat not in p:
            continue
        online = dense(gather_rows(p[feat], items), p[trs])
        tgt = _target(online, mask, items, cfg.dropout)
        on = dense(online, pred)
        cl = cl + wmean(1 - _cos(on, i_tgt)) + wmean(1 - _cos(on, tgt))
    reg = once((torch.linalg.vector_norm(u_ori)
                + torch.linalg.vector_norm(i_ori)) / i_ori.shape[0])
    return loss + cfg.reg * reg + cfg.cl_weight * cl


class BM3(MultimodalRecommender):
    _CAPTURED_STEP = True

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, BM3Config(**model_config), device)
        cfg = self.config
        v_feat, t_feat = item_features(self.dataset)
        self.graph = build_prop_graph(
            selfcf_norm_adj(self.dataset.train_data.to_user_item_pairs(),
                            self.num_users, self.num_items),
            cfg.graph_impl, mesh=self.mesh, device=self.device)
        gen = torch.Generator().manual_seed(run_config.seed)
        xavier_u = get_initializer("xavier_uniform")
        xavier_n = get_initializer("xavier_normal")
        d = cfg.embed_dim
        tree = node_table_rows(self, self.graph, {
            "user_emb": xavier_u((self.num_users, d), gen),
            "item_emb": xavier_u((self.num_items, d), gen)})
        tree.update({"pred_w": xavier_n((d, d), gen),
                     "pred_b": torch.zeros(d)})
        for feat, trs, x in (("v_feat", "image_trs", v_feat),
                             ("t_feat", "text_trs", t_feat)):
            if x is not None:
                tree[feat] = torch.from_numpy(x)
                tree[trs] = {"w": xavier_n((x.shape[1], d), gen),
                             "b": torch.zeros(d)}
        add_param_tree(self, tree, self.device)
        self.has_t, self.has_v = t_feat is not None, v_feat is not None
        self.optimizer = make_optimizer("adam", dict(self.named_parameters()),
                                        cfg.lr)
        self.train_step = make_train_step(self.optimizer, self._loss,
                                          self.sync_gradients)
        self.pipeline = InteractionEpochPipeline(
            self.dataset.train_data, cfg.batch_size, self.device,
            mesh=self.mesh)

    def step_draws(self) -> _Draws:
        """The next training step's keep masks, from the epoch's
        generator."""
        cfg = self.config
        return bm3_draws(self.step_generator(), self.num_users,
                         self.num_items, cfg.embed_dim, cfg.dropout,
                         self.has_t, self.has_v)

    def _loss(self, users, items, w, draws: Optional[_Draws] = None
              ) -> torch.Tensor:
        """The batch's loss under ``draws`` (:func:`bm3_draws`), by default
        the next drawn."""
        if draws is None:
            draws = self.step_draws()
        return bm3_loss(self.graph, self.params_tree(), self.config, users,
                        items, w, draws, self.num_users)

    def _embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        p = self.params_tree()
        u_ori, i_ori = bm3_forward(self.graph, p, self.config.n_layers,
                                   self.num_users)
        pred = {"w": p["pred_w"], "b": p["pred_b"]}
        return dense(u_ori, pred), dense(i_ori, pred)

    @staticmethod
    def _params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
        return bm3_params_from_jax(params)
