"""Caser — convolutional sequence embedding (Tang & Wang, WSDM 2018): the
port of ``skrx.models.Caser``.

Same config fields, defaults and checks, and the JAX package's parameter
layout: ``user_emb`` (U, d) and ``item_emb`` (N + 1, d) from N(0,
0.01^2), row N the pad; the vertical convolution ``conv_v`` (L, 1, nv) and
``conv_v_b`` (nv,); the horizontal ones ``conv_h.<i>`` (i + 1, d, nh) and
``conv_h_b.<i>`` (nh,) for heights 1..L; ``fc1_w`` (nv d + nh L, d),
``fc1_b`` (d,); ``W2`` (N + 1, 2d) from N(0, 0.01^2) and ``b2`` (N + 1,)
zeros. The convolutions and the fully connected layer start at
``torch_layer_default`` (U(-1/sqrt(fan_in), 1/sqrt(fan_in))).

A user's vector (:func:`caser_user_vectors`): the embeddings of its last L
items (pad rows read as zero), the vertical convolution as an einsum over
the L axis, each horizontal one over its windows with relu and a max over
the windows, the concatenation dropped out (training only; the keep mask
is an argument), ``relu(. @ fc1_w + fc1_b)``, and the user's embedding
beside it: (B, 2d). Epochs come from :class:`SequentialPairwiseEpochPipeline`
(L previous items pre-padded with N, T next items, as many negatives); a
step takes the mean sigmoid cross-entropy over the T positives and T
negatives of each row, averaged over the weighted rows, then one Adam step
with ``l2_reg`` added to every gradient (``adam_l2``: the pad rows, whose
gradient is zero, decay too). Each step's dropout mask comes from the
epoch's step generator. ``optimizer="lazy_adam"``: row-wise lazy Adam on
``user_emb``, ``item_emb``, ``W2`` and ``b2`` over the rows a batch
gathers (weight decay on those rows only), dense ``adam_l2`` on the
convolutions and ``fc1``, as the JAX package's.

Scores are ``uv @ W2.T + b2`` with row N of both zeroed: ``predict`` gives
N + 1 columns, the last scored 0, and ``_eval_width`` is N + 1, so every
route ranks the same columns. It is a tower: ``_topk_factors`` gives
``(uv, W2 with row N zeroed, b2 with entry N zeroed)`` for the fused
route.

Under a mesh Caser trains data-parallel: each rank takes its data index's
slice of the batch and of the step's dropout mask (drawn at the whole
batch's shape), the mean divides by the whole batch's valid rows, and the
dense gradients sum over the data axis (with lazy Adam the whole batch's
row gradients are gathered).
"""
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..convert import caser_params_from_jax
from ..ops.initializers import get_initializer, torch_layer_default
from ..ops.losses import sigmoid_cross_entropy
from ..parallel import batch_total, global_rows, local_rows
from ..run_config import RunConfig
from ..utils import ModelConfig
from ..ops.optim import make_lazy_train_step
from .common import (EpochTrainedRecommender, LazyAdamTowerMixin,
                     PadColumnTowerMixin, adam_l2, make_train_step,
                     pad_masked_rows)
from .pipeline import SequentialPairwiseEpochPipeline

__all__ = ["Caser", "CaserConfig", "caser_features", "caser_user_vectors",
           "caser_loss", "caser_gathered_loss", "caser_keep_mask",
           "LAZY_GATHERS"]


class CaserConfig(ModelConfig):
    lr: float = 1e-3
    l2_reg: float = 1e-6
    embed_size: int = 64
    seq_L: int = 5
    seq_T: int = 3
    nv: int = 4
    nh: int = 16
    dropout: float = 0.5
    optimizer: str = "adam"          # adam | lazy_adam
    batch_size: int = 1024
    epochs: int = 500
    early_stop: int = 100

    def _validate(self):
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.l2_reg, float) and self.l2_reg >= 0
              and self.optimizer in ("adam", "lazy_adam")
              and isinstance(self.embed_size, int) and self.embed_size > 0
              and isinstance(self.seq_L, int) and self.seq_L > 0
              and isinstance(self.seq_T, int) and self.seq_T > 0
              and isinstance(self.nv, int) and self.nv > 0
              and isinstance(self.nh, int) and self.nh > 0
              and isinstance(self.dropout, float)
              and isinstance(self.batch_size, int) and self.batch_size > 0)
        if not ok:
            raise ValueError(f"invalid Caser config: {self}")


def caser_keep_mask(generator: torch.Generator, batch: int,
                    cfg: CaserConfig) -> Optional[torch.Tensor]:
    """One step's (B, nv d + nh L) bool dropout keep mask (probability ``1
    - dropout``), None without dropout."""
    if cfg.dropout <= 0:
        return None
    width = cfg.nv * cfg.embed_size + cfg.nh * cfg.seq_L
    return torch.rand((batch, width), generator=generator,
                      device=generator.device) < 1 - cfg.dropout


def caser_features(params: Dict[str, torch.Tensor], cfg: CaserConfig,
                   item_embs: torch.Tensor, user_emb: torch.Tensor,
                   keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 2d) user vectors from the embeddings of the last L items (B, L,
    d; pad rows zero) and of the users (B, d); ``keep`` the dropout mask
    (None: no dropout)."""
    b, big_l, _ = item_embs.shape
    out_v = torch.einsum("bld,lkv->bvd", item_embs, params["conv_v"]) \
        + params["conv_v_b"][None, :, None]
    outs = [out_v.reshape(b, -1)]
    for i in range(big_l):
        h = i + 1
        windows = torch.stack([item_embs[:, j:j + h, :]
                               for j in range(big_l - h + 1)], dim=1)
        conv = torch.einsum("bwhd,hdn->bwn", windows,
                            params[f"conv_h.{i}"]) + params[f"conv_h_b.{i}"]
        outs.append(torch.amax(torch.relu(conv), dim=1))
    out = torch.cat(outs, dim=1)
    if keep is not None:
        out = torch.where(keep, out / (1 - cfg.dropout), 0.0)
    z = torch.relu(out @ params["fc1_w"] + params["fc1_b"])
    return torch.cat([z, user_emb], dim=1)


def caser_user_vectors(params: Dict[str, torch.Tensor], cfg: CaserConfig,
                       pad_id: int, users: torch.Tensor, seqs: torch.Tensor,
                       keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 2d) user vectors of ``seqs`` (B, L); ``keep`` the dropout mask
    (None: no dropout)."""
    return caser_features(params, cfg,
                          pad_masked_rows(params["item_emb"], seqs, pad_id),
                          params["user_emb"][users], keep)


def _caser_scores_loss(x: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """The mean sigmoid cross-entropy of the T positives (the first half
    of the (B, 2T) columns) and T negatives, over the weighted rows."""
    scores = torch.einsum("btd,bd->bt", w2, x) + b2
    t = scores.shape[1] // 2
    loss = (sigmoid_cross_entropy(scores[:, :t], 1.0)
            + sigmoid_cross_entropy(scores[:, t:], 0.0))
    return torch.sum(torch.mean(loss, 1) * w) / torch.clamp(batch_total(w),
                                                            min=1.0)


def _batch_items(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    b = pos.shape[0]
    return torch.cat([pos.reshape(b, -1), neg.reshape(b, -1)], dim=1)


def caser_loss(params: Dict[str, torch.Tensor], cfg: CaserConfig,
               pad_id: int, users: torch.Tensor, pos: torch.Tensor,
               neg: torch.Tensor, w: torch.Tensor, seqs: torch.Tensor,
               keep: Optional[torch.Tensor]) -> torch.Tensor:
    """One batch's loss under one step's dropout mask."""
    x = caser_user_vectors(params, cfg, pad_id, users, seqs, keep)
    items = _batch_items(pos, neg)
    return _caser_scores_loss(x, pad_masked_rows(params["W2"], items, pad_id),
                              pad_masked_rows(params["b2"], items, pad_id), w)


def caser_gathered_loss(gathered, dense: Dict[str, torch.Tensor],
                        cfg: CaserConfig, pad_id: int, batch,
                        keep: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`caser_loss` over a lazy step's gathered rows (user, the L
    previous items, W2 and b2 of the 2T items; pad rows read as zero), as
    the JAX package's lazy-Adam Caser."""
    users, pos, neg, w, seqs = batch[:5]
    ue, item_g, w2_g, b2_g = gathered
    b, big_l = seqs.shape
    items = _batch_items(pos, neg)
    item_embs = torch.where((seqs == pad_id)[..., None], 0.0,
                            item_g.reshape(b, big_l, -1))
    w2 = torch.where((items == pad_id)[..., None], 0.0,
                     w2_g.reshape(*items.shape, -1))
    b2 = torch.where(items == pad_id, 0.0, b2_g.reshape(items.shape))
    return _caser_scores_loss(caser_features(dense, cfg, item_embs, ue, keep),
                              w2, b2, w)


def _item_rows(batch) -> torch.Tensor:
    return _batch_items(batch[1], batch[2]).reshape(-1)


# the rows a lazy step gathers (Caser and HGN), in the loss's order
LAZY_GATHERS = (("user_emb", lambda b: b[0]),
                ("item_emb", lambda b: b[4].reshape(-1)),
                ("W2", _item_rows), ("b2", _item_rows))


class Caser(LazyAdamTowerMixin, PadColumnTowerMixin,
            EpochTrainedRecommender):

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, CaserConfig(**model_config), device)
        cfg = self.config
        self.pad_idx = self.num_items
        self._eval_width = self.num_items + 1
        d, big_l = cfg.embed_size, cfg.seq_L
        fc1_in = cfg.nv * d + cfg.nh * big_l
        gen = torch.Generator().manual_seed(run_config.seed)
        normal = get_initializer("normal")

        def param(t):
            return nn.Parameter(t.to(self.device))
        self.user_emb = param(normal((self.num_users, d), gen))
        self.item_emb = param(normal((self.num_items + 1, d), gen))
        self.conv_v = param(torch_layer_default((big_l, 1, cfg.nv), big_l,
                                                gen))
        self.conv_v_b = param(torch_layer_default((cfg.nv,), big_l, gen))
        self.conv_h = nn.ParameterList(
            [param(torch_layer_default((i + 1, d, cfg.nh), (i + 1) * d, gen))
             for i in range(big_l)])
        self.conv_h_b = nn.ParameterList(
            [param(torch_layer_default((cfg.nh,), (i + 1) * d, gen))
             for i in range(big_l)])
        self.fc1_w = param(torch_layer_default((fc1_in, d), fc1_in, gen))
        self.fc1_b = param(torch_layer_default((d,), fc1_in, gen))
        self.W2 = param(normal((self.num_items + 1, 2 * d), gen))
        self.b2 = param(torch.zeros(self.num_items + 1))
        if cfg.optimizer == "lazy_adam":
            def loss_fn(gathered, dense, batch):
                keep = batch[5] if len(batch) > 5 else local_rows(
                    self.step_keep_mask(global_rows(batch[0].shape[0])))
                return caser_gathered_loss(gathered, dense, cfg,
                                           self.pad_idx, batch, keep)
            self.train_step, (self.optimizer, self.dense_optimizer) = \
                make_lazy_train_step(cfg.lr, LAZY_GATHERS, loss_fn,
                                     dict(self.named_parameters()),
                                     weight_decay=cfg.l2_reg,
                                     sync=self.sync_gradients)
        else:
            self.optimizer = adam_l2(self.parameters(), cfg.lr, cfg.l2_reg)
            self.train_step = make_train_step(self.optimizer, self._loss,
                                              self.sync_gradients)
        self.pipeline = SequentialPairwiseEpochPipeline(
            self.dataset.train_data, cfg.batch_size, self.device,
            num_previous=big_l, num_next=cfg.seq_T, pad=self.pad_idx,
            mesh=self.mesh)
        table, _ = self.dataset.train_data.to_padded_seq_tensor(
            big_l, pad_value=self.pad_idx)
        self.seq_table = torch.as_tensor(table.astype(np.int64),
                                         device=self.device)

    def step_keep_mask(self, batch: int) -> Optional[torch.Tensor]:
        """The next training step's dropout mask, from the epoch's
        generator."""
        return caser_keep_mask(self.step_generator(), batch, self.config)

    def _loss(self, users, pos, neg, w, prev, keep=None) -> torch.Tensor:
        """The batch's loss under the dropout mask ``keep``, by default the
        next drawn."""
        if keep is None and self.config.dropout > 0:
            # drawn at the whole batch's shape, the rank's rows taken
            keep = local_rows(self.step_keep_mask(global_rows(
                users.shape[0])))
        return caser_loss(dict(self.named_parameters()), self.config,
                          self.pad_idx, users, pos, neg, w, prev, keep)

    def load_jax_params(self, params: Dict) -> None:
        """Copy a JAX Caser's ``params`` (arrays taken with ``np.asarray``)
        into this model."""
        self._copy_params(caser_params_from_jax(params))

    def _user_vectors(self, users: torch.Tensor) -> torch.Tensor:
        return caser_user_vectors(dict(self.named_parameters()), self.config,
                                  self.pad_idx, users, self.seq_table[users])
