"""HGN — hierarchical gating networks for sequential recommendation (Ma et
al., KDD 2019): the port of ``skrx.models.HGN``.

Same config fields, defaults and checks, and the JAX package's parameters:
``user_emb`` (U, d), ``item_emb`` and ``W2`` (N + 1, d) from N(0, 0.01^2),
row N the pad; ``b2`` (N + 1,) zeros; the feature gate's ``fg_item_w`` and
``fg_user_w`` (d, d), He-uniform, with zero biases ``fg_item_b`` and
``fg_user_b``; the instance gate's ``ig_item`` (d, 1) and ``ig_user`` (d,
L), Xavier-uniform.

For a user and its last L items (pad rows read as zero,
:func:`hgn_forward`): the feature gate ``sigmoid(items @ fg_item_w +
fg_item_b + user @ fg_user_w + fg_user_b)`` scales the item embeddings,
the instance gate ``sigmoid(gated @ ig_item + user @ ig_user)`` weighs
them, and ``union`` is their weighted mean. An item's score is ``W2_i .
(user + union + sum of the item embeddings) + b2_i`` (row N of W2 and b2
zeroed). Epochs come from :class:`SequentialPairwiseEpochPipeline` (L
previous items pre-padded with N, T next items, as many negatives); a step
takes the BPR loss summed over the T slots and the weighted rows, then one
Adam step with ``reg`` added to every gradient (``adam_l2``).
``optimizer="lazy_adam"``: row-wise lazy Adam on ``user_emb``,
``item_emb``, ``W2`` and ``b2`` over the rows a batch gathers (weight
decay on those rows only), dense ``adam_l2`` on the gates, as the JAX
package's.

``predict`` gives N + 1 columns, the last scored 0; ``_eval_width`` is
N + 1. It is a tower: the user vector folds ``user + union + sum of the
item embeddings`` (d wide), and ``_topk_factors`` gives ``(uv, W2 with row
N zeroed, b2 with entry N zeroed)`` for the fused route.

Under a mesh HGN trains data-parallel: each rank takes its data index's
slice of the batch and the dense gradients sum over the data axis (with
lazy Adam the whole batch's row gradients are gathered).
"""
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..convert import hgn_params_from_jax
from ..ops.initializers import get_initializer
from ..ops.losses import bpr_loss
from ..run_config import RunConfig
from ..utils import ModelConfig
from ..ops.optim import make_lazy_train_step
from .Caser import LAZY_GATHERS
from .common import (EpochTrainedRecommender, LazyAdamTowerMixin,
                     PadColumnTowerMixin, adam_l2, make_train_step,
                     pad_masked_rows)
from .pipeline import SequentialPairwiseEpochPipeline

__all__ = ["HGN", "HGNConfig", "hgn_union", "hgn_forward", "hgn_loss",
           "hgn_gathered_loss"]


class HGNConfig(ModelConfig):
    lr: float = 1e-3
    reg: float = 1e-3
    seq_L: int = 5
    seq_T: int = 3
    embed_size: int = 64
    optimizer: str = "adam"          # adam | lazy_adam
    batch_size: int = 1024
    epochs: int = 1000
    early_stop: int = 100

    def _validate(self):
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.reg, float) and self.reg >= 0
              and self.optimizer in ("adam", "lazy_adam")
              and isinstance(self.seq_L, int) and self.seq_L > 0
              and isinstance(self.seq_T, int) and self.seq_T > 0
              and isinstance(self.embed_size, int) and self.embed_size > 0
              and isinstance(self.batch_size, int) and self.batch_size > 0)
        if not ok:
            raise ValueError(f"invalid HGN config: {self}")


def hgn_union(params: Dict[str, torch.Tensor], user_emb: torch.Tensor,
              item_embs: torch.Tensor) -> torch.Tensor:
    """(B, d) union of the feature- and instance-gated item embeddings (B,
    L, d; pad rows zero) of users with embeddings ``user_emb`` (B, d)."""
    gate = torch.sigmoid(
        item_embs @ params["fg_item_w"] + params["fg_item_b"]
        + (user_emb @ params["fg_user_w"] + params["fg_user_b"])[:, None, :])
    gated = item_embs * gate
    inst = torch.sigmoid((gated @ params["ig_item"])[..., 0]
                         + user_emb @ params["ig_user"])
    return torch.sum(gated * inst[..., None], 1) \
        / torch.sum(inst, 1, keepdim=True)


def hgn_forward(params: Dict[str, torch.Tensor], pad_id: int,
                users: torch.Tensor, seqs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(user (B, d), item embeddings (B, L, d), union (B, d)) of ``users``
    and their sequences ``seqs`` (B, L)."""
    item_embs = pad_masked_rows(params["item_emb"], seqs, pad_id)
    user_emb = params["user_emb"][users]
    return user_emb, item_embs, hgn_union(params, user_emb, item_embs)


def _hgn_bpr(user_emb, item_embs, union, w2, b2, w) -> torch.Tensor:
    """The BPR loss of the T positives (the first half of the (B, 2T)
    columns) against the T negatives, summed over the weighted rows."""
    res = torch.einsum("btd,bd->bt", w2, user_emb) + b2
    res = res + torch.einsum("btd,bd->bt", w2, union)
    res = res + torch.einsum("bld,btd->bt", item_embs, w2)
    t = res.shape[1] // 2
    return torch.sum(torch.sum(bpr_loss(res[:, :t], res[:, t:]), 1) * w)


def hgn_loss(params: Dict[str, torch.Tensor], pad_id: int,
             users: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
             w: torch.Tensor, seqs: torch.Tensor) -> torch.Tensor:
    """One batch's loss."""
    b = users.shape[0]
    user_emb, item_embs, union = hgn_forward(params, pad_id, users, seqs)
    items = torch.cat([pos.reshape(b, -1), neg.reshape(b, -1)], dim=1)
    return _hgn_bpr(user_emb, item_embs, union,
                    pad_masked_rows(params["W2"], items, pad_id),
                    pad_masked_rows(params["b2"], items, pad_id), w)


def hgn_gathered_loss(gathered, dense: Dict[str, torch.Tensor],
                      pad_id: int, batch) -> torch.Tensor:
    """:func:`hgn_loss` over a lazy step's gathered rows (user, the L
    previous items, W2 and b2 of the 2T items; pad rows read as zero), as
    the JAX package's lazy-Adam HGN."""
    users, pos, neg, w, seqs = batch
    ue, item_g, w2_g, b2_g = gathered
    b, big_l = seqs.shape
    items = torch.cat([pos.reshape(b, -1), neg.reshape(b, -1)], dim=1)
    item_embs = torch.where((seqs == pad_id)[..., None], 0.0,
                            item_g.reshape(b, big_l, -1))
    w2 = torch.where((items == pad_id)[..., None], 0.0,
                     w2_g.reshape(*items.shape, -1))
    b2 = torch.where(items == pad_id, 0.0, b2_g.reshape(items.shape))
    return _hgn_bpr(ue, item_embs, hgn_union(dense, ue, item_embs), w2, b2,
                    w)


class HGN(LazyAdamTowerMixin, PadColumnTowerMixin, EpochTrainedRecommender):

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, HGNConfig(**model_config), device)
        cfg = self.config
        self.pad_idx = self.num_items
        self._eval_width = self.num_items + 1
        d, big_l, n_pad = cfg.embed_size, cfg.seq_L, self.num_items + 1
        gen = torch.Generator().manual_seed(run_config.seed)
        normal = get_initializer("normal")
        he = get_initializer("he_uniform")
        xavier = get_initializer("xavier_uniform")

        def param(t):
            return nn.Parameter(t.to(self.device))
        self.user_emb = param(normal((self.num_users, d), gen))
        self.item_emb = param(normal((n_pad, d), gen))
        self.fg_item_w = param(he((d, d), gen))
        self.fg_item_b = param(torch.zeros(d))
        self.fg_user_w = param(he((d, d), gen))
        self.fg_user_b = param(torch.zeros(d))
        self.ig_item = param(xavier((d, 1), gen))
        self.ig_user = param(xavier((d, big_l), gen))
        self.W2 = param(normal((n_pad, d), gen))
        self.b2 = param(torch.zeros(n_pad))
        if cfg.optimizer == "lazy_adam":
            def loss_fn(gathered, dense, batch):
                return hgn_gathered_loss(gathered, dense, self.pad_idx, batch)
            self.train_step, (self.optimizer, self.dense_optimizer) = \
                make_lazy_train_step(cfg.lr, LAZY_GATHERS, loss_fn,
                                     dict(self.named_parameters()),
                                     weight_decay=cfg.reg,
                                     sync=self.sync_gradients)
        else:
            self.optimizer = adam_l2(self.parameters(), cfg.lr, cfg.reg)
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

    def _loss(self, users, pos, neg, w, prev) -> torch.Tensor:
        return hgn_loss(dict(self.named_parameters()), self.pad_idx, users,
                        pos, neg, w, prev)

    def load_jax_params(self, params: Dict[str, np.ndarray]) -> None:
        """Copy a JAX HGN's ``params`` (arrays taken with ``np.asarray``)
        into this model."""
        self._copy_params(hgn_params_from_jax(params))

    def _user_vectors(self, users: torch.Tensor) -> torch.Tensor:
        user_emb, item_embs, union = hgn_forward(
            dict(self.named_parameters()), self.pad_idx, users,
            self.seq_table[users])
        return user_emb + union + torch.sum(item_embs, 1)
