"""CDAE — collaborative denoising autoencoder (Wu et al., WSDM 2016): the
port of ``skrx.models.CDAE``.

Same config fields, defaults and checks. Parameters: ``en_emb`` and
``de_emb`` (N, d), ``user_emb`` (U, d), N(0, 0.01^2); ``en_offset`` (d,) and
``de_bias`` (N,), zeros. Epochs come from :class:`UserVecEpochPipeline`:
(users, dense 0/1 rows (B, N), weight) batches of the users with a
positive.

Each training step draws, in this order, ``max_k = max(max_positives *
num_neg, 1)`` negatives a user (``sample_negatives`` with 4 trials,
excluded against the user's positives) and the input's (B, N) dropout keep
mask (:func:`cdae_draws`, from the epoch's step generator). A user's slots
at or beyond ``n_pos * num_neg`` hold the pad id N; the negatives are set
to 1 in a (B, N + 1) indicator (a repeated negative counts once) whose pad
column is dropped. The input is the rows with the negatives also set to 1,
dropped out and scaled by ``1 / (1 - dropout)``; the encoder ``act(x @
en_emb + en_offset + user_emb[u])`` (sigmoid or identity), the decoder
``h @ de_emb.T + de_bias``. The loss (sigmoid cross-entropy or square) is
summed over the positives and negatives of each weighted row, plus ``reg``
times the L2 of the rows of ``en_emb``, ``de_emb`` and ``de_bias`` in the
batch's positive or negative columns, of ``en_offset`` and of the batch's
weighted user rows; dense Adam.

Scoring runs the encoder without dropout on the users' rows. It is a tower
(:class:`CachedUserVecChunkMixin`): the user vectors are the encoder's
output and ``_topk_factors`` gives ``(uv, de_emb, de_bias)``, so the fused
evaluation route scores them against the decoder's table.

Under a mesh CDAE trains data-parallel: a step's negatives and keep mask
are drawn for the whole batch's users (gathered over the data axis) and
each rank takes its rows; the items the L2 term covers are the whole
batch's, and the terms of the whole tables count once.
"""
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..convert import cdae_params_from_jax
from ..ops.initializers import get_initializer
from ..ops.losses import sigmoid_cross_entropy, square_loss
from ..ops.sampling import sample_negatives
from ..parallel import gather_batch_ids, local_rows, once
from ..run_config import RunConfig
from ..utils import ModelConfig
from .common import (CachedUserVecChunkMixin, EpochTrainedRecommender,
                     as_user_tensor, make_optimizer, make_train_step)
from .pipeline import UserVecEpochPipeline

__all__ = ["CDAE", "CDAEConfig", "cdae_draws", "cdae_loss"]

_Draws = Tuple[torch.Tensor, Optional[torch.Tensor]]


class CDAEConfig(ModelConfig):
    lr: float = 0.001
    reg: float = 0.001
    hidden_dim: int = 64
    dropout: float = 0.5
    num_neg: int = 5
    hidden_act: str = "sigmoid"       # identity | sigmoid
    loss_func: str = "sigmoid_cross_entropy"  # sigmoid_cross_entropy | square
    batch_size: int = 256
    epochs: int = 1000
    early_stop: int = 200

    def _validate(self):
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.reg, float) and self.reg >= 0
              and isinstance(self.hidden_dim, int) and self.hidden_dim > 0
              and isinstance(self.dropout, float) and self.dropout < 1.0
              and isinstance(self.num_neg, int) and self.num_neg >= 0
              and self.hidden_act in {"identity", "sigmoid"}
              and self.loss_func in {"sigmoid_cross_entropy", "square"}
              and isinstance(self.batch_size, int) and self.batch_size > 0
              and isinstance(self.epochs, int) and self.epochs >= 0
              and isinstance(self.early_stop, int))
        if not ok:
            raise ValueError(f"invalid CDAE config: {self}")


def cdae_draws(generator: torch.Generator, users: torch.Tensor,
               pos_table: torch.Tensor, num_items: int, max_k: int,
               dropout: float) -> _Draws:
    """One step's draws, in order: (B, max_k) int32 negatives of ``users``
    (4 trials each, excluded against their rows of ``pos_table``), and the
    (B, N) bool keep mask of the input (probability ``1 - dropout``; None
    without dropout)."""
    neg = sample_negatives(generator, users, pos_table, num_items,
                           num_neg=max_k, num_trials=4)
    if dropout <= 0:
        return neg, None
    keep = torch.rand((users.shape[0], num_items), generator=generator,
                      device=generator.device) < 1 - dropout
    return neg, keep


def batch_total_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed elementwise over the data axis (a rank's column
    statistic made the whole batch's; not differentiated)."""
    return gather_batch_ids(x.detach()[None]).sum(dim=0)


def _act(name: str, h: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(h) if name == "sigmoid" else h


def cdae_loss(params: Dict[str, torch.Tensor], cfg: CDAEConfig,
              pos_lengths: torch.Tensor, users: torch.Tensor,
              rows: torch.Tensor, w: torch.Tensor, neg: torch.Tensor,
              drop_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """One batch's loss under one step's draws (:func:`cdae_draws`):
    ``neg`` (B, max_k) before the slots past each user's ``pos_lengths *
    num_neg`` are emptied; ``params`` by the model's parameter names."""
    b, n = rows.shape
    slot_valid = (torch.arange(neg.shape[1], device=neg.device)[None, :]
                  < (pos_lengths[users] * cfg.num_neg)[:, None])
    neg = torch.where(slot_valid, neg.long(), n)
    neg_mask = torch.zeros((b, n + 1), dtype=rows.dtype, device=rows.device)
    neg_mask = neg_mask.scatter_(1, neg, 1.0)[:, :n]
    x = torch.maximum(rows, neg_mask)          # negatives set to 1 as well
    if drop_mask is not None:
        x = torch.where(drop_mask, x / (1.0 - cfg.dropout), 0.0)
    en_emb, de_emb = params["en_emb"], params["de_emb"]
    en_offset, de_bias = params["en_offset"], params["de_bias"]
    user_rows = params["user_emb"][users]
    hidden = _act(cfg.hidden_act, x @ en_emb + en_offset[None, :] + user_rows)
    logits = hidden @ de_emb.T + de_bias[None, :]
    union = torch.maximum(rows, neg_mask) * w[:, None]
    loss_elem = sigmoid_cross_entropy \
        if cfg.loss_func == "sigmoid_cross_entropy" else square_loss
    loss = torch.sum(loss_elem(logits, rows) * union)
    # the items of the whole batch
    item_mask = (batch_total_rows(torch.amax(union, dim=0)) > 0).to(
        torch.float32)
    reg_term = 0.5 * (
        once(torch.sum(torch.sum(en_emb ** 2, -1) * item_mask)
             + torch.sum(en_offset ** 2))
        + torch.sum(torch.sum(user_rows ** 2, -1) * w)
        + once(torch.sum(torch.sum(de_emb ** 2, -1) * item_mask)
               + torch.sum(de_bias ** 2 * item_mask)))
    return loss + cfg.reg * reg_term


class CDAE(CachedUserVecChunkMixin, EpochTrainedRecommender):
    _JAX_PARAMS = ("de_bias", "de_emb", "en_emb", "en_offset", "user_emb")
    _CAPTURED_STEP = True

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, CDAEConfig(**model_config), device)
        cfg = self.config
        gen = torch.Generator().manual_seed(run_config.seed)
        init = get_initializer("normal")
        d, n = cfg.hidden_dim, self.num_items
        self.en_emb = nn.Parameter(init((n, d), gen).to(self.device))
        self.en_offset = nn.Parameter(torch.zeros(d, device=self.device))
        self.de_emb = nn.Parameter(init((n, d), gen).to(self.device))
        self.de_bias = nn.Parameter(torch.zeros(n, device=self.device))
        self.user_emb = nn.Parameter(
            init((self.num_users, d), gen).to(self.device))
        self.optimizer = make_optimizer("adam", dict(self.named_parameters()),
                                        cfg.lr)
        self.train_step = make_train_step(self.optimizer, self._loss,
                                          self.sync_gradients)
        self.pipeline = UserVecEpochPipeline(self.dataset.train_data,
                                             cfg.batch_size, self.device,
                                             mesh=self.mesh)
        lengths = self.dataset.train_data.to_padded_positive_table().lengths
        self.pos_lengths = torch.as_tensor(lengths, device=self.device)
        # negative slots a user: n_pos * num_neg, padded to the widest user
        self.max_k = max(int(lengths.max()) * cfg.num_neg, 1)

    def step_draws(self, users: torch.Tensor) -> _Draws:
        """The next training step's draws for ``users``, from the epoch's
        generator."""
        return cdae_draws(self.step_generator(), users,
                          self.pipeline.pos_table, self.num_items,
                          self.max_k, self.config.dropout)

    def _loss(self, users, rows, w, draws: Optional[_Draws] = None
              ) -> torch.Tensor:
        """The batch's loss under ``draws`` (negatives, keep mask), by
        default the next drawn."""
        if draws is None:       # drawn for the whole batch's users
            draws = tuple(map(local_rows,
                              self.step_draws(gather_batch_ids(users))))
        return cdae_loss(dict(self.named_parameters()), self.config,
                         self.pos_lengths, users, rows, w, *draws)

    def _user_vectors(self, users: torch.Tensor) -> torch.Tensor:
        rows = self.pipeline.rows_for(users)
        return _act(self.config.hidden_act,
                    rows @ self.en_emb + self.en_offset[None, :]
                    + self.user_emb[users])

    def _score_user_chunk(self, uv: torch.Tensor, item_lo: int,
                          item_hi: int) -> torch.Tensor:
        return uv @ self.de_emb[item_lo:item_hi].T \
            + self.de_bias[None, item_lo:item_hi]

    def _topk_factors(self, uv):
        return uv, self.de_emb, self.de_bias

    @torch.no_grad()
    def predict(self, users) -> torch.Tensor:
        """(B, N) f32 scores of ``users`` on the model's device."""
        uv = self._user_vectors(as_user_tensor(users, self.device))
        return self._score_user_chunk(uv, 0, self.num_items)

    def load_jax_params(self, params: Dict[str, np.ndarray]) -> None:
        """Copy a JAX CDAE's ``params`` (arrays taken with ``np.asarray``)
        into this model."""
        self._copy_params(cdae_params_from_jax(params))
