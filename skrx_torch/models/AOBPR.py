"""AOBPR — BPR with adaptive, rank-biased oversampling of negatives (Rendle
and Freudenthaler, WSDM 2014): the port of ``skrx.models.AOBPR``.

Same config fields and defaults. Parameters ``user_emb`` (U, d) and
``item_emb`` (N, d) drawn from uniform [0, 1). An epoch permutes the padded
training pairs and draws each pair's rank from ``exp(-rank / alpha)``
(``rank_logits = -rank / alpha``); per step, each row draws a factor with
probability ``|u_f| * std_f`` (Gumbel-argmax over ``log(fprob + 1e-24)``,
so a row of all-zero ``fprob`` draws uniformly) and takes as its negative
the item at that rank of the factor's descending order (ascending when
``u_f < 0``). The per-factor order and std are taken at the epoch's start
and again every ``round(N ln N / batch)`` steps (never at step 0). The
update is plain SGD with weight decay; as in the JAX package's documented
deviation, the deltas of rows a batch touches more than once are summed,
not applied one after another. The loss is ``sum(-log sigmoid(x) * w) /
max(sum(w), 1)`` over the epoch. ``predict`` is ``user_emb[users] @
item_emb.T``, so every evaluation strategy applies.

Under a mesh every rank draws the whole batch's negatives, computes the
deltas of its data index's rows, and applies the whole batch's deltas
(gathered over the data axis in batch order) to its replicated tables.
"""
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..convert import two_tables_from_jax
from ..ops.sampling import categorical_cdf, draw_with_replacement
from ..ops.scatter import ordered_row_sum
from ..parallel import batch_total, gather_batch_ids, local_rows
from ..run_config import RunConfig
from ..utils import ModelConfig
from .base import TorchRecommender
from .common import ChunkedDotPredictMixin, as_user_tensor
from .pipeline import epoch_generator, pad_to_batches

__all__ = ["AOBPR", "AOBPRConfig", "sort_factors"]


class AOBPRConfig(ModelConfig):
    lr: float = 1e-2
    reg: float = 5e-2
    embed_size: int = 64
    alpha: int = 6682
    batch_size: int = 1024
    epochs: int = 500
    early_stop: int = 100

    def _validate(self):
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.reg, float) and self.reg >= 0
              and isinstance(self.embed_size, int) and self.embed_size > 0
              and isinstance(self.alpha, int) and self.alpha > 0
              and isinstance(self.batch_size, int) and self.batch_size > 0)
        if not ok:
            raise ValueError(f"invalid AOBPR config: {self}")


def sort_factors(item_emb: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) item ids of each factor in descending order (ties by id) and
    the (D,) population std of each factor."""
    return (torch.argsort(-item_emb, dim=0, stable=True),
            torch.std(item_emb, dim=0, unbiased=False))


class AOBPR(ChunkedDotPredictMixin, TorchRecommender):
    _JAX_PARAMS = ("user_emb", "item_emb")
    # each step's rows in reverse order: the same examples and draws, the
    # updates of repeated rows summed in another order (a check's
    # calibration)
    rows_reversed = False

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, AOBPRConfig(**model_config), device)
        cfg = self.config
        n, d = self.num_items, cfg.embed_size
        gen = torch.Generator().manual_seed(run_config.seed)
        # updated by hand (SGD), never through autograd
        self.user_emb = nn.Parameter(
            torch.rand((self.num_users, d), generator=gen).to(self.device),
            requires_grad=False)
        self.item_emb = nn.Parameter(
            torch.rand((n, d), generator=gen).to(self.device),
            requires_grad=False)
        pairs = self.dataset.train_data.to_user_item_pairs()
        users, weights = pad_to_batches(pairs[:, 0], cfg.batch_size)
        pos, _ = pad_to_batches(pairs[:, 1], cfg.batch_size)
        self._users = torch.as_tensor(users.astype(np.int64),
                                      device=self.device)
        self._pos = torch.as_tensor(pos.astype(np.int64), device=self.device)
        self._w = torch.as_tensor(weights, device=self.device)
        self.num_batches = len(users) // cfg.batch_size
        # the rank of each pair's negative is drawn from exp(-rank / alpha)
        rank = np.arange(1, n + 1)
        self._rank_prob = torch.as_tensor(
            np.exp(-rank / cfg.alpha).astype(np.float32), device=self.device)
        self._rank_cdf = categorical_cdf(self._rank_prob)
        # the JAX package re-sorts every N ln N examples
        self.resort_every = max(1, round(n * math.log(max(n, 2))
                                         / cfg.batch_size))

    def _negatives(self, gen: torch.Generator, users: torch.Tensor,
                   rank_idx: torch.Tensor, sorted_items: torch.Tensor,
                   std: torch.Tensor) -> torch.Tensor:
        """Each row's negative: a factor drawn by Gumbel-argmax over
        ``log(|u_f| * std_f + 1e-24)``, then the item at the row's rank of
        that factor's order (from the other end when ``u_f <= 0``)."""
        ue = self.user_emb[users]
        logits = torch.log(torch.abs(ue) * std[None, :] + 1e-24)
        expo = torch.empty_like(logits).exponential_(generator=gen)
        factor = torch.argmax(logits - torch.log(expo), dim=1)
        u_f = ue.gather(1, factor[:, None])[:, 0]
        row = torch.where(u_f > 0, rank_idx, self.num_items - rank_idx - 1)
        return sorted_items[row, factor]

    def _sgd_step(self, users: torch.Tensor, pos: torch.Tensor,
                  neg: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """One SGD step of the BPR loss with weight decay, deltas of repeated
        rows summed; returns the batch's summed loss (weighted). A rank of
        a mesh takes its slice of the batch and applies the whole batch's
        deltas."""
        lr, reg = self.config.lr, self.config.reg
        ue, ie, je = self.user_emb[users], self.item_emb[pos], \
            self.item_emb[neg]
        x_uij = torch.sum(ue * (ie - je), -1)
        cmg = (torch.sigmoid(-x_uij) * w)[:, None]
        wc = w[:, None]
        du = lr * (cmg * (ie - je) - reg * ue * wc)
        di = lr * (cmg * ue - reg * ie * wc)
        dj = lr * (-cmg * ue - reg * je * wc)
        loss = torch.sum(-torch.nn.functional.logsigmoid(x_uij) * w)
        users, pos, neg, du, di, dj = map(gather_batch_ids,
                                          (users, pos, neg, du, di, dj))
        # repeated rows summed in batch order (a card's index_add_ adds in
        # no fixed order), so every replica takes the same update
        for table, ids, delta in ((self.user_emb, users, du),
                                  (self.item_emb, pos, di),
                                  (self.item_emb, neg, dj)):
            ordered_row_sum(ids, delta, table.shape[0], out=table)
        return loss

    @torch.no_grad()
    def _train_epoch(self, epoch: int) -> float:
        gen = epoch_generator(self.run_config.seed + 1, epoch, self.device)
        s, bsz = len(self._users), self.config.batch_size
        perm = torch.randperm(s, generator=gen, device=self.device)
        users, pos, w = self._users[perm], self._pos[perm], self._w[perm]
        rank_idx = draw_with_replacement(self._rank_prob, s, gen,
                                         self._rank_cdf)
        sorted_items, std = sort_factors(self.item_emb)
        total = torch.zeros((), device=self.device)
        for step in range(self.num_batches):
            if step > 0 and step % self.resort_every == 0:
                sorted_items, std = sort_factors(self.item_emb)
            sl = slice(step * bsz, (step + 1) * bsz)
            neg = self._negatives(gen, users[sl], rank_idx[sl], sorted_items,
                                  std)
            batch = (users[sl], pos[sl], neg, w[sl])
            if self.rows_reversed:
                batch = tuple(t.flip(0) for t in batch)
            total += self._sgd_step(*map(local_rows, batch))
        return float(batch_total(total) / torch.clamp(torch.sum(w), min=1.0))

    def load_jax_params(self, params: Dict[str, np.ndarray]) -> None:
        """Copy a JAX AOBPR's ``params`` (arrays taken with ``np.asarray``)
        into this model."""
        self._copy_params(two_tables_from_jax(params))

    def _chunk_embeddings(self):
        return self.user_emb, self.item_emb

    @torch.no_grad()
    def predict(self, users) -> torch.Tensor:
        """(B, N) f32 scores ``user_emb[users] @ item_emb.T``."""
        users = as_user_tensor(users, self.device)
        return torch.matmul(self.user_emb[users], self.item_emb.T)
