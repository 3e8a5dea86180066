"""GRU4Rec+ — session RNN with sampled negatives and the max losses
(Hidasi & Karatzoglou, CIKM 2018): the port of ``skrx.models.GRU4RecPlus``.

Everything of :class:`~skrx_torch.models.GRU4Rec.GRU4Rec` (the same
parameters, so ``load_jax_params`` takes a JAX GRU4RecPlus's), plus
``n_sample`` negatives a step appended to the step's targets, drawn from
popularity ** ``sample_alpha`` over the training pairs (an item never
seen has log-weight -1e30: probability 0) by
:func:`~skrx_torch.ops.sampling.draw_with_replacement` on the epoch's step
generator (stream 1 of ``epoch_generator(seed + 1, epoch)``;
JAX draws ``jax.random.categorical`` over the same log-weights), and the
BPR-max or TOP1-max loss: each row's negatives weighted by a softmax over
its logits with the positive (the diagonal) masked out.
"""
from typing import Optional

import numpy as np
import torch

from ..ops.rnn import ACTIVATIONS
from ..ops.sampling import categorical_cdf, draw_with_replacement
from ..parallel import batch_mean, batch_offset
from ..utils import ModelConfig
from .GRU4Rec import FINAL_ACTS, GRU4Rec, diagonal_positives

__all__ = ["GRU4RecPlus", "GRU4RecPlusConfig", "softmax_neg",
           "gru4recplus_loss_from_logits"]


class GRU4RecPlusConfig(ModelConfig):
    lr: float = 0.001
    reg: float = 0.0
    bpr_reg: float = 1.0
    layers: list = None
    batch_size: int = 128
    loss: str = "bpr_max"      # top1_max | bpr_max
    hidden_act: str = "tanh"
    final_act: str = "linear"
    n_sample: int = 2048
    sample_alpha: float = 0.75
    epochs: int = 500
    early_stop: int = 100

    def _validate(self):
        if self.layers is None:
            self.layers = [64]
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.reg, float) and self.reg >= 0
              and isinstance(self.bpr_reg, float) and self.bpr_reg >= 0
              and isinstance(self.layers, list) and len(self.layers) > 0
              and isinstance(self.batch_size, int) and self.batch_size > 0
              and self.loss in ("top1_max", "bpr_max")
              and self.hidden_act in ACTIVATIONS
              and self.final_act in FINAL_ACTS
              and isinstance(self.n_sample, int) and self.n_sample >= 0
              and isinstance(self.sample_alpha, float)
              and 0 < self.sample_alpha <= 1)
        if not ok:
            raise ValueError(f"invalid GRU4RecPlusConfig: {self}")


def softmax_neg(logits: torch.Tensor) -> torch.Tensor:
    """Row softmax of (B, Y) logits with the diagonal masked out (its
    weight 0), as the JAX package's ``_softmax_neg`` (a rank's rows under
    a mesh: each row's positive at its global row)."""
    b, size_y = logits.shape
    rows = torch.arange(b, device=logits.device)
    cols = torch.arange(size_y, device=logits.device)
    hm = (cols[None, :] != batch_offset(b) + rows[:, None]).to(logits.dtype)
    masked = logits * hm
    masked = masked - torch.amax(masked, dim=1, keepdim=True)
    e_x = torch.exp(masked) * hm
    return e_x / torch.sum(e_x, dim=1, keepdim=True)


def gru4recplus_loss_from_logits(logits: torch.Tensor, loss: str,
                                 bpr_reg: float) -> torch.Tensor:
    """BPR-max (with ``bpr_reg`` times the weighted squares of the logits)
    or TOP1-max on (B, Y) logits whose diagonal holds the positives."""
    w = softmax_neg(logits)
    pos = diagonal_positives(logits)
    if loss == "bpr_max":
        prob = torch.sum(torch.sigmoid(pos - logits) * w, dim=1)
        reg_loss = torch.sum(torch.square(logits) * w, dim=1)
        return batch_mean(-torch.log(prob + 1e-24) + bpr_reg * reg_loss)
    prob = torch.sigmoid(logits - pos) + torch.sigmoid(torch.square(logits))
    return batch_mean(torch.sum(prob * w, dim=1))


class GRU4RecPlus(GRU4Rec):
    config_class = GRU4RecPlusConfig

    def _init_extra(self) -> None:
        pairs = self.dataset.train_data.to_user_item_pairs()
        counts = np.bincount(pairs[:, 1], minlength=self.num_items) \
            .astype(np.float64)
        weights = np.power(counts, self.config.sample_alpha)
        with np.errstate(divide="ignore"):
            logw = np.log(weights)
        logw[np.isneginf(logw)] = -1e30
        self.neg_log_weights = torch.as_tensor(logw.astype(np.float32),
                                               device=self.device)
        self._neg_probs = torch.softmax(self.neg_log_weights, dim=0)
        self._neg_cdf = categorical_cdf(self._neg_probs)

    def draw_negatives(self, generator: torch.Generator
                       ) -> Optional[torch.Tensor]:
        """One step's ``n_sample`` negatives (int64) from ``generator``
        (None at ``n_sample`` 0)."""
        if self.config.n_sample == 0:
            return None
        return draw_with_replacement(self._neg_probs, self.config.n_sample,
                                     generator, self._neg_cdf)

    def _loss_from_logits(self, logits: torch.Tensor) -> torch.Tensor:
        return gru4recplus_loss_from_logits(logits, self.config.loss,
                                            self.config.bpr_reg)
