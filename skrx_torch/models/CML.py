"""CML — collaborative metric learning (Hsieh et al., WWW 2017): the port
of ``skrx.models.CML``.

Same config fields and defaults. Parameters ``user_emb`` (U, d) and
``item_emb`` (N, d) drawn from N(0, 1/d). Each pair brings ``dns``
candidate negatives (:class:`PairwiseEpochPipeline`); the loss is the hinge
on the closest candidate (distances ``sqrt(|u - i|^2 + 1e-12)``) weighted by
``log(rank + 1)``, rank = the share of impostors times N, plus ``reg`` times
the covariance loss (weighted moments, zero diagonal) of the batch's user
rows and of its positive and chosen negative item rows. The optimizer is
optax's Adagrad (:class:`~skrx_torch.ops.optim.OptaxAdagrad`, not
``torch.optim.Adagrad``); after each step the touched user rows and the
``cat([pos, chosen])`` item rows are clipped to ``clip_norm``. Scores are
the negative Euclidean distance in its expanded form
(:meth:`CML._topk_score_fn`), in ``predict`` and ``predict_chunk`` alike
(the latter scores a chunk straight from the user rows, as JAX's CML: the
cached user vectors of ``CachedUserVecChunkMixin`` would save one gather);
the fused route does not apply (the score is not a dot).
``_topk_factors`` gives ``(uv, item_emb, None)`` for the tensor-parallel
``predict_topk``, which scores each catalog shard by that distance.

Under a mesh CML trains data-parallel: each rank takes its slice of the
batch, the covariance terms run over the whole batch's rows (gathered over
the data axis, counted once), the gradients sum over the data axis, and
every rank clips the whole batch's rows after the step.
"""
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..convert import adagrad_state_from_jax, two_tables_from_jax
from ..ops.optim import OptaxAdagrad
from ..parallel import gather_batch, gather_batch_ids, once
from ..run_config import RunConfig
from ..utils import ModelConfig
from .common import (CachedUserVecChunkMixin, EpochTrainedRecommender,
                     as_user_tensor)
from .pipeline import PairwiseEpochPipeline

__all__ = ["CML", "CMLConfig", "cml_loss", "clip_rows_by_norm"]


class CMLConfig(ModelConfig):
    lr: float = 0.05
    reg: float = 10.0
    embed_size: int = 64
    margin: float = 0.5
    clip_norm: float = 1.0
    dns: int = 10
    batch_size: int = 256
    epochs: int = 500
    early_stop: int = 100

    def _validate(self):
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.reg, (float, int)) and self.reg >= 0
              and isinstance(self.embed_size, int) and self.embed_size > 0
              and isinstance(self.margin, float) and self.margin >= 0
              and isinstance(self.clip_norm, float) and self.clip_norm >= 0
              and isinstance(self.dns, int) and self.dns > 0
              and isinstance(self.batch_size, int) and self.batch_size > 0)
        if not ok:
            raise ValueError(f"invalid CML config: {self}")


def _cov_loss(matrix: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of the off-diagonal weighted covariance: rows of
    weight 0 (padding) leave the moments alone."""
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(matrix * w[:, None], dim=0) / n
    centered = (matrix - mean) * w[:, None]
    cov = centered.T @ centered / n
    cov = cov - torch.diag(torch.diagonal(cov))
    return torch.sqrt(torch.sum(torch.square(cov)) + 1e-12)


def cml_loss(user_emb: torch.Tensor, item_emb: torch.Tensor,
             margin: float, reg: float, users: torch.Tensor,
             pos: torch.Tensor, neg: torch.Tensor, w: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, chosen): one batch's loss and each row's closest candidate
    negative (neg: (B, dns))."""
    num_items = item_emb.shape[0]
    ue, pe, ne = user_emb[users], item_emb[pos], item_emb[neg]
    d_ui = torch.sqrt(torch.sum((ue - pe) ** 2, -1) + 1e-12)
    d_ujs = torch.sqrt(torch.sum((ue[:, None] - ne) ** 2, -1) + 1e-12)
    d_uj, j_idx = torch.min(d_ujs, dim=1)
    hinge = torch.clamp(margin - (d_uj - d_ui), min=0.0)
    impostors = (d_ui[:, None] - d_ujs + margin) > 0
    rank = torch.mean(impostors.float(), dim=1) * num_items
    loss = torch.sum(torch.log(rank + 1.0) * hinge * w)
    chosen = neg.gather(1, j_idx[:, None])[:, 0]
    # the moments are the whole batch's (gathered over the data axis)
    w_all = gather_batch_ids(w)
    item_rows = torch.cat([gather_batch(pe), gather_batch(item_emb[chosen])])
    f2 = once(_cov_loss(gather_batch(ue), w_all)
              + _cov_loss(item_rows, torch.cat([w_all, w_all])))
    return loss + reg * f2, chosen


@torch.no_grad()
def clip_rows_by_norm(table: torch.Tensor, rows: torch.Tensor,
                      clip_norm: float) -> None:
    """Scale the given rows of ``table`` in place down to ``clip_norm``
    (a repeated row is written the same value each time)."""
    vecs = table[rows]
    norms = torch.linalg.vector_norm(vecs, dim=-1, keepdim=True)
    scale = torch.clamp(clip_norm / torch.clamp(norms, min=1e-12), max=1.0)
    table[rows] = vecs * scale


class CML(CachedUserVecChunkMixin, EpochTrainedRecommender):
    _JAX_PARAMS = ("user_emb", "item_emb")

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, CMLConfig(**model_config), device)
        cfg = self.config
        std = 1.0 / (cfg.embed_size ** 0.5)
        gen = torch.Generator().manual_seed(run_config.seed)
        self.user_emb = nn.Parameter(std * torch.randn(
            (self.num_users, cfg.embed_size), generator=gen).to(self.device))
        self.item_emb = nn.Parameter(std * torch.randn(
            (self.num_items, cfg.embed_size), generator=gen).to(self.device))
        self.optimizer = OptaxAdagrad([self.user_emb, self.item_emb], cfg.lr)
        self.pipeline = PairwiseEpochPipeline(
            self.dataset.train_data, cfg.batch_size, self.device,
            num_neg=cfg.dns, mesh=self.mesh)

    def train_step(self, batch) -> torch.Tensor:
        cfg = self.config
        users, pos, neg, w = batch
        self.optimizer.zero_grad(set_to_none=True)
        loss, chosen = cml_loss(self.user_emb, self.item_emb, cfg.margin,
                                cfg.reg, users, pos, neg, w)
        loss.backward()
        self.sync_gradients()
        self.optimizer.step()
        # every rank clips the whole batch's rows
        clip_rows_by_norm(self.user_emb, gather_batch_ids(users),
                          cfg.clip_norm)
        clip_rows_by_norm(self.item_emb, torch.cat(
            [gather_batch_ids(pos), gather_batch_ids(chosen)]), cfg.clip_norm)
        return loss.detach()

    def load_jax_params(self, params: Dict[str, np.ndarray]) -> None:
        """Copy a JAX CML's ``params`` (arrays taken with ``np.asarray``)
        into this model."""
        self._copy_params(two_tables_from_jax(params))

    def load_jax_opt_state(self, sum_of_squares: Dict[str, np.ndarray]
                           ) -> None:
        """Set the Adagrad accumulators from the ``sum_of_squares`` dict of
        a JAX CML's ``optax.adagrad`` state."""
        shapes = {name: tuple(getattr(self, name).shape)
                  for name in self._JAX_PARAMS}
        for name, acc in adagrad_state_from_jax(sum_of_squares,
                                                shapes).items():
            self.optimizer.state[getattr(self, name)]["sum_of_squares"] = \
                acc.to(self.device)

    @staticmethod
    def _topk_score_fn(uv: torch.Tensor, items: torch.Tensor,
                       bias: Optional[torch.Tensor]) -> torch.Tensor:
        """``-sqrt(max(|u|^2 - 2 u.i + |i|^2, 0) + 1e-12)`` (+ bias)."""
        d2 = (torch.sum(uv * uv, -1)[:, None] - 2.0 * (uv @ items.T)
              + torch.sum(items * items, -1)[None, :])
        s = -torch.sqrt(torch.clamp(d2, min=0.0) + 1e-12)
        return s if bias is None else s + bias[None, :]

    def _user_vectors(self, users: torch.Tensor) -> torch.Tensor:
        return self.user_emb[users]

    def _topk_factors(self, uv):
        return uv, self.item_emb, None

    @torch.no_grad()
    def predict_chunk(self, users, item_lo: int, item_hi: int
                      ) -> torch.Tensor:
        """The scores of items [lo, hi): one row gather, so no cache of
        the user vectors (JAX's CML bypasses the mixin's the same way)."""
        users = as_user_tensor(users, self.device)
        return self._topk_score_fn(self.user_emb[users],
                                   self.item_emb[item_lo:item_hi], None)

    @torch.no_grad()
    def predict(self, users) -> torch.Tensor:
        """(B, N) f32 negative distances to every item."""
        users = as_user_tensor(users, self.device)
        return self._topk_score_fn(self.user_emb[users], self.item_emb, None)
