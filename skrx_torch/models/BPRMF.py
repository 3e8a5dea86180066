"""BPRMF — Bayesian Personalized Ranking matrix factorization (Rendle et
al., UAI 2009): the port of ``skrx.models.BPRMF``.

Same config fields and defaults, same parameters (``user_emb`` (U, d) and
``item_emb`` (N, d) drawn from N(0, 0.01^2), ``item_bias`` (N,) zeros).
Training: per step the summed BPR loss of the batch plus
``reg * 0.5 * sum(w * (|ue|^2 + |pe|^2 + |ne|^2 + bp^2 + bn^2))`` over its
gathered rows (padded rows weigh 0), then one dense Adam step; epochs come
from :class:`PairwiseEpochPipeline` with one negative per pair.
``predict`` is one f32 ``torch.matmul`` plus the bias, outside any kernel as
in the JAX package; it assumes PyTorch's default of TF32 off for f32
matmuls (``torch.backends.cuda.matmul.allow_tf32`` False).
"""
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..convert import bprmf_adam_state_from_jax, bprmf_params_from_jax
from ..ops.initializers import get_initializer
from ..ops.losses import bpr_loss
from ..run_config import RunConfig
from ..utils import ModelConfig
from .base import TorchRecommender
from .common import (ChunkedDotPredictMixin, as_user_tensor, make_optimizer,
                     make_train_step)
from .pipeline import PairwiseEpochPipeline, epoch_generator

__all__ = ["BPRMF", "BPRMFConfig"]


class BPRMFConfig(ModelConfig):
    lr: float = 1e-3
    reg: float = 1e-3
    n_dim: int = 64
    batch_size: int = 1024
    epochs: int = 1000
    early_stop: int = 200
    optimizer: str = "adam"

    def _validate(self):
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.reg, float) and self.reg >= 0
              and isinstance(self.n_dim, int) and self.n_dim > 0
              and isinstance(self.batch_size, int) and self.batch_size > 0
              and isinstance(self.epochs, int) and self.epochs >= 0
              and isinstance(self.early_stop, int)
              and self.optimizer in ("adam", "lazy_adam"))
        if not ok:
            raise ValueError(f"invalid BPRMF config: {self}")


class BPRMF(ChunkedDotPredictMixin, TorchRecommender):
    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, BPRMFConfig(**model_config), device)
        d = self.config.n_dim
        gen = torch.Generator().manual_seed(run_config.seed)
        normal, zeros = get_initializer("normal"), get_initializer("zeros")
        self.user_emb = nn.Parameter(
            normal((self.num_users, d), gen).to(self.device))
        self.item_emb = nn.Parameter(
            normal((self.num_items, d), gen).to(self.device))
        self.item_bias = nn.Parameter(zeros((self.num_items,)).to(self.device))
        self.optimizer = make_optimizer(
            self.config.optimizer,
            [self.user_emb, self.item_emb, self.item_bias], self.config.lr)
        self.train_step = make_train_step(self.optimizer, self._loss)
        self.pipeline = PairwiseEpochPipeline(
            self.dataset.train_data, self.config.batch_size, self.device,
            num_neg=1)

    def _loss(self, users, pos, neg, w) -> torch.Tensor:
        neg = neg[:, 0]
        ue = self.user_emb[users]
        pe, ne = self.item_emb[pos], self.item_emb[neg]
        bp, bn = self.item_bias[pos], self.item_bias[neg]
        y_pos = torch.sum(ue * pe, dim=-1) + bp
        y_neg = torch.sum(ue * ne, dim=-1) + bn
        loss = torch.sum(bpr_loss(y_pos, y_neg) * w)
        reg_term = 0.5 * torch.sum(
            (torch.sum(ue ** 2 + pe ** 2 + ne ** 2, dim=-1) + bp ** 2
             + bn ** 2) * w)
        return loss + self.config.reg * reg_term

    def _train_epoch(self, epoch: int) -> float:
        gen = epoch_generator(self.run_config.seed + 1, epoch, self.device)
        return self.pipeline.run_epoch(gen, self.train_step)

    def load_jax_params(self, params: Dict[str, np.ndarray]) -> None:
        """Copy a JAX BPRMF's ``params`` (arrays taken with ``np.asarray``)
        into this model."""
        tensors = bprmf_params_from_jax(params)
        with torch.no_grad():
            for name, value in tensors.items():
                target = getattr(self, name)
                if target.shape != value.shape:
                    raise ValueError(f"{name}: shape {tuple(value.shape)}, "
                                     f"model has {tuple(target.shape)}")
                target.copy_(value)

    def load_jax_opt_state(self, count: int, mu: np.ndarray,
                           nu: np.ndarray) -> None:
        """Set the Adam state from a JAX BPRMF's flat ``optax.adam`` state
        (``count`` and the raveled ``mu``, ``nu``)."""
        shapes = {"user_emb": tuple(self.user_emb.shape),
                  "item_emb": tuple(self.item_emb.shape),
                  "item_bias": tuple(self.item_bias.shape)}
        for name, state in bprmf_adam_state_from_jax(count, mu, nu,
                                                     shapes).items():
            param = getattr(self, name)
            self.optimizer.state[param] = {
                "step": state["step"],
                "exp_avg": state["exp_avg"].to(self.device),
                "exp_avg_sq": state["exp_avg_sq"].to(self.device)}

    def _chunk_embeddings(self):
        return self.user_emb, self.item_emb

    def _chunk_bias(self):
        return self.item_bias

    @torch.no_grad()
    def predict(self, users) -> torch.Tensor:
        """(B, N) f32 scores ``user_emb[users] @ item_emb.T + item_bias`` on
        the model's device."""
        users = as_user_tensor(users, self.device)
        return torch.matmul(self.user_emb[users], self.item_emb.T) \
            + self.item_bias[None, :]
