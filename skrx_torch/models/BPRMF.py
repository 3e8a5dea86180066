"""BPRMF — Bayesian Personalized Ranking matrix factorization (Rendle et
al., UAI 2009): the port of ``skrx.models.BPRMF`` for serving.

Same config fields and defaults, same parameters (``user_emb`` (U, d) and
``item_emb`` (N, d) drawn from N(0, 0.01^2), ``item_bias`` (N,) zeros).
``predict`` is one f32 ``torch.matmul`` plus the bias, outside any kernel as
in the JAX package; it assumes PyTorch's default of TF32 off for f32
matmuls (``torch.backends.cuda.matmul.allow_tf32`` False). Training (the
BPR epoch pipeline and Adam) comes with a later slice.
"""
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..convert import bprmf_params_from_jax
from ..ops.initializers import get_initializer
from ..run_config import RunConfig
from ..utils import ModelConfig
from .base import TorchRecommender
from .common import ChunkedDotPredictMixin, as_user_tensor

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
