"""BPRMF — Bayesian Personalized Ranking matrix factorization (Rendle et
al., UAI 2009): the port of ``skrx.models.BPRMF``.

Same config fields, defaults and search grid, same parameters
(``user_emb`` (U, d) and ``item_emb`` (N, d) drawn from N(0, 0.01^2),
``item_bias`` (N,) zeros).
Training: per step the summed BPR loss of the batch plus
``reg * 0.5 * sum(w * (|ue|^2 + |pe|^2 + |ne|^2 + bp^2 + bn^2))`` over its
gathered rows (padded rows weigh 0), then one dense Adam step (on one
device over the three tables as one flat vector, JAX's flat step:
:class:`~skrx_torch.models.common.FlatTrainStep`; on a card each
epoch a CUDA graph of the step replayed a batch), or with
``optimizer="lazy_adam"`` one row-wise lazy Adam step
(:func:`bprmf_lazy_train_step`, built on ``make_lazy_train_step``): the loss
is taken over the gathered rows as leaf tensors, ``user_emb`` is updated on
the batch's users and ``item_emb`` and ``item_bias`` on ``cat([pos, neg])``,
and no (N, d) gradient or moment is formed; epochs come from
:class:`PairwiseEpochPipeline` with one negative per pair.
``predict`` is one f32 ``torch.matmul`` plus the bias, outside any kernel as
in the JAX package; it assumes PyTorch's default of TF32 off for f32
matmuls (``torch.backends.cuda.matmul.allow_tf32`` False).

Under a mesh of several ranks (``RunConfig.mesh_shape`` (d, m), dense Adam)
``user_emb`` and ``item_emb`` are split by rows over the model axis
(``mf_param_shardings``) and ``item_bias`` is whole on every rank; each
rank trains on its data index's slice of the batch. A batch's rows are
read by :func:`~skrx_torch.parallel.lookup_rows` (of a table, each
owner's rows all-reduced over the model axis; of the bias, the rank's
copy), whose backward adds every data index's gradient into the rank's
rows as one device sums it. ``_tp`` (a model axis above 1) marks
the tensor-parallel step, as in the JAX package. Scoring gathers the
tables whole after the steps move them (``eval_param``); ``evaluate()``
ranks through ``predict_topk`` when the model axis is above 1. With lazy Adam the tables stay whole on
every rank under any mesh (the JAX package's lazy branch comes before
tensor parallelism): each rank gathers the whole batch's rows and row
gradients over the data axis and applies the same row update, so the
replicas stay bit-equal.
"""
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..convert import bprmf_params_from_jax, lazy_adam_state_from_jax
from ..ops.initializers import get_initializer
from ..ops.losses import bpr_loss
from ..ops.optim import LazyAdam, make_lazy_train_step
from ..parallel import (lookup_rows, mf_param_shardings, model_parallel_size,
                        take_rows)
from ..run_config import RunConfig
from ..utils import ModelConfig
from .common import (ChunkedDotPredictMixin, EpochTrainedRecommender,
                     FlatTrainStep, as_user_tensor, make_optimizer,
                     make_train_step)
from .pipeline import PairwiseEpochPipeline

__all__ = ["BPRMF", "BPRMFConfig", "bprmf_gathered_loss",
           "bprmf_lazy_train_step"]


class BPRMFConfig(ModelConfig):
    lr: float = 1e-3
    reg: float = 1e-3
    n_dim: int = 64
    batch_size: int = 1024
    epochs: int = 1000
    early_stop: int = 200
    optimizer: str = "adam"

    @classmethod
    def param_space(cls):
        return {"lr": [0.001, 0.005, 0.01, 0.05],
                "reg": [0.0, 0.001, 0.005, 0.01, 0.05]}

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


def bprmf_gathered_loss(ue, pe, ne, bp, bn, w, reg: float) -> torch.Tensor:
    """The batch's summed BPR loss plus the weighted L2 of its rows, from
    the gathered rows (user, positive and negative item rows and biases)."""
    y_pos = torch.sum(ue * pe, dim=-1) + bp
    y_neg = torch.sum(ue * ne, dim=-1) + bn
    loss = torch.sum(bpr_loss(y_pos, y_neg) * w)
    reg_term = 0.5 * torch.sum(
        (torch.sum(ue ** 2 + pe ** 2 + ne ** 2, dim=-1) + bp ** 2 + bn ** 2)
        * w)
    return loss + reg * reg_term


# the rows a lazy step gathers from each table, in the loss's argument
# order; a table's row sets are concatenated into one update
_LAZY_GATHERS = (("user_emb", lambda b: b[0]), ("item_emb", lambda b: b[1]),
                 ("item_emb", lambda b: b[2][:, 0]),
                 ("item_bias", lambda b: b[1]),
                 ("item_bias", lambda b: b[2][:, 0]))


def bprmf_lazy_train_step(params: Dict[str, torch.Tensor], lr: float,
                          reg: float) -> Tuple[Callable, LazyAdam]:
    """``(train_step, optimizer)``: BPRMF's lazy Adam step over ``params``
    (``user_emb``, ``item_emb``, ``item_bias``, updated in place) and its
    :class:`LazyAdam`. ``train_step(batch)`` takes the gradients of the
    gathered rows only, updates ``user_emb`` on the users and ``item_emb``
    and ``item_bias`` on ``cat([pos, neg])``, and returns the loss before
    the step."""
    def loss_fn(gathered, dense, batch):
        return bprmf_gathered_loss(*gathered, batch[3], reg)
    train_step, (optimizer, _) = make_lazy_train_step(lr, _LAZY_GATHERS,
                                                      loss_fn, params)
    return train_step, optimizer


class BPRMF(ChunkedDotPredictMixin, EpochTrainedRecommender):
    _JAX_PARAMS = ("user_emb", "item_emb", "item_bias")
    # the bias is read through lookup_rows, whose backward sums it
    _GRAD_WHOLE = ("item_bias",)

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, BPRMFConfig(**model_config), device)
        cfg = self.config
        lazy = cfg.optimizer == "lazy_adam"
        self._tp = model_parallel_size(self.mesh) > 1 and not lazy
        d = cfg.n_dim
        gen = torch.Generator().manual_seed(run_config.seed)
        normal, zeros = get_initializer("normal"), get_initializer("zeros")
        full = {"user_emb": normal((self.num_users, d), gen),
                "item_emb": normal((self.num_items, d), gen),
                "item_bias": zeros((self.num_items,))}
        if self.mesh is not None and not lazy:
            self._row_blocks = {
                name: blocks for name, blocks in
                mf_param_shardings(self.mesh, full).items()
                if blocks is not None}
        for name, value in full.items():
            local = take_rows(value, self._row_blocks.get(name))
            setattr(self, name, nn.Parameter(local.to(self.device)))
        tables = {name: getattr(self, name) for name in self._JAX_PARAMS}
        if lazy:
            self.train_step, self.optimizer = bprmf_lazy_train_step(
                tables, cfg.lr, cfg.reg)
        elif self.mesh is None:
            self._flat_step = FlatTrainStep(self, self._JAX_PARAMS,
                                            self._loss, cfg.lr)
            self.train_step = self._flat_step
            self.optimizer = self._flat_step.optimizer
        else:
            self.optimizer = make_optimizer("adam", tables, cfg.lr)
            self.train_step = make_train_step(self.optimizer, self._loss,
                                              self.sync_gradients)
        self.pipeline = PairwiseEpochPipeline(
            self.dataset.train_data, cfg.batch_size, self.device, num_neg=1,
            mesh=self.mesh)

    def _loss(self, users, pos, neg, w) -> torch.Tensor:
        """The loss of this batch, under a mesh of this rank's slice."""
        neg = neg[:, 0]
        if not self._row_blocks:
            def rows(name, ids):
                return getattr(self, name)[ids]
        else:
            def rows(name, ids):
                return lookup_rows(getattr(self, name), ids,
                                   self._row_blocks.get(name), self.mesh)
        return bprmf_gathered_loss(
            rows("user_emb", users), rows("item_emb", pos),
            rows("item_emb", neg), rows("item_bias", pos),
            rows("item_bias", neg), w, self.config.reg)

    def load_jax_params(self, params: Dict[str, np.ndarray]) -> None:
        """Copy a JAX BPRMF's ``params`` (arrays taken with ``np.asarray``)
        into this model."""
        self._copy_params(bprmf_params_from_jax(params))
        self._invalidate_predict_cache()

    def load_jax_opt_state(self, *state) -> None:
        """Dense Adam: ``(count, mu, nu)``, as the base class. Lazy Adam:
        JAX's ``opt_state``, one ``LazyAdamState`` (m, v, counts) per table
        of ``_JAX_PARAMS``, in that order."""
        if self.config.optimizer != "lazy_adam":
            super().load_jax_opt_state(*state)
            return
        if len(state) != len(self._JAX_PARAMS):
            raise ValueError(f"expected {len(self._JAX_PARAMS)} lazy Adam "
                             f"states, got {len(state)}")
        self.optimizer.load_state_dict(
            {name: lazy_adam_state_from_jax(*s)
             for name, s in zip(self._JAX_PARAMS, state)})

    def _chunk_embeddings(self):
        """The live tables; under a mesh, the tables gathered whole (on
        every rank, again after each step moves them)."""
        return self.eval_param("user_emb"), self.eval_param("item_emb")

    def _chunk_bias(self):
        return self.item_bias

    @torch.no_grad()
    def predict(self, users) -> torch.Tensor:
        """(B, N) f32 scores ``user_emb[users] @ item_emb.T + item_bias`` on
        the model's device."""
        user_emb, item_emb = self._chunk_embeddings()
        users = as_user_tensor(users, self.device)
        return torch.matmul(user_emb[users], item_emb.T) \
            + self.item_bias[None, :]
