"""FPMC — factorized personalized Markov chains (Rendle et al., WWW 2010):
the port of ``skrx.models.FPMC``.

Same config fields, defaults and checks. Parameters: four tables drawn
from N(0, 0.01^2), ``UI`` (U, d) user-given-item, ``IU`` (N, d)
item-given-user, ``IL`` (N, d) item-given-last and ``LI`` (N, d)
last-item. The score of item i after last item l for user u is
``<UI_u, IU_i> + <LI_l, IL_i>``. Epochs come from
:class:`SequentialPairwiseEpochPipeline` (one previous item, one next item,
one negative); a step takes the summed BPR loss plus ``reg * 0.5 * sum(w *
|row|^2)`` over the batch's six gathered rows, then one dense Adam step (on
one device over the four tables as one flat vector in JAX's ravel order
``IL, IU, LI, UI``, JAX's flat step:
:class:`~skrx_torch.models.common.FlatTrainStep`; on a card each epoch a
CUDA graph of the step replayed a batch), or with ``optimizer="lazy_adam"``
one row-wise lazy Adam step over those six gathers
(``make_lazy_train_step``, an eager epoch). Scoring uses each user's last
training item by time (0 for a user without one). It is a dot model:
``_chunk_embeddings`` gives ``([UI | LI_last], [IU | IL])``, 2d wide, for
the fused route.

Under a mesh whose model axis is above 1 (dense Adam) each table keeps
only its rank's rows over the model axis (the JAX package's
tensor-parallel ``_finalize_setup_flat``); a step reads the batch's rows
through ``lookup_rows`` and scoring gathers the tables whole. Each rank
trains on its data index's slice of the batch; with lazy Adam the tables
stay whole on every rank and the whole batch's row gradients are gathered
over the data axis.
"""
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..convert import fpmc_params_from_jax, lazy_adam_state_from_jax
from ..ops.initializers import get_initializer
from ..ops.losses import bpr_loss
from ..ops.optim import make_lazy_train_step
from ..run_config import RunConfig
from ..utils import ModelConfig
from .common import (ChunkedDotPredictMixin, EpochTrainedRecommender,
                     FlatTrainStep, as_user_tensor, last_items_by_time,
                     make_optimizer, make_train_step)
from .pipeline import SequentialPairwiseEpochPipeline

__all__ = ["FPMC", "FPMCConfig", "fpmc_gathered_loss", "fpmc_loss"]


class FPMCConfig(ModelConfig):
    lr: float = 1e-3
    reg: float = 1e-3
    embed_size: int = 64
    optimizer: str = "adam"          # adam | lazy_adam
    batch_size: int = 1024
    epochs: int = 1000
    early_stop: int = 200

    def _validate(self):
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.reg, float) and self.reg >= 0
              and isinstance(self.embed_size, int) and self.embed_size > 0
              and self.optimizer in ("adam", "lazy_adam")
              and isinstance(self.batch_size, int) and self.batch_size > 0
              and isinstance(self.epochs, int) and self.epochs >= 0
              and isinstance(self.early_stop, int))
        if not ok:
            raise ValueError(f"invalid FPMC config: {self}")


def fpmc_gathered_loss(ui, iu_p, iu_n, il_p, il_n, li_l, w,
                       reg: float) -> torch.Tensor:
    """The batch's summed BPR loss plus the weighted L2 of its rows, from
    the gathered rows (user, positive and negative rows of IU and IL, the
    last item's LI row)."""
    y_pos = torch.sum(ui * iu_p, -1) + torch.sum(li_l * il_p, -1)
    y_neg = torch.sum(ui * iu_n, -1) + torch.sum(li_l * il_n, -1)
    loss = torch.sum(bpr_loss(y_pos, y_neg) * w)
    reg_term = 0.5 * torch.sum(torch.sum(
        ui ** 2 + li_l ** 2 + iu_p ** 2 + iu_n ** 2 + il_p ** 2 + il_n ** 2,
        -1) * w)
    return loss + reg * reg_term


def fpmc_loss(params, reg: float, users: torch.Tensor, pos: torch.Tensor,
              neg: torch.Tensor, w: torch.Tensor,
              prev: torch.Tensor) -> torch.Tensor:
    """One batch's loss; ``params`` by the model's parameter names, or a
    function ``(name, ids) -> rows``."""
    rows = params if callable(params) else (lambda name, ids:
                                            params[name][ids])
    neg, last = neg[:, 0], prev[:, 0]
    return fpmc_gathered_loss(rows("UI", users), rows("IU", pos),
                              rows("IU", neg), rows("IL", pos),
                              rows("IL", neg), rows("LI", last), w, reg)


# the rows a lazy step gathers, in the loss's argument order
_LAZY_GATHERS = (("UI", lambda b: b[0]), ("IU", lambda b: b[1]),
                 ("IU", lambda b: b[2][:, 0]), ("IL", lambda b: b[1]),
                 ("IL", lambda b: b[2][:, 0]), ("LI", lambda b: b[4][:, 0]))


class FPMC(ChunkedDotPredictMixin, EpochTrainedRecommender):
    _JAX_PARAMS = ("UI", "IU", "IL", "LI")

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, FPMCConfig(**model_config), device)
        cfg = self.config
        gen = torch.Generator().manual_seed(run_config.seed)
        init = get_initializer("normal")
        rows = {"UI": self.num_users, "IU": self.num_items,
                "IL": self.num_items, "LI": self.num_items}
        for name in self._JAX_PARAMS:
            setattr(self, name, nn.Parameter(
                init((rows[name], cfg.embed_size), gen).to(self.device)))
        if cfg.optimizer != "lazy_adam":
            self._split_over_model_axis()
        tables = {name: getattr(self, name) for name in self._JAX_PARAMS}
        if cfg.optimizer == "lazy_adam":
            def loss_fn(gathered, dense, batch):
                return fpmc_gathered_loss(*gathered, batch[3], cfg.reg)
            self.train_step, (self.optimizer, _) = make_lazy_train_step(
                cfg.lr, _LAZY_GATHERS, loss_fn, tables)
        elif self.mesh is None:
            self._flat_step = FlatTrainStep(self, self._JAX_PARAMS,
                                            self._loss, cfg.lr)
            self.train_step = self._flat_step
            self.optimizer = self._flat_step.optimizer
        else:
            self.optimizer = make_optimizer("adam", tables, cfg.lr)
            self.train_step = make_train_step(self.optimizer, self._loss,
                                              self.sync_gradients)
        self.pipeline = SequentialPairwiseEpochPipeline(
            self.dataset.train_data, cfg.batch_size, self.device,
            num_previous=1, num_next=1, mesh=self.mesh)
        self.last_items = torch.as_tensor(
            last_items_by_time(self.dataset.train_data), device=self.device)
        self._concat = None

    def _loss(self, users, pos, neg, w, prev) -> torch.Tensor:
        return fpmc_loss(self.lookup, self.config.reg, users, pos, neg, w,
                         prev)

    def load_jax_params(self, params: Dict[str, np.ndarray]) -> None:
        """Copy a JAX FPMC's ``params`` (arrays taken with ``np.asarray``)
        into this model."""
        self._copy_params(fpmc_params_from_jax(params))

    def load_jax_opt_state(self, *state) -> None:
        """Dense Adam: ``(count, mu, nu)``, as the base class. Lazy Adam:
        the lazy part of JAX's ``opt_state``, a dict of one
        ``LazyAdamState`` (m, v, counts) per table."""
        if self.config.optimizer != "lazy_adam":
            super().load_jax_opt_state(*state)
            return
        (lazy,) = state
        self.optimizer.load_state_dict(
            {name: lazy_adam_state_from_jax(*s) for name, s in lazy.items()})

    def _chunk_embeddings(self):
        """``([UI | LI_last], [IU | IL])``, concatenated again only after the
        tables changed (a step updates them in place), so that serving's
        packed table is reused between steps."""
        ui, li, iu, il = (self.eval_param(n) for n in ("UI", "LI", "IU",
                                                      "IL"))
        key = tuple((t.data_ptr(), t._version) for t in (ui, li, iu, il))
        if self._concat is None or self._concat[0] != key:
            with torch.no_grad():
                self._concat = (key, (
                    torch.cat([ui, li[self.last_items]], 1),
                    torch.cat([iu, il], 1)))
        return self._concat[1]

    @torch.no_grad()
    def predict_chunk(self, users, item_lo: int, item_hi: int
                      ) -> torch.Tensor:
        """Scores of items [lo, hi): ``UI_u . IU_i + LI_last . IL_i``, two
        products as in JAX's FPMC."""
        users = as_user_tensor(users, self.device)
        ui, li, iu, il = (self.eval_param(n) for n in ("UI", "LI", "IU",
                                                      "IL"))
        return (torch.matmul(ui[users], iu[item_lo:item_hi].T)
                + torch.matmul(li[self.last_items[users]],
                               il[item_lo:item_hi].T))

    def predict(self, users) -> torch.Tensor:
        """(B, N) f32 scores on the model's device."""
        return self.predict_chunk(users, 0, self.num_items)
