"""TransRec — translation-based sequential recommendation (He et al.,
RecSys 2017): the port of ``skrx.models.TransRec``.

Same config fields, defaults and checks. Parameters: ``user_emb`` (U, d)
zeros, ``item_emb`` (N, d) and the global translation ``trans`` (1, d)
from N(0, 0.01^2), ``item_bias`` (N,) zeros. The score of item i for user u
after last item l is ``-|user_emb_u + trans + item_emb_l - item_emb_i| +
item_bias_i`` (distances ``sqrt(|.|^2 + 1e-12)``). Epochs come from
:class:`SequentialPairwiseEpochPipeline` (one previous item, one next item,
one negative); a step takes the summed BPR loss plus ``reg * 0.5`` times
the weighted L2 of the batch's gathered rows and biases and the unweighted
``|trans|^2``, then one dense Adam step (on one device over the four
parameters as one flat vector in JAX's ravel order ``item_bias, item_emb,
trans, user_emb``, JAX's flat step:
:class:`~skrx_torch.models.common.FlatTrainStep`; on a card each epoch a
CUDA graph of the step replayed a batch), or with ``optimizer="lazy_adam"``
one row-wise lazy Adam step over the tables with ``trans`` under dense
Adam (an eager epoch). Scoring, in ``predict`` as in ``predict_chunk``, is
the expanded form of the distance (:meth:`TransRec._topk_score_fn`), as
JAX's TransRec scores every route, from each user's last training item by
time (0 for a user without one). The score is not a dot: the fused route
does not apply.

Under a mesh whose model axis is above 1 (dense Adam) ``user_emb`` and
``item_emb`` keep only their rank's rows over the model axis (the JAX
package's tensor-parallel ``_finalize_setup_flat``); a step reads the
batch's rows through ``lookup_rows``, ``trans`` and ``item_bias`` stay
whole, and scoring gathers the tables whole. Each rank trains on its data
index's slice of the batch (``|trans|^2`` counts once); with lazy Adam the
tables stay whole on every rank.
"""
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..convert import lazy_adam_state_from_jax, transrec_params_from_jax
from ..ops.initializers import get_initializer
from ..ops.losses import bpr_loss, euclidean_distance
from ..ops.optim import make_lazy_train_step
from ..parallel import once
from ..run_config import RunConfig
from ..utils import ModelConfig
from .common import (CachedUserVecChunkMixin, EpochTrainedRecommender,
                     FlatTrainStep, as_user_tensor, last_items_by_time,
                     make_optimizer, make_train_step)
from .pipeline import SequentialPairwiseEpochPipeline

__all__ = ["TransRec", "TransRecConfig", "transrec_gathered_loss",
           "transrec_loss"]


class TransRecConfig(ModelConfig):
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
            raise ValueError(f"invalid TransRec config: {self}")


def transrec_gathered_loss(ue, ie_l, ie_p, ie_n, b_p, b_n, trans, w,
                           reg: float) -> torch.Tensor:
    """The batch's summed BPR loss plus the L2 term, from the gathered rows
    (user, last, positive and negative item rows, the two biases) and
    ``trans``."""
    translated = ue + trans + ie_l
    y_pos = -euclidean_distance(translated, ie_p) + b_p
    y_neg = -euclidean_distance(translated, ie_n) + b_n
    loss = torch.sum(bpr_loss(y_pos, y_neg) * w)
    reg_term = 0.5 * (
        torch.sum(torch.sum(ue ** 2 + ie_l ** 2 + ie_p ** 2 + ie_n ** 2, -1)
                  * w)
        + once(torch.sum(trans ** 2)) + torch.sum((b_p ** 2 + b_n ** 2) * w))
    return loss + reg * reg_term


def transrec_loss(params, reg: float, users: torch.Tensor,
                  pos: torch.Tensor, neg: torch.Tensor, w: torch.Tensor,
                  prev: torch.Tensor, trans: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """One batch's loss; ``params`` by the model's parameter names, or a
    function ``(name, ids) -> rows`` with ``trans`` given."""
    if not callable(params):
        trans = params["trans"]
        params = (lambda p: lambda name, ids: p[name][ids])(params)
    neg, last = neg[:, 0], prev[:, 0]
    return transrec_gathered_loss(
        params("user_emb", users), params("item_emb", last),
        params("item_emb", pos), params("item_emb", neg),
        params("item_bias", pos), params("item_bias", neg), trans, w, reg)


# the rows a lazy step gathers, in the loss's argument order
_LAZY_GATHERS = (("user_emb", lambda b: b[0]),
                 ("item_emb", lambda b: b[4][:, 0]),
                 ("item_emb", lambda b: b[1]),
                 ("item_emb", lambda b: b[2][:, 0]),
                 ("item_bias", lambda b: b[1]),
                 ("item_bias", lambda b: b[2][:, 0]))


class TransRec(CachedUserVecChunkMixin, EpochTrainedRecommender):
    _JAX_PARAMS = ("user_emb", "item_emb", "trans", "item_bias")

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, TransRecConfig(**model_config), device)
        cfg = self.config
        d = cfg.embed_size
        gen = torch.Generator().manual_seed(run_config.seed)
        normal = get_initializer("normal")
        self.user_emb = nn.Parameter(
            torch.zeros((self.num_users, d), device=self.device))
        self.item_emb = nn.Parameter(
            normal((self.num_items, d), gen).to(self.device))
        self.trans = nn.Parameter(normal((1, d), gen).to(self.device))
        self.item_bias = nn.Parameter(
            torch.zeros(self.num_items, device=self.device))
        if cfg.optimizer != "lazy_adam":
            self._split_over_model_axis()
        params = {name: getattr(self, name) for name in self._JAX_PARAMS}
        if cfg.optimizer == "lazy_adam":
            def loss_fn(gathered, dense, batch):
                return transrec_gathered_loss(*gathered, dense["trans"],
                                              batch[3], cfg.reg)
            self.train_step, (self.optimizer, self.dense_optimizer) = \
                make_lazy_train_step(cfg.lr, _LAZY_GATHERS, loss_fn, params,
                                     sync=self.sync_gradients)
        elif self.mesh is None:
            self._flat_step = FlatTrainStep(self, self._JAX_PARAMS,
                                            self._loss, cfg.lr)
            self.train_step = self._flat_step
            self.optimizer = self._flat_step.optimizer
        else:
            self.optimizer = make_optimizer("adam", params, cfg.lr)
            self.train_step = make_train_step(self.optimizer, self._loss,
                                              self.sync_gradients)
        self.pipeline = SequentialPairwiseEpochPipeline(
            self.dataset.train_data, cfg.batch_size, self.device,
            num_previous=1, num_next=1, mesh=self.mesh)
        self.last_items = torch.as_tensor(
            last_items_by_time(self.dataset.train_data), device=self.device)

    def _loss(self, users, pos, neg, w, prev) -> torch.Tensor:
        return transrec_loss(self.lookup, self.config.reg, users, pos, neg,
                             w, prev, self.trans)

    def _train_state(self) -> Dict:
        state = super()._train_state()
        if self.config.optimizer == "lazy_adam":
            state["dense_optimizer"] = self.dense_optimizer.state_dict()
        return state

    def _load_train_state(self, state: Dict) -> None:
        super()._load_train_state(state)
        if "dense_optimizer" in state:
            self.dense_optimizer.load_state_dict(state["dense_optimizer"])

    def load_jax_params(self, params: Dict[str, np.ndarray]) -> None:
        """Copy a JAX TransRec's ``params`` (arrays taken with
        ``np.asarray``) into this model."""
        self._copy_params(transrec_params_from_jax(params))

    def load_jax_opt_state(self, *state) -> None:
        """Dense Adam: ``(count, mu, nu)``, as the base class. Lazy Adam:
        JAX's ``opt_state`` as ``(lazy, (count, mu, nu))``: a dict of one
        ``LazyAdamState`` (m, v, counts) per table, and the dense Adam
        state of ``trans``."""
        if self.config.optimizer != "lazy_adam":
            super().load_jax_opt_state(*state)
            return
        lazy, (count, mu, nu) = state
        self.optimizer.load_state_dict(
            {name: lazy_adam_state_from_jax(*s) for name, s in lazy.items()})
        # on a card Adam is capturable: its step count on the device
        self.dense_optimizer.state[self.trans] = {
            "step": torch.tensor(float(count), device=self.device),
            "exp_avg": torch.as_tensor(np.asarray(mu, np.float32).reshape(
                self.trans.shape), device=self.device),
            "exp_avg_sq": torch.as_tensor(np.asarray(nu, np.float32).reshape(
                self.trans.shape), device=self.device)}

    @staticmethod
    def _topk_score_fn(uv: torch.Tensor, items: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
        """``-sqrt(max(|u|^2 - 2 u.i + |i|^2, 0) + 1e-12) + bias``."""
        d2 = (torch.sum(uv * uv, -1)[:, None] - 2.0 * (uv @ items.T)
              + torch.sum(items * items, -1)[None, :])
        return -torch.sqrt(torch.clamp(d2, min=0.0) + 1e-12) + bias[None, :]

    def _user_vectors(self, users: torch.Tensor) -> torch.Tensor:
        return (self.eval_param("user_emb")[users] + self.trans
                + self.eval_param("item_emb")[self.last_items[users]])

    def _topk_factors(self, uv):
        return uv, self.eval_param("item_emb"), self.item_bias

    def _score_user_chunk(self, uv: torch.Tensor, item_lo: int,
                          item_hi: int) -> torch.Tensor:
        return self._topk_score_fn(
            uv, self.eval_param("item_emb")[item_lo:item_hi],
            self.item_bias[item_lo:item_hi])

    @torch.no_grad()
    def predict(self, users) -> torch.Tensor:
        """(B, N) f32 scores on the model's device."""
        uv = self._user_vectors(as_user_tensor(users, self.device))
        return self._score_user_chunk(uv, 0, self.num_items)
