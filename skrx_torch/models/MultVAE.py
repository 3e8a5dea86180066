"""MultVAE — variational autoencoder with a multinomial likelihood (Liang et
al., WWW 2018): the port of ``skrx.models.MultVAE``.

Same config fields, defaults and checks (``p_dims`` defaults to [64];
``q_dims``, when given, must start at the catalog and end at the latent
width). The encoder ``q`` and the decoder ``p`` are lists of
``nn.Linear`` layers with tanh between them, each holding JAX's ``h @ w +
b`` as ``weight = w.T``, every weight and bias drawn from N(0, 0.01^2);
the encoder's last layer gives the mean and the log-variance side by side.
``compute_dtype="bfloat16"`` runs each layer's matmul and bias add in bf16
on bf16 copies of the f32 weights, as the JAX package does. Epochs come
from :class:`UserVecEpochPipeline`.

Each training step draws, in this order, the input's (B, N) dropout keep
mask (probability ``keep_prob``) and the reparameterisation noise ``eps``
(B, latent) (:func:`multvae_draws`, from the epoch's step generator). The
input is ``x / (|x| + 1e-12)``, dropped out and scaled by ``1 /
keep_prob``; ``z = mu + eps * exp(logvar / 2)``. The loss: the weighted
multinomial log-likelihood of the rows under ``log_softmax`` of the
decoder's logits, plus ``anneal`` times the KL term, each averaged over
the valid rows, plus ``reg`` times the squared weights (not biases);
dense Adam. ``anneal = min(anneal_cap, count / anneal_steps)`` in f32 from
the f32 count of steps taken (``update_count``, a tensor the step moves in
place, so that a captured epoch replays the anneal), which the training
state carries across epochs and checkpoints, so a resumed ``fit()``
anneals as an uninterrupted one.

Scoring decodes the mean (no noise, no dropout). It is a tower
(:class:`CachedUserVecChunkMixin`): the user vectors are the decoder's
state before its last layer, and ``_topk_factors`` gives ``(uv, w_last.T,
b_last)``, rounded to bf16 and back under bf16 compute, so the fused
route scores them with the kernels' f32 arithmetic (under bf16 within
rounding of ``predict``'s bf16 matmul; equal under f32).

Under a mesh MultVAE trains data-parallel: a step's keep mask and noise
are drawn at the whole batch's shape (each rank takes its rows), the
means divide by the whole batch's valid rows, the weights' L2 counts once
and the gradients sum over the data axis.
"""
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..convert import linear_port_name, multvae_params_from_jax
from ..ops.initializers import get_initializer
from ..parallel import batch_total, global_rows, local_rows, once
from ..run_config import RunConfig
from ..utils import ModelConfig
from .common import (CachedUserVecChunkMixin, EpochTrainedRecommender,
                     as_user_tensor, make_optimizer, make_train_step)
from .pipeline import UserVecEpochPipeline

__all__ = ["MultVAE", "MultVAEConfig", "multvae_draws", "multvae_encode",
           "multvae_loss"]

_Layers = List[Tuple[torch.Tensor, torch.Tensor]]
_Draws = Tuple[Optional[torch.Tensor], torch.Tensor]
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class MultVAEConfig(ModelConfig):
    lr: float = 1e-3
    reg: float = 0.0
    p_dims: Optional[List[int]] = None   # decoder widths from the latent
    q_dims: Optional[List[int]] = None   # encoder widths; None: symmetric
    keep_prob: float = 0.5
    anneal_steps: int = 200000
    anneal_cap: float = 0.2
    compute_dtype: str = "float32"       # float32 | bfloat16
    batch_size: int = 256
    epochs: int = 1000
    early_stop: int = 200

    def _validate(self):
        if self.p_dims is None:
            self.p_dims = [64]
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.reg, float) and self.reg >= 0
              and isinstance(self.p_dims, list)
              and (self.q_dims is None or isinstance(self.q_dims, list))
              and isinstance(self.keep_prob, float) and self.keep_prob >= 0
              and isinstance(self.anneal_steps, int)
              and self.anneal_steps >= 0
              and isinstance(self.anneal_cap, float) and self.anneal_cap >= 0
              and self.compute_dtype in _DTYPES
              and isinstance(self.batch_size, int) and self.batch_size > 0
              and isinstance(self.epochs, int) and self.epochs >= 0
              and isinstance(self.early_stop, int))
        if not ok:
            raise ValueError(f"invalid MultVAE config: {self}")


def _layers(params: Dict[str, torch.Tensor], net: str) -> _Layers:
    """(weight, bias) of each layer of ``net`` ("q" or "p") in order."""
    count = sum(1 for name in params if name.startswith(f"{net}.")
                and name.endswith(".weight"))
    return [(params[f"{net}.{i}.weight"], params[f"{net}.{i}.bias"])
            for i in range(count)]


def _pairs(layers: nn.ModuleList) -> _Layers:
    return [(layer.weight, layer.bias) for layer in layers]


def _mlp(layers: _Layers, h: torch.Tensor, cdt: torch.dtype,
         last_act: bool = False) -> torch.Tensor:
    """``h @ w + b`` a layer in ``cdt``, tanh between layers (and after the
    last with ``last_act``); f32 out."""
    h = h.to(cdt)
    for i, (weight, bias) in enumerate(layers):
        h = h @ weight.to(cdt).T + bias.to(cdt)
        if last_act or i != len(layers) - 1:
            h = torch.tanh(h)
    return h.to(torch.float32)


def multvae_draws(generator: torch.Generator, batch: int, num_items: int,
                  latent: int, keep_prob: float) -> _Draws:
    """One step's draws, in order: the (batch, N) bool keep mask of the
    input (None when ``keep_prob`` >= 1) and ``eps`` (batch, latent) ~
    N(0, 1)."""
    dev = generator.device
    keep = (torch.rand((batch, num_items), generator=generator, device=dev)
            < keep_prob) if keep_prob < 1.0 else None
    eps = torch.randn((batch, latent), generator=generator, device=dev)
    return keep, eps


def multvae_encode(q_layers: _Layers, x: torch.Tensor, cdt: torch.dtype,
                   drop_mask: Optional[torch.Tensor] = None,
                   keep_prob: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mu, logvar) of rows ``x`` (B, N) under the input's ``drop_mask``."""
    h = x / (torch.linalg.norm(x, dim=1, keepdim=True) + 1e-12)
    if drop_mask is not None:
        h = torch.where(drop_mask, h / keep_prob, 0.0)
    h = _mlp(q_layers, h, cdt)
    latent = h.shape[1] // 2
    return h[:, :latent], h[:, latent:]


def multvae_loss(params: Dict[str, torch.Tensor], cfg: MultVAEConfig,
                 rows: torch.Tensor, w: torch.Tensor,
                 drop_mask: Optional[torch.Tensor], eps: torch.Tensor,
                 anneal: Union[float, torch.Tensor]) -> torch.Tensor:
    """One batch's loss under one step's draws (:func:`multvae_draws`)
    and KL weight ``anneal``; ``params`` by the model's parameter names
    (``q.0.weight``, ``q.0.bias``, ..., ``p.0.weight``, ...)."""
    cdt = _DTYPES[cfg.compute_dtype]
    q_layers, p_layers = _layers(params, "q"), _layers(params, "p")
    mu, logvar = multvae_encode(q_layers, rows, cdt, drop_mask,
                                cfg.keep_prob)
    z = mu + eps * torch.exp(0.5 * logvar)
    log_softmax = F.log_softmax(_mlp(p_layers, z, cdt), dim=-1)
    n_valid = torch.clamp(batch_total(w), min=1.0)
    neg_ll = -torch.sum(torch.sum(log_softmax * rows, dim=-1) * w) / n_valid
    kl = torch.sum(torch.sum(
        0.5 * (-logvar + torch.exp(logvar) + mu ** 2 - 1.0), dim=1) * w) \
        / n_valid
    reg_var = 0.5 * sum(torch.sum(weight ** 2)
                        for weight, _ in q_layers + p_layers) * cfg.reg
    return neg_ll + anneal * kl + 2.0 * once(reg_var)


def _linear_stack(dims: List[int], init, gen: torch.Generator,
                  device: torch.device) -> nn.ModuleList:
    """``nn.Linear`` layers d_in -> d_out along ``dims``, each w (d_in,
    d_out) and b drawn by ``init`` in that order, the weight held as
    w.T."""
    layers = nn.ModuleList()
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        layer = nn.Linear(d_in, d_out, device="meta")    # no init drawn
        layer.weight = nn.Parameter(
            init((d_in, d_out), gen).T.contiguous().to(device))
        layer.bias = nn.Parameter(init((d_out,), gen).to(device))
        layers.append(layer)
    return layers


class MultVAE(CachedUserVecChunkMixin, EpochTrainedRecommender):
    _CAPTURED_STEP = True

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, MultVAEConfig(**model_config), device)
        cfg = self.config
        self.p_dims = list(cfg.p_dims) + [self.num_items]
        if cfg.q_dims is None:
            self.q_dims = self.p_dims[::-1]
        else:
            self.q_dims = [self.num_items] + list(cfg.q_dims)
            if self.q_dims[-1] != self.p_dims[0]:
                raise ValueError("Latent dimension for p- and q-network "
                                 "mismatches.")
        gen = torch.Generator().manual_seed(run_config.seed)
        init = get_initializer("normal")
        # the encoder's last layer gives mu and logvar side by side
        self.q = _linear_stack(self.q_dims[:-1] + [2 * self.q_dims[-1]],
                               init, gen, self.device)
        self.p = _linear_stack(self.p_dims, init, gen, self.device)
        self.cdt = _DTYPES[cfg.compute_dtype]
        self.optimizer = make_optimizer("adam", dict(self.named_parameters()),
                                        cfg.lr)
        # f32 count of the steps taken: the KL anneal's progress, which the
        # step moves on in place (part of its state)
        self._count = torch.zeros((), device=self.device)
        self.train_step = make_train_step(self.optimizer, self._loss,
                                          self.sync_gradients,
                                          count=self._count)
        self.pipeline = UserVecEpochPipeline(self.dataset.train_data,
                                             cfg.batch_size, self.device,
                                             mesh=self.mesh)

    @property
    def update_count(self) -> torch.Tensor:
        """The f32 count of the steps taken, on the device (JAX's
        ``_update_count``); setting it copies into the tensor the step
        moves."""
        return self._count

    @update_count.setter
    def update_count(self, value) -> None:
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value, dtype=np.float32))
        with torch.no_grad():
            self._count.copy_(value)

    def anneal(self) -> Union[float, torch.Tensor]:
        """The KL weight of the next step (f32 on the device)."""
        cfg = self.config
        if cfg.anneal_steps <= 0:
            return cfg.anneal_cap
        return torch.clamp(self.update_count / cfg.anneal_steps,
                           max=cfg.anneal_cap)

    def step_draws(self, batch: int) -> _Draws:
        """The next training step's draws, from the epoch's generator."""
        return multvae_draws(self.step_generator(), batch, self.num_items,
                             self.q_dims[-1], self.config.keep_prob)

    def _loss(self, users, rows, w, draws: Optional[_Draws] = None
              ) -> torch.Tensor:
        """The batch's loss under ``draws`` (keep mask, eps), by default
        the next drawn, at the current anneal."""
        if draws is None:       # drawn at the whole batch's shape
            draws = tuple(map(local_rows, self.step_draws(
                global_rows(users.shape[0]))))
        return multvae_loss(dict(self.named_parameters()), self.config,
                            rows, w, *draws, self.anneal())

    def _train_state(self) -> Dict:
        state = super()._train_state()
        state["update_count"] = self.update_count.detach().clone()
        return state

    def _load_train_state(self, state: Dict) -> None:
        super()._load_train_state(state)
        if "update_count" in state:
            self.update_count = state["update_count"]       # in place

    def _user_vectors(self, users: torch.Tensor) -> torch.Tensor:
        mu, _ = multvae_encode(_pairs(self.q), self.pipeline.rows_for(users),
                               self.cdt)
        return _mlp(_pairs(self.p[:-1]), mu, self.cdt, last_act=True)

    def _last_layer(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The decoder's last weight (N, d) and bias (N,) as the score's dot
        factors take them: rounded to the compute dtype, in f32."""
        last = self.p[-1]
        return (last.weight.to(self.cdt).to(torch.float32),
                last.bias.to(self.cdt).to(torch.float32))

    def _score_user_chunk(self, uv: torch.Tensor, item_lo: int,
                          item_hi: int) -> torch.Tensor:
        weight, bias = self._last_layer()
        return uv @ weight[item_lo:item_hi].T + bias[None, item_lo:item_hi]

    def _topk_factors(self, uv):
        return (uv, *self._last_layer())

    @torch.no_grad()
    def predict(self, users) -> torch.Tensor:
        """(B, N) f32 scores (the decoder's logits of the mean) of
        ``users`` on the model's device."""
        rows = self.pipeline.rows_for(as_user_tensor(users, self.device))
        mu, _ = multvae_encode(_pairs(self.q), rows, self.cdt)
        return _mlp(_pairs(self.p), mu, self.cdt)

    def _jax_leaves(self) -> Dict[str, Tuple[str, bool]]:
        """Leaf ``q/i/w`` is ``q.i.weight``, transposed."""
        return {key: linear_port_name(key)
                for net, layers in (("q", self.q), ("p", self.p))
                for i in range(len(layers)) for key in (f"{net}/{i}/w",
                                                        f"{net}/{i}/b")}

    def load_jax_params(self, params: Dict) -> None:
        """Copy a JAX MultVAE's nested ``params`` (arrays taken with
        ``np.asarray``) into this model."""
        self._copy_params(multvae_params_from_jax(params))
