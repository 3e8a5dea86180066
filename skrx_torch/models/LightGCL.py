"""LightGCL — graph contrastive learning with SVD-augmented views (Cai et
al., ICLR 2023): the port of ``skrx.models.LightGCL``.

Same config fields, defaults and checks. The bipartite R (U x N, duplicate
pairs counted once) is normalised by ``1 / sqrt(max(rowdeg * coldeg,
1e-12))`` and lowered once as a rectangular operator for
:func:`skrx_torch.ops.graph.propagate` (kernel #11 on a card); Rᵀ is the
same buffers transposed (:func:`~skrx_torch.ops.graph.transpose_graph`),
with the same edge ids, so one (E,) mask means the same edges in either
direction. The rank-q SVD of R (scipy ``svds``, once, on the host) gives
four factor tensors on the device: ``u_mul_s`` (U, q), ``v_mul_s`` (N, q),
``ut`` (q, U), ``vt`` (q, N).

Per layer: ``Z_u = R E_i``, ``Z_i = Rᵀ E_u`` and the SVD view ``G_u =
u_mul_s (vt E_i)``, ``G_i = v_mul_s (ut E_u)``, all from the previous
layer; the four layer sums include layer 0. With ``dropout`` > 0 a training
step draws two independent Bernoulli(1 - dropout) masks per layer, scaled
by ``1 / (1 - dropout)`` (one for R, one for Rᵀ), from
``epoch_generator(seed + 1, epoch, stream=1)``. The loss: the InfoNCE
terms between the SVD and the GCN views (``lambda1``; positive logits
clamped to +-5), the mean BPR, and ``lambda2`` times the squared norms of
the ego tables; dense Adam. ``evaluate()`` freezes ``(E_u, E_i)`` for
``predict``, ``_chunk_embeddings`` and serving until the next epoch.
"""
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import svds
from torch import nn

from ..convert import lightgcl_params_from_jax
from ..ops.graph import Graph, edge_dropout, graph_from_coo, propagate, \
    transpose_graph
from ..ops.initializers import get_initializer
from ..ops.losses import bpr_loss
from ..run_config import RunConfig
from ..utils import ModelConfig
from .common import (GRAPH_IMPLS, EpochTrainedRecommender,
                     FrozenEmbeddingMixin, make_optimizer, make_train_step,
                     mxu_msg_dtype, resolve_graph_impl)
from .pipeline import PairwiseEpochPipeline

__all__ = ["LightGCL", "LightGCLConfig", "LightGCLOperators",
           "lightgcl_operators", "lightgcl_dropout_masks",
           "lightgcl_forward", "lightgcl_loss"]

FACTORS = ("u_mul_s", "v_mul_s", "ut", "vt")


class LightGCLConfig(ModelConfig):
    lr: float = 1e-3
    lambda1: float = 0.2     # CL loss weight
    d: int = 64
    gnn_layer: int = 2
    batch_size: int = 2048
    svd_q: int = 5
    dropout: float = 0.0
    temp: float = 0.2
    lambda2: float = 1e-7    # L2 reg weight
    graph_impl: str = "auto"  # auto | segment | mxu | mxu_bf16
    epochs: int = 500
    early_stop: int = 100

    def _validate(self):
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.lambda1, float) and self.lambda1 >= 0
              and isinstance(self.d, int) and self.d > 0
              and isinstance(self.gnn_layer, int) and self.gnn_layer > 0
              and isinstance(self.batch_size, int) and self.batch_size > 0
              and isinstance(self.svd_q, int) and self.svd_q > 0
              and isinstance(self.dropout, float) and self.dropout >= 0
              and isinstance(self.temp, float) and self.temp > 0
              and isinstance(self.lambda2, float) and self.lambda2 >= 0
              and self.graph_impl in GRAPH_IMPLS)
        if not ok:
            raise ValueError(f"invalid LightGCL config: {self}")


class LightGCLOperators(NamedTuple):
    """R and Rᵀ for propagation and the SVD factors, on one device."""
    r: Graph                 # R: (N, D) item rows -> (U, D) user rows
    rt: Graph                # Rᵀ: (U, D) -> (N, D)
    u_mul_s: torch.Tensor    # (U, q) U S
    v_mul_s: torch.Tensor    # (N, q) V S
    ut: torch.Tensor         # (q, U)
    vt: torch.Tensor         # (q, N)

    def to(self, device) -> "LightGCLOperators":
        r = self.r.to(device)
        return LightGCLOperators(r, transpose_graph(r),
                                 *(getattr(self, f).to(device)
                                   for f in FACTORS))


def lightgcl_operators(coo: sp.coo_matrix, svd_q: int,
                       msg_dtype: torch.dtype = torch.float32, device="cpu",
                       seed: Optional[int] = None) -> LightGCLOperators:
    """The normalised R of the (U, N) interaction matrix ``coo`` (entries
    in row-major order, each counted once) and its rank-q SVD factors,
    ``q = min(svd_q, min(U, N) - 1)``; ``seed`` fixes svds' start vector."""
    coo = coo.astype(np.float64)
    coo.data[:] = 1.0
    row_deg = np.asarray(coo.sum(axis=1)).flatten()
    col_deg = np.asarray(coo.sum(axis=0)).flatten()
    norm_data = coo.data / np.sqrt(
        np.maximum(row_deg[coo.row] * col_deg[coo.col], 1e-12))
    adj = sp.coo_matrix((norm_data, (coo.row, coo.col)), shape=coo.shape)
    q = min(svd_q, min(adj.shape) - 1)
    # the start vector svds would draw, from a generator of its own
    v0 = np.random.default_rng(seed).uniform(-1.0, 1.0, min(adj.shape))
    svd_u, s, svd_vt = svds(adj.tocsc(), k=q, v0=v0)
    num_users, num_items = coo.shape
    r = graph_from_coo(coo.col, coo.row, norm_data.astype(np.float32),
                       num_users, msg_dtype, num_src_nodes=num_items,
                       device=device)

    def dev(a):
        return torch.as_tensor(a.astype(np.float32), device=device)
    return LightGCLOperators(r, transpose_graph(r), dev(svd_u * s),
                             dev(svd_vt.T * s), dev(svd_u.T), dev(svd_vt))


def lightgcl_dropout_masks(generator: torch.Generator, num_edges: int,
                           n_layers: int, dropout: float
                           ) -> Optional[List[Tuple[torch.Tensor,
                                                    torch.Tensor]]]:
    """Per layer, the (R, Rᵀ) edge masks of one training step: two
    independent Bernoulli(1 - dropout) draws scaled by 1 / (1 - dropout),
    in that order; None without dropout."""
    if dropout <= 0:
        return None
    return [(edge_dropout(generator, num_edges, 1 - dropout),
             edge_dropout(generator, num_edges, 1 - dropout))
            for _ in range(n_layers)]


def lightgcl_forward(ops: LightGCLOperators, e_u: torch.Tensor,
                     e_i: torch.Tensor, n_layers: int,
                     masks: Optional[list] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """(E_u, E_i, G_u, G_i): the sums over layers 0..n_layers of the GCN
    view and of the SVD view; ``masks`` as :func:`lightgcl_dropout_masks`
    gives them."""
    sum_eu, sum_ei, sum_gu, sum_gi = e_u, e_i, e_u, e_i
    for layer in range(n_layers):
        mask_u, mask_i = (None, None) if masks is None else masks[layer]
        g_u = ops.u_mul_s @ (ops.vt @ e_i)
        g_i = ops.v_mul_s @ (ops.ut @ e_u)
        e_u, e_i = propagate(ops.r, e_i, mask_u), propagate(ops.rt, e_u,
                                                            mask_i)
        sum_eu, sum_ei = sum_eu + e_u, sum_ei + e_i
        sum_gu, sum_gi = sum_gu + g_u, sum_gi + g_i
    return sum_eu, sum_ei, sum_gu, sum_gi


def lightgcl_loss(ops: LightGCLOperators, params: Dict[str, torch.Tensor],
                  cfg: LightGCLConfig, users: torch.Tensor, pos: torch.Tensor,
                  neg: torch.Tensor, w: torch.Tensor,
                  masks: Optional[list] = None) -> torch.Tensor:
    """One batch's loss: mean BPR + ``lambda1`` InfoNCE + ``lambda2`` L2;
    ``params`` holds the ego tables ``E_u_0`` and ``E_i_0``. The InfoNCE
    terms keep JAX's ``log(sum(exp(x / temp)) + 1e-8)`` (no log-sum-exp
    shift), so they overflow where JAX's do."""
    neg = neg[:, 0]
    e_u_0, e_i_0 = params["E_u_0"], params["E_i_0"]
    E_u, E_i, G_u, G_i = lightgcl_forward(ops, e_u_0, e_i_0, cfg.gnn_layer,
                                          masks)
    temp = cfg.temp
    loss_s = 0.0
    if cfg.lambda1 > 0:
        iids = torch.cat([pos, neg])
        w_ii = torch.cat([w, w])
        n_u = torch.clamp(torch.sum(w), min=1.0)
        n_i = torch.clamp(torch.sum(w_ii), min=1.0)
        g_u, g_i = G_u[users], G_i[iids]
        neg_score = torch.sum(torch.log(torch.sum(
            torch.exp(g_u @ E_u.T / temp), 1) + 1e-8) * w) / n_u
        neg_score = neg_score + torch.sum(torch.log(torch.sum(
            torch.exp(g_i @ E_i.T / temp), 1) + 1e-8) * w_ii) / n_i
        pos_score = torch.sum(torch.clamp(
            torch.sum(g_u * E_u[users], 1) / temp, -5.0, 5.0) * w) / n_u
        pos_score = pos_score + torch.sum(torch.clamp(
            torch.sum(g_i * E_i[iids], 1) / temp, -5.0, 5.0) * w_ii) / n_i
        loss_s = cfg.lambda1 * (-pos_score + neg_score)
    ue = E_u[users]
    y_pos = torch.sum(ue * E_i[pos], dim=-1)
    y_neg = torch.sum(ue * E_i[neg], dim=-1)
    n_valid = torch.clamp(torch.sum(w), min=1.0)
    loss_r = torch.sum(bpr_loss(y_pos, y_neg) * w) / n_valid
    loss_reg = cfg.lambda2 * (torch.sum(e_u_0 ** 2) + torch.sum(e_i_0 ** 2))
    return loss_r + loss_s + loss_reg


class LightGCL(FrozenEmbeddingMixin, EpochTrainedRecommender):
    _JAX_PARAMS = ("E_u_0", "E_i_0")

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, LightGCLConfig(**model_config), device)
        cfg = self.config
        self.ops = lightgcl_operators(
            self.dataset.train_data.to_coo_matrix(), cfg.svd_q,
            mxu_msg_dtype(resolve_graph_impl(cfg.graph_impl)), self.device,
            seed=run_config.seed)
        gen = torch.Generator().manual_seed(run_config.seed)
        init = get_initializer("xavier_uniform")
        self.E_u_0 = nn.Parameter(
            init((self.num_users, cfg.d), gen).to(self.device))
        self.E_i_0 = nn.Parameter(
            init((self.num_items, cfg.d), gen).to(self.device))
        self.optimizer = make_optimizer("adam", {"E_u_0": self.E_u_0,
                                                 "E_i_0": self.E_i_0}, cfg.lr)
        self.train_step = make_train_step(self.optimizer, self._loss)
        self.pipeline = PairwiseEpochPipeline(
            self.dataset.train_data, cfg.batch_size, self.device, num_neg=1)

    def step_masks(self) -> Optional[list]:
        """The next training step's dropout masks, from the epoch's
        generator (None without dropout)."""
        cfg = self.config
        if cfg.dropout <= 0:
            return None
        return lightgcl_dropout_masks(self.step_generator(),
                                      self.ops.r.num_edges, cfg.gnn_layer,
                                      cfg.dropout)

    def _loss(self, users, pos, neg, w, masks=None) -> torch.Tensor:
        """The batch's loss under ``masks``, by default the next drawn."""
        if masks is None:
            masks = self.step_masks()
        return lightgcl_loss(self.ops, dict(self.named_parameters()),
                             self.config, users, pos, neg, w, masks)

    def _embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        E_u, E_i, _, _ = lightgcl_forward(self.ops, self.E_u_0, self.E_i_0,
                                          self.config.gnn_layer)
        return E_u, E_i

    def load_jax_params(self, params: Dict[str, np.ndarray],
                        factors: Optional[Dict[str, np.ndarray]] = None
                        ) -> None:
        """Copy a JAX LightGCL's ``params`` (``E_u_0``, ``E_i_0``) into this
        model and, when given, its SVD factors (``u_mul_s``, ``v_mul_s``,
        ``ut``, ``vt``: the arrays of its ``_u_mul_s`` ... ``_vt``), numpy
        arrays of this model's shapes."""
        self._copy_params(lightgcl_params_from_jax(params))
        if factors is not None:
            if set(factors) != set(FACTORS):
                raise ValueError(f"expected factors {FACTORS}, got "
                                 f"{sorted(factors)}")
            new = {}
            for key in FACTORS:
                value = torch.tensor(np.asarray(factors[key], np.float32),
                                     device=self.device)
                have = getattr(self.ops, key)
                if value.shape != have.shape:
                    raise ValueError(f"{key}: shape {tuple(value.shape)}, "
                                     f"model has {tuple(have.shape)}")
                new[key] = value
            self.ops = self.ops._replace(**new)
        self._final_emb = None
