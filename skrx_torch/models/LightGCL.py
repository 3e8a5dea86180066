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

Under a mesh R and Rᵀ are one square bipartite graph ``[[0, R], [Rᵀ,
0]]`` over the users then the items (JAX's mesh branch), a
:class:`~skrx_torch.parallel.ShardedPropGraph` whose edges 0..E-1 run R
and E..2E-1 Rᵀ, so a layer's two masks concatenate into one (2E,) mask;
destination rows split over every rank (segsum on each rank's edges) and
each rank holds the tables' rows in its block. The SVD factors stay whole
on every rank: each layer's input is gathered whole for the SVD view, and
the layer sums are gathered for the rank's slice of the batch; the means
are over the whole batch's valid rows and the L2 term counts once.
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
from ..parallel import ShardedPropGraph, batch_total, once
from .common import (GRAPH_IMPLS, EpochTrainedRecommender,
                     FrozenEmbeddingMixin, graph_sharding_enabled,
                     make_optimizer, make_train_step, mxu_msg_dtype,
                     node_rows, node_table_rows, resolve_graph_impl,
                     whole_nodes)
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
    """R and Rᵀ for propagation and the SVD factors, on one device; under
    a mesh the square bipartite graph ``sq`` in place of R and Rᵀ."""
    r: Optional[Graph]       # R: (N, D) item rows -> (U, D) user rows
    rt: Optional[Graph]      # Rᵀ: (U, D) -> (N, D)
    u_mul_s: torch.Tensor    # (U, q) U S
    v_mul_s: torch.Tensor    # (N, q) V S
    ut: torch.Tensor         # (q, U)
    vt: torch.Tensor         # (q, N)
    sq: Optional[ShardedPropGraph] = None

    def to(self, device) -> "LightGCLOperators":
        r = self.r.to(device)
        return LightGCLOperators(r, transpose_graph(r),
                                 *(getattr(self, f).to(device)
                                   for f in FACTORS))


def lightgcl_operators(coo: sp.coo_matrix, svd_q: int,
                       msg_dtype: torch.dtype = torch.float32, device="cpu",
                       seed: Optional[int] = None,
                       mesh=None) -> LightGCLOperators:
    """The normalised R of the (U, N) interaction matrix ``coo`` (entries
    in row-major order, each counted once) and its rank-q SVD factors,
    ``q = min(svd_q, min(U, N) - 1)``; ``seed`` fixes svds' start vector.
    Under a ``mesh`` of several ranks R and Rᵀ are the square graph
    ``sq``, sharded over its ranks."""
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

    def dev(a):
        return torch.as_tensor(a.astype(np.float32), device=device)
    factors = (dev(svd_u * s), dev(svd_vt.T * s), dev(svd_u.T), dev(svd_vt))
    w32 = norm_data.astype(np.float32)
    if graph_sharding_enabled(mesh):
        sq = ShardedPropGraph(
            mesh, msg_dtype=msg_dtype,
            coo_edges=(np.concatenate([coo.col + num_users, coo.row]),
                       np.concatenate([coo.row, coo.col + num_users]),
                       np.concatenate([w32, w32])),
            num_nodes=num_users + num_items, device=device)
        return LightGCLOperators(None, None, *factors, sq)
    r = graph_from_coo(coo.col, coo.row, w32, num_users, msg_dtype,
                       num_src_nodes=num_items, device=device)
    return LightGCLOperators(r, transpose_graph(r), *factors)


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


def _sharded_forward(ops: LightGCLOperators, e_u: torch.Tensor,
                     e_i: torch.Tensor, n_layers: int,
                     masks: Optional[list], num_users: int
                     ) -> Tuple[torch.Tensor, ...]:
    """:func:`lightgcl_forward` on ``ops.sq`` from the rank's rows of the
    tables: each layer's input gathered whole for the SVD view (the same
    on every rank), the GCN layers summed on the rank's block and gathered
    at the end."""
    sq, nu = ops.sq, num_users
    x = node_rows(sq, e_u, e_i)
    whole = whole_nodes(sq, x)
    sum_x, sum_g = x, whole
    for layer in range(n_layers):
        if layer:
            whole = whole_nodes(sq, x)
        g = torch.cat([ops.u_mul_s @ (ops.vt @ whole[nu:]),
                       ops.v_mul_s @ (ops.ut @ whole[:nu])])
        mask = None if masks is None else torch.cat(masks[layer])
        x = propagate(sq, x, mask)
        sum_x, sum_g = sum_x + x, sum_g + g
    sum_e = whole_nodes(sq, sum_x)
    return sum_e[:nu], sum_e[nu:], sum_g[:nu], sum_g[nu:]


def lightgcl_forward(ops: LightGCLOperators, e_u: torch.Tensor,
                     e_i: torch.Tensor, n_layers: int,
                     masks: Optional[list] = None,
                     num_users: Optional[int] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """(E_u, E_i, G_u, G_i): the sums over layers 0..n_layers of the GCN
    view and of the SVD view; ``masks`` as :func:`lightgcl_dropout_masks`
    gives them. Under a mesh (``ops.sq``) the tables are the rank's rows,
    ``num_users`` the whole count, and the sums come out whole."""
    if ops.sq is not None:
        return _sharded_forward(ops, e_u, e_i, n_layers, masks, num_users)
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
                  masks: Optional[list] = None,
                  num_users: Optional[int] = None) -> torch.Tensor:
    """One batch's loss: mean BPR + ``lambda1`` InfoNCE + ``lambda2`` L2;
    ``params`` holds the ego tables ``E_u_0`` and ``E_i_0``. The InfoNCE
    terms keep JAX's ``log(sum(exp(x / temp)) + 1e-8)`` (no log-sum-exp
    shift), so they overflow where JAX's do."""
    neg = neg[:, 0]
    e_u_0, e_i_0 = params["E_u_0"], params["E_i_0"]
    E_u, E_i, G_u, G_i = lightgcl_forward(ops, e_u_0, e_i_0, cfg.gnn_layer,
                                          masks, num_users)
    temp = cfg.temp
    loss_s = 0.0
    if cfg.lambda1 > 0:
        iids = torch.cat([pos, neg])
        w_ii = torch.cat([w, w])
        n_u = torch.clamp(batch_total(w), min=1.0)
        n_i = torch.clamp(batch_total(w_ii), min=1.0)
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
    n_valid = torch.clamp(batch_total(w), min=1.0)
    loss_r = torch.sum(bpr_loss(y_pos, y_neg) * w) / n_valid
    if ops.sq is not None:              # the ego tables, whole
        ego = whole_nodes(ops.sq, node_rows(ops.sq, e_u_0, e_i_0))
        e_u_0, e_i_0 = ego[:num_users], ego[num_users:]
    loss_reg = once(cfg.lambda2 * (torch.sum(e_u_0 ** 2)
                                   + torch.sum(e_i_0 ** 2)))
    return loss_r + loss_s + loss_reg


class LightGCL(FrozenEmbeddingMixin, EpochTrainedRecommender):
    _JAX_PARAMS = ("E_u_0", "E_i_0")

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, LightGCLConfig(**model_config), device)
        cfg = self.config
        coo = self.dataset.train_data.to_coo_matrix()
        self.num_edges = coo.nnz
        self.ops = lightgcl_operators(
            coo, cfg.svd_q, mxu_msg_dtype(resolve_graph_impl(cfg.graph_impl)),
            self.device, seed=run_config.seed, mesh=self.mesh)
        gen = torch.Generator().manual_seed(run_config.seed)
        init = get_initializer("xavier_uniform")
        tables = node_table_rows(self, self.ops.sq, {
            "E_u_0": init((self.num_users, cfg.d), gen),
            "E_i_0": init((self.num_items, cfg.d), gen)})
        for name, table in tables.items():
            setattr(self, name, nn.Parameter(table.to(self.device)))
        self.optimizer = make_optimizer("adam", {"E_u_0": self.E_u_0,
                                                 "E_i_0": self.E_i_0}, cfg.lr)
        self.train_step = make_train_step(self.optimizer, self._loss,
                                          self.sync_gradients)
        self.pipeline = PairwiseEpochPipeline(
            self.dataset.train_data, cfg.batch_size, self.device, num_neg=1,
            mesh=self.mesh)

    def step_masks(self) -> Optional[list]:
        """The next training step's dropout masks, from the epoch's
        generator (None without dropout)."""
        cfg = self.config
        if cfg.dropout <= 0:
            return None
        return lightgcl_dropout_masks(self.step_generator(),
                                      self.num_edges, cfg.gnn_layer,
                                      cfg.dropout)

    def _loss(self, users, pos, neg, w, masks=None) -> torch.Tensor:
        """The batch's loss under ``masks``, by default the next drawn."""
        if masks is None:
            masks = self.step_masks()
        return lightgcl_loss(self.ops, dict(self.named_parameters()),
                             self.config, users, pos, neg, w, masks,
                             self.num_users)

    def _embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        E_u, E_i, _, _ = lightgcl_forward(self.ops, self.E_u_0, self.E_i_0,
                                          self.config.gnn_layer,
                                          num_users=self.num_users)
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
