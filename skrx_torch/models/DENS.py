"""DENS — disentangled negative sampling on graph collaborative filtering
(Lai et al., WSDM 2023): the port of ``skrx.models.DENS``.

Same config fields, defaults and checks. The symmetric-normalised
bipartite adjacency (LightGCN's "pre") is lowered once through
:func:`~skrx_torch.models.common.build_prop_graph` (kernel #11 on a card;
edge ids in CSR order). The GCN keeps every hop's embedding, (n, hops + 1,
d), with optional edge dropout (an (E,) mask per hop) and message dropout
(an (n, d) keep mask per hop, kept values scaled by 1 / (1 - rate)), drawn
per training step from ``epoch_generator(seed + 1, epoch, stream=1)`` in
JAX's order (per hop: the edge mask, then the message mask).

Parameters: ``user_emb`` (U, d), ``item_emb`` (N, d), Xavier-uniform, and
four gates ``user_gate``, ``item_gate``, ``pos_gate``, ``neg_gate``, each
``nn.Linear(d, d)`` holding JAX's ``x @ w + b`` as ``weight = w.T`` (w
Xavier-uniform, b zero). Each batch row brings ``K`` groups of ``n_negs``
candidates (:class:`PairwiseEpochPipeline` with ``num_neg = K * n_negs``);
a group's negative is its first candidate (``rns``), the one of highest
pooled score (``dns``), or per hop the one of highest score against the
factor-gated residual ``anneal * n - gate(n)`` (``dens``); ties go to the
first candidate and the choice carries no gradient. ``anneal = 1 -
min(1, epoch / max(warmup, 1))``. The loss: ``log(1 + sum(exp(neg -
pos)))`` over the K negatives (kept as JAX writes it, not as a softplus),
for ``dens`` plus ``gamma / 4`` times the four gated terms, plus ``l2``
times the hop-0 L2 of the batch's rows over ``batch_size``; dense Adam.
Poolings: mean, sum, concat, final. ``evaluate()`` freezes the pooled
embeddings for ``predict``, ``_chunk_embeddings`` and serving until the
next epoch.

Under a mesh (``RunConfig.mesh_shape``) the graph's destination rows split
over every rank (segsum on each rank's edges) with the rows of
``user_emb`` and ``item_emb`` in the rank's block; the hops of the rank's
rows are gathered whole (the step's masks are drawn whole and each rank
takes its rows), the rank's slice of the batch selects and scores, and the
gates' gradients sum over the data axis; the loss's mean is over the whole
batch's valid rows.
"""
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..convert import DENS_GATES, dens_params_from_jax, linear_port_name
from ..ops.graph import Graph, edge_dropout, propagate
from ..ops.initializers import get_initializer
from ..run_config import RunConfig
from ..utils import ModelConfig
from .LightGCN import build_bipartite_adj
from ..parallel import batch_total
from .common import (GRAPH_IMPLS, EpochTrainedRecommender,
                     FrozenEmbeddingMixin, build_prop_graph, make_optimizer,
                     make_train_step, node_rows, node_table_rows,
                     own_node_rows, whole_nodes)
from .pipeline import PairwiseEpochPipeline

__all__ = ["DENS", "DENSConfig", "dens_dropout_masks", "dens_gcn",
           "dens_pool", "dens_select", "dens_loss"]

_Masks = List[Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]]


class DENSConfig(ModelConfig):
    lr: float = 1e-3
    l2: float = 1e-4
    gamma: float = 0.3
    dim: int = 64
    batch_size: int = 2048
    context_hops: int = 3
    K: int = 1
    n_negs: int = 6
    ns: str = "dens"
    pool: str = "mean"
    warmup: int = 100
    mess_dropout: bool = False
    mess_dropout_rate: float = 0.1
    edge_dropout: bool = False
    edge_dropout_rate: float = 0.1
    alpha: float = 1.0
    graph_impl: str = "auto"  # auto | segment | mxu | mxu_bf16
    epochs: int = 1000
    early_stop: int = 100

    def _validate(self):
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.l2, float) and self.l2 >= 0
              and isinstance(self.gamma, float) and self.gamma >= 0
              and isinstance(self.dim, int) and self.dim > 0
              and isinstance(self.batch_size, int) and self.batch_size > 0
              and isinstance(self.context_hops, int)
              and self.context_hops >= 0
              and isinstance(self.K, int) and self.K > 0
              and isinstance(self.n_negs, int) and self.n_negs > 0
              and self.ns in {"rns", "dns", "dens"}
              and self.pool in {"mean", "sum", "concat", "final"}
              and isinstance(self.warmup, int) and self.warmup >= 0
              and self.graph_impl in GRAPH_IMPLS)
        if not ok:
            raise ValueError(f"invalid DENS config: {self}")


def dens_dropout_masks(generator: torch.Generator, graph: Graph,
                       hops: int, dim: int, edge_rate: float,
                       mess_rate: float) -> Optional[_Masks]:
    """Per hop, (edge mask (E,) f32 or None, message keep mask (n, dim)
    bool or None) of one training step, drawn in that order; None when
    both rates are 0."""
    if edge_rate <= 0 and mess_rate <= 0:
        return None
    masks = []
    for _ in range(hops):
        edge = (edge_dropout(generator, graph.num_edges, 1 - edge_rate)
                if edge_rate > 0 else None)
        keep = (torch.rand((graph.num_nodes, dim), generator=generator,
                           device=generator.device) < 1 - mess_rate
                if mess_rate > 0 else None)
        masks.append((edge, keep))
    return masks


def dens_gcn(graph: Graph, user_emb: torch.Tensor, item_emb: torch.Tensor,
             hops: int, mess_rate: float = 0.0,
             masks: Optional[_Masks] = None,
             num_users: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(users (U, hops + 1, d), items (N, hops + 1, d)): every hop of the
    propagation of the ego embeddings, under ``masks``
    (:func:`dens_dropout_masks`; a message keep mask scales by 1 / (1 -
    ``mess_rate``)). On a sharded graph the tables are the rank's rows and
    ``num_users`` the whole count."""
    ego = node_rows(graph, user_emb, item_emb)
    embs, h = [ego], ego
    for hop in range(hops):
        edge, keep = (None, None) if masks is None else masks[hop]
        h = propagate(graph, h, edge)
        if keep is not None:
            h = torch.where(own_node_rows(graph, keep), h / (1 - mess_rate),
                            0.0)
        embs.append(h)
    stacked = whole_nodes(graph, torch.stack(embs, dim=1))
    num_users = user_emb.shape[0] if num_users is None else num_users
    return stacked[:num_users], stacked[num_users:]


def dens_pool(e: torch.Tensor, pool: str) -> torch.Tensor:
    """Pool (..., hops + 1, d) over the hops."""
    if pool == "mean":
        return torch.mean(e, dim=-2)
    if pool == "sum":
        return torch.sum(e, dim=-2)
    if pool == "concat":
        return e.flatten(-2)
    return e[..., -1, :]


def _gate(params: Dict[str, torch.Tensor], name: str,
          x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, params[f"{name}.weight"], params[f"{name}.bias"])


@torch.no_grad()
def _pick(params: Dict[str, torch.Tensor], ns: str, pool: str,
          s_e: torch.Tensor, p_e: torch.Tensor, n_e: torch.Tensor,
          anneal: float) -> torch.Tensor:
    """The winning candidate of each row (``dns``: (B,)) or of each (row,
    hop) (``dens``: (B, H)); the first of equal scores (``torch.argmax``,
    as ``jnp.argmax``)."""
    if ns == "dns":
        scores = torch.sum(dens_pool(s_e, pool)[:, None, :]
                           * dens_pool(n_e, pool), dim=-1)
        return torch.argmax(scores, dim=1)
    gate_p = torch.sigmoid(_gate(params, "item_gate", p_e)
                           + _gate(params, "user_gate", s_e))
    gate_n = torch.sigmoid(_gate(params, "neg_gate", n_e)
                           + _gate(params, "pos_gate", p_e * gate_p)[:, None])
    n_sel = anneal * n_e - n_e * gate_n
    return torch.argmax(torch.sum(s_e[:, None] * n_sel, dim=-1), dim=1)


def dens_select(params: Dict[str, torch.Tensor], ns: str, pool: str,
                s_e: torch.Tensor, p_e: torch.Tensor, n_e: torch.Tensor,
                anneal: float) -> torch.Tensor:
    """The selected negatives (B, H, D) of one group ``n_e`` (B, n_negs,
    H, D) for users ``s_e`` and positives ``p_e`` (B, H, D)."""
    if ns == "rns":
        return n_e[:, 0]
    idx = _pick(params, ns, pool, s_e, p_e, n_e, anneal)
    b, _, h, d = n_e.shape
    if ns == "dns":
        return n_e[torch.arange(b, device=n_e.device), idx]
    return torch.gather(n_e.transpose(1, 2), 2,
                        idx[:, :, None, None].expand(b, h, 1, d))[:, :, 0]


def dens_loss(graph: Graph, params: Dict[str, torch.Tensor],
              cfg: DENSConfig, users: torch.Tensor, pos: torch.Tensor,
              neg: torch.Tensor, w: torch.Tensor, anneal: float,
              masks: Optional[_Masks] = None,
              num_users: Optional[int] = None) -> torch.Tensor:
    """One batch's loss (neg: (B, K * n_negs)); ``params`` by the model's
    parameter names (``user_emb``, ``item_emb``, ``user_gate.weight``,
    ``user_gate.bias``, ...); ``num_users`` as :func:`dens_gcn`."""
    pool, K = cfg.pool, cfg.K
    mess_rate = cfg.mess_dropout_rate if cfg.mess_dropout else 0.0
    u_all, i_all = dens_gcn(graph, params["user_emb"], params["item_emb"],
                            cfg.context_hops, mess_rate, masks, num_users)
    s_e, p_e = u_all[users], i_all[pos]                  # (B, H, D)
    groups = neg.reshape(neg.shape[0], K, cfg.n_negs)
    neg_sel = torch.stack([
        dens_select(params, cfg.ns, pool, s_e, p_e, i_all[groups[:, k]],
                    anneal) for k in range(K)], dim=1)    # (B, K, H, D)
    u_pool = dens_pool(s_e, pool)
    pos_scores = torch.sum(u_pool * dens_pool(p_e, pool), dim=-1)
    neg_scores = torch.sum(u_pool[:, None] * dens_pool(neg_sel, pool), dim=-1)
    n_valid = torch.clamp(batch_total(w), min=1.0)

    def mlog(x):
        return torch.sum(x * w) / n_valid
    loss = mlog(torch.log(1 + torch.sum(
        torch.exp(neg_scores - pos_scores[:, None]), 1)))
    if cfg.ns == "dens" and cfg.gamma > 0:
        gate_pos = torch.sigmoid(_gate(params, "item_gate", p_e)
                                 + _gate(params, "user_gate", s_e))
        g_pos_r = p_e * gate_pos
        g_pos_ir = p_e - g_pos_r
        gate_neg = torch.sigmoid(_gate(params, "neg_gate", neg_sel)
                                 + _gate(params, "pos_gate", g_pos_r)[:, None])
        g_neg_r = neg_sel * gate_neg
        g_neg_ir = neg_sel - g_neg_r
        s_pr = torch.sum(u_pool * dens_pool(g_pos_r, pool), -1)
        s_nr = torch.sum(u_pool[:, None] * dens_pool(g_neg_r, pool), -1)
        s_pir = torch.sum(u_pool * dens_pool(g_pos_ir, pool), -1)
        s_nir = torch.sum(u_pool[:, None] * dens_pool(g_neg_ir, pool), -1)
        t1 = mlog(torch.log(1 + torch.exp(s_pir - s_pr)))
        t2 = mlog(torch.log(1 + torch.sum(torch.exp(s_nr - s_nir), 1)))
        t3 = mlog(torch.log(1 + torch.sum(torch.exp(s_nr - s_pr[:, None]),
                                          1)))
        t4 = mlog(torch.log(1 + torch.sum(torch.exp(s_pir[:, None] - s_nir),
                                          1)))
        loss = loss + cfg.gamma * (t1 + t2 + t3 + t4) / 4
    reg = (torch.sum((s_e[:, 0] ** 2).sum(-1) * w)
           + torch.sum((p_e[:, 0] ** 2).sum(-1) * w)
           + torch.sum((neg_sel[:, :, 0] ** 2).sum(-1) * w[:, None])) / 2
    return loss + cfg.l2 * reg / cfg.batch_size


class DENS(FrozenEmbeddingMixin, EpochTrainedRecommender):
    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, DENSConfig(**model_config), device)
        cfg = self.config
        adj = build_bipartite_adj(self.dataset.train_data.to_user_item_pairs(),
                                  self.num_users, self.num_items, "pre")
        self.graph = build_prop_graph(adj, cfg.graph_impl, mesh=self.mesh,
                                      device=self.device)
        gen = torch.Generator().manual_seed(run_config.seed)
        init = get_initializer("xavier_uniform")
        d = cfg.dim
        tables = node_table_rows(self, self.graph, {
            "user_emb": init((self.num_users, d), gen),
            "item_emb": init((self.num_items, d), gen)})
        for name, table in tables.items():
            setattr(self, name, nn.Parameter(table.to(self.device)))
        for name in ("user_gate", "item_gate", "pos_gate", "neg_gate"):
            gate = nn.Linear(d, d, device="meta")   # no default init drawn
            gate.weight = nn.Parameter(
                init((d, d), gen).T.contiguous().to(self.device))
            gate.bias = nn.Parameter(torch.zeros(d, device=self.device))
            setattr(self, name, gate)
        self.optimizer = make_optimizer("adam", dict(self.named_parameters()),
                                        cfg.lr)
        self.train_step = make_train_step(self.optimizer, self._loss,
                                          self.sync_gradients)
        self.pipeline = PairwiseEpochPipeline(
            self.dataset.train_data, cfg.batch_size, self.device,
            num_neg=cfg.K * cfg.n_negs, mesh=self.mesh)
        self.anneal = 1.0

    def step_masks(self) -> Optional[_Masks]:
        """The next training step's dropout masks, from the epoch's
        generator (None with both dropouts off)."""
        cfg = self.config
        edge_rate = cfg.edge_dropout_rate if cfg.edge_dropout else 0.0
        mess_rate = cfg.mess_dropout_rate if cfg.mess_dropout else 0.0
        if edge_rate <= 0 and mess_rate <= 0:
            return None
        return dens_dropout_masks(self.step_generator(), self.graph,
                                  cfg.context_hops, cfg.dim, edge_rate,
                                  mess_rate)

    def _loss(self, users, pos, neg, w, masks=None) -> torch.Tensor:
        """The batch's loss under ``masks``, by default the next drawn."""
        if masks is None:
            masks = self.step_masks()
        return dens_loss(self.graph, dict(self.named_parameters()),
                         self.config, users, pos, neg, w, self.anneal, masks,
                         self.num_users)

    def _train_epoch(self, epoch: int) -> float:
        self.anneal = 1.0 - min(1.0, epoch / max(self.config.warmup, 1))
        return super()._train_epoch(epoch)

    def _embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        u_all, i_all = dens_gcn(self.graph, self.user_emb, self.item_emb,
                                cfg.context_hops, num_users=self.num_users)
        return dens_pool(u_all, cfg.pool), dens_pool(i_all, cfg.pool)

    def load_jax_params(self, params: Dict) -> None:
        """Copy a JAX DENS's nested ``params`` (arrays taken with
        ``np.asarray``) into this model."""
        self._copy_params(dens_params_from_jax(params))
        self._final_emb = None

    def _jax_leaves(self) -> Dict[str, Tuple[str, bool]]:
        """A gate's ``w`` is its ``nn.Linear``'s weight, transposed."""
        leaves = {name: (name, False) for name in ("user_emb", "item_emb")}
        for gate in DENS_GATES:
            for leaf in ("w", "b"):
                key = f"{gate}/{leaf}"
                leaves[key] = linear_port_name(key)
        return leaves
