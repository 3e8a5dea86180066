"""SLMRec — self-supervised learning for multimedia recommendation (Tao et
al., IEEE TMM 2022): the port of ``skrx.models.SLMRec``.

Same config fields, defaults, checks and ``param_space``. The graph is the
``adj_type`` normalisation of the user-item adjacency
(:func:`slmrec_adj`: "plain", "norm", "gcmc", "pre" with degrees + 1e-8,
"mean"), lowered once for kernel #11. The image and text features are
L2-normalised once (numpy, as JAX) and stay constants.

Parameters, in the JAX package's layout (``x @ w + b``; each ``w`` Xavier
uniform, each ``b`` torch's default U(+-1/sqrt(fan_in))): ``user_emb``,
``item_emb`` (Xavier uniform), the projections ``v_dense``, ``t_dense``,
the fusion outputs ``after_gcn_u``, ``after_gcn_i``, and under the FAC task
``g_i_iv``, ``g_v_iv``, ``g_iv_iva``, ``g_iva_ivat``, ``g_t_ivat``.

Three towers share the users' embedding and one graph: the item ids, the
projected image and the projected text features, each the mean of layers
0..L of its propagation. The users' and the items' rows of the three are
fused ("concat" or "mean") and projected. The loss is the in-batch softmax
cross-entropy of the normalised user and item rows at ``temp``
(:func:`ce_diag`: padded rows weigh 0 and leave every row's denominator
through a ``log(w)`` column mask), plus ``ssl_alpha`` times the SSL task at
``ssl_temp``: FAC (the id tower against the image, then the text tower
through the hierarchy of projections) or two branches crossed: FD (each
branch, tower and layer under its own inverted-dropout mask), FM (each
branch with one tower's input zeroed, two distinct towers) and FD+FM. The
draws (:func:`slmrec_draws`: FD's masks by branch, tower (ids, image,
text) and layer, then FM's two tower indices) come from the epoch's step
generator or are passed to ``_loss`` as tensors. Dense Adam.

``predict`` is ``sigmoid(u @ i.T)`` of the fused embeddings frozen at
``evaluate()``; ``_topk_score_fn`` says so, so the fused route leaves
SLMRec out and the full and chunked routes rank the sigmoid values, as
JAX's (which saturate to 1.0 in f32 and tie there).

Under a mesh the graph's destination rows split over every rank (segsum on
each rank's edges) with the rows of ``user_emb`` and ``item_emb`` in the
rank's block; each tower's item input is the rank's item rows (its rows of
the features projected, so ``v_dense`` and ``t_dense`` sum their
gradients over every rank), the tower means are gathered whole, the
in-batch cross-entropies of the rank's rows run against the whole batch's
other side (gathered over the data axis) and the FD masks are drawn whole,
each rank taking its block.
"""
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch

from ..convert import slmrec_params_from_jax
from ..ops.attention import dense
from ..ops.graph import Graph, propagate
from ..ops.initializers import get_initializer, torch_layer_default
from ..run_config import RunConfig
from ..utils import ModelConfig
from ..parallel import (batch_offset, batch_total, gather_batch,
                        gather_batch_ids, take_rows)
from .common import (GRAPH_IMPLS, add_param_tree, as_user_tensor,
                     build_prop_graph, gather_rows, make_optimizer,
                     make_train_step, node_rows, node_table_rows,
                     own_node_rows, whole_nodes)
from .multimodal import MultimodalRecommender, item_features
from .pipeline import InteractionEpochPipeline

__all__ = ["SLMRec", "SLMRecConfig", "slmrec_adj", "slmrec_draws",
           "slmrec_towers", "slmrec_fuse", "slmrec_loss", "ce_diag"]

ADJ_TYPES = ("plain", "norm", "gcmc", "pre", "mean")
SSL_TASKS = ("FAC", "FD", "FM", "FD+FM")
# tower order of the draws and outputs: item ids, image, text; FM's index
# of each (JAX's ``sels``: 0 masks the image tower, 1 the text, 2 the ids)
_FM_INDEX = (2, 0, 1)


class SLMRecConfig(ModelConfig):
    lr: float = 1e-4
    reg: float = 1e-4
    rec_dim: int = 64
    layer_num: int = 3
    ssl_alpha: float = 0.01
    ssl_temp: float = 0.1
    dropout_rate: float = 0.3
    temp: float = 0.2
    mm_fusion_mode: str = "concat"   # concat | mean
    adj_type: str = "pre"
    graph_impl: str = "auto"  # auto | segment | mxu | mxu_bf16
    ssl_task: str = "FAC"            # FAC | FD | FM | FD+FM
    batch_size: int = 2048
    epochs: int = 1000
    early_stop: int = 200

    @classmethod
    def param_space(cls):
        return {"lr": [0.0001, 0.001, 0.01, 0.1],
                "ssl_temp": [0.1, 0.2, 0.5, 1.0],
                "ssl_alpha": [0.01, 0.05, 0.1, 0.5, 1.0],
                "reg": [0.0001, 0.001, 0.01, 0.1]}

    def _validate(self):
        ok = (isinstance(self.lr, float) and self.lr > 0
              and self.mm_fusion_mode in ("concat", "mean")
              and self.ssl_task in SSL_TASKS
              and self.adj_type in ADJ_TYPES
              and self.graph_impl in GRAPH_IMPLS
              and isinstance(self.batch_size, int) and self.batch_size > 0)
        if not ok:
            raise ValueError(f"invalid SLMRec config: {self}")


def slmrec_adj(pairs: np.ndarray, num_users: int, num_items: int,
               adj_type: str) -> sp.csr_matrix:
    """The (U + N)^2 user-item adjacency (items offset by U) under
    ``adj_type``: "plain" as it is; "norm" D^-1 (A + I); "gcmc" D^-1 A;
    "pre" D^-1/2 A D^-1/2 with degrees + 1e-8; "mean" D^-1 A + I (D^-1 of a
    row without edges is 0). Each row's columns sorted."""
    n = num_users + num_items
    ones = np.ones(len(pairs), dtype=np.float32)
    upper = sp.csr_matrix((ones, (pairs[:, 0], pairs[:, 1] + num_users)),
                          shape=(n, n))
    adj = upper + upper.T

    def left_norm(a):
        deg = np.asarray(a.sum(axis=1)).flatten()
        with np.errstate(divide="ignore"):
            d_inv = np.power(deg, -1.0)
        d_inv[np.isinf(d_inv)] = 0.0
        return sp.diags(d_inv) @ a

    if adj_type == "plain":
        out = adj
    elif adj_type == "norm":
        out = left_norm(adj + sp.eye(n))
    elif adj_type == "gcmc":
        out = left_norm(adj)
    elif adj_type == "pre":
        deg = np.asarray(adj.sum(axis=1)).flatten() + 1e-8
        d_inv = np.power(deg, -0.5)
        d_inv[np.isinf(d_inv)] = 0.0
        d = sp.diags(d_inv)
        out = d @ adj @ d
    elif adj_type == "mean":
        out = left_norm(adj) + sp.eye(n)
    else:
        raise ValueError(f"adj_type must be one of {ADJ_TYPES}")
    out = sp.csr_matrix(out)
    out.sort_indices()
    return out


def slmrec_draws(generator: torch.Generator, cfg: SLMRecConfig,
                 num_nodes: int):
    """One step's draws of the SSL task: ``(fd, fm)``. ``fd`` (FD, FD+FM)
    is ``[branch][tower][layer]`` bool keep masks (num_nodes, rec_dim) at
    ``1 - dropout_rate`` for 2 branches, the towers ids, image, text, and
    ``layer_num`` layers, else None; ``fm`` (FM, FD+FM) the int64 pair
    ``(idx1, idx2)`` of distinct towers in [0, 3) to mask, else None."""
    dev = generator.device
    fd = fm = None
    if cfg.ssl_task in ("FD", "FD+FM") and cfg.dropout_rate > 0:
        fd = [[[torch.rand((num_nodes, cfg.rec_dim), generator=generator,
                           device=dev) < 1 - cfg.dropout_rate
                for _ in range(cfg.layer_num)] for _ in range(3)]
              for _ in range(2)]
    if cfg.ssl_task in ("FM", "FD+FM"):
        idx1 = torch.randint(0, 3, (), generator=generator, device=dev)
        step = torch.randint(0, 2, (), generator=generator, device=dev)
        fm = (idx1, (idx1 + 1 + step) % 3)
    return fd, fm


def _gcn(graph: Graph, u_emb: torch.Tensor, i_emb: torch.Tensor,
         n_layers: int, keeps: Optional[List[torch.Tensor]], rate: float
         ) -> torch.Tensor:
    x = node_rows(graph, u_emb, i_emb)
    layers = [x]
    for layer in range(n_layers):
        x = propagate(graph, x)
        if keeps is not None:
            x = torch.where(own_node_rows(graph, keeps[layer]),
                            x / (1 - rate), 0.0)
        layers.append(x)
    return whole_nodes(graph, torch.stack(layers, dim=1).mean(dim=1))


def slmrec_towers(graph: Graph, p: Dict, cfg: SLMRecConfig,
                  v_feat: torch.Tensor, t_feat: torch.Tensor,
                  keeps=None, masked: Optional[torch.Tensor] = None
                  ) -> List[torch.Tensor]:
    """[ids, image, text]: each tower's mean of layers over the users' and
    its items' embeddings; ``keeps[tower]`` the layers' dropout masks,
    ``masked`` the index (FM's) of the tower whose item input is zeroed.
    On a sharded graph the tables and the features are the rank's rows,
    and the towers come out whole."""
    inputs = (p["item_emb"], dense(v_feat, p["v_dense"]),
              dense(t_feat, p["t_dense"]))
    out = []
    for tower, i_emb in enumerate(inputs):
        if masked is not None:
            i_emb = i_emb * (1.0 - (masked == _FM_INDEX[tower]).float())
        out.append(_gcn(graph, p["user_emb"], i_emb, cfg.layer_num,
                        None if keeps is None else keeps[tower],
                        cfg.dropout_rate))
    return out


def slmrec_fuse(p: Dict, cfg: SLMRecConfig, towers: List[torch.Tensor],
                num_users: int, users: Optional[torch.Tensor] = None,
                items: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(users, items) fused embeddings of the rows ``users`` and ``items``
    (all rows when None)."""
    def rows(x, ids, lo):
        x = x[lo:] if lo else x[:num_users]
        return x if ids is None else gather_rows(x, ids)

    def fuse(reps):
        if cfg.mm_fusion_mode == "concat":
            return torch.cat(reps, dim=1)
        return torch.stack(reps).mean(dim=0)
    u = dense(fuse([rows(t, users, 0) for t in towers]), p["after_gcn_u"])
    i = dense(fuse([rows(t, items, num_users) for t in towers]),
              p["after_gcn_i"])
    return u, i


def ce_diag(logits: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted in-batch cross-entropy with diagonal labels; a padded
    (zero-weight) row's column is masked out of every row by ``log(w)``
    and its own term selected away before weighting. Data-parallel: the
    rank's rows (B, whole batch) of the logits, their labels at the rank's
    offset, the mean over the whole batch's valid rows."""
    w_cols = gather_batch_ids(w)
    logits = logits + torch.log(torch.clamp(w_cols, min=1e-38))[None, :]
    log_probs = torch.log_softmax(logits, dim=-1)
    n_valid = torch.clamp(batch_total(w), min=1.0)
    rows = torch.arange(logits.shape[0], device=logits.device)
    labels = log_probs[rows, batch_offset(logits.shape[0]) + rows]
    diag = torch.where(w > 0, labels, 0.0)
    return -torch.sum(diag * w) / n_valid


def _norm_rows(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-12)


def slmrec_loss(graph: Graph, p: Dict, cfg: SLMRecConfig,
                v_feat: torch.Tensor, t_feat: torch.Tensor,
                num_users: int, users: torch.Tensor, items: torch.Tensor,
                w: torch.Tensor, draws) -> torch.Tensor:
    """One batch's loss under one step's draws (:func:`slmrec_draws`)."""
    def cross(a, b):        # the rank's rows against the whole batch's
        return a @ gather_batch(b).T

    towers = slmrec_towers(graph, p, cfg, v_feat, t_feat)
    u_b, i_b = slmrec_fuse(p, cfg, towers, num_users, users, items)
    main = ce_diag(cross(_norm_rows(u_b), _norm_rows(i_b)) / cfg.temp, w)
    if cfg.ssl_task == "FAC":
        i_emb, v_emb, t_emb = (gather_rows(t[num_users:], items)
                               for t in towers)
        x_i_iv = dense(i_emb, p["g_i_iv"])
        x_v_iv = dense(v_emb, p["g_v_iv"])
        v_loss = ce_diag(cross(x_i_iv, x_v_iv) / cfg.ssl_temp, w)
        x_iva_ivat = dense(dense(x_i_iv, p["g_iv_iva"]), p["g_iva_ivat"])
        x_t_ivat = dense(t_emb, p["g_t_ivat"])
        ssl = v_loss + ce_diag(cross(x_iva_ivat, x_t_ivat) / cfg.ssl_temp,
                               w)
    else:
        fd, fm = draws
        branches = []
        for b in range(2):
            tw = slmrec_towers(graph, p, cfg, v_feat, t_feat,
                               None if fd is None else fd[b],
                               None if fm is None else fm[b])
            branches.append(slmrec_fuse(p, cfg, tw, num_users, users,
                                        items))
        (u1, i1), (u2, i2) = branches
        ssl = (ce_diag(cross(_norm_rows(u1), _norm_rows(u2))
                       / cfg.ssl_temp, w)
               + ce_diag(cross(_norm_rows(i1), _norm_rows(i2))
                         / cfg.ssl_temp, w))
    return main + cfg.ssl_alpha * ssl


class SLMRec(MultimodalRecommender):
    # projections of the rank's own item rows of a sharded graph
    _GRAD_WORLD = ("v_dense", "t_dense")
    _CAPTURED_STEP = True

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, SLMRecConfig(**model_config), device)
        cfg = self.config
        v_feat, t_feat = item_features(self.dataset)
        if v_feat is None or t_feat is None:
            raise ValueError("SLMRec requires image and text features")

        def l2n(x):
            return x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)
        self.v_feat = torch.as_tensor(l2n(v_feat), device=self.device)
        self.t_feat = torch.as_tensor(l2n(t_feat), device=self.device)
        self.graph = build_prop_graph(
            slmrec_adj(self.dataset.train_data.to_user_item_pairs(),
                       self.num_users, self.num_items, cfg.adj_type),
            cfg.graph_impl, mesh=self.mesh, device=self.device)
        gen = torch.Generator().manual_seed(run_config.seed)
        xavier = get_initializer("xavier_uniform")
        d = cfg.rec_dim
        fused = 3 * d if cfg.mm_fusion_mode == "concat" else d

        def lin(d_in, d_out):
            return {"w": xavier((d_in, d_out), gen),
                    "b": torch_layer_default((d_out,), d_in, gen)}
        tree = node_table_rows(self, self.graph, {
            "user_emb": xavier((self.num_users, d), gen),
            "item_emb": xavier((self.num_items, d), gen)})
        # the towers' item inputs: the rank's item rows of the features
        items = self._row_blocks.get("item_emb")
        self.v_rows = take_rows(self.v_feat, items)
        self.t_rows = take_rows(self.t_feat, items)
        tree.update({
                "v_dense": lin(v_feat.shape[1], d),
                "t_dense": lin(t_feat.shape[1], d),
                "after_gcn_u": lin(fused, d), "after_gcn_i": lin(fused, d)})
        if cfg.ssl_task == "FAC":
            tree.update({"g_i_iv": lin(d, d), "g_v_iv": lin(d, d),
                         "g_iv_iva": lin(d, d), "g_iva_ivat": lin(d, d // 2),
                         "g_t_ivat": lin(d, d // 2)})
        add_param_tree(self, tree, self.device)
        self.optimizer = make_optimizer("adam", dict(self.named_parameters()),
                                        cfg.lr)
        self.train_step = make_train_step(self.optimizer, self._loss,
                                          self.sync_gradients)
        self.pipeline = InteractionEpochPipeline(
            self.dataset.train_data, cfg.batch_size, self.device,
            mesh=self.mesh)

    def step_draws(self):
        """The next training step's draws, from the epoch's generator."""
        return slmrec_draws(self.step_generator(), self.config,
                            self.num_users + self.num_items)

    def _loss(self, users, items, w, draws=None) -> torch.Tensor:
        """The batch's loss under ``draws`` (:func:`slmrec_draws`), by
        default the next drawn."""
        if draws is None:
            draws = self.step_draws()
        return slmrec_loss(self.graph, self.params_tree(), self.config,
                           self.v_rows, self.t_rows, self.num_users, users,
                           items, w, draws)

    def _embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        p = self.params_tree()
        towers = slmrec_towers(self.graph, p, self.config, self.v_rows,
                               self.t_rows)
        return slmrec_fuse(p, self.config, towers, self.num_users)

    @staticmethod
    def _topk_score_fn(uv: torch.Tensor, items: torch.Tensor,
                       bias: Optional[torch.Tensor]) -> torch.Tensor:
        scores = uv @ items.T
        return torch.sigmoid(scores if bias is None
                             else scores + bias[None, :])

    @torch.no_grad()
    def predict(self, users) -> torch.Tensor:
        """(B, N) f32 ``sigmoid(u @ i.T)`` of the frozen embeddings."""
        u_all, i_all = self._chunk_embeddings()
        users = as_user_tensor(users, u_all.device)
        return torch.sigmoid(torch.matmul(u_all[users], i_all.T))

    @torch.no_grad()
    def predict_chunk(self, users, item_lo: int, item_hi: int
                      ) -> torch.Tensor:
        return torch.sigmoid(super().predict_chunk(users, item_lo, item_hi))

    @staticmethod
    def _params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
        return slmrec_params_from_jax(params)
