"""LATTICE — latent item-item structure for multimedia recommendation
(Zhang et al., MM 2021): the port of ``skrx.models.LATTICE``.

Same config fields, defaults, checks and ``param_space``. Parameters, in
the JAX package's layout: ``user_emb``, ``item_emb`` (Xavier uniform),
``modal_weight`` ([0.5, 0.5], under a softmax), per modality its trainable
feature table and projector to ``feat_embed_dim`` (``v_feat`` with
``image_trs``, ``t_feat`` with ``text_trs``) and, with ``cf_model="ngcf"``,
the layers ``gc.<i>`` and ``bi.<i>``; every Linear at torch's default
U(+-1/sqrt(fan_in)).

The item graph is JAX's dense (N, N) ``(1 - lambda) * learned + lambda *
original``, held sparsely: 4k edges a row, the same function.

- original: each modality's frozen kNN graph of its raw features, valued
  by similarity and normalised ``D^-1/2 S D^-1/2``
  (:func:`~skrx_torch.ops.mm_graph.lattice_original_edges`, cached as
  edges under ``<data_dir>/_data_cache/torch_<modality>_lattice_adj_<k>
  .npz``), blended by the softmax of ``modal_weight``;
- learned: each modality's top k (:func:`~skrx_torch.ops.mm_graph.
  knn_select`, kernels #1-#4 on a card, not differentiated, as
  ``lax.top_k`` passes gradient through the values only) of its projected
  features' cosine similarity; the selected values ``<n_r, n_c>`` of the
  normalised projections, differentiable; blended by the softmax (one
  modality alone unweighted); normalised by the rows' sums of the blend
  (kernel #11 over the learned edges' rows, an index set laid out once,
  :func:`~skrx_torch.ops.scatter.fixed_index`; ``d = rowsum ** -0.5``
  where it is > 0, else 0), with the gradient through ``d``.

The edges form one :class:`~skrx_torch.ops.graph.WeightedGraph` whose
weights are traced: ``h <- A(w) @ h`` runs ``n_layers`` times through
:func:`~skrx_torch.ops.graph.propagate_weighted` (kernel #11, with dw).
The topology is selected at each epoch's first batch, which builds the
weights with gradient from the parameters before its update; the later
batches of the epoch reuse those weights detached (JAX's ``lax.cond`` on
``is_first``). ``evaluate()`` selects and builds again.

The user-item side is ``cf_model`` over the left-normalised (A + I) graph:
"lightgcn" (the mean of layers), "ngcf" (leaky-ReLU layers, each under an
inverted-dropout mask of rate ``mess_dropout[i]`` in training, from
:func:`lattice_draws`, and L2-normalised into the mean) or "mf" (the
tables alone); the items add ``h`` L2-normalised. The loss is the weighted
mean BPR plus ``reg`` times half the weighted squared norms of the batch's
rows over the batch size (padded rows included, as JAX's); dense Adam.

Under a mesh the user-item graph's destination rows split over every rank
(segsum on each rank's edges) with the rows of ``user_emb`` and
``item_emb`` in the rank's block; the item graph runs whole on every rank
over the item table gathered whole, the user-item layers' mean is gathered
for the rank's slice of the batch (ngcf's layers apply to the rank's rows,
so ``gc`` and ``bi`` sum their gradients over every rank, the rest over
the data axis), and the BPR mean and the ``reg`` term divide by the whole
batch.
"""
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ..convert import lattice_params_from_jax
from ..ops.attention import dense
from ..ops.graph import (Graph, WeightedGraph, propagate, propagate_weighted,
                         weighted_graph_from_coo)
from ..ops.initializers import get_initializer, torch_layer_default
from ..ops.mm_graph import (cached_edges, inv_sqrt_positive, knn_select,
                            knn_values, l2_normalize, lattice_original_edges)
from ..ops.scatter import FixedIndex, fixed_index, fixed_sum
from ..run_config import RunConfig
from ..utils import ModelConfig, normalize_adj_matrix
from ..parallel import global_rows
from .common import (GRAPH_IMPLS, add_param_tree, build_prop_graph,
                     gather_rows, make_optimizer, make_train_step,
                     mxu_msg_dtype, node_rows, node_table_rows,
                     own_node_rows, resolve_graph_impl, whole_nodes)
from .multimodal import (MultimodalRecommender, bpr_mean, cache_dir_of,
                         item_features)
from .pipeline import PairwiseEpochPipeline

__all__ = ["LATTICE", "LATTICEConfig", "LatticeItemGraph", "MODALITIES",
           "lattice_select", "lattice_item_graph", "lattice_item_weights",
           "lattice_forward", "lattice_draws", "lattice_loss"]

# (feature table, projector) of each modality, in JAX's order
MODALITIES = (("v_feat", "image_trs"), ("t_feat", "text_trs"))


class LATTICEConfig(ModelConfig):
    lr: float = 1e-4
    reg: float = 0.0
    embed_dim: int = 64
    feat_embed_dim: int = 64
    weight_size: Optional[List[int]] = None   # default [64, 64]
    lambda_coeff: float = 0.9
    mess_dropout: Optional[List[float]] = None  # default [0.1, 0.1]
    n_layers: int = 1
    knn_k: int = 10
    cf_model: str = "lightgcn"  # lightgcn | ngcf | mf
    graph_impl: str = "auto"  # auto | segment | mxu | mxu_bf16
    batch_size: int = 2048
    epochs: int = 1000
    early_stop: int = 200

    @classmethod
    def param_space(cls):
        return {"lr": [0.0001, 0.0005, 0.001, 0.005],
                "reg": [0.0, 1e-05, 1e-04, 1e-03]}

    def _validate(self):
        if self.weight_size is None:
            self.weight_size = [64, 64]
        if self.mess_dropout is None:
            self.mess_dropout = [0.1, 0.1]
        ok = (isinstance(self.lr, float) and self.lr > 0
              and isinstance(self.reg, float) and self.reg >= 0
              and self.cf_model in ("lightgcn", "ngcf", "mf")
              and self.graph_impl in GRAPH_IMPLS
              and isinstance(self.batch_size, int) and self.batch_size > 0)
        if not ok:
            raise ValueError(f"invalid LATTICE config: {self}")


class LatticeItemGraph(NamedTuple):
    """One selection of the item graph: the edges of the learned graphs
    (``ids[m]`` (N, k) per present modality), then of the originals, as a
    :class:`WeightedGraph`, the originals' normalised values, and the
    rows of every modality's learned edges as an index set (the same for
    every selection)."""
    ids: Tuple[torch.Tensor, ...]
    graph: WeightedGraph
    rows: torch.Tensor                # (N k,) row of each learned edge
    orig_vals: Tuple[torch.Tensor, ...]
    learned_rows: FixedIndex          # (M N k,) rows, M modalities


def lattice_select(p: Dict, k: int) -> Tuple[torch.Tensor, ...]:
    """Each present modality's (N, k) learned neighbours: the top k of its
    projected features' cosine similarity, not differentiated."""
    with torch.no_grad():
        return tuple(knn_select(dense(p[feat], p[trs]), k)[1]
                     for feat, trs in MODALITIES if feat in p)


def lattice_item_graph(ids: Sequence[torch.Tensor], originals,
                       num_items: int, msg_dtype=torch.float32,
                       learned_rows: Optional[FixedIndex] = None
                       ) -> LatticeItemGraph:
    """The item graph of the learned neighbours ``ids`` and the originals'
    ``(rows, cols, vals)`` edges, built on the host and placed on the
    devices of ``ids``; ``learned_rows`` an earlier selection's (laid out
    anew when None)."""
    device = ids[0].device
    k = ids[0].shape[1]
    rows = torch.arange(num_items, device=device).repeat_interleave(k)
    dst = [rows] * len(ids) + [o[0] for o in originals]
    src = [i.reshape(-1) for i in ids] + [o[1] for o in originals]
    graph = weighted_graph_from_coo(torch.cat(src).cpu().numpy(),
                                    torch.cat(dst).cpu().numpy(), num_items,
                                    msg_dtype, device=device)
    if learned_rows is None:
        learned_rows = fixed_index(rows.repeat(len(ids)), num_items)
    return LatticeItemGraph(tuple(ids), graph, rows,
                            tuple(o[2] for o in originals), learned_rows)


def lattice_item_weights(p: Dict, cfg: LATTICEConfig,
                         item: LatticeItemGraph) -> torch.Tensor:
    """(E,) weights of the item graph's edges, differentiable in the
    projections, the feature tables and ``modal_weight``: ``(1 - lambda)``
    times the normalised learned blend, then ``lambda`` times the
    originals' blend."""
    weight = torch.softmax(p["modal_weight"], dim=0)
    present = [(feat, trs) for feat, trs in MODALITIES if feat in p]
    both = len(present) == 2
    learned = []
    for m, ((feat, trs), ids) in enumerate(zip(present, item.ids)):
        norm = l2_normalize(dense(p[feat], p[trs]))
        vals = knn_values(norm, item.rows, ids.reshape(-1))
        learned.append(weight[m] * vals if both else vals)
    learned = torch.cat(learned)
    rows = item.rows.repeat(len(present))
    cols = torch.cat([i.reshape(-1) for i in item.ids])
    d = inv_sqrt_positive(fixed_sum(learned, item.learned_rows))
    lam = cfg.lambda_coeff
    learned = (1 - lam) * (learned * d[rows] * d[cols])
    original = [lam * (weight[m] * v if both else v)
                for m, v in enumerate(item.orig_vals)]
    return torch.cat([learned, *original])


def lattice_draws(generator: torch.Generator, cfg: LATTICEConfig,
                  num_nodes: int) -> Optional[List[Optional[torch.Tensor]]]:
    """ngcf's message-dropout keep masks, one (num_nodes, width) bool mask
    a layer (None at rate 0); None for the other ``cf_model``s."""
    if cfg.cf_model != "ngcf":
        return None
    dev = generator.device
    return [torch.rand((num_nodes, width), generator=generator, device=dev)
            < 1 - rate if rate > 0 else None
            for width, rate in zip(cfg.weight_size, cfg.mess_dropout)]


def lattice_forward(ui_graph: Graph, item: LatticeItemGraph,
                    weights: torch.Tensor, p: Dict, cfg: LATTICEConfig,
                    masks: Optional[List[Optional[torch.Tensor]]] = None,
                    num_users: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(users, items) over the item graph of edge ``weights``; ``masks``
    ngcf's dropout masks (None: no dropout, as in evaluation). On a
    sharded ``ui_graph`` the tables are the rank's rows, ``num_users`` the
    whole count, and both come out whole."""
    if num_users is None:
        num_users = p["user_emb"].shape[0]
    x = node_rows(ui_graph, p["user_emb"], p["item_emb"])
    ego = whole_nodes(ui_graph, x)
    h = ego[num_users:]
    for _ in range(cfg.n_layers):
        h = propagate_weighted(item.graph, h, weights)
    h_norm = l2_normalize(h)
    if cfg.cf_model == "mf":
        return ego[:num_users], ego[num_users:] + h_norm
    layers = [x]
    for i in range(len(cfg.weight_size)):
        side = propagate(ui_graph, x)
        if cfg.cf_model == "ngcf":
            x = (F.leaky_relu(dense(side, p["gc"][i]))
                 + F.leaky_relu(dense(x * side, p["bi"][i])))
            if masks is not None and masks[i] is not None:
                x = torch.where(own_node_rows(ui_graph, masks[i]),
                                x / (1 - cfg.mess_dropout[i]), 0.0)
            layers.append(l2_normalize(x))
        else:
            x = side
            layers.append(x)
    combined = whole_nodes(ui_graph, torch.stack(layers, dim=1).mean(dim=1))
    return combined[:num_users], combined[num_users:] + h_norm


def lattice_loss(ui_graph: Graph, item: LatticeItemGraph, p: Dict,
                 cfg: LATTICEConfig, users: torch.Tensor, pos: torch.Tensor,
                 neg: torch.Tensor, w: torch.Tensor, masks,
                 weights: Optional[torch.Tensor] = None,
                 num_users: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, item weights) of one batch: the weights built with gradient
    from ``p`` when ``weights`` is None (an epoch's first batch), else the
    given (detached) ones; ``num_users`` as :func:`lattice_forward`."""
    if weights is None:
        weights = lattice_item_weights(p, cfg, item)
    neg = neg[:, 0]
    u_all, i_all = lattice_forward(ui_graph, item, weights, p, cfg, masks,
                                   num_users)
    ue, pe, ne = (gather_rows(t, ids) for t, ids in
                  ((u_all, users), (i_all, pos), (i_all, neg)))
    reg = 0.5 * torch.sum(torch.sum(ue ** 2 + pe ** 2 + ne ** 2, dim=-1)
                          * w) / global_rows(users.shape[0])
    return bpr_mean(ue, pe, ne, w) + cfg.reg * reg, weights


class LATTICE(MultimodalRecommender):
    # ngcf's layers, applied to the rank's own rows of a sharded graph
    _GRAD_WORLD = ("gc", "bi")

    def __init__(self, run_config: RunConfig, model_config: Dict,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(run_config, LATTICEConfig(**model_config), device)
        cfg = self.config
        num_users, num_items = self.num_users, self.num_items
        feats = dict(zip(("v_feat", "t_feat"), item_features(self.dataset)))
        if all(x is None for x in feats.values()):
            raise ValueError("LATTICE requires at least one modality "
                             "feature table")
        self.msg_dtype = mxu_msg_dtype(resolve_graph_impl(cfg.graph_impl))
        pairs = self.dataset.train_data.to_user_item_pairs()
        n = num_users + num_items
        ones = np.ones(len(pairs), dtype=np.float32)
        upper = sp.csr_matrix((ones, (pairs[:, 0], pairs[:, 1] + num_users)),
                              shape=(n, n))
        self.ui_graph = build_prop_graph(
            normalize_adj_matrix(upper + upper.T + sp.eye(n), "left"),
            cfg.graph_impl, mesh=self.mesh, device=self.device)
        cache = cache_dir_of(self.dataset)
        self.originals = tuple(
            cached_edges(os.path.join(cache, f"torch_{tag}_lattice_adj_"
                                             f"{cfg.knn_k}.npz"),
                         lambda x=feats[feat]: lattice_original_edges(
                             torch.as_tensor(x, device=self.device),
                             cfg.knn_k), self.device)
            for (feat, _), tag in zip(MODALITIES, ("image", "text"))
            if feats[feat] is not None)
        gen = torch.Generator().manual_seed(run_config.seed)
        xavier = get_initializer("xavier_uniform")
        d = cfg.embed_dim

        def lin(d_in, d_out):
            return {"w": torch_layer_default((d_in, d_out), d_in, gen),
                    "b": torch_layer_default((d_out,), d_in, gen)}
        tree = node_table_rows(self, self.ui_graph, {
            "user_emb": xavier((num_users, d), gen),
            "item_emb": xavier((num_items, d), gen)})
        tree["modal_weight"] = torch.tensor([0.5, 0.5])
        for feat, trs in MODALITIES:
            if feats[feat] is not None:
                tree[feat] = torch.from_numpy(feats[feat])
                tree[trs] = lin(feats[feat].shape[1], cfg.feat_embed_dim)
        if cfg.cf_model == "ngcf":
            sizes = [d] + list(cfg.weight_size)
            tree["gc"] = [lin(sizes[i], sizes[i + 1])
                          for i in range(len(cfg.weight_size))]
            tree["bi"] = [lin(sizes[i], sizes[i + 1])
                          for i in range(len(cfg.weight_size))]
        add_param_tree(self, tree, self.device)
        self.optimizer = make_optimizer("adam", dict(self.named_parameters()),
                                        cfg.lr)
        self.train_step = make_train_step(self.optimizer, self._step_loss,
                                          self.sync_gradients)
        self.pipeline = PairwiseEpochPipeline(
            self.dataset.train_data, cfg.batch_size, self.device, num_neg=1,
            mesh=self.mesh)
        # the running epoch's item graph and, after its first batch, its
        # detached weights
        self.epoch_item: Optional[LatticeItemGraph] = None
        self.epoch_weights: Optional[torch.Tensor] = None
        # the learned edges' rows, laid out at the first selection
        self._learned_rows: Optional[FixedIndex] = None

    def item_graph(self) -> LatticeItemGraph:
        """The item graph selected from the current parameters."""
        item = lattice_item_graph(
            lattice_select(self.params_tree(), self.config.knn_k),
            self.originals, self.num_items, self.msg_dtype,
            self._learned_rows)
        self._learned_rows = item.learned_rows
        return item

    def step_draws(self):
        """The next training step's ngcf dropout masks (None for the other
        models), from the epoch's generator."""
        return lattice_draws(self.step_generator(), self.config,
                             self.num_users + self.num_items)

    def _loss(self, users, pos, neg, w, masks=None, weights=None):
        """(loss, item weights) of the batch over the epoch's item graph
        (selected now if the epoch has none), ``weights`` as
        :func:`lattice_loss` takes them."""
        if self.epoch_item is None:
            self.epoch_item = self.item_graph()
        return lattice_loss(self.ui_graph, self.epoch_item,
                            self.params_tree(), self.config, users, pos, neg,
                            w, masks, weights, self.num_users)

    def _step_loss(self, users, pos, neg, w, masks=None) -> torch.Tensor:
        """A training step's loss (``masks`` drawn for ngcf when not
        given): the epoch's first step builds the item weights with
        gradient and keeps them, detached, for the others."""
        if masks is None and self.config.cf_model == "ngcf":
            masks = self.step_draws()
        loss, weights = self._loss(users, pos, neg, w, masks,
                                   self.epoch_weights)
        if self.epoch_weights is None:
            self.epoch_weights = weights.detach()
        return loss

    def _train_epoch(self, epoch: int) -> float:
        self.epoch_item = self.epoch_weights = None
        try:
            return super()._train_epoch(epoch)
        finally:
            self.epoch_item = self.epoch_weights = None

    def _embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        p = self.params_tree()
        item = self.item_graph()
        return lattice_forward(self.ui_graph, item,
                               lattice_item_weights(p, self.config, item),
                               p, self.config, num_users=self.num_users)

    @staticmethod
    def _params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
        return lattice_params_from_jax(params)
