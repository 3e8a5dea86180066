"""Shared model helpers: the optimizer and train-step factories (one device,
and a mesh of ranks), the base of models trained by an epoch pipeline,
chunked scoring for dot-product models (frozen embeddings for the graph
models; the two-stage top-k over a catalog split by the mesh's model axis)
and for models with a per-user encoder, and the lowering of a model's
adjacency for propagation, sharded over a mesh's ranks or not (the port of
``skrx.models.common``)."""
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from ..convert import (adam_state_from_jax, flat_adam_state_from_jax,
                       lazy_adam_state_from_jax)
from ..ops.graph import Graph, graph_from_sp_matrix
from ..ops.optim import LazyAdam
from ..ops.scatter import ordered_gather
from ..parallel import (RowBlocks, ShardedPropGraph, gather_all_rows,
                        sharded_dot_topk, take_rows)
from ..parallel.mesh import row_blocks
from .base import TorchRecommender
from .pipeline import epoch_generator

__all__ = ["ParamTree", "param_tree", "add_param_tree", "cast_tree",
           "nest_params", "NestedParamsMixin",
           "gather_rows", "dotted_jax_leaves",
           "ChunkedDotPredictMixin", "FrozenEmbeddingMixin",
           "CachedUserVecChunkMixin", "PadColumnTowerMixin",
           "EpochTrainedRecommender", "as_user_tensor", "last_items_by_time",
           "pad_masked_rows", "LazyAdamTowerMixin", "make_optimizer",
           "adam_l2", "make_train_step", "make_sharded_train_step",
           "LeafTrainStep",
           "FlatTrainStep", "ravel_order",
           "GRAPH_IMPLS", "resolve_graph_impl", "mxu_msg_dtype",
           "build_prop_graph", "graph_sharding_enabled",
           "graph_param_shardings", "node_rows", "whole_nodes",
           "own_node_rows", "node_table_rows"]

GRAPH_IMPLS = ("auto", "segment", "mxu", "mxu_bf16")


class ParamTree(nn.Module):
    """A nested dict of parameters as a module: ``tree["att"]["q"]["w"]``
    reads as the JAX package's params do, and ``named_parameters`` gives
    the dotted path (``att.q.w``)."""

    def __getitem__(self, key: str):
        return getattr(self, key)


def param_tree(tree, device) -> Union[nn.Module, nn.Parameter]:
    """Parameters on ``device`` from a nested dict (a :class:`ParamTree`)
    or list (an ``nn.ModuleList``) of CPU tensors."""
    if isinstance(tree, torch.Tensor):
        return nn.Parameter(tree.to(device))
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList([param_tree(v, device) for v in tree])
    return add_param_tree(ParamTree(), tree, device)


def add_param_tree(module: nn.Module, tree: Dict, device) -> nn.Module:
    """Register the entries of the nested dict ``tree`` on ``module``
    (:func:`param_tree`), so that its parameters carry the tree's paths."""
    for key, value in tree.items():
        child = param_tree(value, device)
        if isinstance(child, nn.Parameter):
            module.register_parameter(key, child)
        else:
            module.add_module(key, child)
    return module


def cast_tree(tree, dtype: Optional[torch.dtype] = None):
    """A module's or nested dict's parameters as nested dicts and lists of
    tensors, the f32 ones cast to ``dtype`` (differentiably; None keeps
    them): the JAX package's mixed precision, f32 master weights and
    ``dtype`` compute."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if dtype is not None \
            and tree.dtype == torch.float32 else tree
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        return [cast_tree(v, dtype) for v in tree]
    if isinstance(tree, nn.Module):
        items = [*tree.named_parameters(recurse=False),
                 *tree.named_children()]
    else:
        items = tree.items()
    return {key: cast_tree(value, dtype) for key, value in items}


def nest_params(flat: Dict[str, torch.Tensor]):
    """Tensors by dotted name (``blocks.0.att.q.w``, as ``named_parameters``
    gives them) as nested dicts, a run of numbered keys as a list."""
    root: Dict = {}
    for name, value in flat.items():
        node = root
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (ids of any shape) by ``index_select``, its gradient
    summed in batch order (:func:`~skrx_torch.ops.scatter.ordered_gather`):
    the same bits from run to run on a card."""
    return ordered_gather(table, ids)


def dotted_jax_leaves(model: nn.Module) -> Dict[str, Tuple[str, bool]]:
    """A model's parameters by their JAX paths: the dotted names with
    ``/`` (a list's entries ``cells/<i>``), none transposed."""
    return {name.replace(".", "/"): (name, False)
            for name, _ in model.named_parameters()}


class NestedParamsMixin:
    """A model whose parameters carry the JAX package's nested paths
    (``blocks.0.att.q.w``; ``conv_h.<i>``): its leaves by JAX path for the
    Adam state, and its parameters as the nested tree the functional
    losses take."""

    def _jax_leaves(self) -> Dict[str, Tuple[str, bool]]:
        return dotted_jax_leaves(self)

    def params_tree(self):
        """The parameters as the JAX package's nested tree."""
        return cast_tree(self)


def make_optimizer(name: str, params: Dict[str, torch.nn.Parameter],
                   lr: float, weight_decay: float = 0.0
                   ) -> Union[torch.optim.Optimizer, LazyAdam]:
    """The optimizer of a model's named parameters. "adam": dense Adam
    (``optax.adam``'s constants, :func:`adam_l2`); the JAX package runs it
    over the raveled parameter vector, and Adam is elementwise, so
    per-parameter state computes the same update. "lazy_adam": row-wise
    lazy Adam (:class:`~skrx_torch.ops.optim.LazyAdam`), updated by a step
    over the rows a batch gathers
    (:func:`~skrx_torch.ops.optim.make_lazy_train_step`); it has no dense
    step."""
    if name == "lazy_adam":
        return LazyAdam(params, lr, weight_decay=weight_decay)
    if name != "adam":
        raise ValueError(f"unknown optimizer {name!r}")
    return adam_l2(list(params.values()), lr, weight_decay)


def adam_l2(params, lr: Union[float, torch.Tensor],
            weight_decay: float = 0.0) -> torch.optim.Adam:
    """``torch.optim.Adam`` with ``weight_decay`` added to the gradient
    before the moments (L2, not AdamW): the JAX package's ``adam_l2``.
    Over parameters on a CUDA device it is capturable: the step count and
    the bias corrections stay on the device in f32, as optax computes
    them, so the card runs one Adam arithmetic, in a CUDA graph or not. A
    state saved on another device loads with this choice (and the step
    count where it asks). ``lr`` may be a one-value f32 tensor on the
    parameters' device, which a schedule rewrites in place before each
    step (:class:`FlatTrainStep`): a float would be fixed in a CUDA graph
    at its capture."""
    params = list(params)
    capturable = any(p.device.type == "cuda" for p in params)
    adam = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay, capturable=capturable)
    adam.register_load_state_dict_pre_hook(
        lambda opt, state: dict(state, param_groups=[
            dict(g, capturable=capturable) for g in state["param_groups"]]))
    return adam


def make_train_step(optimizer: torch.optim.Optimizer,
                    loss_fn: Callable[..., torch.Tensor],
                    sync: Optional[Callable[[], None]] = None,
                    count: Optional[torch.Tensor] = None) -> "LeafTrainStep":
    """``train_step(batch) -> loss``, a :class:`LeafTrainStep`: the loss of
    ``loss_fn(*batch)`` before the update, then one optimizer step (the
    port of the JAX package's per-leaf ``make_train_step``)."""
    return LeafTrainStep(optimizer, loss_fn, sync, count)


class LeafTrainStep:
    """``step(batch) -> loss``: the loss of ``loss_fn(*batch)`` before the
    update, then one step of ``optimizer`` over its parameters, one by one
    (the port of the JAX package's ``make_train_step``). The loss stays on
    the device. A parameter the loss does not reach (DENS's gates under
    ``rns``, ``dns``) gets a zero gradient, so that Adam moves it by its
    moments, as optax steps every leaf of a JAX model's params. ``sync``
    runs after the backward, before the step (a model's
    ``sync_gradients`` under a mesh). ``count``: an f32 tensor the step
    adds one to after the update (MultVAE's KL anneal count, the JAX
    step's carried ``count``).

    Each parameter's gradient is made once and zeroed in place before
    each step (the backward adds into it; 0 + g is g, but for a -0.0
    that becomes +0.0), and ``torch.optim.Adam``'s state (``step``,
    ``exp_avg``, ``exp_avg_sq``) is made now where the optimizer holds
    none (Adam's lazy init would make it inside the first step), so that
    under Adam every tensor a step writes stays in place (``state``) and
    a CUDA graph can hold the step
    (:class:`~skrx_torch.models.pipeline.EpochProgram`). A checkpoint's
    Adam state is copied into those tensors (:meth:`load_state_dict`)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 loss_fn: Callable[..., torch.Tensor],
                 sync: Optional[Callable[[], None]] = None,
                 count: Optional[torch.Tensor] = None):
        self.optimizer, self.loss_fn = optimizer, loss_fn
        self.sync, self.count = sync, count
        self.params = [p for group in optimizer.param_groups
                       for p in group["params"]]
        # (parameter, its gradient): re-attached before a step where a
        # caller dropped it (zero_grad), or the backward would not add here
        self._grads = [(p, torch.zeros_like(p)) for p in self.params]
        for p, g in self._grads:
            p.grad = g
        self.adam = type(optimizer) is torch.optim.Adam
        if self.adam:
            for group in optimizer.param_groups:
                for p in group["params"]:
                    if not optimizer.state[p]:
                        optimizer.state[p] = _adam_zeros(
                            p, group["capturable"])

    @property
    def state(self) -> Optional[Tuple[torch.Tensor, ...]]:
        """The tensors a step updates in place: every parameter and its
        gradient, Adam's moments and step count of each, ``count``; None
        under an optimizer other than ``torch.optim.Adam``, whose state
        this step does not make."""
        if not self.adam:
            return None
        out = [t for p, g in self._grads for t in (p, g)]
        for p in self.params:
            st = self.optimizer.state[p]
            out += [st["exp_avg"], st["exp_avg_sq"], st["step"]]
        return tuple(out) if self.count is None else (*out, self.count)

    def __call__(self, batch) -> torch.Tensor:
        for p, g in self._grads:
            if p.grad is not g:
                p.grad = g
        torch._foreach_zero_([g for _, g in self._grads])
        loss = self.loss_fn(*batch)
        loss.backward()
        if self.sync is not None:
            self.sync()
        self.optimizer.step()
        if self.count is not None:
            with torch.no_grad():
                self.count.add_(1.0)
        return loss.detach()

    @torch.no_grad()
    def load_state_dict(self, state_dict: Dict) -> None:
        """Copy a per-parameter Adam state (``torch.optim.Adam``'s, in the
        optimizer's parameter order) into this step's tensors (under Adam,
        where it has ``state``); a parameter the state holds nothing for
        starts again from zeros."""
        saved = state_dict["state"]
        n_saved = sum(len(g["params"]) for g in state_dict["param_groups"])
        if n_saved != len(self.params):
            raise ValueError(f"the state holds {n_saved} parameters, the "
                             f"step {len(self.params)}")
        for i, p in enumerate(self.params):
            held = self.optimizer.state[p]
            for key in ("step", "exp_avg", "exp_avg_sq"):
                if i in saved:
                    held[key].copy_(saved[i][key])
                else:
                    held[key].zero_()


def _adam_zeros(p: torch.Tensor, capturable: bool) -> Dict[str, torch.Tensor]:
    """``torch.optim.Adam``'s state of ``p`` before its first step: a
    capturable Adam's step count on the device."""
    return {"step": torch.zeros((), device=p.device if capturable else "cpu"),
            "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
            "exp_avg_sq": torch.zeros_like(
                p, memory_format=torch.preserve_format)}


def make_sharded_train_step(optimizer: torch.optim.Optimizer,
                            loss_fn: Callable[..., torch.Tensor],
                            sync: Optional[Callable[[], None]] = None
                            ) -> Callable:
    """``train_step(batch) -> loss`` on one rank of a mesh: the loss of
    ``loss_fn(*batch)``, the rank's share (its data index's slice of the
    batch) of the summed loss, before the update; then one optimizer step
    over the rank's parameters, its rows of a split table. It is
    :func:`make_train_step` with ``sync`` (the model's
    ``sync_gradients``): a split table gets its whole gradient from the
    backward of the collectives that read it
    (:func:`~skrx_torch.parallel.lookup_rows`,
    :func:`~skrx_torch.parallel.gather_all_rows`, the sharded propagate),
    a replicated parameter read directly its slice's, which ``sync`` sums
    over the data axis; Adam is elementwise, so stepping a rank's rows and
    their moments is the single-device step."""
    return make_train_step(optimizer, loss_fn, sync)


def ravel_order(names) -> list:
    """Dotted parameter names (``image_trs.w``, ``blocks.0.att.q.w``) in
    the order ``jax.flatten_util.ravel_pytree`` lays the JAX package's
    nested params out: a dict's keys sorted at each level, a list's
    entries (numbered parts) in their order."""
    def key(name):
        return tuple((int(part), "") if part.isdigit() else (-1, part)
                     for part in name.split("."))
    return sorted(names, key=key)


class FlatTrainStep:
    """The port of the JAX package's ``make_flat_train_step``: the model's
    parameters ``names`` (dotted for a nested tree's leaves) become views
    of one flat f32 vector (``flat``), laid out in JAX's ravel order
    (:func:`ravel_order`: BPRMF's ``item_bias``, ``item_emb``,
    ``user_emb``; MGCN's nested tree key by key), their gradients views
    of one flat gradient (``grad``), and one Adam (:func:`adam_l2`,
    capturable on a CUDA device) steps the one vector: its update is one
    elementwise pass.

    ``step(batch) -> loss`` is :func:`make_train_step`'s step: the loss of
    ``loss_fn(*batch)`` before the update, a parameter the loss does not
    reach moved by its moments. It zeroes the flat gradient in place, and
    the backward adds into it (the gradients stay the same tensors), so
    every tensor it updates stays in place (``state``) and a CUDA graph
    can hold it (:class:`~skrx_torch.models.pipeline.EpochProgram`).

    ``schedule``: the learning rate as a function of Adam's step count
    before the update (an f32 tensor on the device -> an f32 tensor), as
    optax's ``scale_by_schedule`` reads its count; Adam then takes its
    rate from a tensor (``lr``) that each step rewrites on the device, so
    that a captured step replays the schedule. Without one the rate is
    the float ``lr``.

    Checkpoints see the state as a per-parameter Adam over ``names`` in
    their given order (:meth:`state_dict`, :meth:`load_state_dict`: views
    of the flat moments out, copies into them in), so that one device's
    and a mesh's are alike; JAX's flat Adam state goes straight into the
    flat moments (:meth:`load_jax_adam`)."""

    def __init__(self, model: nn.Module, names, loss_fn: Callable,
                 lr: float,
                 schedule: Optional[Callable[[torch.Tensor],
                                             torch.Tensor]] = None):
        self.names, self.loss_fn = tuple(names), loss_fn
        old = {n: model.get_parameter(n) for n in self.names}
        device = old[self.names[0]].device
        order = ravel_order(self.names)
        with torch.no_grad():
            self.flat = nn.Parameter(torch.cat([old[n].reshape(-1)
                                                for n in order]))
        self.grad = torch.zeros_like(self.flat)
        self.slices, lo = {}, 0
        for n in order:
            self.slices[n] = (lo, lo + old[n].numel(), old[n].shape)
            lo += old[n].numel()
        # (tensor, its gradient view): re-attached before a step where a
        # caller dropped it (zero_grad), or the backward would not add here
        self._grads = [(self.flat, self.grad)]
        for n in self.names:
            lo, hi, shape = self.slices[n]
            view = nn.Parameter(self.flat.detach()[lo:hi].view(shape))
            owner, _, leaf = n.rpartition(".")
            setattr(model.get_submodule(owner) if owner else model, leaf,
                    view)
            self._grads.append((view, self.grad[lo:hi].view(shape)))
        for p, g in self._grads:
            p.grad = g
        self.schedule = schedule
        self.lr = None if schedule is None else \
            torch.tensor(float(lr), device=device)
        self.optimizer = adam_l2([self.flat],
                                 lr if self.lr is None else self.lr)
        # the state made now, in place from here on (Adam's lazy init
        # would make it inside the first step); a capturable Adam's step
        # count on the device
        capturable = self.optimizer.defaults["capturable"]
        self.optimizer.state[self.flat] = {
            "step": torch.zeros((), device=device if capturable else "cpu"),
            "exp_avg": torch.zeros_like(self.flat),
            "exp_avg_sq": torch.zeros_like(self.flat)}

    @property
    def _adam(self) -> Dict[str, torch.Tensor]:
        return self.optimizer.state[self.flat]

    @property
    def state(self) -> Tuple[torch.Tensor, ...]:
        """The tensors a step updates in place: the flat parameters and
        gradient, Adam's moments and step count, a schedule's rate."""
        st = self._adam
        out = (self.flat, self.grad, st["exp_avg"], st["exp_avg_sq"],
               st["step"])
        return out if self.lr is None else out + (self.lr,)

    @torch.no_grad()
    def next_lr(self) -> Optional[torch.Tensor]:
        """The schedule's rate for the next update, from Adam's step count
        (no schedule: None)."""
        if self.schedule is None:
            return None
        return self.schedule(self._adam["step"])

    def __call__(self, batch) -> torch.Tensor:
        for p, g in self._grads:
            if p.grad is not g:
                p.grad = g
        self.grad.zero_()
        loss = self.loss_fn(*batch)
        loss.backward()
        if self.lr is not None:
            self.lr.copy_(self.next_lr())
        self.optimizer.step()
        return loss.detach()

    def state_dict(self) -> Dict:
        """The Adam state as ``torch.optim.Adam`` over the parameters
        ``names`` (in that order) gives it: per parameter its step count
        and views of the flat moments."""
        sd = self.optimizer.state_dict()
        st = self._adam
        state = {}
        for i, n in enumerate(self.names):
            lo, hi, shape = self.slices[n]
            state[i] = {"step": st["step"],
                        "exp_avg": st["exp_avg"][lo:hi].view(shape),
                        "exp_avg_sq": st["exp_avg_sq"][lo:hi].view(shape)}
        group = dict(sd["param_groups"][0],
                     params=list(range(len(self.names))))
        return {"state": state, "param_groups": [group]}

    @torch.no_grad()
    def load_state_dict(self, state_dict: Dict) -> None:
        """Copy a :meth:`state_dict` (or a per-parameter Adam's over
        ``names``) into the flat moments and the step count."""
        st = self._adam
        for i, n in enumerate(self.names):
            lo, hi, _ = self.slices[n]
            saved = state_dict["state"][i]
            for key in ("exp_avg", "exp_avg_sq"):
                st[key][lo:hi].copy_(saved[key].reshape(-1))
        st["step"].copy_(state_dict["state"][0]["step"])

    @torch.no_grad()
    def load_jax_adam(self, count: int, mu: np.ndarray,
                      nu: np.ndarray) -> None:
        """JAX's ``optax.adam`` state over the raveled parameters
        (``count``, flat ``mu`` and ``nu``) into the flat moments."""
        step, m, v = flat_adam_state_from_jax(count, mu, nu,
                                              self.flat.numel())
        st = self._adam
        st["step"].copy_(step)
        st["exp_avg"].copy_(m)
        st["exp_avg_sq"].copy_(v)


def as_user_tensor(users, device: torch.device) -> torch.Tensor:
    """User ids (a sequence, numpy array or tensor) as int64 on ``device``."""
    if isinstance(users, torch.Tensor):
        return users.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(users, dtype=np.int64), device=device)


def last_items_by_time(train_data) -> np.ndarray:
    """(num_users,) int64: each user's last training item by time, 0 for a
    user without one (FPMC, TransRec)."""
    pairs = train_data.to_user_item_pairs_by_time()
    last = np.zeros(train_data.num_users, dtype=np.int64)
    # rows sorted by user: the last row of each user's run wins
    last[pairs[:, 0]] = pairs[:, 1]
    return last


def pad_masked_rows(table: torch.Tensor, ids: torch.Tensor,
                    pad_id: int) -> torch.Tensor:
    """``table[ids]`` with the rows of ``pad_id`` read as zero and given no
    gradient, as the JAX package's ``table.at[pad].set(0)[ids]`` (Caser,
    HGN)."""
    rows = table[ids]
    keep = ids != pad_id
    return torch.where(keep[..., None] if rows.dim() > ids.dim() else keep,
                       rows, 0.0)


def _sharded_topk(model, uv: torch.Tensor, table: torch.Tensor,
                  bias: Optional[torch.Tensor], k: int, train_table):
    """:func:`~skrx_torch.parallel.sharded_dot_topk` of ``uv`` against the
    whole ``table`` (and bias) on the model's mesh, with its
    ``_topk_score_fn`` where it has one; no train ids masked when
    ``train_table`` is None."""
    n_items = int(table.shape[0])
    if train_table is None:
        train_table = torch.full((uv.shape[0], 1), n_items,
                                 dtype=torch.int32, device=uv.device)
    return sharded_dot_topk(
        model.mesh, uv, table, bias, k, n_items, train_table,
        model.__dict__.setdefault("_topk_cache", {}),
        score_fn=getattr(model, "_topk_score_fn", None))


class ChunkedDotPredictMixin:
    """``predict_chunk(users, lo, hi)`` for models whose full-catalog score
    is ``user_vectors @ item_vectors.T (+ bias)``: scores of items
    [lo, hi) only, so a caller can walk a catalog without building (B, N).
    Subclasses implement ``_chunk_embeddings() -> (u_all, i_all)`` and
    optionally ``_chunk_bias() -> (N,) or None``.

    The fused route (``TopKRecommender(fused="always")``, eval_mode
    "fused") relies on this contract: ``predict(users)`` scores
    ``u_all[users] @ i_all.T (+ bias)`` with no transform after the dot (a
    model that applies one sets ``_topk_score_fn`` and keeps the predict
    route). Serving caches the packed item table and packs it again when
    ``i_all`` or the bias is another tensor or was updated in place (its
    storage and version counter), so the returned tensors must be the ones
    ``predict`` reads: BPRMF returns its live parameters, which an optimizer
    step updates in place; LightGCN the embeddings frozen at
    ``evaluate()``, a new tensor each time they are propagated again."""

    def _chunk_embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def _chunk_bias(self) -> Optional[torch.Tensor]:
        return None

    @torch.no_grad()
    def predict_chunk(self, users, item_lo: int, item_hi: int) -> torch.Tensor:
        u_all, i_all = self._chunk_embeddings()
        users = as_user_tensor(users, u_all.device)
        scores = torch.matmul(u_all[users], i_all[item_lo:item_hi].T)
        bias = self._chunk_bias()
        if bias is not None:
            scores = scores + bias[None, item_lo:item_hi]
        return scores

    @torch.no_grad()
    def predict_topk(self, users, k: int, train_table=None):
        """The exact train-masked top-k with the catalog split over the
        mesh's model axis (model axis above 1; every rank of the model
        group calls it with the same users): each rank scores its items,
        takes its local top-k (#1-#4 on a card) and the candidates merge
        through #5 (:func:`~skrx_torch.parallel.sharded_dot_topk`), so no
        rank builds the (B, N) scores. Returns (values (B, k'), global ids
        (B, k') int32), ``k' = min(k, num_items)``; -inf slots carry
        masked or padding ids."""
        u_all, i_all = self._chunk_embeddings()
        users = as_user_tensor(users, u_all.device)
        return _sharded_topk(self, u_all[users], i_all, self._chunk_bias(),
                             k, train_table)


class FrozenEmbeddingMixin(ChunkedDotPredictMixin):
    """Scoring for dot models whose embeddings are computed from their
    parameters (graph propagation): ``evaluate()`` computes them once under
    ``no_grad`` and freezes them; ``predict``, ``_chunk_embeddings`` and
    serving reuse them until a training epoch moves the parameters
    (``_train_epoch`` and ``fit()`` drop them). Subclasses implement
    ``_embeddings() -> (u_all, i_all)``."""

    _final_emb: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def _embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def _train_epoch(self, epoch: int):
        self._final_emb = None            # the parameters move
        return super()._train_epoch(epoch)

    @torch.no_grad()
    def _freeze(self) -> Tuple[torch.Tensor, torch.Tensor]:
        self._final_emb = self._embeddings()
        return self._final_emb

    def evaluate(self, test_users=None):
        self._freeze()                    # computed once per evaluation
        return super().evaluate(test_users)

    def _chunk_embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._final_emb if self._final_emb is not None \
            else self._freeze()

    @torch.no_grad()
    def predict(self, users) -> torch.Tensor:
        """(B, N) f32 scores ``u_all[users] @ i_all.T`` of the frozen
        embeddings, on the model's device."""
        u_all, i_all = self._chunk_embeddings()
        users = as_user_tensor(users, u_all.device)
        return torch.matmul(u_all[users], i_all.T)


class CachedUserVecChunkMixin:
    """``predict_chunk`` for models whose predict factors into a per-user
    encoder and a cheap per-item score: the user vectors are computed once
    per (model state, user batch), and each catalog chunk is scored from
    them, so chunked evaluation neither runs the encoder again per chunk
    nor builds (B, N).

    Subclasses implement ``_user_vectors(users) -> tensor`` and
    ``_score_user_chunk(uv, item_lo, item_hi) -> (B, hi - lo)``. The cache
    is keyed by the tensors of ``_uv_state_refs()`` (by default the
    model's parameters), by identity and version counter (an optimizer step
    updates them in place), and by the users: a batch given as a tensor
    by that tensor and its version counter (comparing its values would
    copy them to the host and stall the card before every batch), ids
    given otherwise by their values; ``fit()`` also clears it after every
    epoch. A batch tensor must therefore not be rewritten outside torch's
    version tracking (through a numpy array it shares memory with, as
    ``torch.from_numpy`` gives, or through ``.data``): the cache would not
    see the write and would return the old users' vectors.

    A tower whose catalog score is a plain dot also implements
    ``_topk_factors(uv) -> (uv2, table, bias)`` such that ``predict(users)
    == uv2 @ table.T + bias`` up to a per-row constant (which cannot change
    a row's ranking), with ``uv = _user_vectors(users)``: ``table`` (N, d)
    covers exactly predict's columns, ``bias`` is (N,) or None, and neither
    depends on ``uv``'s values (it passes through untouched; the evaluator
    asks with ``uv=None``). Fused evaluation then scores each batch's
    cached user vectors against the packed table
    (:func:`~skrx_torch.eval.fused_family`); a tower that applies a
    transform after the dot sets ``_topk_score_fn`` instead and keeps the
    predict route. Serving keeps the predict route for every tower, as
    the JAX package's fused serving takes only ``_chunk_embeddings``. The
    same factors give the towers' tensor-parallel :meth:`predict_topk`."""

    _uv_cache = None

    def _user_vectors(self, users: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _score_user_chunk(self, uv: torch.Tensor, item_lo: int,
                          item_hi: int) -> torch.Tensor:
        raise NotImplementedError

    def _uv_state_refs(self) -> tuple:
        return tuple(self.parameters())

    @torch.no_grad()
    def _cached_user_vectors(self, users) -> torch.Tensor:
        refs = self._uv_state_refs()
        batch = (users, users._version) if isinstance(users, torch.Tensor) \
            else (None, np.asarray(users, dtype=np.int64).tobytes())
        versions = [t._version for t in refs]
        cached = self._uv_cache
        if (cached is None or len(cached[0]) != len(refs)
                or any(a is not b for a, b in zip(cached[0], refs))
                or cached[1][0] != versions or cached[1][1] is not batch[0]
                or cached[1][2] != batch[1]):
            # the references held keep the ids of the tensors from reuse
            cached = (refs, (versions, *batch), self._user_vectors(
                as_user_tensor(users, self.device)))
            self._uv_cache = cached
        return cached[2]

    @torch.no_grad()
    def predict_chunk(self, users, item_lo: int, item_hi: int
                      ) -> torch.Tensor:
        return self._score_user_chunk(self._cached_user_vectors(users),
                                      item_lo, item_hi)

    @torch.no_grad()
    def predict_topk(self, users, k: int, train_table=None):
        """The exact train-masked top-k with the catalog split over the
        mesh's model axis (model axis above 1, else ``ValueError``; every
        rank of the model group calls it with the same users): the user
        encoder runs on every rank (cached), then each rank scores its
        items of ``_topk_factors``' table, with the model's
        ``_topk_score_fn`` where it has one, takes its local top-k (#1-#4
        on a card) and the candidates merge through #5
        (:func:`~skrx_torch.parallel.sharded_dot_topk`). Returns (values
        (B, k'), global ids (B, k') int32), ``k' = min(k, width)`` over
        the table's rows (a pad column included); -inf slots carry masked
        or padding ids."""
        uv, table, bias = self._topk_factors(self._cached_user_vectors(users))
        return _sharded_topk(self, uv, table, bias, k, train_table)


class PadColumnTowerMixin(NestedParamsMixin, CachedUserVecChunkMixin):
    """Scoring of the towers with a pad row (Caser, HGN): ``uv @ W2.T +
    b2`` over N + 1 columns, row N of ``W2`` and ``b2`` (the pad, id
    ``pad_idx`` = N) zeroed, so that ``predict`` shows the pad column with
    score 0 and every route ranks the same N + 1 columns (``_eval_width``).
    A subclass sets ``W2``, ``b2`` and ``pad_idx`` and implements
    ``_user_vectors``."""

    def _score_user_chunk(self, uv: torch.Tensor, item_lo: int,
                          item_hi: int) -> torch.Tensor:
        """Items [lo, hi) of the N + 1 columns; the pad column scores 0."""
        live = torch.arange(item_lo, item_hi, device=uv.device) != self.pad_idx
        return (uv @ self.W2[item_lo:item_hi].T
                + self.b2[None, item_lo:item_hi]) * live[None, :]

    def _topk_factors(self, uv):
        w2, b2 = self.W2.detach().clone(), self.b2.detach().clone()
        w2[self.pad_idx], b2[self.pad_idx] = 0.0, 0.0
        return uv, w2, b2

    @torch.no_grad()
    def predict(self, users) -> torch.Tensor:
        """(B, N + 1) f32 scores on the model's device, the pad column 0."""
        uv = self._user_vectors(as_user_tensor(users, self.device))
        return self._score_user_chunk(uv, 0, self.pad_idx + 1)


class LazyAdamTowerMixin:
    """The state of a model with ``optimizer="lazy_adam"`` whose tables
    step under :class:`~skrx_torch.ops.optim.LazyAdam` (``self.optimizer``)
    and whose other parameters under dense Adam (``self.dense_optimizer``,
    as ``make_lazy_train_step`` returns them; Caser, HGN): checkpoints
    hold both, and JAX's ``opt_state`` converts."""

    def _train_state(self) -> Dict:
        state = super()._train_state()
        if self.config.optimizer == "lazy_adam":
            state["dense_optimizer"] = self.dense_optimizer.state_dict()
        return state

    def _load_train_state(self, state: Dict) -> None:
        super()._load_train_state(state)
        if "dense_optimizer" in state:
            self.dense_optimizer.load_state_dict(state["dense_optimizer"])

    def load_jax_opt_state(self, *state) -> None:
        """Dense Adam: ``(count, mu, nu)``, as the base class. Lazy Adam:
        JAX's ``opt_state`` as ``(lazy, (count, mu, nu))``: a dict of one
        ``LazyAdamState`` (m, v, counts) per table, and the dense Adam
        state of the other leaves (``mu``, ``nu`` raveled in JAX's
        order)."""
        if self.config.optimizer != "lazy_adam":
            super().load_jax_opt_state(*state)
            return
        lazy, (count, mu, nu) = state
        self.optimizer.load_state_dict(
            {name: lazy_adam_state_from_jax(*s) for name, s in lazy.items()})
        leaves = {key: name for key, (name, _) in dotted_jax_leaves(
            self).items() if name not in self.optimizer.tables}
        shapes = {key: tuple(self.get_parameter(name).shape)
                  for key, name in leaves.items()}
        for key, st in adam_state_from_jax(count, mu, nu, shapes).items():
            # on a card Adam is capturable: its step count on the device
            self.dense_optimizer.state[self.get_parameter(leaves[key])] = {
                "step": st["step"].to(self.device),
                "exp_avg": st["exp_avg"].to(self.device),
                "exp_avg_sq": st["exp_avg_sq"].to(self.device)}


class EpochTrainedRecommender(TorchRecommender):
    """Base of models trained by an epoch pipeline: a subclass sets
    ``self.optimizer``, ``self.pipeline`` (``run_epoch(generator,
    train_step, captured) -> loss``) and ``self.train_step``. Epoch ``e``'s
    pipeline draws from ``epoch_generator(seed + 1, e)``, as the JAX
    package folds the epoch into its key, so a resumed run draws the
    batches of an uninterrupted one. A step's own draws (dropout masks, an
    autoencoder's negatives) come from :meth:`step_generator`, stream 1 of
    the same (seed + 1, e), independent of the pipeline's.

    On a CUDA device the epochs of some models run as one captured
    program (:attr:`captured_epochs`): those with a flat step
    (``self._flat_step``, :class:`FlatTrainStep`; BPRMF with Adam,
    LightGCN, FPMC, TransRec, SGAT and MGCN on one device, the JAX
    package's flat step), whose checkpoints and JAX Adam state read and
    write the flat buffers, and the classes that set
    ``_CAPTURED_STEP`` (SelfCF, BM3, SLMRec, CDAE, MultVAE), whose
    per-leaf dense-Adam step (:class:`LeafTrainStep`) keeps its tensors
    in place on one device."""

    _step_gen: Optional[torch.Generator] = None
    _flat_step: Optional[FlatTrainStep] = None
    # the class's per-leaf step may be captured (each model's own host-read
    # check done): set by the models that take the captured route
    _CAPTURED_STEP = False

    @property
    def captured_epochs(self) -> bool:
        """Whether ``_train_epoch`` runs the epoch as a CUDA graph of one
        step replayed a batch (``run_epoch(captured=True)``): on a CUDA
        device, for a model with a flat step, or of a class that sets
        ``_CAPTURED_STEP`` on one device under dense Adam (a step with
        ``state``)."""
        if self.device.type != "cuda":
            return False
        if self._flat_step is not None:
            return True
        return (self._CAPTURED_STEP and self.mesh is None
                and getattr(self.train_step, "state", None) is not None)

    def step_generator(self) -> torch.Generator:
        """The generator of the running epoch's in-step draws: the
        epoch's stream 1, or on the captured route the epoch program's
        step generator, which replays them inside the graph."""
        if self._step_gen is None:
            raise RuntimeError("a training step's draws are made inside an "
                               "epoch")
        return self._step_gen

    def run_epoch(self, generator: torch.Generator,
                  step_generator: torch.Generator,
                  captured: bool = False) -> float:
        """One epoch of the pipeline: its batches from ``generator``, the
        steps' own draws from ``step_generator`` (both left where the
        epoch's draws end), eagerly or as one captured program; returns
        the mean step loss. On the captured route the steps draw from the
        program's step generator, which takes ``step_generator``'s state
        over and gives it back."""
        pipe = self.pipeline
        self._step_gen = (pipe.program(self.train_step).step_generator
                          if captured else step_generator)
        try:
            return pipe.run_epoch(generator, self.train_step, captured,
                                  step_generator)
        finally:
            self._step_gen = None

    def _train_epoch(self, epoch: int) -> Optional[float]:
        seed = self.run_config.seed + 1
        return self.run_epoch(
            epoch_generator(seed, epoch, self.device),
            epoch_generator(seed, epoch, self.device, stream=1),
            captured=self.captured_epochs)

    def _train_state(self) -> Dict:
        state = super()._train_state()
        if self._flat_step is not None:
            state["optimizer"] = self._flat_step.state_dict()
        return state

    def _load_train_state(self, state: Dict) -> None:
        if self._flat_step is None:
            super()._load_train_state(state)
            return
        self._copy_params(state["params"])         # into the flat vector
        self._flat_step.load_state_dict(state["optimizer"])
        self._invalidate_predict_cache()

    def load_jax_opt_state(self, count: int, mu: np.ndarray,
                           nu: np.ndarray) -> None:
        if self._flat_step is None:
            super().load_jax_opt_state(count, mu, nu)
        else:
            self._flat_step.load_jax_adam(count, mu, nu)


def resolve_graph_impl(graph_impl: str) -> str:
    """The concrete propagation for a model's ``graph_impl``. Every choice
    runs kernel #11 (its plain version on the CPU): "segment" and "mxu"
    with f32 messages, "mxu_bf16" with bf16 messages summed in f32. "auto"
    is "segment": the JAX package sends large graphs to bf16 messages on a
    TPU after measurements there, which do not carry to this card."""
    if graph_impl not in GRAPH_IMPLS:
        raise ValueError(f"graph_impl must be one of {GRAPH_IMPLS}, got "
                         f"{graph_impl!r}")
    return "segment" if graph_impl == "auto" else graph_impl


def mxu_msg_dtype(impl: str) -> torch.dtype:
    """Message dtype of a resolved ``graph_impl``."""
    return torch.bfloat16 if impl == "mxu_bf16" else torch.float32


def graph_sharding_enabled(mesh) -> bool:
    """Whether a graph model shards its propagation: under any mesh of
    more than one rank."""
    return mesh is not None and mesh.size > 1


def build_prop_graph(adj: sp.spmatrix, graph_impl: str = "auto",
                     mesh=None, device="cpu"
                     ) -> Union[Graph, ShardedPropGraph]:
    """Lower a square scipy adjacency for
    :func:`skrx_torch.ops.graph.propagate` on ``device``. Under a mesh of
    several ranks the destination rows split over every rank (a
    :class:`~skrx_torch.parallel.ShardedPropGraph`: one all-gather each
    way a propagation, segsum over the rank's edges)."""
    impl = resolve_graph_impl(graph_impl)
    if graph_sharding_enabled(mesh):
        return ShardedPropGraph(mesh, adj, mxu_msg_dtype(impl),
                                device=device)
    return graph_from_sp_matrix(adj, msg_dtype=mxu_msg_dtype(impl),
                                device=device)


def graph_param_shardings(mesh, sizes: Dict[str, int]
                          ) -> Dict[str, RowBlocks]:
    """Row ownership of a graph model's tables, ``sizes`` (name -> rows)
    in node order (their rows concatenated are the node table): rank r
    owns node rows ``r * rows_per .. (r + 1) * rows_per`` of the padded
    table (``rows_per = -(-N // ranks)``, as the sharded propagate), and
    of each table the rows that fall there."""
    total, offset, out = sum(sizes.values()), 0, {}
    for name, rows in sizes.items():
        out[name] = row_blocks(rows, mesh.size, mesh.rank, mesh.world,
                               offset=offset, span=total)
        offset += rows
    return out


def node_table_rows(model, graph, tables: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """A graph model's node tables (name -> whole table, in node order:
    users, then items) as the model holds them: on a
    :class:`~skrx_torch.parallel.ShardedPropGraph` each table's rows in
    the rank's block of the node table (:func:`graph_param_shardings`,
    recorded in ``model._row_blocks``), on one device whole."""
    if isinstance(graph, ShardedPropGraph):
        model._row_blocks.update(graph_param_shardings(
            model.mesh, {name: t.shape[0] for name, t in tables.items()}))
    return {name: take_rows(t, model._row_blocks.get(name))
            for name, t in tables.items()}


def node_rows(graph, *tables: torch.Tensor) -> torch.Tensor:
    """The propagation's input from node tables in node order (users, then
    items): their rows concatenated; on a sharded graph the rank's rows of
    each table, its block of the node table, padded with zero rows up to
    ``rows_per_shard``."""
    x = torch.cat(tables, dim=0)
    if isinstance(graph, ShardedPropGraph):
        pad = graph.rows_per_shard - x.shape[0]
        x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
    return x


def whole_nodes(graph, x: torch.Tensor) -> torch.Tensor:
    """Every node's rows of the propagation's output ``x``: ``x`` itself on
    one device; on a sharded graph every rank's block gathered in rank
    order and cut to the node count (differentiable: the backward sums the
    cotangent over the data axis and keeps the rank's block)."""
    if not isinstance(graph, ShardedPropGraph):
        return x
    flat = gather_all_rows(x.reshape(x.shape[0], -1), graph.mesh)
    return flat[:graph.num_nodes].reshape(graph.num_nodes, *x.shape[1:])


def own_node_rows(graph, x: Optional[torch.Tensor]
                  ) -> Optional[torch.Tensor]:
    """This rank's block of ``x``, a tensor over every node (a mask drawn
    whole): all of it on one device; on a sharded graph rows ``rank *
    rows_per .. (rank + 1) * rows_per``, padded with zeros."""
    if x is None or not isinstance(graph, ShardedPropGraph):
        return x
    rp = graph.rows_per_shard
    lo = graph.mesh.rank * rp
    rows = x[lo:lo + rp]
    if rows.shape[0] < rp:
        rows = torch.cat([rows, rows.new_zeros((rp - rows.shape[0],
                                                *x.shape[1:]))])
    return rows
