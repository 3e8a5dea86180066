"""Shared model helpers: the optimizer and train-step factory, chunked
scoring for dot-product models, and the lowering of a model's adjacency for
propagation (the port of the parts of ``skrx.models.common`` that BPRMF and
LightGCN use)."""
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.graph import Graph, graph_from_sp_matrix

__all__ = ["ChunkedDotPredictMixin", "as_user_tensor", "make_optimizer",
           "make_train_step", "make_sharded_train_step", "GRAPH_IMPLS",
           "resolve_graph_impl", "mxu_msg_dtype", "build_prop_graph"]

GRAPH_IMPLS = ("auto", "segment", "mxu", "mxu_bf16")


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                   lr: float) -> torch.optim.Optimizer:
    """Dense Adam (``optax.adam``'s constants) over ``params``. The JAX
    package runs it over the raveled parameter vector; Adam is elementwise,
    so per-parameter state computes the same update. ``lazy_adam`` (row-wise
    sparse updates) is not ported yet."""
    if name == "lazy_adam":
        raise NotImplementedError("optimizer='lazy_adam' is not ported yet "
                                  "(ROADMAP.md, Queue 1); use 'adam'")
    if name != "adam":
        raise ValueError(f"unknown optimizer {name!r}")
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_train_step(optimizer: torch.optim.Optimizer,
                    loss_fn: Callable[..., torch.Tensor]) -> Callable:
    """``train_step(batch) -> loss``: the loss of ``loss_fn(*batch)`` before
    the update, then one optimizer step. The loss stays on the device."""
    def train_step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(*batch)
        loss.backward()
        optimizer.step()
        return loss.detach()
    return train_step


def make_sharded_train_step(*args, **kwargs):
    """The tensor-parallel step of the JAX package (tables row-sharded over
    a mesh) is not ported yet."""
    raise NotImplementedError("the tensor-parallel train step is not ported "
                              "yet (ROADMAP.md, Queue 1, parallel/)")


def as_user_tensor(users, device: torch.device) -> torch.Tensor:
    """User ids (a sequence, numpy array or tensor) as int64 on ``device``."""
    if isinstance(users, torch.Tensor):
        return users.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(users, dtype=np.int64), device=device)


class ChunkedDotPredictMixin:
    """``predict_chunk(users, lo, hi)`` for models whose full-catalog score
    is ``user_vectors @ item_vectors.T (+ bias)``: scores of items
    [lo, hi) only, so a caller can walk a catalog without building (B, N).
    Subclasses implement ``_chunk_embeddings() -> (u_all, i_all)`` and
    optionally ``_chunk_bias() -> (N,) or None``."""

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


def build_prop_graph(adj: sp.spmatrix, graph_impl: str = "auto",
                     mesh=None, device="cpu") -> Graph:
    """Lower a square scipy adjacency for
    :func:`skrx_torch.ops.graph.propagate` on ``device``. A device mesh
    (row-sharded propagation) is not ported yet."""
    if mesh is not None:
        raise NotImplementedError("sharded propagation over a mesh is not "
                                  "ported yet (ROADMAP.md, Queue 1, "
                                  "parallel/)")
    impl = resolve_graph_impl(graph_impl)
    return graph_from_sp_matrix(adj, msg_dtype=mxu_msg_dtype(impl),
                                device=device)
