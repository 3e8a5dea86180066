"""Shared model helpers: the optimizer and train-step factory, and chunked
scoring for dot-product models (the port of the parts of
``skrx.models.common`` that BPRMF uses)."""
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

__all__ = ["ChunkedDotPredictMixin", "as_user_tensor", "make_optimizer",
           "make_train_step", "make_sharded_train_step"]


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
