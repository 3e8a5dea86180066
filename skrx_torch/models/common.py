"""Shared model helpers: chunked scoring for dot-product models."""
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["ChunkedDotPredictMixin", "as_user_tensor"]


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
