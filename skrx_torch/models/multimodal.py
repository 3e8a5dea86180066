"""What the multimodal models (BM3, SLMRec, FREEDOM, MGCN, LATTICE) share:
the item feature tables as f32 arrays, the directory their kNN edges are
cached in, the weighted mean BPR loss, and their base class."""
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import batch_total
from .common import (EpochTrainedRecommender, FrozenEmbeddingMixin,
                     NestedParamsMixin)

__all__ = ["MultimodalRecommender", "item_features", "bpr_mean",
           "cache_dir_of"]


def item_features(dataset) -> Tuple[Optional[np.ndarray],
                                    Optional[np.ndarray]]:
    """(image, text) item features of ``dataset`` as f32 arrays, None for
    a missing table."""
    def f32(x):
        return None if x is None else np.asarray(x, dtype=np.float32)
    return f32(dataset.img_features), f32(dataset.txt_features)


def cache_dir_of(dataset) -> str:
    """``<data_dir>/_data_cache``, where the JAX package caches its kNN
    graphs too (the port's files have names of their own)."""
    return os.path.join(dataset.data_dir, "_data_cache")


def bpr_mean(u: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """``-sum(w * log sigmoid(u.pos - u.neg)) / max(sum(w), 1)``, the count
    the whole batch's (a rank's share under a mesh)."""
    y_pos = torch.sum(u * pos, dim=-1)
    y_neg = torch.sum(u * neg, dim=-1)
    return -torch.sum(F.logsigmoid(y_pos - y_neg) * w) \
        / torch.clamp(batch_total(w), min=1.0)


class MultimodalRecommender(NestedParamsMixin, FrozenEmbeddingMixin,
                            EpochTrainedRecommender):
    """Base of the multimodal models: parameters in the JAX package's
    nested layout (``image_trs.w``, ``x @ w + b``), carried over by the
    model's ``_params_from_jax``; ``evaluate()`` freezes the embeddings of
    ``_embeddings()`` that ``predict``, the chunked and fused routes and
    serving reuse until the next epoch."""

    @staticmethod
    def _params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def load_jax_params(self, params: Dict) -> None:
        """Copy a JAX model's ``params`` of this kind (arrays taken with
        ``np.asarray``) into this model."""
        self._copy_params(self._params_from_jax(params))
        self._invalidate_predict_cache()
