"""Top-K recommendation serving: the port of ``skrx.serve``.

``recommend(users)`` returns each user's top-K ids and scores with the
user's training items masked, on the model's device, by one of two routes:

- the score matrix: the model's ``predict`` scores the full catalog, then
  :func:`skrx_torch.ops.metrics.topk_scores_and_indices` (the blockwise CUDA
  kernels on a card);
- fused (``fused="always"``, dot models): :func:`~skrx_torch.ops.kernels.
  dot_topk.dot_topk` computes each score block inside its kernels from the
  model's factors, so the (B, N) score matrix never exists. Its scores are
  summed in the kernels' fixed order, not by ``predict``'s matmul, so the
  two routes can differ in the last bit of a score.

"auto" keeps the score-matrix route: the JAX package takes the fused one
there only on a TPU, behind a catalog size measured on that chip. The JAX
package's StableHLO export has no counterpart.
"""
from typing import Optional, Tuple

import numpy as np
import torch

from .ops.kernels.dot_topk import PackedItems, dot_topk, pack_items
from .ops.metrics import topk_scores_and_indices
from .utils import resolve_device

__all__ = ["TopKRecommender"]


def _table_key(t: Optional[torch.Tensor]):
    """What identifies a tensor's contents between in-place updates: its
    storage, shape and version counter (an optimizer step bumps it)."""
    return None if t is None else (t.data_ptr(), tuple(t.shape), t._version)


class TopKRecommender:
    """Serve ``recommend(users) -> (item_ids, scores)`` as numpy arrays.

    Args:
        model: trained model exposing ``predict(users) -> (B, N) scores``,
            ``device`` and ``dataset`` (for the seen-item mask).
        k: recommendations per user.
        filter_seen: mask the user's training items.
        fused: "always" serves a dot model (one with ``_chunk_embeddings``
            and no ``_topk_score_fn``) through the fused score-and-select
            kernels; other models, and "auto" and "never", score the
            catalog with ``predict``. ``self.fused`` tells which.
    """

    def __init__(self, model, k: int = 10, filter_seen: bool = True,
                 fused: str = "auto"):
        if fused not in ("auto", "always", "never"):
            raise ValueError(f"fused must be 'auto', 'always' or 'never', "
                             f"got {fused!r}")
        self.device = resolve_device(model.device)
        self.model = model
        self.k = k
        self.filter_seen = filter_seen
        table = model.dataset.train_data.to_padded_positive_table().table
        self._seen = torch.as_tensor(table, device=self.device)  # pad = N
        self.fused = (fused == "always"
                      and hasattr(model, "_chunk_embeddings")
                      and getattr(model, "_topk_score_fn", None) is None)
        # (keys of the item table and bias, the tensors, the packed table)
        self._packed_cache = None

    def _packed(self, items: torch.Tensor,
                bias: Optional[torch.Tensor]) -> PackedItems:
        """The item table packed for the fused kernels, packed again only
        when the model's item factors or bias change (a new tensor, or an
        in-place update such as an optimizer step). The cache holds the
        tensors, so their storage cannot be reused by new ones."""
        key = (_table_key(items), _table_key(bias))
        if self._packed_cache is None or self._packed_cache[0] != key:
            self._packed_cache = (key, (items, bias),
                                  pack_items(items, bias))
        return self._packed_cache[2]

    # no_grad, not inference_mode: tensors made here (the packed table,
    # embeddings a model freezes on demand) keep the version counter that
    # the packed-table cache reads
    @torch.no_grad()
    def recommend(self, users) -> Tuple[np.ndarray, np.ndarray]:
        """(ids (B, k) int32, scores (B, k) f32) for the user ids given."""
        users_np = np.asarray(users, dtype=np.int64).reshape(-1)
        num_users = self._seen.shape[0]
        if users_np.size and (users_np.min() < 0
                              or users_np.max() >= num_users):
            raise ValueError(
                f"user ids must be in [0, {num_users}); got "
                f"[{users_np.min()}, {users_np.max()}]")
        users_t = torch.as_tensor(users_np, device=self.device)
        seen = self._seen[users_t] if self.filter_seen else None
        if self.fused:
            u_all, i_all = self.model._chunk_embeddings()
            packed = self._packed(i_all, self.model._chunk_bias())
            uv = u_all[users_t].to(torch.float32)
            vals, idx = dot_topk(uv, None, None, self.k, mask_table=seen,
                                 packed=packed)
        else:
            scores = self.model.predict(users_t).to(torch.float32)
            vals, idx = topk_scores_and_indices(scores, self.k,
                                                mask_table=seen)
        return idx.cpu().numpy(), vals.cpu().numpy()
