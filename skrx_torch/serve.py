"""Top-K recommendation serving: the port of ``skrx.serve``.

``recommend(users)`` scores the full catalog with the model's ``predict``,
masks each user's training items and returns the top-K ids and scores. The
ranking runs on the model's device through
:func:`skrx_torch.ops.metrics.topk_scores_and_indices` (the blockwise CUDA
kernels on a card). The JAX package's StableHLO export has no counterpart.
"""
from typing import Tuple

import numpy as np
import torch

from .ops.metrics import topk_scores_and_indices
from .utils import resolve_device

__all__ = ["TopKRecommender"]


class TopKRecommender:
    """Serve ``recommend(users) -> (item_ids, scores)`` as numpy arrays.

    Args:
        model: trained model exposing ``predict(users) -> (B, N) scores``,
            ``device`` and ``dataset`` (for the seen-item mask).
        k: recommendations per user.
        filter_seen: mask the user's training items.
        fused: "auto" or "never" score the catalog with ``predict``; the
            fused score-and-select kernels are not ported yet, so "always"
            raises.
    """

    def __init__(self, model, k: int = 10, filter_seen: bool = True,
                 fused: str = "auto"):
        if fused not in ("auto", "always", "never"):
            raise ValueError(f"fused must be 'auto', 'always' or 'never', "
                             f"got {fused!r}")
        if fused == "always":
            raise NotImplementedError(
                "fused serving (dot_topk) is not ported yet: ROADMAP.md "
                "Queue 1, fused serving (Queue 2 kernels #9-#10)")
        self.device = resolve_device(model.device)
        self.model = model
        self.k = k
        self.filter_seen = filter_seen
        table = model.dataset.train_data.to_padded_positive_table().table
        self._seen = torch.as_tensor(table, device=self.device)  # pad = N

    @torch.inference_mode()
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
        scores = self.model.predict(users_t).to(torch.float32)
        seen = self._seen[users_t] if self.filter_seen else None
        vals, idx = topk_scores_and_indices(scores, self.k, mask_table=seen)
        return idx.cpu().numpy(), vals.cpu().numpy()
