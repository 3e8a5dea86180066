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
there only on a TPU, behind a catalog size measured on that chip.

The score-matrix route's mask and rank are one module, :class:`RankTail`;
``export_program`` exports it ahead of time through ``torch.export``, the
counterpart of the JAX package's StableHLO export.
"""
import io
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .ops.kernels.dot_topk import PackedItems, dot_topk, pack_items
from .ops.metrics import topk_scores_and_indices
from .utils import resolve_device

__all__ = ["RankTail", "TopKRecommender"]


class RankTail(nn.Module):
    """The mask+rank tail of serving: ``forward(scores (B, N) f32,
    seen_rows (B, P) int32)`` -> ``(ids (B, k) int32, vals (B, k) f32)``,
    the top k of each row with its ``seen_rows`` items masked (ignored, and
    may be None, when ``filter_seen`` is False), through
    :func:`~skrx_torch.ops.metrics.topk_scores_and_indices`: the blockwise
    kernels (``torch.ops.skrx.*``) on a card when N // 128 >= 2k, a sort
    otherwise. The order of the JAX package's ``rank``: ids first."""

    def __init__(self, k: int, filter_seen: bool = True):
        super().__init__()
        self.k = k
        self.filter_seen = filter_seen

    def forward(self, scores: torch.Tensor,
                seen_rows: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        vals, idx = topk_scores_and_indices(
            scores, self.k, mask_table=seen_rows if self.filter_seen else None)
        return idx, vals


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
        self.rank_tail = RankTail(k, filter_seen)
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
            idx, vals = self.rank_tail(scores, seen)
        return idx.cpu().numpy(), vals.cpu().numpy()

    @torch.no_grad()
    def export_program(self, batch_size: int) -> bytes:
        """The mask+rank tail (:class:`RankTail`) exported ahead of time for
        a batch of ``batch_size`` users: the counterpart of
        ``skrx.serve.TopKRecommender.export_stablehlo``. The program takes
        (B, N) f32 scores and (B, P) int32 seen rows (the padded rows of
        the training items, pad id N) on the server's device and returns
        (ids (B, k) int32, values (B, k) f32); N is the width of the
        model's ``predict``, P that of the seen table. The bytes are a
        ``torch.export.save`` archive: ``torch.export.load`` reads them
        and ``.module()(scores, seen)`` runs them. On a card with
        N // 128 >= 2k its graph calls ``skrx.submax``,
        ``skrx.kth_largest``, ``skrx.extract`` and ``skrx.pruned_merge``,
        the kernels; elsewhere it holds the sort route, as the JAX export
        holds ``lax.top_k`` off a TPU. Loading needs ``torch`` and
        ``import skrx_torch``, which registers the ``skrx`` operators (and
        builds the kernels at their first launch); no loader without
        Python exists yet."""
        n = int(self.model.predict(torch.zeros(
            1, dtype=torch.int64, device=self.device)).shape[1])
        scores = torch.zeros((batch_size, n), dtype=torch.float32,
                             device=self.device)
        seen = torch.full((batch_size, self._seen.shape[1]), n,
                          dtype=torch.int32, device=self.device)
        program = torch.export.export(self.rank_tail, (scores, seen))
        # not the zeros it was traced on (4 B N bytes): its input specs
        # and guards stay
        program.example_inputs = None
        buf = io.BytesIO()
        torch.export.save(program, buf)
        return buf.getvalue()
