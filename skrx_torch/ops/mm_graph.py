"""Item-item kNN graphs from modality features (the multimodal models):
the port of ``skrx.ops.mm_graph``, with MGCN's value-weighted kNN edges
(``skrx.models.MGCN._weighted_knn_edges``) and LATTICE's frozen original
graphs (``skrx.models.LATTICE``, ``_knn_weighted`` and
``_norm_laplacian_dense``) on the same selection.

Selection (:func:`knn_select`): the features L2-normalised (``x / (|x| +
1e-12)``), scored a chunk of rows at a time, ``norm[c0:c1] @ norm.T`` (a
plain f32 product, as JAX computes it outside Pallas), and each row's top k
(self included) taken by :func:`~skrx_torch.ops.metrics.
topk_scores_and_indices`: the blockwise kernels #1-#4 on a card when N //
128 >= 2k, else an exact sort (a catalog too small for the kernels, and
every CPU tensor). The (N, N) similarity never exists whole: JAX forms it
on the host.

Every graph is COO edges ``(rows, cols, vals)`` in JAX's order (row r's k
neighbours at r*k .. r*k + k - 1, best first), so that ``A @ h`` is the sum
over edges of ``vals_e * h[cols_e]`` into ``rows_e``. Edges are cached as
``.npz`` under names the JAX package does not read (:func:`cached_edges`).
"""
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .metrics import topk_scores_and_indices
from .scatter import ordered_gather

__all__ = ["l2_normalize", "knn_select", "cosine_knn",
           "normalized_laplacian_values", "knn_adj_edges", "mm_edges",
           "cached_edges", "cached_mm_edges", "weighted_knn_edges",
           "lattice_original_edges", "knn_values", "inv_sqrt_positive",
           "Edges"]

Edges = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_CHUNK_BYTES = 2 ** 30                # one chunk's (rows, N) f32 scores


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` over their L2 norm plus 1e-12."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def knn_select(features: torch.Tensor, k: int,
               chunk_rows: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sims (N, k) f32, ids (N, k) int64)``: each row's k largest cosine
    similarities among all rows (itself included), best first, ties to the
    lower id; not differentiated. ``chunk_rows`` rows are scored at a time
    (by default as many as fit ~1 GiB of scores)."""
    with torch.no_grad():
        norm = l2_normalize(features.float())
        n = norm.shape[0]
        if not 1 <= k <= n:
            raise ValueError(f"need 1 <= k <= {n}, got k={k}")
        step = chunk_rows or max(1, _CHUNK_BYTES // (4 * n))
        sims, ids = [], []
        for c0 in range(0, n, step):
            scores = torch.matmul(norm[c0:c0 + step], norm.T)
            v, i = topk_scores_and_indices(scores, k)
            sims.append(v)
            ids.append(i.long())
        return torch.cat(sims), torch.cat(ids)


def cosine_knn(features: torch.Tensor, k: int,
               chunk_rows: Optional[int] = None) -> torch.Tensor:
    """(N, k) int64 ids of each row's top-k cosine neighbours (self
    included), best first."""
    return knn_select(features, k, chunk_rows)[1]


def _rows(n: int, k: int, device) -> torch.Tensor:
    return torch.arange(n, device=device).repeat_interleave(k)


def normalized_laplacian_values(rows: torch.Tensor, cols: torch.Tensor,
                                n: int) -> torch.Tensor:
    """(E,) f32 ``D^-1/2 A D^-1/2`` of a 0/1 adjacency in COO, D the count
    of each row's edges plus 1e-7, in float64."""
    deg = torch.bincount(rows, minlength=n).double() + 1e-7
    d_inv_sqrt = deg ** -0.5
    return (d_inv_sqrt[rows] * d_inv_sqrt[cols]).float()


def knn_adj_edges(features: torch.Tensor, k: int,
                  chunk_rows: Optional[int] = None) -> Edges:
    """Each item to its top-k cosine neighbours, valued by
    :func:`normalized_laplacian_values`."""
    n = features.shape[0]
    cols = cosine_knn(features, k, chunk_rows).reshape(-1)
    rows = _rows(n, k, cols.device)
    return rows, cols, normalized_laplacian_values(rows, cols, n)


def mm_edges(img_features: Optional[torch.Tensor],
             txt_features: Optional[torch.Tensor], k: int,
             image_weight: float = 0.5,
             chunk_rows: Optional[int] = None) -> Edges:
    """FREEDOM's blended kNN adjacency: the image graph's edges times
    ``image_weight``, then the text graph's times ``1 - image_weight``; a
    modality alone keeps its values."""
    parts = []
    if img_features is not None:
        r, c, v = knn_adj_edges(img_features, k, chunk_rows)
        parts.append((r, c, v * (image_weight if txt_features is not None
                                 else 1.0)))
    if txt_features is not None:
        r, c, v = knn_adj_edges(txt_features, k, chunk_rows)
        parts.append((r, c, v * ((1.0 - image_weight)
                                 if img_features is not None else 1.0)))
    if not parts:
        raise ValueError("no multimodal features available")
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def cached_edges(path: str, build: Callable[[], Edges],
                 device) -> Edges:
    """The edges saved at ``path`` (``rows``, ``cols`` int32, ``vals``
    f32), or ``build()`` saved there first (under a name of the process's
    own, then moved into place: the ranks of a mesh may build it at once);
    on ``device``."""
    if os.path.exists(path):
        with np.load(path) as blob:
            arrays = [blob[name] for name in ("rows", "cols", "vals")]
    else:
        rows, cols, vals = build()
        arrays = [rows.cpu().numpy().astype(np.int32),
                  cols.cpu().numpy().astype(np.int32),
                  vals.cpu().numpy().astype(np.float32)]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, rows=arrays[0], cols=arrays[1], vals=arrays[2])
        os.replace(tmp, path)
    rows, cols = (torch.as_tensor(a.astype(np.int64), device=device)
                  for a in arrays[:2])
    return rows, cols, torch.as_tensor(arrays[2], device=device)


def cached_mm_edges(cache_dir: str, tag: str, k: int,
                    img_features: Optional[torch.Tensor],
                    txt_features: Optional[torch.Tensor],
                    image_weight: float = 0.5, device="cpu") -> Edges:
    """:func:`mm_edges` cached as ``<cache_dir>/torch_mm_adj_<tag>_<k>_w
    <image_weight>.npz``."""
    path = os.path.join(cache_dir,
                        f"torch_mm_adj_{tag}_{k}_w{image_weight:g}.npz")
    return cached_edges(path, lambda: mm_edges(
        img_features, txt_features, k, image_weight), device)


def weighted_knn_edges(features: torch.Tensor, k: int,
                       chunk_rows: Optional[int] = None) -> Edges:
    """MGCN's kNN graph: each row's top-k neighbours valued by their
    similarity, normalised ``D^-1/2 S D^-1/2`` by the rows' sums of
    selected similarities in float64 (a row whose sum is 0 gets 0)."""
    sims, ids = knn_select(features, k, chunk_rows)
    n = ids.shape[0]
    rows, cols = _rows(n, k, ids.device), ids.reshape(-1)
    vals = sims.reshape(-1).double()
    # unordered on a card, but taken once when the graph is built and cached
    deg = torch.zeros(n, dtype=torch.float64,
                      device=vals.device).index_add_(0, rows, vals)
    d_inv_sqrt = deg ** -0.5
    d_inv_sqrt = torch.where(torch.isinf(d_inv_sqrt), 0.0, d_inv_sqrt)
    return rows, cols, (d_inv_sqrt[rows] * vals * d_inv_sqrt[cols]).float()


def knn_values(norm: torch.Tensor, rows: torch.Tensor,
               cols: torch.Tensor) -> torch.Tensor:
    """(E,) ``<norm[rows_e], norm[cols_e]>``: the similarities of selected
    pairs of L2-normalised rows, differentiable in ``norm`` (LATTICE's
    learned graph), the gathers' gradients summed in batch order."""
    return torch.sum(ordered_gather(norm, rows) * ordered_gather(norm, cols),
                     dim=-1)


def lattice_original_edges(features: torch.Tensor, k: int,
                           chunk_rows: Optional[int] = None) -> Edges:
    """LATTICE's original graph of one modality: each row's top-k cosine
    neighbours valued by their similarity, then ``D^-1/2 S D^-1/2`` in f32
    by the rows' sums (``rowsum ** -0.5`` where it is > 0, else 0): the
    nonzeros of JAX's dense ``_norm_laplacian_dense(_knn_weighted(...))``."""
    sims, ids = knn_select(features, k, chunk_rows)
    n = ids.shape[0]
    rows, cols = _rows(n, k, ids.device), ids.reshape(-1)
    vals = sims.reshape(-1)
    # unordered on a card, but taken once when the graph is built and cached
    rowsum = torch.zeros(n, device=vals.device).index_add_(0, rows, vals)
    d = inv_sqrt_positive(rowsum)
    return rows, cols, vals * d[rows] * d[cols]


def inv_sqrt_positive(rowsum: torch.Tensor) -> torch.Tensor:
    """``rowsum ** -0.5`` where it is > 0, else 0, with a finite gradient
    everywhere (the power is taken of 1 where the sum is not positive)."""
    pos = rowsum > 0
    return torch.where(pos, torch.where(pos, rowsum, 1.0) ** -0.5, 0.0)
