"""Synthetic implicit-feedback data, numpy-only.

Two generators write the layout of ``skrx.io.synthetic.make_dataset_dir``
(``<dir>/<dir>.{all,train,valid,test,user2id,item2id}``, tab-separated):

- with ``latent_dim`` given, JAX's generator (:func:`make_latent_interactions`,
  Zipf popularity plus a low-rank user-item affinity, so factor models beat
  the popularity baseline) through this package's :class:`Preprocessor`:
  for the same arguments the files, item features included, are byte-equal
  to the JAX package's;
- with ``latent_dim=None`` (the default), the catalog-scale generator
  (:func:`make_interactions`): items drawn from a Zipf popularity law with
  vectorized numpy instead of a dense (users, items) affinity matrix, so a
  Gowalla-sized log (29,858 users, 40,981 items, 1,027,370 interactions)
  takes seconds. Users and items are drawn independently: no user prefers
  any item, so a model's NDCG on these data measures how well it learns
  popularity. It writes the ratio split by time of all four columns; its
  item features (``with_mm``, :func:`write_mm_features`) are the JAX
  generator's draws, bit for bit, for the same seed and item count.
"""
import os
from typing import Dict, Optional

import numpy as np

from .preprocessor import _COLUMN_DICT, Preprocessor

__all__ = ["make_interactions", "make_latent_interactions", "make_dataset_dir",
           "write_mm_features"]

_MIN_PER_USER = 3
_ITEM_EXPONENT = 0.8                   # Zipf popularity, as the JAX generator
_USER_EXPONENT = 0.5


def make_interactions(num_users: int, num_items: int, num_ratings: int,
                      seed: int = 2021) -> np.ndarray:
    """(num_ratings, 4) int64 rows (user, item, rating, time) with no
    duplicate (user, item) pair, every user at least 3 times and every item
    at least once, so the ids span exactly ``num_users`` x ``num_items``."""
    if num_items < _MIN_PER_USER or \
            num_ratings < _MIN_PER_USER * num_users + num_items:
        raise ValueError("need num_items >= 3 and num_ratings >= "
                         "3 * num_users + num_items")
    if num_ratings > num_users * num_items // 2:
        raise ValueError("num_ratings too dense for rejection of duplicates")
    rng = np.random.default_rng(seed)
    item_w = rng.permutation(1.0 / np.arange(1, num_items + 1)
                             ** _ITEM_EXPONENT)
    user_w = rng.permutation(1.0 / np.arange(1, num_users + 1)
                             ** _USER_EXPONENT)

    # coverage first: 3 distinct items per user, one user per item; then
    # fill with Zipf draws until num_ratings distinct pairs exist
    per_user = rng.choice(num_items, (num_users, _MIN_PER_USER),
                          p=item_w / item_w.sum())
    while True:
        srt = np.sort(per_user, axis=1)
        clash = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
        if not clash.any():
            break
        per_user[clash] = rng.choice(num_items, (clash.sum(), _MIN_PER_USER),
                                     p=item_w / item_w.sum())
    cover_u = np.concatenate([np.repeat(np.arange(num_users), _MIN_PER_USER),
                              rng.integers(0, num_users, num_items)])
    cover_i = np.concatenate([per_user.ravel(), np.arange(num_items)])
    keys = cover_u * num_items + cover_i
    keys = keys[np.sort(np.unique(keys, return_index=True)[1])]
    while len(keys) < num_ratings:
        extra = int((num_ratings - len(keys)) * 1.2) + 64
        u = rng.choice(num_users, extra, p=user_w / user_w.sum())
        i = rng.choice(num_items, extra, p=item_w / item_w.sum())
        keys = np.concatenate([keys, u * num_items + i])
        keys = keys[np.sort(np.unique(keys, return_index=True)[1])]
    keys = keys[:num_ratings]
    # a user's 3 coverage pairs come first, so the cut keeps every user
    out = np.empty((num_ratings, 4), np.int64)
    out[:, 0], out[:, 1] = np.divmod(keys, num_items)
    out[:, 2] = rng.integers(1, 6, num_ratings)
    out[:, 3] = rng.integers(1_000_000, 2_000_000, num_ratings)
    return out


def _first_rows(keys: np.ndarray) -> np.ndarray:
    """Indices of each key's first row, in row order (pandas'
    ``drop_duplicates(keep="first")``)."""
    return np.sort(np.unique(keys, return_index=True)[1])


def make_latent_interactions(num_users: int = 200, num_items: int = 300,
                             num_ratings: int = 5000, seed: int = 2021,
                             latent_dim: int = 8,
                             latent_strength: float = 3.0
                             ) -> Dict[str, np.ndarray]:
    """JAX's generator (``skrx.io.synthetic.make_interactions``) in numpy:
    int64 columns ``user``, ``item``, ``rating``, ``time`` with Zipfian item
    popularity plus a low-rank user-item affinity, no duplicate (user, item)
    pair and every user at least 3 times. The same draws in the same order,
    so the rows equal JAX's."""
    rng = np.random.default_rng(seed)
    item_w = 1.0 / np.arange(1, num_items + 1) ** _ITEM_EXPONENT
    item_logit = np.log(item_w / item_w.sum())
    user_w = 1.0 / np.arange(1, num_users + 1) ** _USER_EXPONENT
    user_p = user_w / user_w.sum()

    u_vec = rng.standard_normal((num_users, latent_dim)) / np.sqrt(latent_dim)
    i_vec = rng.standard_normal((num_items, latent_dim)) / np.sqrt(latent_dim)
    affinity = latent_strength * (u_vec @ i_vec.T)          # (U, I)
    logits = affinity + item_logit[None, :]
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)

    oversample = int(num_ratings * 2.5)
    users = rng.choice(num_users, size=oversample, p=user_p)
    # each user's categorical draw by inverse CDF, one searchsorted a user
    cdf = np.cumsum(probs, axis=1)
    r = rng.random(oversample)
    items = np.empty(oversample, np.int64)
    order = np.argsort(users, kind="stable")
    uniq, starts = np.unique(users[order], return_index=True)
    for u, rows in zip(uniq, np.split(order, starts[1:])):
        items[rows] = np.searchsorted(cdf[u], r[rows])
    items = np.minimum(items, num_items - 1)
    keep = _first_rows(users * num_items + items)[:num_ratings]
    users, items = users[keep], items[keep]
    # every user needs >= 3 interactions so leave-out splits are
    # non-degenerate: 3 random items a user come first
    base_u = np.repeat(np.arange(num_users), _MIN_PER_USER)
    base_i = rng.integers(0, num_items, size=_MIN_PER_USER * num_users)
    users = np.concatenate([base_u, users])
    items = np.concatenate([base_i, items])
    keep = _first_rows(users * num_items + items)
    users, items = users[keep], items[keep]
    n = len(users)
    return {"user": users, "item": items,
            "rating": rng.integers(1, 6, size=n).astype(np.int64),
            "time": rng.integers(1_000_000, 2_000_000,
                                 size=n).astype(np.int64)}


def _split_by_time(rows: np.ndarray, ratios=(0.7, 0.1, 0.2)):
    """Per user, the earliest ceil(0.7 n) rows train, the next ceil(0.1 n)
    valid, the rest test (``Preprocessor.split_data_by_ratio(by_time=True)``
    semantics); rows come back sorted by (user, time)."""
    rows = rows[np.lexsort((rows[:, 3], rows[:, 0]))]
    _, starts, sizes = np.unique(rows[:, 0], return_index=True,
                                 return_counts=True)
    rank = np.arange(len(rows)) - np.repeat(starts, sizes)
    size = np.repeat(sizes, sizes)
    train_end = np.ceil(ratios[0] * size)
    valid_end = train_end + np.ceil(ratios[1] * size)
    return (rows[rank < train_end],
            rows[(rank >= train_end) & (rank < valid_end)],
            rows[rank >= valid_end])


def write_mm_features(out_dir: str, num_items: int, seed: int,
                      img_dim: int = 24, txt_dim: int = 16) -> None:
    """Write ``<out_dir>/<name>.img.npz`` (num_items, img_dim) and
    ``.txt.npz`` (num_items, txt_dim) f32 item features: standard normal
    draws of ``np.random.default_rng(seed + 1)``, the image table first, as
    the JAX generator's ``with_mm`` draws them."""
    rng = np.random.default_rng(seed + 1)
    prefix = os.path.join(out_dir, os.path.basename(os.path.normpath(out_dir)))
    np.savez(prefix + ".img.npz",
             rng.standard_normal((num_items, img_dim)).astype(np.float32))
    np.savez(prefix + ".txt.npz",
             rng.standard_normal((num_items, txt_dim)).astype(np.float32))


def make_dataset_dir(root: str, name: str = "synth", num_users: int = 29_858,
                     num_items: int = 40_981, num_ratings: int = 1_027_370,
                     seed: int = 2021, by_time: bool = True,
                     split: str = "ratio", columns: str = "UIRT",
                     latent_dim: Optional[int] = None,
                     latent_strength: float = 3.0, with_mm: bool = False,
                     img_dim: int = 24, txt_dim: int = 16) -> str:
    """Generate, split and save a dataset; returns its directory, ready for
    :class:`skrx_torch.io.RSDataset` with ``sep="\\t"``.

    With ``latent_dim`` given, the arguments mean what they mean to
    ``skrx.io.synthetic.make_dataset_dir``: JAX's interactions
    (:func:`make_latent_interactions`) keep ``columns`` ("UI", "UIR", "UIT"
    or "UIRT"), go through :class:`Preprocessor` (duplicates dropped, users
    with >= 3 and items with >= 1 interactions, ids remapped) and are split
    by ``split`` ("ratio": 0.7/0.1/0.2; "leave_out": one valid, one test),
    ``by_time`` or at random; the files equal JAX's byte for byte. Pass
    JAX's own default, ``latent_dim=8``, for its data at its defaults.

    With ``latent_dim=None``, the catalog-scale Zipf generator
    (:func:`make_interactions`) writes the 0.7/0.1/0.2 split by time of all
    four columns; other ``by_time``, ``split`` or ``columns`` raise. Its
    defaults are the Gowalla catalog of the LightGCN paper.

    ``with_mm`` also writes item features of ``img_dim`` and ``txt_dim``
    columns for the items that are left (:func:`write_mm_features`)."""
    if latent_dim is not None:
        return _make_latent_dataset_dir(
            root, name, num_users, num_items, num_ratings, seed, by_time,
            split, columns, latent_dim, latent_strength, with_mm, img_dim,
            txt_dim)
    if (by_time, split, columns) != (True, "ratio", "UIRT"):
        raise ValueError("the catalog-scale generator writes the ratio split "
                         "by time of UIRT; pass latent_dim for JAX's "
                         "generator and its options")
    rows = make_interactions(num_users, num_items, num_ratings, seed)
    train, valid, test = _split_by_time(rows)
    # same directory naming as the JAX Preprocessor (ratio split by time,
    # users with >= 3 and items with >= 1 interactions)
    tag = f"{name}_ratio_by_time_u{_MIN_PER_USER}_i1"
    out_dir = os.path.join(root, tag)
    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(out_dir, tag)
    for suffix, part in ((".all", rows), (".train", train),
                         (".valid", valid), (".test", test)):
        np.savetxt(prefix + suffix, part, fmt="%d", delimiter="\t")
    for suffix, n in ((".user2id", num_users), (".item2id", num_items)):
        ids = np.arange(n)
        np.savetxt(prefix + suffix, np.stack([ids, ids], 1), fmt="%d",
                   delimiter="\t")
    if with_mm:
        write_mm_features(out_dir, num_items, seed, img_dim, txt_dim)
    return out_dir


def _make_latent_dataset_dir(root, name, num_users, num_items, num_ratings,
                             seed, by_time, split, columns, latent_dim,
                             latent_strength, with_mm, img_dim,
                             txt_dim) -> str:
    """``skrx.io.synthetic.make_dataset_dir``'s steps on this package's
    generator and :class:`Preprocessor`."""
    if columns not in _COLUMN_DICT:
        raise ValueError(f"'columns' must be one of {list(_COLUMN_DICT)}.")
    cols = make_latent_interactions(num_users, num_items, num_ratings, seed,
                                    latent_dim=latent_dim,
                                    latent_strength=latent_strength)
    proc = Preprocessor()
    os.makedirs(root, exist_ok=True)
    proc.load_arrays({k: cols[k] for k in _COLUMN_DICT[columns]},
                     columns=columns, name=name, dir_path=root)
    proc.drop_duplicates()
    proc.filter_data(user_min=_MIN_PER_USER, item_min=1)
    proc.remap_data_id()
    if split == "ratio":
        proc.split_data_by_ratio(0.7, 0.1, 0.2, by_time=by_time)
    elif split == "leave_out":
        proc.split_data_by_leave_out(valid=1, test=1, by_time=by_time)
    else:
        raise ValueError(f"unknown split {split!r}")
    out_dir = proc.save_data(root)
    if with_mm:
        write_mm_features(out_dir, len(np.unique(proc.all_data["item"])),
                          seed, img_dim, txt_dim)
    return out_dir
