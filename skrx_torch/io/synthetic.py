"""Synthetic implicit-feedback data at catalog scale, numpy-only.

Writes the same file layout as ``skrx.io.synthetic.make_dataset_dir``
(``<dir>/<dir>.{all,train,valid,test,user2id,item2id}``, tab-separated
user, item, rating, time), but draws items from a Zipf popularity law with
vectorized numpy instead of a dense (users, items) affinity matrix, so a
Gowalla-sized log (29,858 users, 40,981 items, 1,027,370 interactions) takes
seconds. It does not reproduce the JAX generator's interactions; its item
features (``with_mm``, :func:`write_mm_features`) are the JAX generator's
draws, bit for bit, for the same seed and item count.
"""
import os

import numpy as np

__all__ = ["make_interactions", "make_dataset_dir", "write_mm_features"]

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
                     seed: int = 2021, with_mm: bool = False,
                     img_dim: int = 24, txt_dim: int = 16) -> str:
    """Generate, split (0.7/0.1/0.2 by time) and save a dataset; returns its
    directory, ready for :class:`skrx_torch.io.RSDataset` with
    ``sep="\\t"`` and ``columns="UIRT"``. The defaults are the Gowalla
    catalog of the LightGCN paper. ``with_mm`` also writes item features of
    ``img_dim`` and ``txt_dim`` columns (:func:`write_mm_features`)."""
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
