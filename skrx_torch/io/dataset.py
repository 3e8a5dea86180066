"""Dataset layer, numpy-only: the port of ``skrx.io.dataset``.

Reads the ``<name>.{train,valid,test}`` and ``<name>.{user2id,item2id}``
layout that ``skrx.io.synthetic.make_dataset_dir`` and this package's
:mod:`skrx_torch.io.synthetic` write, the knowledge graph ``<name>.kg``
(head, relation, tail) and the item features ``<name>.{img,txt,audio}.npz``,
and exposes the JAX package's views of them. ``read_delimited`` types a
headerless file's columns as ``pandas.read_csv`` does. ``CFData`` keeps the
views it built in a pickle, ``<data_dir>/_data_cache/torch_<name>_cf.pkl``
(the JAX package's cache under its own name), restored by the next load
until a split file is newer.
"""
import atexit
import os
import pickle
import warnings
from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ..utils.generic import pad_sequences

__all__ = ["ImplicitFeedback", "KnowledgeGraph", "PaddedPositives", "CFData",
           "KGData", "MMData", "RSDataset", "SocialNetwork", "SocialData",
           "UserGroup", "group_users_by_interactions", "missing_mask",
           "read_delimited"]

_COLUMN_SETS = {"UI": ("user", "item"),
                "UIR": ("user", "item", "rating"),
                "UIT": ("user", "item", "time"),
                "UIRT": ("user", "item", "rating", "time")}


def _read_table(path: str, sep: str, names) -> Dict[str, np.ndarray]:
    """Columns of a headerless delimited file; user and item as int64, the
    rest as float64 (timestamps up to 2**53 stay exact)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # empty file
        data = np.loadtxt(path, delimiter=sep, dtype=np.float64, ndmin=2)
    if data.size == 0:
        return {}
    if data.shape[1] != len(names):
        raise ValueError(f"{path}: {data.shape[1]} columns, expected "
                         f"{len(names)} ({', '.join(names)})")
    if np.isnan(data).any():
        warnings.warn(f"{path} has null values; check the file or the "
                      f"separator.")
    cols = {name: data[:, i] for i, name in enumerate(names)}
    for key in ("user", "item"):
        cols[key] = cols[key].astype(np.int64)
    return cols


# the strings pandas.read_csv reads as a missing value by default
_NA_STRINGS = ["", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
               "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL",
               "NaN", "None", "n/a", "nan", "null"]


def _typed_column(tokens: np.ndarray) -> np.ndarray:
    """One column's fields typed as pandas types them: int64 when every
    field is an integer, float64 when every field is a number or missing
    (NaN), else an object array of str with NaN where missing."""
    missing = np.isin(tokens, _NA_STRINGS)
    if not missing.any():
        try:
            return tokens.astype(np.int64)
        except (ValueError, OverflowError):
            pass
    try:
        out = np.full(len(tokens), np.nan)
        out[~missing] = tokens[~missing].astype(np.float64)
        return out
    except ValueError:
        out = tokens.astype(object)
        out[missing] = np.nan
        return out


def missing_mask(column: np.ndarray) -> np.ndarray:
    """Where a column of :func:`read_delimited` holds a missing value."""
    if column.dtype.kind == "f":
        return np.isnan(column)
    if column.dtype == object:
        return np.array([isinstance(v, float) for v in column], dtype=bool)
    return np.zeros(len(column), dtype=bool)


def read_delimited(path: str, sep: str, names) -> Dict[str, np.ndarray]:
    """Columns of a headerless ``sep``-delimited file by name, each typed
    as ``pandas.read_csv(path, sep=sep, header=None, names=names)`` types
    it; blank lines are skipped, a short row's missing fields are NaN."""
    with open(path, newline="") as f:
        rows = [line.split(sep) for line in f.read().splitlines() if line]
    width = len(names)
    if any(len(r) > width for r in rows):
        raise ValueError(f"{path}: a row has more than {width} fields "
                         f"({', '.join(names)})")
    cols = [[] for _ in names]
    for r in rows:
        r = r + [""] * (width - len(r))
        for c, field in zip(cols, r):
            c.append(field)
    return {name: _typed_column(np.array(c, dtype=str))
            for name, c in zip(names, cols)}


class PaddedPositives:
    """Per-user positive sets as a device-ready table.

    ``table``: (num_users, max_pos) int32, each row the user's positive items
    sorted ascending, padded with ``pad_id`` (= num_items). ``lengths``:
    (num_users,) int32.
    """

    def __init__(self, table: np.ndarray, lengths: np.ndarray, pad_id: int):
        self.table = table
        self.lengths = lengths
        self.pad_id = pad_id


def _grouped(keys: np.ndarray, *values: np.ndarray):
    """key -> the int32 values of its rows in row order, keys ascending;
    with several value columns, key -> a tuple of them."""
    order = np.argsort(keys, kind="stable")
    uniq, starts = np.unique(keys[order], return_index=True)
    parts = [np.split(v[order].astype(np.int32), starts[1:])
             for v in values]
    if len(values) == 1:
        return OrderedDict((int(k), p) for k, p in zip(uniq, parts[0]))
    return OrderedDict((int(k), tuple(p)) for k, *p in zip(uniq, *parts))


class _Views(dict):
    """A holder's memoised views; ``dirty`` once a view is added (a
    restore through ``update`` does not set it)."""
    dirty = False

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.dirty = True


class ImplicitFeedback:
    """Views over one split of (user, item[, rating, time]) rows, in file
    order."""

    def __init__(self, columns: Optional[Dict[str, np.ndarray]] = None,
                 num_users: Optional[int] = None,
                 num_items: Optional[int] = None):
        cols = columns or {}
        users = cols.get("user", np.zeros(0, np.int64))
        items = cols.get("item", np.zeros(0, np.int64))
        self._users, self._items = users, items
        self._times = cols.get("time")
        self.num_ratings = len(users)
        self.num_users = (num_users if num_users is not None
                          else int(users.max()) + 1 if len(users) else 0)
        self.num_items = (num_items if num_items is not None
                          else int(items.max()) + 1 if len(items) else 0)
        self._views = _Views()

    def __len__(self):
        return self.num_ratings

    def is_empty(self) -> bool:
        return self.num_ratings == 0

    def to_set_of_users(self) -> set:
        """The users with a row."""
        return set(np.unique(self._users).tolist())

    def to_user_item_pairs(self) -> np.ndarray:
        """(num_ratings, 2) int32 (user, item) rows in file order."""
        return np.stack([self._users, self._items], axis=1).astype(np.int32)

    def to_user_dict(self) -> "OrderedDict[int, np.ndarray]":
        """user -> int32 items in file order, users ascending."""
        if "user_dict" not in self._views:
            self._views["user_dict"] = _grouped(self._users, self._items)
        return self._views["user_dict"]

    def _time_order(self) -> np.ndarray:
        """The rows sorted by (user, time), stably: rows of one user at one
        time keep their file order."""
        if self._times is None:
            raise ValueError("This dataset does not contain timestamps.")
        order = np.argsort(self._times, kind="stable")
        return order[np.argsort(self._users[order], kind="stable")]

    def to_user_item_pairs_by_time(self) -> np.ndarray:
        """(num_ratings, 2) int32 (user, item) rows sorted by (user,
        time)."""
        order = self._time_order()
        return np.stack([self._users[order], self._items[order]],
                        axis=1).astype(np.int32)

    def to_user_dict_by_time(self) -> "OrderedDict[int, np.ndarray]":
        """user -> int32 items in time order, users ascending (users without
        rows absent)."""
        if "user_dict_by_time" not in self._views:
            pairs = self.to_user_item_pairs_by_time()
            keys, starts = np.unique(pairs[:, 0], return_index=True)
            self._views["user_dict_by_time"] = OrderedDict(
                (int(u), part) for u, part in
                zip(keys, np.split(pairs[:, 1], starts[1:])))
        return self._views["user_dict_by_time"]

    def to_truncated_seq_dict(self, max_len: Optional[int],
                              pad_value: int = 0, padding: str = "pre",
                              truncating: str = "pre"
                              ) -> "OrderedDict[int, np.ndarray]":
        """user -> the last ``max_len`` items in time order (all of the
        longest sequence's length when None), padded with ``pad_value`` to
        ``max_len``."""
        seq_dict = self.to_user_dict_by_time()
        if max_len is None:
            max_len = max((len(s) for s in seq_dict.values()), default=0)
        seqs = [s[-max_len:] for s in seq_dict.values()]
        padded = pad_sequences(seqs, value=pad_value, max_len=max_len,
                               padding=padding, truncating=truncating,
                               dtype=np.int32)
        return OrderedDict(zip(seq_dict.keys(), padded))

    def to_padded_seq_tensor(self, max_len: int,
                             pad_value: Optional[int] = None
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """(num_users, max_len) int32 sequences of each user's last
        ``max_len`` items in time order, pre-padded with ``pad_value``
        (default num_items), and (num_users,) int32 lengths; a user without
        rows has length 0 and a row of padding."""
        if pad_value is None:
            pad_value = self.num_items
        table = np.full((self.num_users, max_len), pad_value, dtype=np.int32)
        lengths = np.zeros(self.num_users, dtype=np.int32)
        for u, seq in self.to_user_dict_by_time().items():
            tail = seq[-max_len:]
            table[u, max_len - len(tail):] = tail
            lengths[u] = len(tail)
        return table, lengths

    def to_csr_matrix(self) -> sp.csr_matrix:
        """(num_users, num_items) f32 interaction counts: 1.0 a row, a pair
        that repeats summed, as the JAX package builds it. Cached: do not
        modify the returned matrix."""
        if "csr" not in self._views:
            ones = np.ones(self.num_ratings, dtype=np.float32)
            self._views["csr"] = sp.csr_matrix(
                (ones, (self._users, self._items)),
                shape=(self.num_users, self.num_items))
        return self._views["csr"]

    def to_coo_matrix(self) -> sp.coo_matrix:
        """:meth:`to_csr_matrix` as a new COO matrix, entries in row-major
        order."""
        return self.to_csr_matrix().tocoo()

    def to_csc_matrix(self) -> sp.csc_matrix:
        return self.to_csr_matrix().tocsc()

    def to_dok_matrix(self) -> sp.dok_matrix:
        return self.to_csr_matrix().todok()

    def to_item_dict(self) -> "OrderedDict[int, np.ndarray]":
        """item -> int32 users in file order, items ascending."""
        if "item_dict" not in self._views:
            self._views["item_dict"] = _grouped(self._items, self._users)
        return self._views["item_dict"]

    def to_padded_positive_table(self, bucket: int = 32,
                                 max_pos_cap: Optional[int] = None
                                 ) -> PaddedPositives:
        """(num_users, max_pos) table of sorted positive items; ``max_pos``
        rounded up to a multiple of ``bucket``. ``max_pos_cap`` keeps a
        random subsample (``np.random.default_rng(0)``, users ascending) of
        the items of users above it, as the JAX package does."""
        key = ("padded", bucket, max_pos_cap)
        if key in self._views:
            return self._views[key]
        user_dict = self.to_user_dict()
        lengths = np.zeros(self.num_users, dtype=np.int32)
        rows = {}
        rng = np.random.default_rng(0)
        for u, items in user_dict.items():
            if max_pos_cap is not None and len(items) > max_pos_cap:
                items = rng.choice(items, max_pos_cap, replace=False)
            rows[u] = np.sort(items)
            lengths[u] = len(rows[u])
        max_pos = max(1, int(lengths.max()) if len(lengths) else 1)
        max_pos = -(-max_pos // bucket) * bucket
        table = np.full((self.num_users, max_pos), self.num_items,
                        dtype=np.int32)
        if rows:
            users = np.repeat(np.fromiter(rows, np.int64, len(rows)),
                              [len(r) for r in rows.values()])
            cols = np.concatenate([np.arange(len(r)) for r in rows.values()])
            table[users, cols] = np.concatenate(list(rows.values()))
        out = PaddedPositives(table, lengths, pad_id=self.num_items)
        self._views[key] = out
        return out


class KnowledgeGraph:
    """Views over (head, relation, tail) triplets, in row order."""

    def __init__(self, columns: Optional[Dict[str, np.ndarray]] = None,
                 num_entities: Optional[int] = None,
                 num_relations: Optional[int] = None):
        cols = columns or {}
        empty = np.zeros(0, np.int64)
        self._heads = cols.get("head", empty)
        self._relations = cols.get("relation", empty)
        self._tails = cols.get("tail", empty)
        self.num_triplets = len(self._heads)
        if self.num_triplets:
            top = max(np.nanmax(self._heads), np.nanmax(self._tails))
            self.num_entities = (num_entities if num_entities is not None
                                 else int(top) + 1)
            self.num_relations = (num_relations if num_relations is not None
                                  else int(np.nanmax(self._relations)) + 1)
        else:
            self.num_entities = num_entities or 0
            self.num_relations = num_relations or 0
        self._views: Dict = {}

    def is_empty(self) -> bool:
        return self.num_triplets == 0

    def __len__(self):
        return self.num_triplets

    def to_triplets(self) -> np.ndarray:
        """(num_triplets, 3) int32 (head, relation, tail) rows."""
        return np.stack([self._heads, self._relations, self._tails],
                        axis=1).astype(np.int32)

    def _dict(self, by: str, c1: str, c2: str):
        """``by`` value -> {c1: int32, c2: int32} of its rows in row order,
        keys ascending."""
        if by not in self._views:
            col = {"head": self._heads, "relation": self._relations,
                   "tail": self._tails}
            self._views[by] = OrderedDict(
                (k, {c1: a, c2: b}) for k, (a, b) in
                _grouped(col[by], col[c1], col[c2]).items())
        return self._views[by]

    def to_head_dict(self):
        return self._dict("head", "relation", "tail")

    def to_tail_dict(self):
        return self._dict("tail", "relation", "head")

    def to_relation_dict(self):
        return self._dict("relation", "head", "tail")

    def to_csr_matrix_dict(self) -> Dict[int, sp.csr_matrix]:
        """relation -> (num_entities, num_entities) f32 head-by-tail
        counts, relations ascending."""
        if "csr" not in self._views:
            n = self.num_entities
            self._views["csr"] = {
                rel: sp.csr_matrix((np.ones(len(d["head"]), np.float32),
                                    (d["head"], d["tail"])), shape=(n, n))
                for rel, d in self.to_relation_dict().items()}
        return self._views["csr"]

    def to_coo_matrix_dict(self) -> Dict[int, sp.coo_matrix]:
        return {rel: mat.tocoo()
                for rel, mat in self.to_csr_matrix_dict().items()}


class _PersistentCache:
    """The views of a dataset's splits pickled to one file, stale when any
    existing source file is newer (``skrx.io.dataset._PersistentCache``'s
    contract)."""

    def __init__(self, cache_file: str, source_files: List[str]):
        self.cache_file = cache_file
        self.source_files = [f for f in source_files if os.path.exists(f)]

    def _stale(self) -> bool:
        if not os.path.exists(self.cache_file):
            return True
        cached_time = os.path.getmtime(self.cache_file)
        return any(os.path.getmtime(f) > cached_time
                   for f in self.source_files)

    def load_into(self, holders: Dict[str, "ImplicitFeedback"]) -> None:
        if self._stale():
            return
        try:
            with open(self.cache_file, "rb") as f:
                blobs = pickle.load(f)
            for name, holder in holders.items():
                if name in blobs:
                    holder._views.update(blobs[name])
        except Exception as err:  # a corrupt cache is not fatal
            warnings.warn(f"failed to restore data cache: {err}")

    def save_from(self, holders: Dict[str, "ImplicitFeedback"]) -> None:
        # nothing new, or the data were deleted: nothing to keep
        if not any(h._views.dirty for h in holders.values()) or \
                not all(os.path.exists(f) for f in self.source_files):
            return
        try:
            os.makedirs(os.path.dirname(self.cache_file), exist_ok=True)
            blobs = {name: dict(h._views) for name, h in holders.items()}
            # a name of this process's own, so that two processes saving
            # one cache never write one temporary file
            tmp = f"{self.cache_file}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                pickle.dump(blobs, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, self.cache_file)
        except Exception as err:
            warnings.warn(f"failed to persist data cache: {err}")


# one atexit hook per cache file, saving the newest dataset loaded from it
# (a hook per instance would keep every copy alive during a search)
_ATEXIT_CACHES: Dict[str, tuple] = {}


def _save_at_exit(cache_file: str) -> None:
    cache, holders = _ATEXIT_CACHES[cache_file]
    cache.save_from(holders)


class CFData:
    """Load ``<prefix>.{train,valid,test}`` and the id maps; ``.train`` and
    ``.test`` are required, ``.valid`` is optional. With ``use_cache`` the
    splits' views come from ``_data_cache/torch_<name>_cf.pkl`` when it is
    newer than every split file, and the views built meanwhile are saved
    there when the process exits."""

    def __init__(self, data_dir: str, sep: str, columns: str,
                 use_cache: bool = True):
        if columns not in _COLUMN_SETS:
            raise ValueError(f"'columns' must be one of {list(_COLUMN_SETS)}")
        names = _COLUMN_SETS[columns]
        self.data_dir = data_dir
        self.data_name = os.path.basename(os.path.normpath(data_dir))
        prefix = os.path.join(data_dir, self.data_name)

        splits = {}
        for split in ("train", "valid", "test"):
            path = f"{prefix}.{split}"
            if not os.path.isfile(path):
                if split != "valid":
                    raise FileNotFoundError(path)
                splits[split] = {}
                continue
            splits[split] = _read_table(path, sep, names)

        self.user2id, self.id2user = self._read_map_file(prefix + ".user2id",
                                                         sep)
        self.item2id, self.id2item = self._read_map_file(prefix + ".item2id",
                                                         sep)

        # counts from the max id over all splits, as the JAX package does
        present = [c for c in splits.values() if c]
        if not present:
            raise ValueError(f"{data_dir}: no interactions")
        self.num_users = max(int(c["user"].max()) for c in present) + 1
        self.num_items = max(int(c["item"].max()) for c in present) + 1
        self.num_ratings = sum(len(c["user"]) for c in present)
        self.train_data, self.valid_data, self.test_data = (
            ImplicitFeedback(splits[s], self.num_users, self.num_items)
            for s in ("train", "valid", "test"))
        if use_cache:
            cache_file = os.path.join(data_dir, "_data_cache",
                                      f"torch_{self.data_name}_cf.pkl")
            self._cache = _PersistentCache(
                cache_file, [f"{prefix}.{s}" for s in ("train", "valid",
                                                       "test")])
            holders = {"train": self.train_data, "valid": self.valid_data,
                       "test": self.test_data}
            self._cache.load_into(holders)
            if cache_file not in _ATEXIT_CACHES:
                atexit.register(_save_at_exit, cache_file)
            _ATEXIT_CACHES[cache_file] = (self._cache, holders)

    @property
    def statistic_info(self) -> str:
        """The dataset summary a run's log opens with."""
        if 0 in (self.num_users, self.num_items, self.num_ratings):
            return ""
        sparsity = 1.0 - self.num_ratings / (self.num_users * self.num_items)
        return "\n".join([
            "Dataset statistic information:",
            f"Name: {self.data_name}",
            f"Path: {os.path.abspath(self.data_dir)}",
            f"The number of users: {self.num_users}",
            f"The number of items: {self.num_items}",
            f"The number of ratings: {self.num_ratings}",
            f"Average actions of users: {self.num_ratings / self.num_users:.2f}",
            f"Average actions of items: {self.num_ratings / self.num_items:.2f}",
            f"The sparsity of the dataset: {sparsity * 100:.6f}%",
            "",
            f"The number of training: {len(self.train_data)}",
            f"The number of validation: {len(self.valid_data)}",
            f"The number of testing: {len(self.test_data)}"])

    @staticmethod
    def _read_map_file(path: str, sep: str):
        if not os.path.isfile(path):
            return None, None
        fwd, bwd = OrderedDict(), OrderedDict()
        with open(path) as f:
            for line in f:
                raw, idx = line.rstrip("\n").split(sep)
                fwd[raw] = int(idx)
                bwd[int(idx)] = raw
        return fwd, bwd


def _drop_duplicate_rows(cols: Dict[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
    """The rows that repeat no earlier row, in row order (NaN equal to NaN,
    -0.0 to 0.0, as pandas' ``drop_duplicates``)."""
    keys = []
    for c in cols.values():
        if c.dtype == object:
            _, c = np.unique(c.astype(str), return_inverse=True)
        elif c.dtype.kind == "f":
            c = np.where(np.isnan(c), np.nan, c + 0.0).view(np.int64)
        keys.append(c.astype(np.int64))
    if not keys or not len(keys[0]):
        return cols
    _, first = np.unique(np.stack(keys, axis=1), axis=0, return_index=True)
    keep = np.sort(first)
    return {name: c[keep] for name, c in cols.items()}


class KGData:
    """The knowledge graph ``<prefix>.kg``: (head, relation, tail) rows
    with repeated rows dropped (the first kept); warns on missing
    values."""

    def __init__(self, data_dir: str, sep: str):
        data_name = os.path.basename(os.path.normpath(data_dir))
        path = os.path.join(data_dir, data_name + ".kg")
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        cols = _drop_duplicate_rows(
            read_delimited(path, sep, ("head", "relation", "tail")))
        if any(missing_mask(c).any() for c in cols.values()):
            warnings.warn("knowledge graph data has null values; check the "
                          "file or the separator.")
        self.kg_data = KnowledgeGraph(cols)

    @property
    def statistic_info(self) -> str:
        kg = self.kg_data
        return "\n".join(["",
                          f"The number of entities: {kg.num_entities}",
                          f"The number of relations: {kg.num_relations}",
                          f"The number of triplets: {kg.num_triplets}"])


class MMData:
    """Item feature tables ``<prefix>.{img,txt,audio}.npz`` (the first array
    of each file), as the JAX package's ``MMData`` loads them; a missing
    file gives ``None`` features and dimension."""

    def __init__(self, data_dir: str):
        data_name = os.path.basename(os.path.normpath(data_dir))
        prefix = os.path.join(data_dir, data_name)
        self.img_features, self.img_dim = self._load_npz(prefix + ".img.npz")
        self.txt_features, self.txt_dim = self._load_npz(prefix + ".txt.npz")
        self.audio_features, self.audio_dim = self._load_npz(
            prefix + ".audio.npz")

    @staticmethod
    def _load_npz(path: str):
        if not os.path.exists(path):
            return None, None
        with np.load(path, allow_pickle=True) as obj:
            features = obj[obj.files[0]]
        return features, features.shape[-1]

    @property
    def statistic_info(self) -> str:
        lines = [""]
        for name, feats in [("image", self.img_features),
                            ("txt", self.txt_features),
                            ("audio", self.audio_features)]:
            if feats is not None:
                lines.append(f"The shape of {name} features: {feats.shape}")
        return "\n".join(lines)


class SocialNetwork:
    """Placeholder for social-graph views (empty in the JAX package too)."""


class SocialData:
    """Placeholder loader for social data (empty in the JAX package too)."""


class RSDataset:
    """Facade that loads the collaborative-filtering data, the knowledge
    graph (``kg_data``) and the item features (``mm_data``) on first
    use."""

    def __init__(self, data_dir: str, sep: str, columns: str):
        self.data_dir = data_dir
        self.sep = sep
        self.columns = columns
        self.data_name = os.path.basename(os.path.normpath(data_dir))
        self._cf_data = None
        self._kg_data = None
        self._mm_data = None

    @property
    def cf_data(self) -> CFData:
        if self._cf_data is None:
            self._cf_data = CFData(self.data_dir, self.sep, self.columns)
        return self._cf_data

    @property
    def kg_data(self) -> KnowledgeGraph:
        if self._kg_data is None:
            self._kg_data = KGData(self.data_dir, self.sep)
        return self._kg_data.kg_data

    @property
    def social_data(self):
        raise NotImplementedError  # a stub, as in the JAX package

    @property
    def mm_data(self) -> MMData:
        if self._mm_data is None:
            self._mm_data = MMData(self.data_dir)
        return self._mm_data

    train_data = property(lambda self: self.cf_data.train_data)
    valid_data = property(lambda self: self.cf_data.valid_data)
    test_data = property(lambda self: self.cf_data.test_data)
    num_users = property(lambda self: self.cf_data.num_users)
    num_items = property(lambda self: self.cf_data.num_items)
    num_ratings = property(lambda self: self.cf_data.num_ratings)
    num_entities = property(lambda self: self.kg_data.num_entities)
    num_relations = property(lambda self: self.kg_data.num_relations)
    num_triplets = property(lambda self: self.kg_data.num_triplets)
    img_features = property(lambda self: self.mm_data.img_features)
    img_dim = property(lambda self: self.mm_data.img_dim)
    txt_features = property(lambda self: self.mm_data.txt_features)
    txt_dim = property(lambda self: self.mm_data.txt_dim)
    audio_features = property(lambda self: self.mm_data.audio_features)
    audio_dim = property(lambda self: self.mm_data.audio_dim)

    @property
    def statistic_info(self) -> str:
        """The collaborative-filtering summary, and the knowledge graph's
        counts and the feature tables' shapes once they are loaded."""
        info = self.cf_data.statistic_info
        for part in (self._kg_data, self._mm_data):
            if part is not None:
                info += "\n" + part.statistic_info
        return info


class UserGroup:
    """Users of one activity band: ``users`` (int64), their total training
    interactions, the distinct activities (interaction counts) in the band,
    and its label."""

    def __init__(self, users: np.ndarray, num_interactions: int,
                 activities: np.ndarray, label: str):
        self.label = label
        self.users = users
        self.num_users = len(users)
        self.num_interactions = num_interactions
        self.activities = activities


def group_users_by_interactions(dataset: RSDataset, num_groups: int = 4
                                ) -> List[UserGroup]:
    """Split the training users into ``num_groups`` bands of about equal
    total interactions, ordered by activity, as the JAX package does: a
    greedy cut at 1/(groups left) of the remaining interactions, labels
    ``< a``, ``[a, b)``, ``>= b`` (``all`` for one band); within a band,
    users by activity, then in ``to_user_dict`` order."""
    users_by_activity = defaultdict(list)
    for user, items in dataset.train_data.to_user_dict().items():
        users_by_activity[len(items)].append(user)
    activities = np.array(sorted(users_by_activity))
    if len(activities) == 0:
        return []
    n_users = np.array([len(users_by_activity[a]) for a in activities])
    interactions = activities * n_users

    split_points: List[int] = []
    start = 0
    for g in range(num_groups - 1):
        rest = interactions[start:]
        if len(rest) <= 1:
            break
        target = rest.sum() / (num_groups - g)
        cum = np.cumsum(rest)
        idx = max(int(np.searchsorted(cum, target)), 1)
        if idx < len(cum) and target - cum[idx - 1] >= cum[idx] - target:
            idx += 1
        split_points.append(start + idx)
        start += idx

    boundaries = activities[split_points]
    if len(boundaries):
        labels = ([f"< {boundaries[0]}"]
                  + [f"[{lo}, {hi})" for lo, hi in zip(boundaries[:-1],
                                                       boundaries[1:])]
                  + [f">= {boundaries[-1]}"])
    else:
        labels = ["all"]
    groups = []
    for label, chunk in zip(labels, np.split(np.arange(len(activities)),
                                             split_points)):
        users = [u for a in activities[chunk] for u in users_by_activity[a]]
        groups.append(UserGroup(np.array(users), int(interactions[chunk].sum()),
                                activities[chunk], label))
    return groups
