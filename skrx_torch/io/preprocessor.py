"""Offline dataset preprocessing, numpy-only: the port of
``skrx.io.preprocessor``.

load → drop duplicates → filter → remap → split → save, into
``<dir>/<name>_<split>_u<user_min>_i<item_min>/`` with the files
``.all/.train/.valid/.test/.user2id/.item2id/.info`` that the JAX package
writes, byte for byte. The data are columns (``user``, ``item``[,
``rating``][, ``time``]) typed as ``pandas.read_csv`` types them (see
``read_delimited``), and each column is written as pandas writes its type:
an int64 column as ints, a float64 column as ``repr`` of each value (a
column that held a missing value before ``dropna`` stays float), a str
column as is. Sorts are stable; ids are remapped in the order of first
appearance. The by-random splits draw ``np.random.permutation`` from
numpy's global state.
"""
import math
import os
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from ..utils.logger import Logger
from .dataset import missing_mask, read_delimited

__all__ = ["Preprocessor"]

_USER, _ITEM, _RATING, _TIME = "user", "item", "rating", "time"

_COLUMN_DICT = {"UI": [_USER, _ITEM],
                "UIR": [_USER, _ITEM, _RATING],
                "UIT": [_USER, _ITEM, _TIME],
                "UIRT": [_USER, _ITEM, _RATING, _TIME]}

_Columns = Dict[str, np.ndarray]


def _take(cols: _Columns, index) -> _Columns:
    return {k: v[index] for k, v in cols.items()}


def _stable_order(*keys: np.ndarray) -> np.ndarray:
    """The row order sorted by ``keys`` (the first the primary), stable."""
    order = np.arange(len(keys[0]))
    for key in reversed(keys):
        order = order[np.argsort(key[order], kind="stable")]
    return order


def _group_sizes(keys: np.ndarray) -> np.ndarray:
    """Each row's count of rows with its key."""
    _, inverse, counts = np.unique(keys, return_inverse=True,
                                   return_counts=True)
    return counts[inverse.reshape(-1)]


def _first_appearance(values: np.ndarray) -> np.ndarray:
    """The distinct values in the order they first appear."""
    _, first = np.unique(values, return_index=True)
    return values[np.sort(first)]


def _format(column: np.ndarray) -> np.ndarray:
    """A column's fields as pandas' ``to_csv`` writes them."""
    if column.dtype.kind == "f":
        return np.array([repr(float(v)) for v in column], dtype=object)
    return column.astype(str).astype(object)


def _write(path: str, columns, sep: str = "\t") -> None:
    fields = [_format(c) for c in columns]
    with open(path, "w", newline="") as f:
        f.write("".join(sep.join(row) + "\n" for row in zip(*fields)))


class Preprocessor:
    def __init__(self):
        self._config: "OrderedDict[str, str]" = OrderedDict()
        self._column_name = None
        self.all_data: Optional[_Columns] = None
        self.train_data: Optional[_Columns] = None
        self.valid_data: Optional[_Columns] = None
        self.test_data: Optional[_Columns] = None
        # (raw ids in order of first appearance, their new ids)
        self.user2id = None
        self.item2id = None
        self._dir_path: Optional[str] = None
        self._data_name = ""
        self._split_manner = ""
        self._user_min = 0
        self._item_min = 0

    # ---- load ----

    def load_data(self, filename: str, sep: str = ",", columns: str = None):
        """Read a headerless file; rows with a missing field are dropped."""
        if not os.path.isfile(filename):
            raise FileNotFoundError(f"There is no file named '{filename}'.")
        if columns not in _COLUMN_DICT:
            raise ValueError(f"'columns' must be one of {list(_COLUMN_DICT)}.")
        self._column_name = _COLUMN_DICT[columns]
        self._config["columns"] = columns
        self._config["filename"] = filename
        self._config["sep"] = sep
        cols = read_delimited(filename, sep, self._column_name)
        missing = np.logical_or.reduce([missing_mask(c)
                                        for c in cols.values()])
        self.all_data = _take(cols, ~missing)
        self._data_name = os.path.basename(filename).split(".")[0]
        self._dir_path = os.path.dirname(filename)

    def load_arrays(self, columns_dict: Dict[str, np.ndarray], columns: str,
                    name: str = "data", dir_path: str = "."):
        """Start from in-memory columns: ``columns_dict`` holds one array a
        column, in the order of ``columns``."""
        if columns not in _COLUMN_DICT:
            raise ValueError(f"'columns' must be one of {list(_COLUMN_DICT)}.")
        self._column_name = _COLUMN_DICT[columns]
        self._config["columns"] = columns
        arrays = list(columns_dict.values())
        if len(arrays) != len(self._column_name):
            raise ValueError(f"{len(arrays)} arrays for the columns "
                             f"{self._column_name}")
        self.all_data = {name_: np.array(a) for name_, a in
                         zip(self._column_name, arrays)}
        self._data_name = name
        self._dir_path = dir_path

    def load_dataframe(self, df, columns: str, name: str = "data",
                       dir_path: str = "."):
        """Start from an in-memory frame: any object with ``columns`` (or a
        mapping's keys) whose ``df[column]`` gives an array, such as a
        pandas DataFrame or a dict of arrays. Its columns are taken in order
        and named by ``columns``, as the JAX package renames them."""
        names = list(df.columns) if hasattr(df, "columns") else list(df)
        self.load_arrays({str(i): np.asarray(df[c]) for i, c in
                          enumerate(names)}, columns, name, dir_path)

    # ---- clean ----

    def drop_duplicates(self, keep: str = "last"):
        """Sort by (user, time), or (user, item) without times, and keep
        one row of each (user, item) pair, the first or the last."""
        if keep not in ("first", "last"):
            raise ValueError(f"'keep' must be 'first' or 'last', got {keep!r}")
        second = _TIME if _TIME in self._column_name else _ITEM
        data = _take(self.all_data, _stable_order(self.all_data[_USER],
                                                  self.all_data[second]))
        pair = _stable_order(data[_USER], data[_ITEM])
        u, i = data[_USER][pair], data[_ITEM][pair]
        new = np.ones(len(pair), dtype=bool)
        new[1:] = (u[1:] != u[:-1]) | (i[1:] != i[:-1])
        # within a run of one pair the rows keep their order
        if keep == "first":
            kept = pair[new]
        else:
            last = np.ones(len(pair), dtype=bool)
            last[:-1] = new[1:]
            kept = pair[last]
        self.all_data = _take(data, np.sort(kept))

    def filter_data(self, user_min: int = 0, item_min: int = 0):
        """Drop cold items, then cold users, until neither drops a row."""
        while True:
            before = len(self.all_data[_USER])
            self.filter_item(item_min)
            self.filter_user(user_min)
            if len(self.all_data[_USER]) == before:
                break

    def filter_user(self, user_min: int = 0):
        self._config["user_min"] = str(user_min)
        self._user_min = user_min
        if user_min > 0:
            self.all_data = _take(self.all_data,
                                  _group_sizes(self.all_data[_USER])
                                  >= user_min)

    def filter_item(self, item_min: int = 0):
        self._config["item_min"] = str(item_min)
        self._item_min = item_min
        if item_min > 0:
            self.all_data = _take(self.all_data,
                                  _group_sizes(self.all_data[_ITEM])
                                  >= item_min)

    # ---- remap ----

    def remap_data_id(self):
        self.remap_user_id()
        self.remap_item_id()

    def _remap(self, column: str):
        raw = _first_appearance(self.all_data[column])
        sorted_raw = np.argsort(raw, kind="stable")
        pos = np.searchsorted(raw[sorted_raw], self.all_data[column])
        self.all_data[column] = sorted_raw[pos].astype(np.int64)
        return raw, np.arange(len(raw), dtype=np.int64)

    def remap_user_id(self):
        self._config["remap_user_id"] = "True"
        self.user2id = self._remap(_USER)

    def remap_item_id(self):
        self._config["remap_item_id"] = "True"
        self.item2id = self._remap(_ITEM)

    # ---- split ----

    def _sorted_with_rank(self, by_time: bool):
        """The rows sorted within each user (by time, by item without
        times, or at random), with each row's rank in its user and its
        user's size."""
        data = self.all_data
        if by_time and _TIME in self._column_name:
            order = _stable_order(data[_USER], data[_TIME])
        elif by_time:
            order = _stable_order(data[_USER], data[_ITEM])
        else:
            shuffle_key = np.random.permutation(len(data[_USER]))
            order = _stable_order(data[_USER], shuffle_key)
        data = _take(data, order)
        users = data[_USER]
        start = np.ones(len(users), dtype=bool)
        start[1:] = users[1:] != users[:-1]
        first = np.maximum.accumulate(np.where(start, np.arange(len(users)),
                                               0))
        rank = np.arange(len(users)) - first
        return data, rank, _group_sizes(users)

    def _split(self, train_end, valid_end, valid, by_time) -> None:
        data, rank, size = self._sorted_with_rank(by_time)
        train_end, valid_end = train_end(size), valid_end(size)
        self.train_data = _take(data, rank < train_end)
        self.valid_data = (_take(data, (rank >= train_end)
                                 & (rank < valid_end))
                           if valid != 0 else None)
        self.test_data = _take(data, rank >= valid_end)

    def split_data_by_ratio(self, train: float = 0.7, valid: float = 0.1,
                            test: float = 0.2, by_time: bool = True):
        if train <= 0.0:
            raise ValueError("'train' must be a positive value.")
        if not math.isclose(train + valid + test, 1.0, abs_tol=1e-9):
            raise ValueError("The sum of 'train', 'valid' and 'test' must "
                             "be 1.0.")
        self._config.update(split_by="ratio", train=str(train),
                            valid=str(valid), test=str(test),
                            by_time=str(by_time))
        self._split_manner = "ratio_" + ("by_time" if by_time
                                         else "by_random")
        self._split(lambda n: np.ceil(train * n),
                    lambda n: np.ceil(train * n) + np.ceil(valid * n),
                    valid, by_time)

    def split_data_by_leave_out(self, valid: int = 1, test: int = 1,
                                by_time: bool = True):
        self._config.update(split_by="leave_out", valid=str(valid),
                            test=str(test), by_time=str(by_time))
        self._split_manner = "leave_" + ("by_time" if by_time
                                         else "by_random")
        self._split(lambda n: n - (valid + test), lambda n: n - test,
                    valid, by_time)

    # ---- save ----

    def save_data(self, save_dir: Optional[str] = None) -> str:
        dir_path = save_dir if save_dir is not None else self._dir_path
        name = (f"{self._data_name}_{self._split_manner}_u{self._user_min}"
                f"_i{self._item_min}")
        dir_path = os.path.join(dir_path, name)
        os.makedirs(dir_path, exist_ok=True)
        prefix = os.path.join(dir_path, name)

        for suffix, data in [(".all", self.all_data),
                             (".train", self.train_data),
                             (".valid", self.valid_data),
                             (".test", self.test_data)]:
            if data is not None:
                _write(prefix + suffix, data.values())
        for suffix, ids in ((".user2id", self.user2id),
                            (".item2id", self.item2id)):
            if ids is not None:
                _write(prefix + suffix, ids)

        user_num = len(np.unique(self.all_data[_USER]))
        item_num = len(np.unique(self.all_data[_ITEM]))
        rating_num = len(self.all_data[_USER])
        sparsity = 1.0 - rating_num / (user_num * item_num)

        logger = Logger(prefix + ".info")
        logger.info("\n" + "\n".join(f"{k} = {v}"
                                     for k, v in self._config.items()))
        logger.info("Dataset statistic information:")
        logger.info(f"The number of users: {user_num}")
        logger.info(f"The number of items: {item_num}")
        logger.info(f"The number of ratings: {rating_num}")
        logger.info(f"Average actions of users: {rating_num / user_num:.2f}")
        logger.info(f"Average actions of items: {rating_num / item_num:.2f}")
        logger.info(f"The sparsity of the dataset: {sparsity * 100:.6f}%")
        return dir_path
