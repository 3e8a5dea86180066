"""Host-side epoch iterators over training examples: the port of
``skrx.io.data_iterator``.

The eight iterators yield numpy batches of the JAX package's tuple shapes
and dtypes, and draw their negatives anew at every ``__iter__`` (every
epoch) from the shared host generator (``skrx_torch.utils.random``), users
in ``to_user_dict`` order, then shuffle through :class:`BatchIterator`: for
the same seed they yield the same batches as the JAX package's. The
training paths run on the device instead (``skrx_torch/models/pipeline.py``,
whose sequential pipeline uses ``_generate_time_order_positive_items``).
"""
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils.random import randint_choice
from .batch_iterator import BatchIterator
from .dataset import ImplicitFeedback, KnowledgeGraph

__all__ = ["InteractionIterator", "PointwiseIterator", "PairwiseIterator",
           "SequentialPointwiseIterator", "SequentialPairwiseIterator",
           "UserVecIterator", "ItemVecIterator", "KGPairwiseIterator",
           "_generate_positive_items", "_generate_time_order_positive_items",
           "_sampling_negative_items"]


class _Iterator:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def _num_batches(self, n_sample: int) -> int:
        if self.drop_last:
            return n_sample // self.batch_size
        return (n_sample + self.batch_size - 1) // self.batch_size


def _generate_positive_items(user_pos_dict: Dict[int, np.ndarray]
                             ) -> Tuple["OrderedDict[int, int]", np.ndarray,
                                        np.ndarray]:
    """``(positives per user, users, items)``: the dict flattened into
    aligned int32 arrays, users in the dict's order."""
    if not user_pos_dict:
        raise ValueError("'user_pos_dict' cannot be empty.")
    user_n_pos = OrderedDict((u, len(items))
                             for u, items in user_pos_dict.items())
    users = np.repeat(np.fromiter(user_n_pos, np.int64, len(user_n_pos)),
                      list(user_n_pos.values())).astype(np.int32)
    items = np.concatenate([np.asarray(i, dtype=np.int32)
                            for i in user_pos_dict.values()])
    return user_n_pos, users, items


def _generate_time_order_positive_items(
        user_pos_dict: Dict[int, np.ndarray], num_previous: int = 1,
        num_next: int = 1, pad: Optional[int] = None
        ) -> Tuple["OrderedDict[int, int]", np.ndarray, np.ndarray,
                   np.ndarray]:
    """Each user's sequence (in time order) cut into (context, next)
    examples: for every prefix, longest first, its last ``num_previous``
    items as the context and the ``num_next`` after them as the targets.
    Without ``pad`` only full windows of ``num_previous + num_next`` items
    are kept; with ``pad``, every prefix longer than ``num_next``, and the
    windows are pre-padded with ``pad`` when the window is longer than 2.

    Returns ``(examples per user, users (E,), prev (E, num_previous),
    next (E, num_next))``, int32, users in the dict's order."""
    if not user_pos_dict:
        raise ValueError("'user_pos_dict' cannot be empty.")
    if num_previous < 1 or num_next < 1:
        raise ValueError("num_previous and num_next must be >= 1")
    tot_len = num_previous + num_next
    # the shortest prefix kept; with a pad and a window of 2, the windows
    # are full anyway (prefixes of more than num_next = 1 items)
    shortest = num_next + 1 if pad is not None else tot_len
    user_ids = np.fromiter(user_pos_dict, np.int64, len(user_pos_dict))
    lengths = np.array([len(s) for s in user_pos_dict.values()], np.int64)
    flat = np.concatenate([np.asarray(s, np.int64)
                           for s in user_pos_dict.values()])
    starts = np.cumsum(lengths) - lengths
    counts = np.maximum(lengths - shortest + 1, 0)
    ex_user = np.repeat(np.arange(len(lengths)), counts)
    # the examples of a user: prefix ends length, length - 1, ...
    first = np.cumsum(counts) - counts
    ends = lengths[ex_user] - (np.arange(int(counts.sum()))
                               - first[ex_user])
    pos = (starts[ex_user] + ends)[:, None] + np.arange(-tot_len, 0)
    inside = pos >= starts[ex_user][:, None]
    fill = pad if pad is not None else 0
    seqs = np.where(inside, flat[np.where(inside, pos, 0)],
                    fill).astype(np.int32)
    per_user = OrderedDict((int(u), int(c)) for u, c in zip(user_ids, counts)
                           if c)
    return (per_user, user_ids[ex_user].astype(np.int32),
            seqs[:, :num_previous], seqs[:, num_previous:])


def _sampling_negative_items(user_n_pos: "OrderedDict[int, int]",
                             num_neg: int, num_items: int,
                             user_pos_dict: Dict[int, np.ndarray]
                             ) -> np.ndarray:
    """``num_neg`` uniform negatives per positive of each user, none of
    them among the user's positives, users in ``user_n_pos`` order; (P,)
    for one a positive, else (P, num_neg); int32."""
    if num_neg <= 0:
        raise ValueError("'num_neg' must be a positive integer.")
    out = []
    for user, n_pos in user_n_pos.items():
        neg = np.atleast_1d(np.asarray(
            randint_choice(num_items, size=n_pos * num_neg,
                           exclusion=user_pos_dict[user]), dtype=np.int32))
        out.append(neg.reshape([n_pos, num_neg]) if num_neg > 1 else neg)
    return np.concatenate(out)


class InteractionIterator(_Iterator):
    """Yields (users, items), no negatives."""

    def __init__(self, dataset: ImplicitFeedback, batch_size: int = 1024,
                 shuffle: bool = True, drop_last: bool = False):
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        ui_pairs = dataset.to_user_item_pairs()
        self.users = ui_pairs[:, 0]
        self.pos_items = ui_pairs[:, 1]

    def __len__(self):
        return self._num_batches(len(self.users))

    def __iter__(self):
        yield from BatchIterator(self.users, self.pos_items,
                                 batch_size=self.batch_size,
                                 shuffle=self.shuffle,
                                 drop_last=self.drop_last)


class PointwiseIterator(_Iterator):
    """Yields (users, items, labels): every positive with label 1, then
    ``num_neg`` negatives of each with label 0 (f32)."""

    def __init__(self, dataset: ImplicitFeedback, num_neg: int = 1,
                 batch_size: int = 1024, shuffle: bool = True,
                 drop_last: bool = False):
        if num_neg <= 0:
            raise ValueError("'num_neg' must be a positive integer.")
        self.num_neg = num_neg
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_items = dataset.num_items
        self.user_pos_dict = dataset.to_user_dict()
        self.user_n_pos, users_ary, self.pos_items = \
            _generate_positive_items(self.user_pos_dict)
        self.all_users = np.tile(users_ary, num_neg + 1)
        n_pos = len(self.pos_items)
        self.all_labels = np.concatenate([
            np.ones(n_pos, dtype=np.float32),
            np.zeros(n_pos * num_neg, dtype=np.float32)])

    def __len__(self):
        return self._num_batches(len(self.all_users))

    def __iter__(self):
        neg = _sampling_negative_items(self.user_n_pos, self.num_neg,
                                       self.num_items, self.user_pos_dict)
        neg = neg.reshape([-1, self.num_neg]).transpose().reshape([-1])
        yield from BatchIterator(self.all_users,
                                 np.concatenate([self.pos_items, neg]),
                                 self.all_labels, batch_size=self.batch_size,
                                 shuffle=self.shuffle,
                                 drop_last=self.drop_last)


class PairwiseIterator(_Iterator):
    """Yields (users, pos_items, neg_items); neg_items (B, num_neg) when
    num_neg > 1."""

    def __init__(self, dataset: ImplicitFeedback, num_neg: int = 1,
                 batch_size: int = 1024, shuffle: bool = True,
                 drop_last: bool = False):
        if num_neg <= 0:
            raise ValueError("'num_neg' must be a positive integer.")
        self.num_neg = num_neg
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_items = dataset.num_items
        self.user_pos_dict = dataset.to_user_dict()
        self.user_n_pos, self.all_users, self.pos_items = \
            _generate_positive_items(self.user_pos_dict)

    def __len__(self):
        return self._num_batches(len(self.all_users))

    def __iter__(self):
        neg = _sampling_negative_items(self.user_n_pos, self.num_neg,
                                       self.num_items, self.user_pos_dict)
        yield from BatchIterator(self.all_users, self.pos_items, neg,
                                 batch_size=self.batch_size,
                                 shuffle=self.shuffle,
                                 drop_last=self.drop_last)


class SequentialPointwiseIterator(_Iterator):
    """Yields (users, item_seqs, next_items, labels) over the time-ordered
    (context, next) examples: the positives with label 1, then
    ``num_neg`` negative next items of each with label 0."""

    def __init__(self, dataset: ImplicitFeedback, num_previous: int = 1,
                 num_next: int = 1, num_neg: int = 1,
                 pad: Optional[int] = None, batch_size: int = 1024,
                 shuffle: bool = True, drop_last: bool = False):
        if num_previous < 1 or num_next < 1 or num_neg < 1:
            raise ValueError("num_previous, num_next and num_neg must be "
                             ">= 1")
        self.num_previous = num_previous
        self.num_next = num_next
        self.num_neg = num_neg
        self.pad = pad
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_items = dataset.num_items
        self.user_pos_dict = dataset.to_user_dict_by_time()
        self.user_n_pos, users_ary, item_seqs, self.pos_next_items = \
            _generate_time_order_positive_items(self.user_pos_dict,
                                                num_previous, num_next, pad)
        self.all_users = np.tile(users_ary, num_neg + 1)
        self.all_item_seqs = np.tile(item_seqs, [num_neg + 1, 1]).squeeze()
        len_pos = len(self.pos_next_items)
        self.all_labels = np.concatenate([
            np.ones([len_pos, num_next], dtype=np.float32),
            np.zeros([len_pos * num_neg, num_next], dtype=np.float32)
        ]).squeeze()

    def __len__(self):
        return self._num_batches(len(self.all_users))

    def __iter__(self):
        neg = _sampling_negative_items(self.user_n_pos,
                                       self.num_neg * self.num_next,
                                       self.num_items, self.user_pos_dict)
        neg = neg.reshape([-1, self.num_neg * self.num_next])
        neg = np.concatenate(np.split(neg, self.num_neg, axis=-1), axis=0)
        all_next = np.concatenate([self.pos_next_items, neg]).squeeze()
        yield from BatchIterator(self.all_users, self.all_item_seqs,
                                 all_next, self.all_labels,
                                 batch_size=self.batch_size,
                                 shuffle=self.shuffle,
                                 drop_last=self.drop_last)


class SequentialPairwiseIterator(_Iterator):
    """Yields (users, item_seqs, pos_next, neg_next) over the time-ordered
    (context, next) examples."""

    def __init__(self, dataset: ImplicitFeedback, num_previous: int = 1,
                 num_next: int = 1, pad: Optional[int] = None,
                 batch_size: int = 1024, shuffle: bool = True,
                 drop_last: bool = False):
        if num_previous < 1 or num_next < 1:
            raise ValueError("num_previous and num_next must be >= 1")
        self.num_previous = num_previous
        self.num_next = num_next
        self.pad = pad
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_items = dataset.num_items
        self.user_pos_dict = dataset.to_user_dict_by_time()
        self.user_n_pos, self.all_users, item_seqs, pos_next = \
            _generate_time_order_positive_items(self.user_pos_dict,
                                                num_previous, num_next, pad)
        self.all_item_seqs = item_seqs.squeeze()
        self.pos_next_items = pos_next.squeeze()

    def __len__(self):
        return self._num_batches(len(self.all_users))

    def __iter__(self):
        neg = _sampling_negative_items(self.user_n_pos, self.num_next,
                                       self.num_items, self.user_pos_dict)
        if self.num_next > 1:
            neg = neg.reshape([-1, self.num_next])
        yield from BatchIterator(self.all_users, self.all_item_seqs,
                                 self.pos_next_items, neg.squeeze(),
                                 batch_size=self.batch_size,
                                 shuffle=self.shuffle,
                                 drop_last=self.drop_last)


class UserVecIterator(_Iterator):
    """Yields dense (B, num_items) f32 rows of users' interactions."""

    def __init__(self, dataset: ImplicitFeedback, batch_size: int = 1024,
                 shuffle: bool = True, drop_last: bool = False):
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.user_csr_matrix = dataset.to_csr_matrix()
        self.user_iter = BatchIterator(
            np.arange(dataset.num_users, dtype=np.int32),
            batch_size=batch_size, shuffle=shuffle, drop_last=drop_last)

    def __len__(self):
        return len(self.user_iter)

    def __iter__(self):
        for users in self.user_iter:
            yield self.user_csr_matrix[users].toarray()


class ItemVecIterator(_Iterator):
    """Yields dense (B, num_users) f32 rows of items' interactions."""

    def __init__(self, dataset: ImplicitFeedback, batch_size: int = 1024,
                 shuffle: bool = True, drop_last: bool = False):
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.item_csr_matrix = dataset.to_csr_matrix().transpose().tocsr()
        self.item_iter = BatchIterator(
            np.arange(dataset.num_items, dtype=np.int32),
            batch_size=batch_size, shuffle=shuffle, drop_last=drop_last)

    def __len__(self):
        return len(self.item_iter)

    def __iter__(self):
        for items in self.item_iter:
            yield self.item_csr_matrix[items].toarray()


class KGPairwiseIterator(_Iterator):
    """Yields (heads, relations, pos_tails, neg_tails): each triplet with
    ``num_neg`` entities that are no tail of its head."""

    def __init__(self, dataset: KnowledgeGraph, num_neg: int = 1,
                 batch_size: int = 1024, shuffle: bool = True,
                 drop_last: bool = False):
        if num_neg <= 0:
            raise ValueError("'num_neg' must be a positive integer.")
        self.num_neg = num_neg
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_entities = dataset.num_entities
        self.head_pos_dict = dataset.to_head_dict()
        self.head_n_pos = OrderedDict(
            (h, len(rt["tail"])) for h, rt in self.head_pos_dict.items())
        self.all_heads = np.repeat(
            np.fromiter(self.head_n_pos, np.int64, len(self.head_n_pos)),
            list(self.head_n_pos.values())).astype(np.int32)
        self.relations = np.concatenate(
            [rt["relation"] for rt in self.head_pos_dict.values()])
        self.pos_tails = np.concatenate(
            [rt["tail"] for rt in self.head_pos_dict.values()])

    def __len__(self):
        return self._num_batches(len(self.all_heads))

    def __iter__(self):
        tails = OrderedDict((h, rt["tail"])
                            for h, rt in self.head_pos_dict.items())
        neg_tails = _sampling_negative_items(self.head_n_pos, self.num_neg,
                                             self.num_entities, tails)
        yield from BatchIterator(self.all_heads, self.relations,
                                 self.pos_tails, neg_tails,
                                 batch_size=self.batch_size,
                                 shuffle=self.shuffle,
                                 drop_last=self.drop_last)
