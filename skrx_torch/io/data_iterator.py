"""Training examples from time-ordered sequences: the part of
``skrx.io.data_iterator`` that the sequential epoch pipeline uses
(``_generate_time_order_positive_items``). The host iterators of that
module are not ported yet (ROADMAP.md, Queue 1)."""
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["_generate_time_order_positive_items"]


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
