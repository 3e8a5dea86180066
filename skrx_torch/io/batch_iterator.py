"""Minibatches over aligned host arrays: the port's own copy of
``skrx.io.batch_iterator``."""
from typing import Optional

import numpy as np

from ..utils.random import host_rng

__all__ = ["BatchIterator"]


class BatchIterator:
    """Zip equal-length arrays into minibatches: each batch a tuple of
    slices (one slice when one array was given). ``shuffle`` draws a new
    permutation at every ``__iter__``, from ``rng`` or, when None, from the
    shared host generator (``skrx_torch.utils.random.host_rng``) as it is
    at that moment; ``drop_last`` drops the last incomplete batch."""

    def __init__(self, *arrays, batch_size: int = 1024,
                 shuffle: bool = False, drop_last: bool = False,
                 rng: Optional[np.random.Generator] = None):
        if not arrays:
            raise ValueError("at least one array is required")
        lengths = {len(a) for a in arrays}
        if len(lengths) != 1:
            raise ValueError(f"all arrays must have equal length, got "
                             f"{lengths}")
        self._arrays = [np.asarray(a) for a in arrays]
        self._n = len(self._arrays[0])
        self.batch_size = int(batch_size)
        if self.batch_size <= 0:
            raise ValueError("'batch_size' must be a positive integer")
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = rng

    def __len__(self):
        if self.drop_last:
            return self._n // self.batch_size
        return (self._n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        arrays = self._arrays
        if self.shuffle:
            rng = self._rng if self._rng is not None else host_rng()
            order = rng.permutation(self._n)
            arrays = [a[order] for a in arrays]
        for b in range(len(self)):
            lo = b * self.batch_size
            batch = tuple(a[lo:lo + self.batch_size] for a in arrays)
            yield batch[0] if len(batch) == 1 else batch
