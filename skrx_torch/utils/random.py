"""Host-side random sampling: the port's own copy of ``skrx.utils.random``.

One seeded ``np.random.Generator`` (``host_rng``, reset by
``set_host_seed``) feeds every host-side draw: these samplers and the
shuffles of ``BatchIterator``. For the same seed they make the same draws
as the JAX package's, in the same order. The training paths sample on the
device instead (``skrx_torch/ops/sampling.py``). There is no native path:
the samplers are numpy only.
"""
from typing import Optional, Sequence

import numpy as np

__all__ = ["randint_choice", "batch_randint_choice", "set_host_seed",
           "host_rng"]

_rng = np.random.default_rng(2020)


def set_host_seed(seed: int) -> None:
    global _rng
    _rng = np.random.default_rng(seed)


def host_rng() -> np.random.Generator:
    """The shared, seeded host generator (rebound by ``set_host_seed``)."""
    return _rng


def randint_choice(high: int, size: int = 1, replace: bool = True,
                   p: Optional[np.ndarray] = None,
                   exclusion: Optional[Sequence[int]] = None) -> np.ndarray:
    """``size`` ints from [0, high) outside ``exclusion`` (int32; a scalar
    when size is 1). With replacement and no ``p``: uniform draws, each
    round redrawing the excluded ones; without replacement or with ``p``:
    one ``choice`` over the allowed ids, ``p`` renormalised over them."""
    if high <= 0:
        raise ValueError("'high' must be a positive integer.")
    if size <= 0:
        raise ValueError("'size' must be a positive integer.")
    excl = (np.asarray(exclusion, dtype=np.int64)
            if exclusion is not None and len(exclusion) else None)

    if not replace or p is not None:
        if excl is not None:
            mask = np.ones(high, dtype=bool)
            mask[excl] = False
            allowed = np.nonzero(mask)[0]
            probs = None
            if p is not None:
                probs = np.asarray(p, dtype=np.float64)[allowed]
                probs = probs / probs.sum()
            result = _rng.choice(allowed, size=size, replace=replace, p=probs)
        else:
            probs = None
            if p is not None:
                probs = np.asarray(p, dtype=np.float64)
                probs = probs / probs.sum()
            result = _rng.choice(high, size=size, replace=replace, p=probs)
        return result.astype(np.int32) if size > 1 else np.int32(result)

    if excl is None:
        out = _rng.integers(0, high, size=size)
    else:
        excl_sorted = np.unique(excl)
        if len(excl_sorted) >= high:
            raise ValueError("exclusion covers the whole range")
        out = _rng.integers(0, high, size=size)
        while True:
            pos = np.minimum(np.searchsorted(excl_sorted, out),
                             len(excl_sorted) - 1)
            bad = excl_sorted[pos] == out
            n_bad = int(bad.sum())
            if n_bad == 0:
                break
            out[bad] = _rng.integers(0, high, size=n_bad)
    out = out.astype(np.int32)
    return out if size > 1 else np.int32(out[0])


def batch_randint_choice(high: int, size: Sequence[int],
                         replace: bool = True,
                         p: Optional[np.ndarray] = None,
                         exclusion: Optional[Sequence[Sequence[int]]] = None
                         ) -> list:
    """``randint_choice`` once per row: ``size[i]`` draws outside
    ``exclusion[i]``."""
    if exclusion is not None and len(exclusion) != len(size):
        raise ValueError("len(exclusion) must equal len(size)")
    return [randint_choice(high, size=int(n), replace=replace, p=p,
                           exclusion=None if exclusion is None
                           else exclusion[i])
            for i, n in enumerate(size)]
