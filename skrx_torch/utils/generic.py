"""Small host-side helpers: the port's own copy of
``skrx.utils.generic``."""
import hashlib
import re
import unicodedata
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np

__all__ = ["OrderedDefaultDict", "md5sum", "pad_sequences", "slugify"]


class OrderedDefaultDict(OrderedDict):
    """An OrderedDict with defaultdict semantics (insertion order kept)."""

    def __init__(self, default_factory=None, *args, **kwargs):
        if default_factory is not None and not callable(default_factory):
            raise TypeError("first argument must be callable or None")
        super().__init__(*args, **kwargs)
        self.default_factory = default_factory

    def __missing__(self, key):
        if self.default_factory is None:
            raise KeyError(key)
        self[key] = value = self.default_factory()
        return value

    def __reduce__(self):
        args = ((self.default_factory,) if self.default_factory is not None
                else ())
        return self.__class__, args, None, None, iter(self.items())


def md5sum(file_path: str, chunk_size: int = 1 << 20) -> str:
    """The MD5 hex digest of a file, read in chunks."""
    digest = hashlib.md5()
    with open(file_path, "rb") as f:
        for chunk in iter(lambda: f.read(chunk_size), b""):
            digest.update(chunk)
    return digest.hexdigest()

_SLUG_BAD = re.compile(r"[^\w\s\-\.\@\[\]\(\),=]")
_SLUG_WS = re.compile(r"[\s]+")


def slugify(text: str, separator: str = "_", max_len: int = 255) -> str:
    """Sanitize a string into a filesystem-safe run-id slug."""
    text = unicodedata.normalize("NFKD", str(text))
    text = _SLUG_BAD.sub("", text).strip()
    text = _SLUG_WS.sub(separator, text)
    return text[:max_len]


def pad_sequences(sequences: Sequence[Sequence[int]], value: float = 0.0,
                  max_len: Optional[int] = None, padding: str = "post",
                  truncating: str = "post", dtype=np.int32) -> np.ndarray:
    """Variable-length sequences as one dense (len, max_len) array:
    ``padding`` and ``truncating`` ("pre" or "post") choose the end that is
    padded with ``value`` and the end that is cut; ``max_len`` defaults to
    the longest sequence."""
    if padding not in ("pre", "post"):
        raise ValueError(f"'padding' must be 'pre' or 'post', got {padding!r}")
    if truncating not in ("pre", "post"):
        raise ValueError(f"'truncating' must be 'pre' or 'post', got "
                         f"{truncating!r}")
    seqs = [np.asarray(s) for s in sequences]
    if max_len is None:
        max_len = max((len(s) for s in seqs), default=0)
    out = np.full((len(seqs), max_len), value, dtype=dtype)
    for i, s in enumerate(seqs):
        if len(s) == 0:
            continue
        trunc = s[-max_len:] if truncating == "pre" else s[:max_len]
        if padding == "post":
            out[i, :len(trunc)] = trunc
        else:
            out[i, max_len - len(trunc):] = trunc
    return out
