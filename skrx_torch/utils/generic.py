"""Small helpers (the port's own copy of the part of
``skrx.utils.generic`` it uses)."""
import re
import unicodedata
from typing import Optional, Sequence

import numpy as np

__all__ = ["slugify", "pad_sequences"]

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
