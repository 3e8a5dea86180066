"""Small helpers (the port's own copy of the part of
``skrx.utils.generic`` it uses)."""
import re
import unicodedata

__all__ = ["slugify"]

_SLUG_BAD = re.compile(r"[^\w\s\-\.\@\[\]\(\),=]")
_SLUG_WS = re.compile(r"[\s]+")


def slugify(text: str, separator: str = "_", max_len: int = 255) -> str:
    """Sanitize a string into a filesystem-safe run-id slug."""
    text = unicodedata.normalize("NFKD", str(text))
    text = _SLUG_BAD.sub("", text).strip()
    text = _SLUG_WS.sub(separator, text)
    return text[:max_len]
