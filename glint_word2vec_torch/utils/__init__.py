"""Small host helpers (own copy of ``glint_word2vec_tpu/utils/__init__.py:7-50``)."""

import json as _json
import os as _os


def atomic_write_json(path: str, obj, **dump_kwargs) -> None:
    """Write JSON via temp file + ``os.replace``: readers see the old file
    or the complete new one, never a truncated document."""
    tmp = f"{path}.tmp.{_os.getpid()}"
    with open(tmp, "w") as f:
        _json.dump(obj, f, **dump_kwargs)
    _os.replace(tmp, path)


def atomic_write_text(path: str, text: str, encoding: str = "utf-8") -> None:
    """Write a text file via temp + ``os.replace`` (same crash contract
    as :func:`atomic_write_json`)."""
    tmp = f"{path}.tmp.{_os.getpid()}"
    with open(tmp, "w", encoding=encoding) as f:
        f.write(text)
    _os.replace(tmp, path)


def atomic_write_npy(path: str, arr) -> None:
    """``np.save`` via temp file + ``os.replace``. Writes through a file
    object so numpy cannot append a second ``.npy`` suffix."""
    import numpy as _np

    tmp = f"{path}.tmp.{_os.getpid()}"
    with open(tmp, "wb") as f:
        _np.save(f, arr)
    _os.replace(tmp, path)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1): the shape bucket the
    query paths pad to, so request sizes map onto a small family."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()
