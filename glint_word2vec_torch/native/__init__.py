"""The native host pass of the port: ``host_ops.cpp`` loaded with ctypes
(the port's own copy of ``glint_word2vec_tpu/native/__init__.py``).

Four wrappers, each returning None when the library is unavailable, so
that its caller runs the Python pass instead:

- :func:`alias_build_native`: the alias table (``corpus/alias.py``);
- :func:`window_batch_epoch_native`: an epoch's subsample and window rows
  (``corpus/batching.py``);
- :func:`corpus_scan_native`: ``fit_file``'s vocabulary and flat encode
  (``corpus/vocab.py``);
- :func:`ann_place_spills_native`: the ANN build's spill placement
  (``ops/ann.py``), which runs with the interpreter lock released.

The library is built with ``g++`` on first use, never at import
(``kernels/build.native_library``, into the gitignored ``_build/``).
Without a compiler the Python pass runs, and this logs it once at
WARNING; ``GLINT_W2V_NO_NATIVE=1`` asks for the Python pass (tests cover
both). ``GLINT_NATIVE_THREADS`` sets the threads of the parallel passes
(0, the default: one per hardware core). :data:`calls` counts the native
calls that ran, by wrapper.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

#: Native calls that ran since import, by wrapper: ``chip_smoke.py``
#: reads them to show the fits took the native pass. The host batcher's
#: producer thread counts too, so a count is taken under a lock.
calls = {"alias_build": 0, "window_batch_epoch": 0, "corpus_scan": 0,
         "ann_place_spills": 0}
_calls_lock = threading.Lock()


def _count(name: str) -> None:
    with _calls_lock:
        calls[name] += 1


def _bind_shared(lib: ctypes.CDLL) -> None:
    """Bind the interface this library shares with the JAX package's."""
    P = ctypes.POINTER
    lib.alias_build.restype = ctypes.c_int
    lib.alias_build.argtypes = [
        P(ctypes.c_double), ctypes.c_int64, P(ctypes.c_float), P(ctypes.c_int32),
    ]
    lib.window_batch_epoch.restype = ctypes.c_int64
    lib.window_batch_epoch.argtypes = [
        P(ctypes.c_int32), P(ctypes.c_int64), ctypes.c_int64,
        P(ctypes.c_float), ctypes.c_int32, ctypes.c_uint64, P(ctypes.c_int32),
        P(ctypes.c_int32), P(ctypes.c_float), ctypes.c_int64,
        P(ctypes.c_int64), ctypes.c_int32,
    ]
    lib.corpus_open.restype = ctypes.c_void_p
    lib.corpus_open.argtypes = [ctypes.c_char_p, ctypes.c_int32]
    lib.corpus_vocab_size.restype = ctypes.c_int64
    lib.corpus_vocab_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.corpus_vocab_chars.restype = ctypes.c_int64
    lib.corpus_vocab_chars.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.corpus_vocab_fill.restype = ctypes.c_int
    lib.corpus_vocab_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
        P(ctypes.c_int64), P(ctypes.c_int64),
    ]
    lib.corpus_encode.restype = ctypes.c_int64
    lib.corpus_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, P(ctypes.c_int64),
    ]
    lib.corpus_encode_fill.restype = ctypes.c_int
    lib.corpus_encode_fill.argtypes = [
        ctypes.c_void_p, P(ctypes.c_int32), P(ctypes.c_int64),
    ]
    lib.corpus_free.restype = None
    lib.corpus_free.argtypes = [ctypes.c_void_p]


def _bind(lib: ctypes.CDLL) -> None:
    _bind_shared(lib)
    P = ctypes.POINTER
    lib.ann_place_spills.restype = ctypes.c_int64
    lib.ann_place_spills.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, P(ctypes.c_int32),
        P(ctypes.c_int64), P(ctypes.c_int64), P(ctypes.c_float), ctypes.c_int64,
        P(ctypes.c_int64), P(ctypes.c_int32), P(ctypes.c_float),
        P(ctypes.c_int32), P(ctypes.c_int32),
    ]


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built and loaded on first use, or None: when
    ``GLINT_W2V_NO_NATIVE`` is set, or when it cannot be built or loaded
    (logged once at WARNING)."""
    global _lib, _build_failed
    if os.environ.get("GLINT_W2V_NO_NATIVE"):
        return None
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            from glint_word2vec_torch.kernels import build

            try:
                lib = build.native_library("host_ops")
                _bind(lib)
                _lib = lib
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _build_failed = True
                logger.warning(
                    "native host pass unavailable (%s): the alias build, the "
                    "host batcher and fit_file's ingestion run in Python", e
                )
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _resolve_threads(threads: Optional[int]) -> int:
    """Threads for the parallel passes: an explicit argument wins, else
    ``GLINT_NATIVE_THREADS`` (empty or not a number reads as 0); 0 is one
    per hardware core (resolved in C++)."""
    if threads is not None:
        return int(threads)
    try:
        return int(os.environ.get("GLINT_NATIVE_THREADS", "0"))
    except ValueError:
        return 0


def alias_build_native(
    weights: np.ndarray,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The alias table ``(prob float32, alias int32)`` of ``weights``, or
    None without the library. Raises ValueError for invalid weights, as
    the Python builder does."""
    lib = get_lib()
    if lib is None:
        return None
    w = np.ascontiguousarray(weights, dtype=np.float64)
    n = w.size
    prob = np.empty(n, dtype=np.float32)
    alias = np.empty(n, dtype=np.int32)
    rc = lib.alias_build(
        _ptr(w, ctypes.c_double), n, _ptr(prob, ctypes.c_float),
        _ptr(alias, ctypes.c_int32),
    )
    if rc == 1:
        raise ValueError("weights must be a nonempty 1-D array")
    if rc == 2:
        raise ValueError("weights must be finite and nonnegative")
    if rc == 3:
        raise ValueError("weights must sum to > 0")
    _count("alias_build")
    return prob, alias


def window_batch_epoch_native(
    ids: np.ndarray,
    offsets: np.ndarray,
    keep_prob: np.ndarray,
    window: int,
    seed: int,
    threads: Optional[int] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
    """One subsample-and-window pass over the flat corpus ``(ids,
    offsets)``, parallel across sentence chunks; the output is the same
    bytes for every thread count (per-sentence seeds, then a count pass
    and a fill pass). ``threads``: None reads ``GLINT_NATIVE_THREADS``.
    Returns ``(centers, contexts, mask, words_done)`` with exactly the
    kept rows, or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    threads = _resolve_threads(threads)
    C = max(1, 2 * int(window) - 3)
    ids_c = np.ascontiguousarray(ids, dtype=np.int32)
    off_c = np.ascontiguousarray(offsets, dtype=np.int64)
    kp_c = np.ascontiguousarray(keep_prob, dtype=np.float32)
    cap = int(ids_c.size)
    centers = np.empty(cap, dtype=np.int32)
    contexts = np.empty((cap, C), dtype=np.int32)
    mask = np.empty((cap, C), dtype=np.float32)
    words_done = ctypes.c_int64(0)
    rows = lib.window_batch_epoch(
        _ptr(ids_c, ctypes.c_int32), _ptr(off_c, ctypes.c_int64),
        off_c.size - 1, _ptr(kp_c, ctypes.c_float), int(window),
        ctypes.c_uint64(seed & (2**64 - 1)), _ptr(centers, ctypes.c_int32),
        _ptr(contexts, ctypes.c_int32), _ptr(mask, ctypes.c_float),
        cap, ctypes.byref(words_done), int(threads),
    )
    if rows < 0:  # the capacity is every id, so this cannot happen
        raise RuntimeError("window_batch_epoch capacity overflow")
    _count("window_batch_epoch")
    return centers[:rows], contexts[:rows], mask[:rows], int(words_done.value)


def corpus_scan_native(
    path: str,
    min_count: int,
    max_sentence_length: int,
    lowercase: bool = False,
    threads: Optional[int] = None,
) -> Optional[Tuple[list, np.ndarray, np.ndarray, np.ndarray]]:
    """Both ``fit_file`` ingestion passes (the vocabulary count, then the
    flat encode) in C++; the count runs thread-parallel over mapped
    chunks of a large file, with the same output for every thread count.

    Returns ``(words, counts int64, ids int32, offsets int64)``, or None
    when the caller should run the Python passes: no library, an
    unreadable file, invalid UTF-8 anywhere in the file (Python's
    ``errors="replace"`` decode merges tokens that differ only in invalid
    bytes, which a byte-level count cannot reproduce), or ``lowercase``
    (``str.lower`` is Unicode-aware). For valid UTF-8 the tokens, sentence
    boundaries, order and chunking are those of ``corpus/vocab.py``: the
    whitespace set of ``str.split()``, universal newlines, count
    descending with first-seen order on ties, OOV dropped, lines chunked
    at ``max_sentence_length``. An empty vocabulary gives empty arrays."""
    if lowercase:
        return None
    lib = get_lib()
    if lib is None:
        return None
    h = lib.corpus_open(os.fsencode(path), _resolve_threads(threads))
    if not h:
        return None
    try:
        n = int(lib.corpus_vocab_size(h, min_count))
        if n <= 0:
            _count("corpus_scan")
            return ([], np.zeros(0, np.int64), np.zeros(0, np.int32),
                    np.zeros(1, np.int64))
        nchars = int(lib.corpus_vocab_chars(h, min_count))
        chars = ctypes.create_string_buffer(max(nchars, 1))
        offs = np.empty(n + 1, dtype=np.int64)
        counts = np.empty(n, dtype=np.int64)
        lib.corpus_vocab_fill(
            h, min_count, chars, _ptr(offs, ctypes.c_int64),
            _ptr(counts, ctypes.c_int64),
        )
        raw = chars.raw[:nchars]
        bounds = offs.tolist()
        words = [
            raw[bounds[i]:bounds[i + 1]].decode("utf-8", errors="replace")
            for i in range(n)
        ]
        n_sent = ctypes.c_int64(0)
        n_ids = int(lib.corpus_encode(
            h, min_count, max_sentence_length, ctypes.byref(n_sent)
        ))
        if n_ids < 0:
            return None
        ids = np.empty(max(n_ids, 1), dtype=np.int32)[:n_ids]
        soffs = np.empty(int(n_sent.value) + 1, dtype=np.int64)
        lib.corpus_encode_fill(
            h, _ptr(ids, ctypes.c_int32), _ptr(soffs, ctypes.c_int64)
        )
        _count("corpus_scan")
        return words, counts, ids, soffs
    finally:
        lib.corpus_free(h)


def ann_place_spills_native(start: int, stop: int, cand: np.ndarray,
                            rid: np.ndarray, pos: np.ndarray, inv: np.ndarray,
                            L: int, fill: np.ndarray, members: np.ndarray,
                            invn: np.ndarray, cluster_of: np.ndarray,
                            slot_of: np.ndarray) -> Optional[int]:
    """Place spilled rows ``[start, stop)`` in order, each into the first
    of its candidates (``cand``: the rows' ``(stop - start, K)`` best
    clusters) with space, editing the layout arrays in place (``fill``
    int64, ``members``/``cluster_of``/``slot_of`` int32, ``invn``
    float32, all contiguous). Returns the first row whose candidates are
    all full, or ``stop``; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    for a, dt in ((fill, np.int64), (members, np.int32), (invn, np.float32),
                  (cluster_of, np.int32), (slot_of, np.int32)):
        if a.dtype != dt or not a.flags.c_contiguous:
            raise ValueError(f"layout arrays must be contiguous {dt.__name__}")
    cand = np.ascontiguousarray(cand, dtype=np.int32)
    if cand.ndim != 2 or cand.shape[0] < stop - start:
        raise ValueError("cand must hold (stop - start, K) candidates")
    rid = np.ascontiguousarray(rid, dtype=np.int64)
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    inv = np.ascontiguousarray(inv, dtype=np.float32)
    out = lib.ann_place_spills(
        int(start), int(stop), cand.shape[1], _ptr(cand, ctypes.c_int32),
        _ptr(rid, ctypes.c_int64), _ptr(pos, ctypes.c_int64),
        _ptr(inv, ctypes.c_float), int(L), _ptr(fill, ctypes.c_int64),
        _ptr(members, ctypes.c_int32), _ptr(invn, ctypes.c_float),
        _ptr(cluster_of, ctypes.c_int32), _ptr(slot_of, ctypes.c_int32),
    )
    _count("ann_place_spills")
    return int(out)
