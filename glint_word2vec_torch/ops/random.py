"""Counter-based random words for training: the port's stand-in for
``jax.random.fold_in`` and the draws made from it.

Every draw of the training path is a pure function of ``(seed, counter,
...)``: a key is a 32-bit word, :func:`fold_in` derives a new key from a
key and a datum, and :func:`bits` / :func:`uniform` turn a key into a
word or a float. ``pack_window_pairs`` consumes only whole positions and
assembles the rest again on the next step, which is exact only because
a position's shrink draw depends on the position alone; the per-position
subsample draw and the per-pair-row negatives rely on the same property.
A sequential ``torch.Generator`` stream would draw them differently the
second time.

The arithmetic is integer-only on int64 tensors holding values in
``[0, 2^32)``: xor, shifts, masks, and a 32-bit multiply by a constant
taken as a signed 32-bit value, so every product stays inside int64
(``|x * c| < 2^32 * 2^31``) and none overflows. The same code runs on
Python ints (for keys known on the host), on CPU tensors and on CUDA
tensors, and gives the same words on all three.

The mixing function is ``lowbias32`` (C. Wellons' integer hash
prospector: two multiply-xorshift rounds, full avalanche on 32 bits).
These words are not the JAX package's threefry words: the tests hand the
JAX package's draws to the port where they compare the two.
"""

from __future__ import annotations

#: Domain constants shared with the JAX package
#: (``ops/device_batching.py:59,65``, ``ops/sampling.py:54``).
WINDOW_FOLD = 0x77696E64  # "wind"
SUBSAMPLE_FOLD = 0x73756273  # "subs"
NEGS_FOLD = 0x6E656773  # "negs"

_M32 = 0xFFFFFFFF
_SEED_SALT = 0x9E3779B9  # golden ratio: seeds -> root keys
_DATA_SALT = 0x85EBCA6B  # murmur3 constant: the data side of fold_in


def _signed32(c: int) -> int:
    """A 32-bit constant as the signed value with the same low 32 bits."""
    return c - (1 << 32) if c >= (1 << 31) else c


_MUL_A = _signed32(0x7FEB352D)
_MUL_B = _signed32(0x846CA68B)


def mix32(x):
    """``lowbias32``: a bijection of ``[0, 2^32)`` with full avalanche.
    ``(x * c) & (2^32 - 1)`` is ``x * c mod 2^32`` for the signed form of
    ``c`` too (two's complement), and that form keeps the product inside
    int64."""
    x = x ^ (x >> 16)
    x = (x * _MUL_A) & _M32
    x = x ^ (x >> 15)
    x = (x * _MUL_B) & _M32
    return x ^ (x >> 16)


def seed_key(seed: int) -> int:
    """The root key of a run with this seed."""
    return mix32((int(seed) ^ _SEED_SALT) & _M32)


def fold_in(key, data):
    """A new key from ``key`` and ``data`` (ints or int64 tensors with
    values in ``[0, 2^32)``; tensors broadcast). For a fixed key it is a
    bijection of the datum, and for a fixed datum one of the key."""
    return mix32(key ^ mix32(data ^ _DATA_SALT))


#: Salts of the words a key yields: word ``i`` is ``mix32(key ^ salt_i)``.
_WORD_SALTS = (0x5BD1E995, 0x27D4EB2F, 0x165667B1)


def bits(key, word: int = 0):
    """32-bit word number ``word`` (0, 1 or 2) of a key."""
    return mix32(key ^ _WORD_SALTS[word])


def uniform(key):
    """A float32 in ``[0, 1)`` from word 0 of a key: its top 24 bits, so
    every value is exact in float32."""
    import torch

    return (bits(key, 0) >> 8).to(torch.float32) * (1.0 / (1 << 24))


def below(key, n: int):
    """An int64 in ``[0, n)`` from words 1 and 2 of a key, for
    ``0 < n < 2^30``: the top bits of ``n`` times the 64-bit word they
    make, so no value is more likely than another by more than
    ``n / 2^64``."""
    if not 0 < int(n) < (1 << 30):
        raise ValueError(f"range {n} must be in (0, 2^30)")
    hi = bits(key, 1)
    lo = bits(key, 2)
    # floor((hi * 2^32 + lo) * n / 2^64), without leaving int64.
    return (hi * n + ((lo * n) >> 32)) >> 32
