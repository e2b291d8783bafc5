"""The JAX package's native host pass, built from its own source into a
directory of the calling test, for the tests that hold the port's native
pass against it.

The JAX package builds its library in place next to its source, and test
processes that build it at the same moment can load a half-written file
and fall back to Python for good; a private build avoids that. The two
packages' sources share one C interface (the port's adds the ANN spill
placement), so the port's ctypes binding of that interface binds this
library too.
"""

import contextlib
import ctypes
import os
import subprocess

from glint_word2vec_tpu import native as jnative

from glint_word2vec_torch import native as pnative
from glint_word2vec_torch.kernels import build


@contextlib.contextmanager
def jax_native_library(tmpdir: str):
    """Within the block, the JAX package's native wrappers call a private
    build of ``glint_word2vec_tpu/native/host_ops.cpp`` (the flags of the
    JAX package's own build)."""
    out = os.path.join(tmpdir, "jax_host_ops.so")
    subprocess.run(["g++", *build.GXX_FLAGS, jnative._SRC, "-o", out],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(out)
    pnative._bind_shared(lib)
    saved = jnative._lib
    jnative._lib = lib
    try:
        yield lib
    finally:
        jnative._lib = saved
