"""Device operations of the port: hand-written kernels and their plain versions."""

# The port's matrix-product settings (no TF32) hold for every op module.
from glint_word2vec_torch import device as _device  # noqa: F401
