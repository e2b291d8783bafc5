"""PyTorch/CUDA port of ``glint_word2vec_tpu``: load a saved word2vec model
and serve it on an NVIDIA GPU.

The JAX package stays the reference; this package imports none of it.
Module names mirror the JAX package's, so each module's counterpart is
found by name. Entry points run on the CUDA card unless ``device="cpu"``
is asked for; the one TPU kernel on the serving path (the row gather)
is a hand-written CUDA kernel here (``csrc/gather_rows.cu``).
"""

from glint_word2vec_torch.models import load_model
from glint_word2vec_torch.models.word2vec import Word2VecModel
from glint_word2vec_torch.parallel.engine import EmbeddingEngine
from glint_word2vec_torch.serving import ModelServer

__all__ = [
    "EmbeddingEngine",
    "ModelServer",
    "Word2VecModel",
    "load_model",
]
