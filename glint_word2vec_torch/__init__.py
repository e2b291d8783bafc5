"""PyTorch/CUDA port of ``glint_word2vec_tpu``: train a word2vec or
fastText model, save it, load it and serve it on an NVIDIA GPU.

The JAX package stays the reference; this package imports none of it.
Module names mirror the JAX package's, so each module's counterpart is
found by name. Entry points run on the CUDA card unless ``device="cpu"``
is asked for. The TPU kernels on these paths are hand-written CUDA
kernels here: the row gather (``csrc/gather_rows.cu``), the fused pair
step of the resident training path (``csrc/pair_forward.cu``,
``csrc/scatter_runs.cu``) with its shared-pool forward
(``csrc/pair_forward_shared.cu``), and the table-dtype scatters of the
composed step (``csrc/scatter_runs.cu``).
"""

from glint_word2vec_torch.models import load_model
from glint_word2vec_torch.models.fasttext import (
    FastTextModel,
    FastTextParams,
    FastTextWord2Vec,
)
from glint_word2vec_torch.models.word2vec import Word2Vec, Word2VecModel
from glint_word2vec_torch.parallel.engine import EmbeddingEngine
from glint_word2vec_torch.serving import ModelServer

__all__ = [
    "EmbeddingEngine",
    "FastTextModel",
    "FastTextParams",
    "FastTextWord2Vec",
    "ModelServer",
    "Word2Vec",
    "Word2VecModel",
    "load_model",
]
