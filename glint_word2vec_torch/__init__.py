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
composed step (``csrc/scatter_runs.cu``). ``ServerSideGlintWord2Vec``
and ``ServerSideGlintWord2VecModel`` (``compat.py``) give the reference's
PySpark surface over the same estimator.
"""

from glint_word2vec_torch.version import __version__

#: Public name -> the module that defines it. Each is imported on first use
#: (PEP 562), so a process that serves no model and trains none (the
#: fleet's supervisor and balancer shards, ``trace-merge``, ``supervise``)
#: imports no torch and can never make a CUDA context.
_EXPORTS = {
    "EmbeddingEngine": "glint_word2vec_torch.parallel.engine",
    "FastTextModel": "glint_word2vec_torch.models.fasttext",
    "FastTextParams": "glint_word2vec_torch.models.fasttext",
    "FastTextWord2Vec": "glint_word2vec_torch.models.fasttext",
    "LocalWord2VecModel": "glint_word2vec_torch.models.word2vec",
    "ModelServer": "glint_word2vec_torch.serving",
    "ObsConfig": "glint_word2vec_torch.obs",
    "ServerSideGlintWord2Vec": "glint_word2vec_torch.compat",
    "ServerSideGlintWord2VecModel": "glint_word2vec_torch.compat",
    "TrainingDiverged": "glint_word2vec_torch.obs.canary",
    "Word2Vec": "glint_word2vec_torch.models.word2vec",
    "Word2VecModel": "glint_word2vec_torch.models.word2vec",
    "Word2VecParams": "glint_word2vec_torch.utils.params",
    "load_model": "glint_word2vec_torch.models",
}

__all__ = ["__version__", *sorted(_EXPORTS)]


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
