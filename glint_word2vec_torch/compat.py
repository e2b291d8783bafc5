"""Reference-surface compatibility layer (counterpart of
``glint_word2vec_tpu/compat.py``): the PySpark binding API
(`ServerSideGlintWord2Vec` / `ServerSideGlintWord2VecModel`,
src/main/python/ml_glintword2vec.py:38-385) re-exposed over the port, so
code written against the reference's estimator/model surface ports by
changing an import.

Parameter mapping (camelCase as in ml_glintword2vec.py:101-170):

  vectorSize / windowSize / stepSize / batchSize / n / minCount / maxIter /
  maxSentenceLength / seed / subsampleRatio / unigramTableSize
      -> the same-meaning Word2VecParams fields.
  numPartitions        -> data-parallel mesh axis (clamped to devices).
  numParameterServers  -> model-parallel mesh axis (each shard owns 1/n of
      the matrices — the direct analogue of README.md:69), clamped to the
      available device count the way the reference adapts the server count
      to its cluster. The port trains on one device until its SPMD mesh
      lands, so both clamp to 1 for now, with the same warning.
  parameterServerHost / parameterServerConfig -> no analogue: there is no
      server process to connect to (the "cluster" is the device mesh in
      this process). Accepted for signature compatibility; a non-empty
      host raises.
  device (port only)   -> where the model trains and lives: the CUDA card
      by default, ``"cpu"`` for the plain versions of the kernels.
  inputCol / outputCol -> stored for API compatibility; this layer takes
      tokenized sentences directly instead of DataFrames.

Documented behavioral divergences (see README "Faithfulness"):
  * subsampleRatio defaults to 0.0 here. The reference declares 1e-6 but
    its integer-division bug (mllib:375) makes subsampling a silent no-op,
    so 0.0 IS the reference's de-facto behavior; passing a ratio here opts
    into the *fixed* float semantics.
  * unigramTableSize defaults to None here (exact alias sampling of the
    same unigram^0.75 distribution) instead of the reference's quantized
    1e8-entry table; pass a size to opt into the quantized compatibility
    mode.
  * `stop(terminateOtherClients=True)` is accepted but meaningless: no
    other clients exist.

``seed=None`` draws a fresh random seed per fit, matching the reference.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from glint_word2vec_torch.device import DeviceLike
from glint_word2vec_torch.models.word2vec import Word2Vec, Word2VecModel
from glint_word2vec_torch.utils.params import Word2VecParams


def _clamp_topology(numPartitions: int, numParameterServers: int,
                    device: DeviceLike = None) -> Tuple[int, int]:
    """The mesh ``(num_data, num_model)`` a requested (workers, servers)
    topology maps onto, clamped to the devices present as the JAX layer's
    ``_mesh_axes`` does (``compat.py:50-66``), with its warning when the
    request was larger. The devices are the CUDA cards (one on the CPU),
    so one card trains 1 x 1."""
    import torch

    on_cpu = device is not None and torch.device(device).type == "cpu"
    n_dev = 1 if on_cpu else max(1, torch.cuda.device_count())
    num_model = max(1, min(numParameterServers, n_dev))
    num_data = max(1, min(numPartitions, n_dev // num_model))
    if (numParameterServers, numPartitions) != (num_model, num_data):
        warnings.warn(
            f"requested topology {numPartitions}x{numParameterServers} "
            f"(partitions x parameter servers) clamped to mesh "
            f"{num_data}x{num_model} for {n_dev} device(s)"
        )
    return num_data, num_model


class ServerSideGlintWord2Vec:
    """Estimator with the reference's parameter surface
    (ml_glintword2vec.py:138-170 defaults, except subsampleRatio — see
    module docstring)."""

    def __init__(
        self,
        vectorSize: int = 100,
        minCount: int = 5,
        numPartitions: int = 1,
        stepSize: float = 0.01875,
        maxIter: int = 1,
        seed: Optional[int] = None,
        inputCol: Optional[str] = None,
        outputCol: Optional[str] = None,
        windowSize: int = 5,
        maxSentenceLength: int = 1000,
        batchSize: int = 50,
        n: int = 5,
        subsampleRatio: float = 0.0,
        numParameterServers: int = 5,
        parameterServerHost: str = "",
        unigramTableSize: Optional[int] = None,
        device: DeviceLike = None,
    ):
        self.device = device
        self._kw = {}
        self.setParams(
            vectorSize=vectorSize, minCount=minCount,
            numPartitions=numPartitions, stepSize=stepSize, maxIter=maxIter,
            seed=seed, inputCol=inputCol, outputCol=outputCol,
            windowSize=windowSize, maxSentenceLength=maxSentenceLength,
            batchSize=batchSize, n=n, subsampleRatio=subsampleRatio,
            numParameterServers=numParameterServers,
            parameterServerHost=parameterServerHost,
            unigramTableSize=unigramTableSize,
        )

    # -- params ---------------------------------------------------------

    #: The full parameter surface (ml_glintword2vec.py:138-170).
    _PARAM_NAMES = frozenset(
        {
            "vectorSize", "minCount", "numPartitions", "stepSize", "maxIter",
            "seed", "inputCol", "outputCol", "windowSize",
            "maxSentenceLength", "batchSize", "n", "subsampleRatio",
            "numParameterServers", "parameterServerHost", "unigramTableSize",
        }
    )

    def setParams(self, **kwargs) -> "ServerSideGlintWord2Vec":
        unknown = set(kwargs) - self._PARAM_NAMES
        if unknown:
            # Same contract as the keyword_only PySpark surface: a typoed
            # or wrong-dialect name must fail loudly, not silently train
            # with defaults.
            raise TypeError(
                f"unknown param(s) {sorted(unknown)}; valid params: "
                f"{sorted(self._PARAM_NAMES)}"
            )
        self._kw.update(kwargs)
        return self

    def _get(self, name):
        return self._kw[name]

    # Per-param setters/getters, mirroring ml_glintword2vec.py:172-302.
    def setVectorSize(self, value):
        return self.setParams(vectorSize=value)

    def getVectorSize(self):
        return self._get("vectorSize")

    def setMinCount(self, value):
        return self.setParams(minCount=value)

    def getMinCount(self):
        return self._get("minCount")

    def setNumPartitions(self, value):
        return self.setParams(numPartitions=value)

    def getNumPartitions(self):
        return self._get("numPartitions")

    def setStepSize(self, value):
        return self.setParams(stepSize=value)

    def getStepSize(self):
        return self._get("stepSize")

    def setMaxIter(self, value):
        return self.setParams(maxIter=value)

    def getMaxIter(self):
        return self._get("maxIter")

    def setSeed(self, value):
        return self.setParams(seed=value)

    def getSeed(self):
        return self._get("seed")

    def setInputCol(self, value):
        return self.setParams(inputCol=value)

    def getInputCol(self):
        return self._get("inputCol")

    def setOutputCol(self, value):
        return self.setParams(outputCol=value)

    def getOutputCol(self):
        return self._get("outputCol")

    def setWindowSize(self, value):
        return self.setParams(windowSize=value)

    def getWindowSize(self):
        return self._get("windowSize")

    def setMaxSentenceLength(self, value):
        return self.setParams(maxSentenceLength=value)

    def getMaxSentenceLength(self):
        return self._get("maxSentenceLength")

    def setBatchSize(self, value):
        return self.setParams(batchSize=value)

    def getBatchSize(self):
        return self._get("batchSize")

    def setN(self, value):
        return self.setParams(n=value)

    def getN(self):
        return self._get("n")

    def setSubsampleRatio(self, value):
        return self.setParams(subsampleRatio=value)

    def getSubsampleRatio(self):
        return self._get("subsampleRatio")

    def setNumParameterServers(self, value):
        return self.setParams(numParameterServers=value)

    def getNumParameterServers(self):
        return self._get("numParameterServers")

    def setParameterServerHost(self, value):
        return self.setParams(parameterServerHost=value)

    def getParameterServerHost(self):
        return self._get("parameterServerHost")

    def setUnigramTableSize(self, value):
        return self.setParams(unigramTableSize=value)

    def getUnigramTableSize(self):
        return self._get("unigramTableSize")

    # -- fit ------------------------------------------------------------

    def fit(
        self, sentences: Sequence[Sequence[str]]
    ) -> "ServerSideGlintWord2VecModel":
        """Train. Takes tokenized sentences (the content of the reference's
        input DataFrame column, ml:286) and returns the fitted model."""
        kw = self._kw
        if kw.get("parameterServerHost"):
            raise ValueError(
                "parameterServerHost has no analogue: there is no separate "
                "parameter-server cluster to connect to (the device mesh "
                "lives in this process); leave it empty"
            )
        num_data, num_model = _clamp_topology(
            kw["numPartitions"], kw["numParameterServers"], self.device
        )
        # The global batch must split over the data axis: round up, as the
        # JAX layer does, rather than fail a valid reference setting.
        batch_size = kw["batchSize"]
        if batch_size % num_data:
            rounded = -(-batch_size // num_data) * num_data
            warnings.warn(
                f"batchSize={batch_size} is not divisible by the data-axis "
                f"size {num_data}; rounding up to {rounded}",
                stacklevel=2,
            )
            batch_size = rounded
        params = Word2VecParams(
            vector_size=kw["vectorSize"],
            window=kw["windowSize"],
            step_size=kw["stepSize"],
            batch_size=batch_size,
            num_negatives=kw["n"],
            subsample_ratio=kw["subsampleRatio"],
            min_count=kw["minCount"],
            num_iterations=kw["maxIter"],
            max_sentence_length=kw["maxSentenceLength"],
            # seed=None means a fresh random seed, as in the reference.
            seed=(
                kw["seed"]
                if kw["seed"] is not None
                else int(np.random.default_rng().integers(2**31 - 1))
            ),
            num_partitions=num_data,
            num_shards=num_model,
            unigram_table_size=kw["unigramTableSize"],
        )
        model = Word2Vec(params, device=self.device).fit(list(sentences))
        return ServerSideGlintWord2VecModel(model)


class ServerSideGlintWord2VecModel:
    """Model with the reference surface (ml_glintword2vec.py:311-383)."""

    def __init__(self, model: Word2VecModel):
        self._model = model

    def getVectors(self) -> List[Tuple[str, np.ndarray]]:
        """All (word, vector) rows — the reference's getVectors DataFrame
        (ml:342-364) as a list. Streams from the device; the 8 GB broadcast
        caveat in the reference docstring does not apply."""
        return list(self._model.get_vectors())

    def findSynonyms(
        self, word: Union[str, np.ndarray, Sequence[float]], num: int
    ) -> List[Tuple[str, float]]:
        """Top-``num`` (word, cosine) pairs; ``word`` may be a string or a
        vector, as in the reference (ml_glintword2vec.py:330-339)."""
        if isinstance(word, str):
            return self._model.find_synonyms(word, num)
        return self._model.find_synonyms_vector(
            np.asarray(word, np.float32), num
        )

    def findSynonymsArray(self, word, num) -> List[Tuple[str, float]]:
        """Alias of :meth:`findSynonyms` (the reference splits DataFrame and
        array flavors, ml_glintword2vec.py:341-351; here both are lists)."""
        return self.findSynonyms(word, num)

    def transform(
        self, sentences: Sequence[Sequence[str]]
    ) -> np.ndarray:
        """Sentence embeddings by device-side averaging — the DataFrame
        transform path (ml:443-459): OOV dropped, empty rows zero."""
        return self._model.transform_sentences(sentences)

    def save(self, path: str) -> None:
        """Save, refusing to clobber an existing model — the MLWritable
        ErrorIfExists default; use ``write().overwrite().save(path)`` to
        replace (ml:471,504-507 delegation chain)."""
        self.write().save(path)

    def write(self):  # minimal MLWritable-style shim
        class _Writer:
            def __init__(self, m):
                self._m = m
                self._overwrite = False

            def save(self, path):
                import os

                if not self._overwrite and os.path.exists(path):
                    raise FileExistsError(
                        f"model path {path} already exists; call "
                        f".write().overwrite().save(path) to replace it"
                    )
                self._m.save(path)

            def overwrite(self):
                self._overwrite = True
                return self

        return _Writer(self._model)

    @classmethod
    def load(
        cls, path: str, parameterServerHost: str = "",
        device: DeviceLike = None,
    ) -> "ServerSideGlintWord2VecModel":
        """Load a saved model onto ``device``. ``parameterServerHost``
        mirrors the reference's load-time re-homing override
        (ml_glintword2vec.py:353-373); here re-homing means choosing a
        device, so the host string must stay empty."""
        if parameterServerHost:
            raise ValueError(
                "parameterServerHost has no analogue; load onto another "
                "device with Word2VecModel.load(path, device=...)"
            )
        return cls(Word2VecModel.load(path, device=device))

    def stop(self, terminateOtherClients: bool = False) -> None:
        """Release the distributed matrices (ml_glintword2vec.py:375-383).
        ``terminateOtherClients`` is accepted for signature parity; there
        are no other clients in-process."""
        del terminateOtherClients
        self._model.stop()
