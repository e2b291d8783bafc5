"""Hyperparameters of a model (own copy of ``glint_word2vec_tpu/utils/params.py``).

The field set is the JAX package's in full, so a ``params.json`` written
by either package round-trips through the other. See the JAX module for
what each field means to training; ``Word2Vec.fit`` of the port refuses
the settings it does not train yet.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclass
class Word2VecParams:
    """All training/serving hyperparameters, validated on construction."""

    vector_size: int = 100
    window: int = 5
    step_size: float = 0.01875
    batch_size: int = 1024
    num_negatives: int = 5
    subsample_ratio: float = 0.0
    min_count: int = 5
    num_iterations: int = 1
    max_sentence_length: int = 1000
    seed: int = 1
    num_partitions: int = 1
    num_shards: int = 1
    unigram_power: float = 0.75
    unigram_table_size: int | None = None
    dtype: str = "float32"
    compute_dtype: str | None = None
    layout: str = "rows"
    steps_per_call: int = 16
    shared_negatives: int = 0
    batch_packing: str = "dense"
    exchange: str = "none"
    exchange_capacity: int = 0
    exchange_wire: str = "fp32"
    exchange_every: int = 1
    exchange_topology: str = "flat"
    exchange_shard: str = "roundrobin"

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        _require(self.vector_size > 0, "vector_size must be > 0")
        _require(self.window > 0, "window must be > 0")
        _require(self.step_size > 0, "step_size must be > 0")
        _require(self.batch_size > 0, "batch_size must be > 0")
        _require(self.num_negatives > 0, "num_negatives must be > 0")
        _require(self.subsample_ratio >= 0, "subsample_ratio must be >= 0")
        _require(self.min_count >= 0, "min_count must be >= 0")
        _require(self.num_iterations > 0, "num_iterations must be > 0")
        _require(self.max_sentence_length > 0, "max_sentence_length must be > 0")
        _require(self.num_partitions > 0, "num_partitions must be > 0")
        _require(self.num_shards > 0, "num_shards must be > 0")
        _require(0 < self.unigram_power <= 1, "unigram_power must be in (0, 1]")
        _require(
            self.unigram_table_size is None or self.unigram_table_size > 0,
            "unigram_table_size must be > 0 or None",
        )
        _require(self.dtype in ("float32", "bfloat16"), "dtype must be float32|bfloat16")
        _require(
            self.compute_dtype in (None, "float32", "bfloat16"),
            "compute_dtype must be float32|bfloat16|None",
        )
        _require(self.layout in ("rows", "dims"), "layout must be rows|dims")
        _require(self.steps_per_call > 0, "steps_per_call must be > 0")
        _require(self.shared_negatives >= 0, "shared_negatives must be >= 0")
        _require(
            self.batch_packing in ("grid", "dense"),
            "batch_packing must be grid|dense",
        )
        _require(
            self.exchange in ("none", "sparse", "dense"),
            "exchange must be none|sparse|dense",
        )
        _require(self.exchange_capacity >= 0, "exchange_capacity must be >= 0")
        _require(
            self.exchange_wire in ("fp32", "bf16", "int8"),
            "exchange_wire must be fp32|bf16|int8",
        )
        _require(self.exchange_every >= 1, "exchange_every must be >= 1")
        _require(
            self.exchange_topology in ("flat", "twolevel"),
            "exchange_topology must be flat|twolevel",
        )
        _require(
            self.exchange_shard in ("roundrobin", "locality"),
            "exchange_shard must be roundrobin|locality",
        )

    def replace(self, **kwargs) -> "Word2VecParams":
        """A validated copy with the given fields changed."""
        return dataclasses.replace(self, **kwargs)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Word2VecParams":
        return cls(**json.loads(s))
