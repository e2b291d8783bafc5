"""The built-in graftlint checkers. Importing this package registers
every rule with :data:`glint_word2vec_torch.analysis.core.CHECKERS`."""

from glint_word2vec_torch.analysis.checkers import (  # noqa: F401
    atomic_persist,
    fault_points,
    lock_discipline,
    prometheus,
    span_registry,
    sync_point,
    table_mutation,
)
