"""graftlint for the port: AST-based checkers of the contracts the port's
correctness rests on (counterpart of ``glint_word2vec_tpu/analysis/``).

The port inherited the JAX package's conventions, and no tool checked
them: host<->device syncs only in blessed harvest seams, every persisted
artifact through ``utils.atomic_write_*`` or a temp + ``os.replace``
commit, every table mutation ticking ``table_version`` (in place and on
model shards too, which JAX never does), fault points and request spans
matching their registries, the Prometheus renderers consistent with the
snapshots that feed them, and shared mutable state accessed under its
owning lock. This package checks the port's own source,
``glint_word2vec_torch/`` and ``chip_smoke.py``, with the JAX package's
seven rules retargeted to torch.

Usage::

    python -m glint_word2vec_torch.analysis                  # report findings
    python -m glint_word2vec_torch.analysis --check-baseline # the gate
    python -m glint_word2vec_torch.analysis --update-baseline

The package imports only the standard library (no torch, no jax, no
numpy, nothing of the JAX package), so the gate runs on a bare
interpreter in seconds.

Per-line suppression::

    something_flagged()  # graftlint: ignore[rule-id] reason it is fine

The reason is mandatory; a bare suppression is itself reported (rule
``graftlint-suppression``). The committed ``baseline.json`` holds the
audited-and-accepted findings, so the gate is zero-NEW-findings, not
zero-findings; every baseline entry carries a non-empty ``note``.
"""

from glint_word2vec_torch.analysis.core import (  # noqa: F401
    CHECKERS,
    Finding,
    ModuleCache,
    checker,
    default_targets,
    run_analysis,
)
from glint_word2vec_torch.analysis.baseline import (  # noqa: F401
    compare_to_baseline,
    load_baseline,
    write_baseline,
)
