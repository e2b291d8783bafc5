"""Deterministic fault injection (own copy of
``glint_word2vec_tpu/utils/faults.py``, trimmed to the points the port
fires).

Injection points are plain string names fired where a fault domain
boundary exists:

  ``worker.step``             once per dispatched streaming training group
  ``exchange.pre_send``       before each replica-exchange round's header
                              allgather
  ``publish.pre_commit``      just before a published generation
                              directory's atomic rename
  ``publish.pre_pointer``     between the generation rename and the
                              ``LATEST.json`` pointer flip
  ``serving.dispatch``        once per coalesced or simple serving
                              device dispatch
  ``serving.reload``          at the start of a serving hot-swap reload,
                              before staging
  ``fleet.replica_probe``     once per fleet health probe of one serving
                              replica
  ``fleet.rollout_step``      before each per-replica step of a rolling
                              generation rollout
  ``transform.producer``      once per packed bulk-transform batch
                              (producer thread)
  ``transform.shard_commit``  after each vector shard + sidecar manifest
                              commit
  ``fleet.shard_accept``      once per accepted connection on a balancer
                              data-plane shard
  ``fleet.autoscale_step``    before each warm-spare autoscaler policy
                              evaluation

Arming is via the ``GLINT_FAULTS`` environment variable (parsed once at
import) or :func:`arm` (tests). The spec grammar, ``;`` or ``,``
separated::

    point:action[@n]

      action := exc          raise FaultInjected at the point
              | kill         SIGKILL the current process
              | hang[=secs]  sleep (default 3600 s)
              | delay[=secs] sleep briefly (default 0.05 s), then continue
      @n     := fire on the n-th hit of that point (1-based; default 1).
                The point keeps counting afterwards but fires only once.

    GLINT_FAULTS="transform.shard_commit:exc@3"   fail the third commit
    GLINT_FAULTS="publish.pre_pointer:kill@2"     SIGKILL the second publish
                                                  between rename and pointer

Unarmed cost is one module-global ``is None`` check per :func:`fire`.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)

#: The injection-point registry: name -> what the point means.
#: :func:`parse_spec` validates specs against it and :func:`fire` rejects
#: undeclared names, so a typo fails loudly instead of never firing.
POINTS = {
    "worker.step":
        "once per dispatched training group (all fit loops)",
    "exchange.pre_send":
        "before each replica-exchange round's header allgather "
        "(a peer lost here leaves the others waiting in the collective)",
    "publish.pre_commit":
        "just before a published generation directory's atomic rename",
    "publish.pre_pointer":
        "between the generation rename and the LATEST pointer flip",
    "serving.dispatch":
        "once per coalesced/simple serving device dispatch",
    "serving.reload":
        "at the start of a serving hot-swap reload, before staging",
    "fleet.replica_probe":
        "once per fleet health probe of one serving replica",
    "fleet.rollout_step":
        "before each per-replica step of a rolling generation rollout",
    "transform.producer":
        "once per packed bulk-transform batch (producer thread)",
    "transform.shard_commit":
        "after each bulk-transform vector shard + sidecar manifest "
        "commit",
    "fleet.shard_accept":
        "once per accepted connection on a balancer data-plane shard",
    "fleet.autoscale_step":
        "before each warm-spare autoscaler policy evaluation",
}

_ACTIONS = ("exc", "kill", "hang", "delay")


class FaultInjected(RuntimeError):
    """Raised by an armed ``exc`` fault."""


class _Spec:
    __slots__ = ("point", "action", "arg", "at", "hits", "fired")

    def __init__(self, point: str, action: str, arg: Optional[float],
                 at: int):
        self.point = point
        self.action = action
        self.arg = arg
        self.at = at
        self.hits = 0
        self.fired = False


#: point -> armed spec; None when nothing is armed (the zero-cost path).
_ARMED: Optional[Dict[str, _Spec]] = None
_MU = threading.Lock()


def parse_spec(text: str) -> Dict[str, _Spec]:
    """Parse a ``GLINT_FAULTS`` spec string; raises ``ValueError`` with
    the offending clause on any grammar error."""
    out: Dict[str, _Spec] = {}
    for clause in text.replace(";", ",").split(","):
        clause = clause.strip()
        if not clause:
            continue
        try:
            point, _, rest = clause.partition(":")
            point = point.strip()
            if not rest:
                raise ValueError("missing action")
            action, _, at_s = rest.partition("@")
            at = int(at_s) if at_s else 1
            if at < 1:
                raise ValueError("@n must be >= 1")
            action, _, arg_s = action.partition("=")
            action = action.strip()
            arg = float(arg_s) if arg_s else None
            if point not in POINTS:
                raise ValueError(
                    f"unknown injection point {point!r} "
                    f"(valid: {', '.join(POINTS)})"
                )
            if action not in _ACTIONS:
                raise ValueError(
                    f"unknown action {action!r} "
                    f"(valid: {', '.join(_ACTIONS)})"
                )
        except ValueError as e:
            raise ValueError(f"bad GLINT_FAULTS clause {clause!r}: {e}")
        out[point] = _Spec(point, action, arg, at)
    return out


def arm(text: Optional[str]) -> None:
    """Arm from a spec string (None or empty disarms). Replaces any
    previously armed set wholesale."""
    global _ARMED
    specs = parse_spec(text) if text else {}
    with _MU:
        _ARMED = specs or None
    if specs:
        logger.warning(
            "fault injection ARMED: %s",
            "; ".join(f"{s.point}:{s.action}@{s.at}" for s in specs.values()),
        )


def disarm() -> None:
    arm(None)


def armed() -> bool:
    return _ARMED is not None


def fire(point: str) -> None:
    """Hit one injection point. Free (one global read) when unarmed; an
    undeclared ``point`` raises ``ValueError`` once any fault is armed."""
    if _ARMED is None:
        return
    if point not in POINTS:
        raise ValueError(
            f"undeclared injection point {point!r} fired "
            f"(valid: {', '.join(sorted(POINTS))})"
        )
    with _MU:
        spec = _ARMED.get(point) if _ARMED is not None else None
        if spec is None:
            return
        spec.hits += 1
        if spec.fired or spec.hits != spec.at:
            return
        spec.fired = True
    logger.error("fault injection FIRING %s:%s at hit %d",
                 point, spec.action, spec.at)
    if spec.action == "exc":
        raise FaultInjected(f"injected fault at {point} (hit {spec.at})")
    if spec.action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(60)  # pragma: no cover - never survives the signal
    if spec.action == "hang":
        time.sleep(spec.arg if spec.arg is not None else 3600.0)
        return
    if spec.action == "delay":
        time.sleep(spec.arg if spec.arg is not None else 0.05)


# Arm from the environment once at import, so a child process inherits its
# schedule with no code changes.
_env_spec = os.environ.get("GLINT_FAULTS")
if _env_spec:
    arm(_env_spec)
