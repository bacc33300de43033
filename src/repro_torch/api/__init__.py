"""repro_torch.api — the planner's front door in the port.

Declarative specs + a session that owns the serving state:

* :class:`Problem` — the full scheduling instance (topology, platform
  arrays, loads with release dates and return ratios), frozen and hashable;
* :class:`Policy` — how to solve it (installments fixed or auto-T*,
  backend, objective, cache quantum, fallback rules), frozen and hashable;
* :class:`Session` — ``solve`` / ``solve_bulk`` / async ``submit`` with
  coalescing micro-batch flushing, owning the backend handles and the
  solution cache;
* :class:`PlanTicket` — the future-style handle ``submit`` returns;
* :class:`PlanArtifact` — the versioned, JSON-round-trippable result
  (schedule decision + makespan + provenance).

Copies of the reference package's ``repro.api`` (the reference is never
imported): the specs, the artifact and its JSON document are the same, and
the session runs the port's engine.  Its engine backends are ``"torch"``
(on the session's device: ``device=None`` is the CUDA card and raises where
there is none, ``device="cpu"`` runs the kernels' plain versions) and
``"cuda"`` (the card and its hand-written kernels, never degraded).  A
session on a serial backend (``"auto"``, the default) stays NumPy.
``Planner`` (:mod:`repro_torch.core.planner`) is a shim over a Session.
"""

from .artifact import ARTIFACT_VERSION, PlanArtifact
from .session import PlanSubscription, PlanTicket, Session
from .spec import Policy, Problem

__all__ = [
    "Problem",
    "Policy",
    "Session",
    "PlanTicket",
    "PlanSubscription",
    "PlanArtifact",
    "ARTIFACT_VERSION",
    "default_session",
]

_DEFAULT: Session | None = None


def default_session() -> Session:
    """The shared process-wide session (lazily created).

    Used by the compatibility shims when the caller did not wire a session
    of their own; sharing it means shim traffic coalesces into the same
    cache and backend handles instead of fragmenting per call site.
    """
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Session()
    return _DEFAULT
