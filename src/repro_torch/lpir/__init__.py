"""repro_torch.lpir — the declarative schedule-LP intermediate representation.

One emitter (:func:`emit_schedule_ir`) walks the paper's Fig. 6 constraint
families — (1)-(10), the (2b)/(3b) own-port rows, and every §5 extension —
exactly once, producing a backend-neutral row stream; the lowerers in
:mod:`repro_torch.lpir.lower` turn that stream into sparse triplets (serial
simplex / HiGHS), dense ``[B, R, n_vars]`` batches (the batched engine
simplex), or a single dense tableau (the heuristics' equal-finish sub-LPs).
``core/lp.py``, ``engine/batched_lp.py``, and ``core/heuristics.py`` are all
thin consumers of this package — the families live nowhere else.
"""

from .ir import (
    ELIDABLE_KINDS,
    K_AVAIL,
    K_COMPLETENESS,
    K_COMPLETION,
    K_COMPUTE_AFTER_RECV,
    K_COMP_SERIAL,
    K_EQUAL_FINISH,
    K_GAMMA_ZERO,
    K_LINK_AVAIL,
    K_MAKESPAN,
    K_MAKESPAN_RET,
    K_MASTER_PORT,
    K_OWN_PORT,
    K_RECV_AFTER_FWD,
    K_RELEASE_COMM,
    K_RELEASE_COMP,
    K_RET_AFTER_COMP,
    K_RET_PORT,
    K_RET_SERIAL,
    K_RET_STORE_FORWARD,
    K_STORE_FORWARD,
    Row,
    ScheduleIR,
    VarLayout,
    elide_dead_rows,
    emit_schedule_ir,
)
from .lower import DenseBatch, SparseRows, lower_dense, lower_dense_batch, lower_sparse
from .views import BucketView, EqualFinishView, InstanceView, PerturbedView

__all__ = [
    "Row",
    "VarLayout",
    "ScheduleIR",
    "emit_schedule_ir",
    "elide_dead_rows",
    "ELIDABLE_KINDS",
    "InstanceView",
    "BucketView",
    "EqualFinishView",
    "PerturbedView",
    "SparseRows",
    "DenseBatch",
    "lower_sparse",
    "lower_dense",
    "lower_dense_batch",
    "K_STORE_FORWARD",
    "K_OWN_PORT",
    "K_RECV_AFTER_FWD",
    "K_MASTER_PORT",
    "K_RELEASE_COMM",
    "K_RELEASE_COMP",
    "K_LINK_AVAIL",
    "K_COMPUTE_AFTER_RECV",
    "K_COMP_SERIAL",
    "K_AVAIL",
    "K_COMPLETENESS",
    "K_MAKESPAN",
    "K_MAKESPAN_RET",
    "K_EQUAL_FINISH",
    "K_GAMMA_ZERO",
    "K_COMPLETION",
    "K_RET_AFTER_COMP",
    "K_RET_STORE_FORWARD",
    "K_RET_SERIAL",
    "K_RET_PORT",
]
