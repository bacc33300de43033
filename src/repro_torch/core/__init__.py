"""The serial NumPy core of the port: instances, schedules, the ASAP
simulator, the schedule LP, the dense simplex, the solver-backend registry,
the paper's §3 heuristics and closed forms, Theorem 1's machinery and the
planner.  Copies of the JAX package's NumPy modules (that package is the
reference and is never imported here); importing this package does not
import torch.
"""

from .closed_form import (
    LAMBDA_DIVERGENCE,
    LAMBDA_SINGLE_INSTALLMENT,
    example_instance,
    hand_schedule_lambda_3_4,
    makespan_1,
    makespan_2,
    multi_inst_makespan,
    multi_inst_q2,
    schedule_section_3_2,
    star_bus_instance,
    star_single_load_fractions,
    star_single_load_makespan,
)
from .heuristics import (
    ALL_HEURISTICS,
    HeuristicResult,
    adversary_sweep,
    heuristic_b,
    multi_inst,
    run_strategy,
    simple,
    single_inst,
    single_load,
)
from .backends import (
    AutoBackend,
    LPResult,
    ScipyBackend,
    SimplexBackend,
    SolveReport,
    SolveRequest,
    SolverBackend,
    available_backends,
    get_backend,
    register_backend,
)
from .instance import Chain, Instance, Loads, Star, Topology, random_instance
from .lp import ScheduleLP, build_lp, extract_schedule
from .planner import AutoTResult, BatchSpec, DLTPlan, LinkSpec, Planner, StageSpec
from .schedule import Schedule, check_feasible
from .simplex import SimplexResult, solve_simplex
from .simulator import simulate
from .solver import lower_bound, solve, solve_batch
from .theory import QStarResult, optimal_installments, q_monotonicity

__all__ = [
    "AutoBackend", "LPResult", "ScipyBackend", "SimplexBackend", "SolveReport",
    "SolveRequest", "SolverBackend", "available_backends", "get_backend",
    "register_backend", "Chain", "Instance", "Loads", "Star", "Topology",
    "random_instance", "ScheduleLP", "build_lp", "extract_schedule", "Schedule",
    "check_feasible", "SimplexResult", "solve_simplex", "simulate", "lower_bound",
    "solve", "solve_batch", "BatchSpec", "DLTPlan", "LinkSpec", "Planner", "StageSpec",
    "AutoTResult", "HeuristicResult", "simple", "single_load", "single_inst", "multi_inst",
    "heuristic_b", "adversary_sweep", "run_strategy", "ALL_HEURISTICS", "QStarResult",
    "q_monotonicity", "optimal_installments", "LAMBDA_SINGLE_INSTALLMENT", "LAMBDA_DIVERGENCE",
    "example_instance", "schedule_section_3_2", "makespan_1", "makespan_2", "multi_inst_q2",
    "multi_inst_makespan", "hand_schedule_lambda_3_4", "star_single_load_fractions",
    "star_single_load_makespan", "star_bus_instance",
]
