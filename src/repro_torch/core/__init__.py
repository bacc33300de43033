"""The serial NumPy core of the port: instances, schedules, the ASAP
simulator, the schedule LP, the dense simplex and the solver-backend
registry.  Copies of the JAX package's NumPy modules (that package is the
reference and is never imported here); importing this package does not
import torch.
"""

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
from .schedule import Schedule, check_feasible
from .simplex import SimplexResult, solve_simplex
from .simulator import simulate
from .solver import lower_bound, solve, solve_batch

__all__ = [
    "AutoBackend", "LPResult", "ScipyBackend", "SimplexBackend", "SolveReport",
    "SolveRequest", "SolverBackend", "available_backends", "get_backend",
    "register_backend", "Chain", "Instance", "Loads", "Star", "Topology",
    "random_instance", "ScheduleLP", "build_lp", "extract_schedule", "Schedule",
    "check_feasible", "SimplexResult", "solve_simplex", "simulate", "lower_bound",
    "solve", "solve_batch",
]
