"""Step builders and the planner's runtime in the port: the serve step,
event-stream replanning (:mod:`repro_torch.runtime.replan`) and the fault
tolerance machinery (:mod:`repro_torch.runtime.ft`); training comes with its
own slice."""

from . import ft, replan
from .ft import FailureEvent, FailureSim, RecoveringChain, StragglerSim
from .replan import (
    EventStreamReplanner,
    LoadArrived,
    ProcessorDown,
    ProcessorUp,
    SpeedObserved,
)
from .train import make_serve_step

__all__ = [
    "make_serve_step",
    "ft",
    "replan",
    "EventStreamReplanner",
    "LoadArrived",
    "ProcessorDown",
    "ProcessorUp",
    "SpeedObserved",
    "FailureEvent",
    "FailureSim",
    "StragglerSim",
    "RecoveringChain",
]
