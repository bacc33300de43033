"""Step builders and the planner's runtime in the port: the train step
(AdamW over microbatches) and its state, the serve step, event-stream
replanning (:mod:`repro_torch.runtime.replan`) and the fault tolerance
machinery (:mod:`repro_torch.runtime.ft`)."""

from . import ft, replan
from .ft import FailureEvent, FailureSim, RecoveringChain, StragglerSim
from .replan import (
    EventStreamReplanner,
    LoadArrived,
    ProcessorDown,
    ProcessorUp,
    SpeedObserved,
)
from .train import TrainState, make_serve_step, make_train_state, make_train_step

__all__ = [
    "TrainState",
    "make_train_state",
    "make_train_step",
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
