"""Step builders and the planner's runtime in the port: the train step
(AdamW over microbatches) and its state, the serve step, the DLT chain
runner and its replanner (:mod:`repro_torch.runtime.dlt_runner`),
event-stream replanning (:mod:`repro_torch.runtime.replan`) and the fault
tolerance machinery (:mod:`repro_torch.runtime.ft`)."""

from . import dlt_runner, ft, replan
from .dlt_runner import ChainReplanner, make_dlt_train_step, stage_batches
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
    "stage_batches",
    "make_dlt_train_step",
    "ChainReplanner",
    "dlt_runner",
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
