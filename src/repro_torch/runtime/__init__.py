"""Step builders and the planner's runtime in the port: the sharding rules
and FSDP (:mod:`repro_torch.runtime.sharding`), the train step (AdamW over
microbatches, sharded or not) and its state, the serve step, the DLT chain
runner and its replanner (:mod:`repro_torch.runtime.dlt_runner`),
event-stream replanning (:mod:`repro_torch.runtime.replan`) and the fault
tolerance machinery (:mod:`repro_torch.runtime.ft`)."""

from . import dlt_runner, ft, replan, sharding
from .dlt_runner import ChainReplanner, make_dlt_train_step, stage_batches
from .ft import FailureEvent, FailureSim, RecoveringChain, StragglerSim
from .replan import (
    EventStreamReplanner,
    LoadArrived,
    ProcessorDown,
    ProcessorUp,
    SpeedObserved,
)
from .sharding import batch_specs, cache_specs, named, param_specs, shard_model, shardings_for
from .train import TrainState, make_serve_step, make_train_state, make_train_step

__all__ = [
    "param_specs",
    "batch_specs",
    "cache_specs",
    "shardings_for",
    "named",
    "shard_model",
    "sharding",
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
