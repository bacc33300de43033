"""Fault tolerance & elasticity: failure injection, checkpoint/restart,
DLT re-planning (the paper's tau_i availability dates used for real), and
straggler mitigation via w_i EWMA feedback.

The port's copy of ``repro/runtime/ft.py``, over the port's
:class:`repro_torch.core.planner.Planner`.

The recovery path is exactly the paper's machinery:
  * stage failure  -> drop P_i from the chain, fuse its links, re-solve the LP
                      with availability dates tau_i = checkpoint-restore time;
  * straggler      -> observed step times update stage speeds (w_i EWMA,
                      Planner.observe_step_time); drift > 10% triggers replan
                      with hysteresis;
  * elastic join   -> insert a stage with tau_i = join time, re-solve.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core.planner import DLTPlan, LinkSpec, Planner, StageSpec

__all__ = ["FailureEvent", "FailureSim", "StragglerSim", "RecoveringChain"]


@dataclasses.dataclass
class FailureEvent:
    step: int
    stage: int
    restore_delay: float = 0.0  # seconds to restore the checkpoint on survivors


class FailureSim:
    """Deterministic failure injector (the chaos monkey for tests/examples)."""

    def __init__(self, events: list):
        self.events = sorted(events, key=lambda e: e.step)
        self.fired: list = []

    def check(self, step: int) -> Optional[FailureEvent]:
        for e in self.events:
            if e.step == step and e not in self.fired:
                self.fired.append(e)
                return e
        return None


class StragglerSim:
    """Simulated per-stage speed drift (a stage slowing down mid-run)."""

    def __init__(self, stage: int, after_step: int, slowdown: float = 2.0):
        self.stage = stage
        self.after_step = after_step
        self.slowdown = slowdown

    def effective_speed(self, stage: int, nominal: float, step: int) -> float:
        if stage == self.stage and step >= self.after_step:
            return nominal / self.slowdown
        return nominal


class RecoveringChain:
    """Planner + plan lifecycle under failures/stragglers.

    Wraps a Planner; owns the current plan; ``on_step``/``on_failure`` mutate
    the chain and re-solve.  The training loop stays dumb: it asks for the
    current plan, reports observations, and is told when the chain changed
    (so it can rebuild its jitted step for the new stage count).
    """

    def __init__(self, planner: Planner, batches: list, q: int | list = 1):
        self.planner = planner
        self.batches = list(batches)
        self.q = q
        self.plan: DLTPlan = planner.plan(self.batches, q=q)
        self.generation = 0  # bumped every re-plan that changes the chain size
        self.replans = 0
        self.log: list = []

    @property
    def n_stages(self) -> int:
        return len(self.planner.stages)

    def stage_names(self) -> list:
        return [s.name for s in self.planner.stages]

    def on_failure(self, ev: FailureEvent):
        """Drop the failed stage, fuse links, re-solve (paper §2 tau_i)."""
        self.planner, self.plan = self.planner.replan_without_stage(
            ev.stage, self.batches, restore_delay=ev.restore_delay, q=self.q
        )
        self.generation += 1
        self.replans += 1
        self.log.append(("failure", ev.stage, self.plan.makespan))

    def on_observation(self, stage: int, achieved_flops_per_sec: float) -> bool:
        """Feed an observed stage speed; re-plan on drift (straggler path).

        Returns True when the plan changed (sample counts moved off the slow
        stage) — the caller re-stages its batches.
        """
        drifted = self.planner.observe_step_time(stage, achieved_flops_per_sec)
        if drifted:
            self.plan = self.planner.plan(self.batches, q=self.q)
            self.replans += 1
            self.log.append(("straggler", stage, self.plan.makespan))
        return drifted

    def on_join(self, spec: StageSpec, link: LinkSpec, position: int | None = None):
        """Elastic scale-up: insert a stage (tau_i = its join time)."""
        pos = len(self.planner.stages) if position is None else position
        stages = list(self.planner.stages)
        links = list(self.planner.links)
        stages.insert(pos, spec)
        if pos >= len(stages) - 1:
            links.append(link)
        else:
            links.insert(min(pos, len(links)), link)
        self.planner = Planner(stages, links, ewma=self.planner.ewma)
        self.plan = self.planner.plan(self.batches, q=self.q)
        self.generation += 1
        self.replans += 1
        self.log.append(("join", spec.name, self.plan.makespan))
