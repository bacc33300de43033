"""DLT chain runner: execute a planner schedule on a linear chain of stages,
the port of the reference's ``runtime/dlt_runner.py``, mirroring the
paper's platform model:

  * all load data starts on stage 0 (the head stage holds the dataset);
  * per cell (load, installment), the chunk hops down the chain stage by
    stage, store-and-forward: stage i keeps its planned rows
    ``[offs[i], offs[i] + counts[t, i])`` and sends the rows still owed
    downstream on to stage i + 1;
  * each stage runs the forward and backward passes on its own rows only,
    its loss scaled by its share of the super-step's samples, so the
    gradients accumulate in ``.grad`` as the train step's microbatches do;
  * the gradients and the loss are summed over the chain, then every stage
    takes the same AdamW step on its replica.

The chain is a stage group (:class:`LocalChain` or :class:`DistChain`,
built by :func:`repro_torch.launch.mesh.make_chain_mesh`).  A
:class:`LocalChain` runs every stage in one process on one device: a hop
hands the chunk's remaining rows to the next stage and the sum is the
identity, as the reference's forced host devices share one host.  A
:class:`DistChain` runs one stage a process of a ``torch.distributed``
group: a hop is ``isend``/``irecv`` (every receive of a step is posted at
its start and every send is asynchronous, so the next installment moves
while the current one computes: the overlap the reference leaves to XLA's
async ``ppermute``), and the sum is ``all_reduce`` over flat buckets of the
gradients.

Where the reference runs ``loss_fn`` on the whole padded chunk with a mask,
on every device for every cell and hop, each stage here computes its own
rows once.  The loss equals a single pass over the same samples up to the
order of the sums (``tests/test_torch_dlt_runner.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.config import ArchConfig, ShardingPolicy, TrainConfig
from repro_torch.core.planner import DLTPlan, Planner
from repro_torch.models import loss_fn

from .train import GradAccumulator, TrainState, apply_update, refuse_kernel_attention

__all__ = ["stage_batches", "make_dlt_train_step", "ChainReplanner", "LocalChain",
           "DistChain"]

# gradients summed across a DistChain in flat buckets of at most this size
SUM_BUCKET_BYTES = 256 << 20


class ChainReplanner:
    """Online replanning for a running platform, through the session front door.

    Owns a :class:`repro_torch.core.planner.Planner` and shares its
    :class:`repro_torch.api.Session` (backend handles + solution cache):
    every replan (straggler drift, stage failure, or a bulk what-if sweep)
    is stated as a (Problem, Policy) pair against the ``backend`` registry
    entry, and platform states the chain has seen before replay from the
    session's cache instead of re-solving.

    ``backend`` defaults to ``"cuda"`` (the engine's simplex pivot and ASAP
    replay kernels on the card; the reference's ``"batched"`` on the
    accelerator), and raises where there is no card; ``"torch"`` runs the
    same engine through the kernels' plain versions.  ``device`` pins the
    planner's session to a device when it has none yet (``"cpu"`` with
    ``backend="torch"`` runs here); ``None`` keeps the session's (the card
    unless it was made otherwise).
    """

    def __init__(self, planner: Planner, q: int | list = 2, backend="cuda", device=None):
        from repro_torch.api import Session
        from repro_torch.convert import resolve_device

        if device is not None:
            if planner._session is None:
                planner._session = Session(cache=planner._cache0, device=device)
                planner._cache0 = None
            elif planner.session.device != resolve_device(device):
                raise ValueError(f"the planner's session runs on {planner.session.device}, "
                                 f"not {device}")
        self.planner = planner
        self.q = q
        self.backend = backend
        self.session = planner.session
        if backend == "cuda" and self.session.device.type != "cuda":
            raise ValueError("the 'cuda' backend runs on the card; this planner's session "
                             f"is on {self.session.device}")

    def _backend_args(self):
        """(registry name for the Policy, instance override or None)."""
        if isinstance(self.backend, str):
            return self.backend, None
        return "auto", self.backend

    def stream(self, batches: list, policy=None, warm: bool = True):
        """Open an online :class:`repro_torch.runtime.replan.EventStreamReplanner`
        for this chain's current problem, on this replanner's session: each
        re-solve warm-starts from the previous exit basis, and subscribers
        see every plan update."""
        from repro_torch.api import Policy

        from .replan import EventStreamReplanner

        name, override = self._backend_args()
        if policy is None:
            policy = Policy(installments=self.q, backend=name)
        return EventStreamReplanner(self.session, self.planner.to_problem(batches), policy,
                                    warm=warm, backend=override)

    def replan(self, batches: list) -> DLTPlan:
        """One offline re-solve (see :meth:`stream` for the online path)."""
        return self.planner.plan(batches, q=self.q, backend=self.backend)

    def observe(self, stage: int, achieved_flops_per_sec: float, batches: list):
        """EWMA speed feedback; returns a fresh plan when drift demands one."""
        if self.planner.observe_step_time(stage, achieved_flops_per_sec):
            return self.replan(batches)
        return None

    def on_failure(self, dead: int, batches: list, restore_delay: float = 0.0):
        """Stage loss: fuse links, carry the session over, re-solve."""
        p2, plan = self.planner.replan_without_stage(
            dead, batches, restore_delay=restore_delay, q=self.q, backend=self.backend)
        self.planner = p2
        return plan

    def auto_installments(self, batches: list, t_max: int = 8, installment_cost: float = 0.0):
        """Cost-aware installment chooser for the running chain: one bulk
        sweep (``Planner.plan_auto_T``) through this replanner's backend and
        cache.  Returns the :class:`repro_torch.core.planner.AutoTResult`."""
        return self.planner.plan_auto_T(batches, t_max=t_max,
                                        installment_cost=installment_cost,
                                        backend=self.backend)

    def what_if_speeds(self, batches: list, speed_scales) -> np.ndarray:
        """Straggler sensitivity: predicted makespan per speed scenario.

        ``speed_scales`` is [S, m] multipliers on the stages' effective
        FLOP/s; all S hypothetical problems solve in one session bulk call.
        Returns the S predicted makespans.
        """
        import dataclasses

        from repro_torch.api import Policy

        problems = []
        m = len(self.planner.stages)
        for scales in np.atleast_2d(np.asarray(speed_scales, dtype=np.float64)):
            if scales.shape != (m,):
                raise ValueError(f"speed_scales rows must have one entry per stage ({m}), "
                                 f"got {scales.shape}")
            stages = [dataclasses.replace(s, flops_per_sec=s.flops_per_sec * float(f))
                      for s, f in zip(self.planner.stages, scales)]
            p = Planner(stages, self.planner.links, ewma=self.planner.ewma,
                        topology=self.planner.topology, session=self.session)
            problems.append(p.to_problem(batches))
        name, override = self._backend_args()
        arts = self.session.solve_bulk(problems, Policy(installments=self.q, backend=name),
                                       backend=override)
        return np.array([a.makespan for a in arts])


def stage_batches(plan: DLTPlan, batches: list, n_stages: int):
    """Stack the per-cell host batches for the runner.

    Returns (tokens [T, cap, S], labels [T, cap, S], counts [T, n_stages]):
    every cell padded to the largest cell size; data logically lives on
    stage 0 (the runner sends it down the chain from there).
    """
    T = len(plan.cells)
    caps = [int(np.sum(plan.samples[t])) for t in range(T)]
    cap = max(caps)
    tok_list, lab_list = [], []
    consumed = {n: 0 for n in range(len(batches))}
    for t, (n, _) in enumerate(plan.cells):
        k = caps[t]
        start = consumed[n]
        tok = batches[n]["tokens"][start: start + k]
        lab = batches[n]["labels"][start: start + k]
        consumed[n] += k
        pad = cap - k
        if pad:
            tok = np.concatenate([tok, np.zeros((pad,) + tok.shape[1:], tok.dtype)])
            lab = np.concatenate([lab, np.zeros((pad,) + lab.shape[1:], lab.dtype)])
        tok_list.append(tok)
        lab_list.append(lab)
    counts = np.array([[int(c) for c in plan.samples[t]] for t in range(T)], dtype=np.int32)
    return np.stack(tok_list), np.stack(lab_list), counts


# ---------------------------------------------------------------- stage groups


class LocalChain:
    """A chain of ``size`` stages in one process, on one device and one
    replica of the model.  A hop hands a cell's remaining rows to the next
    stage; :meth:`sum_` is the identity (the stages already share their
    gradients).

    A step calls :meth:`begin` with every cell's rows on the host, then, for
    each cell and each stage the process runs, :meth:`arrive` (the rows that
    reach the stage, its own first) and :meth:`hop` (the rows past its own
    sent on), and :meth:`end` after the last cell; :class:`DistChain` has
    the same methods."""

    rank = 0

    def __init__(self, size: int, device):
        if size < 1:
            raise ValueError(f"a chain needs at least one stage, got {size}")
        self.size = size
        self.device = torch.device(device)
        self.stages = tuple(range(size))
        self.seconds = {"hop": 0.0, "sum": 0.0}
        self._held: dict = {}

    def begin(self, packed: torch.Tensor, counts: np.ndarray) -> None:
        """Start a step: stage 0 holds every cell's rows ``packed[t, :k_t]``
        (``packed`` [T, cap, width] on the host, put on the device here)."""
        packed = packed.to(self.device)
        self._held = {(t, 0): packed[t, :int(counts[t].sum())] for t in range(len(counts))}

    def arrive(self, t: int, stage: int) -> torch.Tensor:
        """Cell ``t``'s rows as they reach ``stage``: its own first."""
        return self._held[(t, stage)]

    def hop(self, t: int, stage: int, n: int) -> None:
        """Send the rows of cell ``t`` that ``stage`` does not keep (all but
        its first ``n``) on to ``stage + 1``."""
        rows = self._held.pop((t, stage))
        if stage + 1 < self.size:
            self._held[(t, stage + 1)] = rows[n:]

    def end(self) -> None:
        self._held = {}

    def sum_(self, tensors: list) -> None:
        """Sum ``tensors`` over the chain in place: one replica, nothing to do."""

    def barrier(self) -> None:
        """Wait for every stage: one process, nothing to wait for."""

    def shrink(self, size: int) -> "LocalChain":
        """The chain of the first ``size`` stages."""
        return LocalChain(size, self.device)


class DistChain:
    """One stage a process: the ranks of a ``torch.distributed`` group are
    the stages, rank = stage (the group's ranks are the first ``size`` of
    the world, so a group rank is the global one).

    Hops are ``isend``/``irecv``, tagged with the cell.  With ``gloo`` on a
    CUDA device (ranks that share a card, where NCCL refuses two ranks)
    the rows hop between host buffers, page-locked where they are received,
    and each stage copies its own to the card: gloo's point-to-point takes
    CPU tensors only, while its ``all_reduce`` takes CUDA tensors and stages
    them itself.  ``seconds`` accumulates the host time spent in hops
    (posting, sending, and waiting for what arrives) and in :meth:`sum_`."""

    def __init__(self, device, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = torch.device(device)
        self.stages = (self.rank,)
        self.backend = dist.get_backend(group)
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.seconds = {"hop": 0.0, "sum": 0.0}
        self._recv: dict = {}
        self._rows: dict = {}
        self._sends: list = []
        self._empty = None

    def begin(self, packed: torch.Tensor, counts: np.ndarray) -> None:
        """Start a step: stage 0 holds every cell's rows ``packed[t, :k_t]``
        (on the host; only stage 0 reads the values); every later stage
        posts the receives of its rows of every cell now."""
        t0 = time.perf_counter()
        self._sends, self._recv, self._rows = [], {}, {}
        width, dtype = packed.shape[2:], packed.dtype
        self._empty = torch.empty((0, *width), dtype=dtype, device=self.device)
        if self.rank == 0:
            on_device = packed.to(self.device)
            for t, cnt in enumerate(counts):
                k = int(cnt.sum())
                self._rows[t] = (on_device[t, :k], packed[t, :k])
        else:
            for t, cnt in enumerate(counts):
                n = int(cnt[self.rank:].sum())
                if n == 0:
                    continue
                buf = (torch.empty((n, *width), dtype=dtype, pin_memory=True) if self.staged
                       else torch.empty((n, *width), dtype=dtype, device=self.device))
                work = self._dist.irecv(buf, self.rank - 1, group=self.group, tag=t)
                self._recv[t] = (buf, work)
        self.seconds["hop"] += time.perf_counter() - t0

    def arrive(self, t: int, stage: int) -> torch.Tensor:
        if t in self._recv:
            t0 = time.perf_counter()
            buf, work = self._recv.pop(t)
            work.wait()
            self._rows[t] = ((buf.to(self.device, non_blocking=True), buf) if self.staged
                             else (buf, None))
            self.seconds["hop"] += time.perf_counter() - t0
        # a cell with nothing owed to this stage or beyond arrives empty
        return self._rows.get(t, (self._empty,))[0]

    def hop(self, t: int, stage: int, n: int) -> None:
        rows, host = self._rows.pop(t, (self._empty, None))
        if stage + 1 >= self.size or rows.shape[0] == n:
            return
        t0 = time.perf_counter()
        out = host[n:] if self.staged else rows[n:].contiguous()
        self._sends.append((out, self._dist.isend(out, self.rank + 1, group=self.group,
                                                  tag=t)))
        self.seconds["hop"] += time.perf_counter() - t0

    def end(self) -> None:
        t0 = time.perf_counter()
        for _, work in self._sends:
            work.wait()
        self._sends, self._recv, self._rows = [], {}, {}
        self.seconds["hop"] += time.perf_counter() - t0

    def sum_(self, tensors: list) -> None:
        """Sum ``tensors`` over the chain in place: ``all_reduce(SUM)`` of
        flat buckets (one dtype each, at most :data:`SUM_BUCKET_BYTES`)."""
        t0 = time.perf_counter()
        buckets, filled = [], 0
        for x in tensors:
            nbytes = x.numel() * x.element_size()
            if not buckets or buckets[-1][0].dtype != x.dtype or filled + nbytes > SUM_BUCKET_BYTES:
                buckets.append([])
                filled = 0
            buckets[-1].append(x)
            filled += nbytes
        for b in buckets:
            flat = torch.cat([x.reshape(-1) for x in b])
            self._dist.all_reduce(flat, op=self._dist.ReduceOp.SUM, group=self.group)
            off = 0
            for x in b:
                x.copy_(flat[off: off + x.numel()].view_as(x))
                off += x.numel()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds["sum"] += time.perf_counter() - t0

    def barrier(self) -> None:
        self._dist.barrier(group=self.group)

    def shrink(self, size: int) -> "DistChain | None":
        """The chain of the first ``size`` ranks: a new group, made by every
        rank of this one (``new_group`` is collective); ``None`` on a rank
        outside it, which leaves the chain."""
        ranks = list(range(size))
        group = self._dist.new_group(ranks=ranks)
        return DistChain(self.device, group) if self.rank < size else None


# ---------------------------------------------------------------- the train step


def _pack(tokens, labels) -> torch.Tensor:
    """Tokens and labels [T, cap, ...] side by side as one int tensor
    [T, cap, w_tok + w_lab] on the host: a hop moves one message."""
    tok, lab = torch.as_tensor(tokens).cpu(), torch.as_tensor(labels).cpu()
    T, cap = tok.shape[:2]
    return torch.cat([tok.reshape(T, cap, -1), lab.reshape(T, cap, -1).to(tok.dtype)], dim=2)


def make_dlt_train_step(cfg: ArchConfig, policy: ShardingPolicy, tcfg: TrainConfig, chain,
                        n_cells: int):
    """Build the chain train step for a fixed number of cells.

    Signature: step(state, tokens [T, cap, S], labels [T, cap, S],
    counts [T, m]) -> (state, metrics), with the reference's metrics
    (``loss``, ``lr``, ``grad_norm``, ...) as tensors.  ``tokens`` and
    ``labels`` (NumPy or tensors, from :func:`stage_batches`) are read by
    the process holding stage 0 only; ``counts`` is on the host.  The
    state is updated in place, as :func:`repro_torch.runtime.make_train_step`
    updates it; after the step each float32 parameter's ``.grad`` holds the
    chain's summed gradient.  Every stage's forward and backward is under a
    ``chain.stage{i}`` profiler scope.
    """
    refuse_kernel_attention(policy)
    m = chain.size

    def step(state: TrainState, tokens, labels, counts):
        counts = np.asarray(counts)
        if counts.shape != (n_cells, m):
            raise ValueError(f"counts must be [{n_cells}, {m}] (cells, stages), got "
                             f"{counts.shape}")
        model = state.params
        dev = model.embed.device
        w_tok = int(np.prod(tokens.shape[2:]))
        tail = tuple(tokens.shape[2:])
        lab_tail = tuple(labels.shape[2:])
        total_n = int(counts.sum())
        acc = GradAccumulator(model)
        loss = torch.zeros(1, dtype=torch.float32, device=dev)
        chain.begin(_pack(tokens, labels), counts)
        for t in range(n_cells):
            for s in chain.stages:
                rows = chain.arrive(t, s)
                n = int(counts[t, s])
                chain.hop(t, s, n)
                if n == 0:
                    continue
                with record_function(f"chain.stage{s}"):
                    mine = rows[:n]
                    batch = {"tokens": mine[:, :w_tok].reshape(n, *tail),
                             "labels": mine[:, w_tok:].reshape(n, *lab_tail)}
                    total, _ = loss_fn(model, cfg, policy, batch)
                    acc.backward(total * (n / total_n))
                    loss = loss + total.detach() * (n / total_n)
        chain.end()
        grads = acc.gradients()
        with record_function("chain.sum"):
            chain.sum_([*grads.values(), loss])
        lr, om = apply_update(state, grads, tcfg)
        return state, {"loss": loss[0], "lr": lr, **om}

    return step
