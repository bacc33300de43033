"""The engine's front door on a device: ``solve_bulk``.

The port of ``repro/engine/service.py``.  ``solve_bulk`` evaluates a whole
population of instances:

  1. cache lookup on the quantized-instance hash (hits replay through the
     batched ASAP replay);
  2. misses are packed into exact ``(topology, returns, m, T, q)`` buckets
     (arena.py), their Fig.-6 LPs stacked through the one IR and solved by
     the batched simplex (:mod:`repro_torch.engine.batched_simplex`);
  3. every solved gamma batch is ASAP-replayed through the batched replay
     (:mod:`repro_torch.engine.batched_sim`) and certified against the LP
     makespan;
  4. any batch element the batched path could not certify (non-optimal
     status, or replay exceeding the LP objective beyond tolerance) goes to
     the serial NumPy solver — the engine's semantics, counted in
     ``repro_engine_fallback_total`` and in each result's telemetry, not a
     device fallback.

``device=None`` runs on the CUDA card, through the hand-written kernels
(:mod:`repro_torch.kernels`), and raises when there is no card; only an
explicit ``device="cpu"`` runs the same path on the CPU, through the
kernels' plain versions.  Results are labelled ``"cuda"`` or ``"torch"``
accordingly.

``TorchBackend`` / ``CudaBackend`` expose this path through the solver
backend registry (``repro_torch.core.backends``: ``"torch"``, ``"cuda"``).
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.convert import resolve_device
from repro_torch.core.backends import SolveReport, SolveRequest, SolverBackend, get_backend
from repro_torch.core.instance import Instance
from repro_torch.core.schedule import Schedule
from repro_torch.core.simulator import simulate
from repro_torch.core.solver import LPResult, solve
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import span

from .arena import InstanceArena
from .batched_lp import build_lp_bucket
from .batched_sim import simulate_bucket
from .batched_simplex import STATUS, solve_simplex_batched
from .cache import CachedSolution, SolutionCache

__all__ = ["solve_bulk", "TorchBackend", "CudaBackend"]

_REPLAY_TOL = 1e-6


def _result_from_gamma(
    inst: Instance, gamma: np.ndarray, lp_makespan: float, backend: str,
    sched: Schedule | None = None,
) -> LPResult:
    if sched is None:
        sched = simulate(inst, gamma)
    return LPResult(
        schedule=sched,
        lp_makespan=float(lp_makespan),
        objective_value=float(sched.makespan),
        backend=backend,
        status="optimal",
        n_vars=-1,
        n_rows=-1,
    )


def _replay_hits(instances, hit_idx, sols, results, label, device,
                 cache_s, met) -> None:
    """Re-materialize cached gammas through the batched ASAP replay.

    Hits used to call the serial ``simulate(inst, gamma)`` loop one instance
    at a time; packing them into (ladder-padded) arena buckets and replaying
    each bucket in one ``simulate_bucket`` launch keeps a
    warm-cache ``solve_bulk`` out of per-instance Python entirely.  Every
    hit gets the full v2 telemetry shape (stages/bucket/lp + ``cache_hit``)
    so :meth:`PlanArtifact.diff` works across hit/miss pairs.
    """
    t0 = time.perf_counter()
    telem_slots: list = []  # (result index, bucket info) — timed after replay
    with span("engine.hit_replay", n=len(hit_idx)):
        arena = InstanceArena([instances[i] for i in hit_idx], pad_shapes=True)
        for bucket in arena.buckets:
            g = bucket.gamma_padded(
                [sols[hit_idx[j]].gamma for j in bucket.indices])
            cs, ce, ps, pe, rs, re, mk = simulate_bucket(
                bucket, g, device=device)
            if rs is not None:
                rs, re = bucket.unpad(rs), bucket.unpad(re)
            cs, ce = bucket.unpad(cs), bucket.unpad(ce)
            ps, pe = bucket.unpad(ps), bucket.unpad(pe)
            bucket_info = {"B": bucket.B, "topology": bucket.topology,
                           "m": bucket.m_real, "T": bucket.T_real,
                           "q": [int(x) for x in bucket.q]}
            for b in range(bucket.B):
                gi = hit_idx[bucket.indices[b]]
                sol = sols[gi]
                sched = Schedule(
                    instance=bucket.instances[b],
                    gamma=np.asarray(sol.gamma, dtype=np.float64),
                    comm_start=cs[b],
                    comm_end=ce[b],
                    comp_start=ps[b],
                    comp_end=pe[b],
                    makespan=float(mk[b]),
                    ret_start=rs[b] if rs is not None else None,
                    ret_end=re[b] if re is not None else None,
                )
                results[gi] = _result_from_gamma(
                    bucket.instances[b], sol.gamma, sol.lp_makespan,
                    label + "+cache", sched=sched,
                )
                telem_slots.append((gi, bucket_info))
    replay_s = time.perf_counter() - t0
    met.observe("repro_engine_stage_seconds", replay_s,
                stage="hit_replay", path=label)
    for gi, bucket_info in telem_slots:
        # cached solutions are only ever optimal certified gammas; their
        # pivot counts were spent (and recorded) at miss time
        results[gi].telemetry = {
            "stages": {"cache_lookup_s": cache_s, "replay_s": replay_s},
            "bucket": dict(bucket_info),
            "lp": {"pivots_phase1": 0, "pivots_phase2": 0,
                   "status": "optimal"},
            "cache_hit": True,
        }


def solve_bulk(
    instances: list,
    objective: str = "makespan",
    cache: SolutionCache | None = None,
    fallback: bool = True,
    validate: bool = True,
    warm_starts: list | None = None,
    device=None,
    devices: list | None = None,
    n_shards: int | None = None,
) -> list:
    """Solve many instances at once; returns ``LPResult``s in caller order.

    Only the paper's makespan objective runs on the batched path; other
    objectives delegate to the serial solver per instance.  ``validate``
    is forwarded to the serial solver on the (rare) uncertified-element
    fallback — the batched path itself always certifies by replay.

    ``device`` (None: the CUDA card; raises with no card) runs the LP
    solves and the replays there, through the hand-written kernels;
    ``device="cpu"`` runs their plain versions.  The results' ``backend``
    label is ``"cuda"`` or ``"torch"`` accordingly.

    ``warm_starts`` (optional, parallel to ``instances``) carries per-
    instance exit bases from a previous solve of a perturbed sibling; rows
    with a usable basis enter the simplex phase-2-only (replan hot path),
    everything else — ``None`` entries, shape mismatches, rejected seeds —
    solves cold, identically to omitting the argument.  The exit basis of
    every engine-solved instance rides back in
    ``result.telemetry["lp"]["final_basis"]`` for the *next* replan.

    ``devices``/``n_shards`` (the reference's sharded fan-out) are not
    ported yet and raise ``NotImplementedError``.
    """
    if devices is not None or n_shards is not None:
        raise NotImplementedError(
            "sharded solve_bulk (devices=/n_shards=) is not ported yet")
    dev = resolve_device(device)
    label = "cuda" if dev.type == "cuda" else "torch"
    if objective != "makespan":
        return [solve(inst, objective=objective, validate=validate) for inst in instances]

    met = obs_metrics.get_registry()
    met.inc("repro_engine_bulk_solves_total", path=label)
    with span("engine.solve_bulk", n=len(instances), path=label):
        n = len(instances)
        results: list = [None] * n
        t0 = time.perf_counter()
        with span("engine.cache_lookup", n=n):
            if cache is not None:
                # bulk key derivation + one batched LRU pass — the per-
                # instance quantize/hash loop was ~90% of warm-cache wall
                keys = cache.keys(instances, objective)
                sols = cache.lookup_many(keys)
            else:
                keys = [None] * n
                sols = [None] * n
            pending = [i for i, sol in enumerate(sols) if sol is None]
            hit_idx = [i for i in range(n) if sols[i] is not None]
        cache_s = time.perf_counter() - t0
        if hit_idx:
            _replay_hits(instances, hit_idx, sols, results, label,
                         dev, cache_s, met)
        if not pending:
            return results

        t0 = time.perf_counter()
        with span("engine.pack", n=len(pending)):
            arena = InstanceArena([instances[i] for i in pending], pad_shapes=False)
        pack_s = time.perf_counter() - t0

        for bucket in arena.buckets:
            _solve_bucket(bucket, instances, results, keys, pending, cache,
                          label, dev, fallback, validate, met,
                          {"cache_lookup_s": cache_s, "pack_s": pack_s},
                          warm_starts)
    return results


def _solve_bucket(bucket, instances, results, keys, pending, cache, label,
                  device, fallback, validate, met, shared_stages,
                  warm_starts=None) -> None:
    """Solve one packed bucket in place: LP build -> batched simplex ->
    batched ASAP replay -> certify-or-rescue, with per-stage timings and
    solver telemetry recorded on every report (DESIGN.md §8)."""
    B = bucket.B
    q_label = "-".join(str(int(x)) for x in bucket.q)
    bucket_t0 = time.perf_counter()
    with span("engine.bucket", B=B, topology=bucket.topology,
              m=bucket.m_real, T=bucket.T_real, q=q_label):
        t0 = time.perf_counter()
        with span("engine.lp_build", B=B):
            lp = build_lp_bucket(bucket)
            c = np.tile(lp.c, (B, 1))  # objective pattern is bucket-constant
        lp_build_s = time.perf_counter() - t0

        n_rows = lp.A_ub.shape[1] + lp.A_eq.shape[1]
        wb = None
        if warm_starts is not None:
            wb = bucket.basis_padded(
                [warm_starts[pending[i]] for i in bucket.indices], n_rows)

        t0 = time.perf_counter()
        with span("engine.simplex", B=B, rows=len(lp.b_ub) + len(lp.b_eq)):
            res = solve_simplex_batched(c, lp.A_ub, lp.b_ub, lp.A_eq, lp.b_eq,
                                        warm_basis=wb, device=device)
        simplex_s = time.perf_counter() - t0
        if wb is not None:
            met.inc("repro_simplex_warm_starts_total",
                    int(res.warm_started.sum()), path=label)
        met.inc("repro_simplex_pivots_total",
                int(res.iterations_phase1.sum()), phase="1", path=label)
        met.inc("repro_simplex_pivots_total",
                int(res.iterations_phase2.sum()), phase="2", path=label)
        for code, count in zip(*np.unique(res.status, return_counts=True)):
            met.inc("repro_simplex_status_total", int(count),
                    status=STATUS[int(code)], path=label)

        gammas = lp.gamma_of(res.x)
        lp_mks = lp.makespan_of(res.x)

        # replay every solved gamma through the batched ASAP simulator
        # (rs/re are None unless the bucket activates the return phase)
        t0 = time.perf_counter()
        with span("engine.replay", B=B):
            cs, ce, ps, pe, rs, re, mk = simulate_bucket(
                bucket, bucket.gamma_padded(list(gammas)), device=device)
        replay_s = time.perf_counter() - t0

        stages = dict(shared_stages, lp_build_s=lp_build_s,
                      simplex_s=simplex_s, replay_s=replay_s)
        bucket_info = {"B": B, "topology": bucket.topology,
                       "m": bucket.m_real, "T": bucket.T_real,
                       "q": [int(x) for x in bucket.q]}

        def telem(b: int, extra: dict | None = None) -> dict:
            lp_info = {
                "pivots_phase1": int(res.iterations_phase1[b]),
                "pivots_phase2": int(res.iterations_phase2[b]),
                "status": res.status_str(b),
                # warm-start provenance: whether the seed served this element,
                # and the exit basis (JSON-safe ints) the next replan may seed
                # from — the basis rides the artifact, not solver state
                "warm": bool(res.warm_started[b]) if res.warm_started is not None else False,
            }
            if res.basis is not None:
                lp_info["final_basis"] = [int(v) for v in res.basis[b]]
            out = {
                "stages": dict(stages),
                "bucket": dict(bucket_info),
                "lp": lp_info,
            }
            if extra:
                out.update(extra)
            return out

        for b in range(B):
            gi = pending[bucket.indices[b]]
            inst = bucket.instances[b]
            certified = (
                res.status[b] == 0
                and np.isfinite(lp_mks[b])
                and mk[b] <= lp_mks[b] * (1 + _REPLAY_TOL) + 1e-9
            )
            if not certified:
                if not fallback:
                    raise RuntimeError(
                        f"batched solve failed for instance {gi}: "
                        f"status={res.status_str(b)} replay={mk[b]} lp={lp_mks[b]}"
                    )
                met.inc("repro_engine_fallback_total", path=label,
                        reason=res.status_str(b))
                t0 = time.perf_counter()
                with span("engine.serial_rescue", index=gi,
                          status=res.status_str(b)):
                    results[gi] = solve(inst, objective="makespan",
                                        validate=validate)
                results[gi].telemetry = telem(b, {
                    "serial_rescue": {
                        "reason": res.status_str(b),
                        "seconds": time.perf_counter() - t0,
                        "backend": results[gi].backend,
                    },
                })
                if cache is not None and results[gi].ok:
                    cache.put(keys[gi], CachedSolution(
                        gamma=results[gi].schedule.gamma,
                        lp_makespan=results[gi].lp_makespan,
                        backend="serial",
                    ))
                continue
            sched = Schedule(
                instance=inst,
                gamma=gammas[b],
                comm_start=cs[b],
                comm_end=ce[b],
                comp_start=ps[b],
                comp_end=pe[b],
                makespan=float(mk[b]),
                ret_start=rs[b] if rs is not None else None,
                ret_end=re[b] if re is not None else None,
            )
            results[gi] = _result_from_gamma(
                inst, gammas[b], lp_mks[b], label, sched=sched
            )
            results[gi].telemetry = telem(b)
            if cache is not None:
                cache.put(keys[gi], CachedSolution(
                    gamma=gammas[b], lp_makespan=float(lp_mks[b]), backend=label
                ))
    bucket_s = time.perf_counter() - bucket_t0
    met.observe("repro_engine_bucket_solve_seconds", bucket_s,
                topology=bucket.topology, m=bucket.m_real, T=bucket.T_real,
                q=q_label, path=label)
    for stage, dt in (("lp_build", lp_build_s), ("simplex", simplex_s),
                      ("replay", replay_s)):
        met.observe("repro_engine_stage_seconds", dt, stage=stage, path=label)




class TorchBackend(SolverBackend):
    """The engine's bulk path behind the ``SolverBackend`` registry, on the
    device its caller names (``device=None``: the CUDA card, raising when
    there is none).

    ``solve_many`` routes makespan requests through :func:`solve_bulk`
    (cache-first, bucketed, batched); requests the batched path cannot
    express — other objectives (whose ``weights``/``beta`` must be honored)
    or an explicit ``cross_check`` — delegate to the serial reference solver
    with their full request, so no request field is ever silently dropped.
    Reports come back in caller order with their requests attached.
    """

    name = "torch"

    def __init__(self, cache: SolutionCache | None = None, fallback: bool = True,
                 device=None):
        super().__init__(cache=cache)
        self.fallback = fallback
        self.device = device

    @property
    def label(self) -> str:
        """The backend label its engine-solved results carry: ``"cuda"`` on
        the card, ``"torch"`` on the CPU."""
        return "cuda" if resolve_device(self.device).type == "cuda" else "torch"

    @staticmethod
    def _batchable(req: SolveRequest) -> bool:
        # a cross_check against the *other* serial backend is a serial-only
        # contract, so honor it serially
        return req.objective == "makespan" and not req.cross_check

    def solve_many(self, requests: list) -> list:
        requests = list(requests)
        reports: list = [None] * len(requests)
        # validate only affects the rare uncertified-element fallback, so
        # group by it
        by_validate: dict[bool, list[int]] = {}
        for i, req in enumerate(requests):
            if self._batchable(req):
                by_validate.setdefault(req.validate, []).append(i)
        for validate, bulk_idxs in by_validate.items():
            warm = [requests[i].warm_basis for i in bulk_idxs]
            results = solve_bulk(
                [requests[i].instance for i in bulk_idxs],
                objective="makespan",
                cache=self.cache,
                fallback=self.fallback,
                validate=validate,
                warm_starts=warm if any(w is not None for w in warm) else None,
                device=self.device,
            )
            for i, res in zip(bulk_idxs, results):
                reports[i] = SolveReport.from_result(res, requests[i])
        for i, req in enumerate(requests):
            if reports[i] is None:
                reports[i] = get_backend("auto").solve(req)
        return reports


class CudaBackend(TorchBackend):
    """The engine on a CUDA card (``device``: the current one by default),
    its hot loops in the hand-written kernels.  Construction raises when
    there is no card, when ``device`` is not a card, or when the kernels do
    not build; there is no degrade to another device or to the plain
    versions."""

    name = "cuda"

    def __init__(self, cache: SolutionCache | None = None, fallback: bool = True,
                 device=None):
        from repro_torch.kernels.build import library

        dev = resolve_device("cuda" if device is None else device)
        if dev.type != "cuda":
            raise ValueError(f"the 'cuda' backend runs on the card; got device {dev}")
        super().__init__(cache=cache, fallback=fallback, device=dev)
        library()  # build (or load) the kernels now: a failure raises here
