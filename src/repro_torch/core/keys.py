"""Canonical key derivation for scheduling instances — THE one place.

Every layer that groups, caches, or deduplicates instances derives its key
here, so the notions of "same problem" can never drift apart:

* :func:`instance_content_key` / :func:`instance_content_keys` — the
  quantized content hash used by the engine solution cache
  (:mod:`repro_torch.engine.cache`) and by the reference package's ``repro.api.Problem.key()``: two
  instances with indistinguishable (to ``quantum`` relative precision)
  parameter arrays, the same topology, installment counts, and objective
  hash identically and therefore share a cache slot.
* :func:`instance_bucket_key` — the structural key used by the engine arena
  (:mod:`repro_torch.engine.arena`) to pack instances into fixed-shape batches:
  instances sharing ``(topology, has_returns, m, T, q)`` have identical
  recurrence *and* LP shapes, so they batch with no padding.

Identical content keys imply identical bucket keys (the bucket key is a
function of fields the content key also hashes), which is what makes
"same ``Problem.key()`` => same arena bucket and same cache slot" a
theorem rather than a convention (tested in tests/test_api_spec.py).

Hot-path layout.  Key derivation was the dominant cost of a
warm-cache ``solve_bulk`` (~90% of session wall in the reference's traces), so
the bulk entry point :func:`instance_content_keys` is engineered for
populations:

  1. instances whose key is already **memoized** (keys are attached to the
     effectively-frozen :class:`Instance` on first derivation) cost one
     dict probe;
  2. the rest are grouped by parameter-array shape ``(m, N, unrelated?)``
     and their arrays are packed into one ``[G, L]`` row matrix that is
     quantized in a **single vectorized pass** — the
     ``10^floor(log10 |a|)`` magnitude computation is hoisted out of the
     per-array loop into five in-place whole-matrix ufunc sweeps;
  3. each instance is hashed with ``blake2b`` (digest_size=32 — faster
     than sha256 on every platform we run, same 64-hex-char key width)
     over its header string + its precomputed quantized row bytes.

``instance_content_key(inst)`` IS ``instance_content_keys([inst])[0]`` —
the bulk and per-instance keys are bit-identical by construction (and
regression-tested against the unbatched reference derivation
``_content_key_single`` across topology x returns x q).
"""

from __future__ import annotations

import hashlib

import numpy as np

from .instance import Instance

__all__ = [
    "quantize",
    "instance_content_key",
    "instance_content_keys",
    "instance_bucket_key",
]

# memo attribute attached to Instance objects (frozen dataclass — stored via
# its __dict__, invisible to dataclass eq/repr); maps (objective, quantum)
# to the derived key.  Instances are treated as immutable everywhere (the
# arena, the cache, and Problem.to_instance all rely on that), so the memo
# can never go stale.
_MEMO_ATTR = "_content_key_memo"

_EMPTY = np.zeros(0)


def _quantize_into(a: np.ndarray, quantum: float) -> np.ndarray:
    """The one quantization kernel: relative rounding to ``quantum``.

    Works on any float64 array without mutating it; the magnitude term
    ``10^floor(log10 |a|)`` is computed in-place in one scratch buffer so a
    stacked ``[G, L]`` row matrix quantizes in five ufunc sweeps instead of
    ~9 small-array round trips per instance.
    """
    mag = np.abs(a)
    np.maximum(mag, 1e-300, out=mag)
    np.log10(mag, out=mag)
    np.floor(mag, out=mag)
    np.power(10.0, mag, out=mag)
    mag *= quantum  # mag now holds the rounding step: 10^floor(log10)|a| * q
    out = a / mag
    np.round(out, out=out)
    out *= mag
    return out


def quantize(a: np.ndarray, quantum: float) -> np.ndarray:
    """Relative quantization: keep ~|log10 quantum| significant digits."""
    a = np.asarray(a, dtype=np.float64)
    if a.size == 0:
        return a
    return _quantize_into(a, quantum)


def _hash_parts(inst: Instance) -> tuple:
    """The parameter arrays in canonical hash order (fixed forever)."""
    return (
        inst.platform.w,
        inst.platform.z,
        inst.platform.tau,
        inst.platform.latency,
        inst.loads.v_comm,
        inst.loads.v_comp,
        inst.loads.release,
        inst.loads.return_ratio,
        inst.w_per_load if inst.w_per_load is not None else _EMPTY,
    )


def _header(inst: Instance, objective: str) -> bytes:
    """The non-array key material: objective, topology, shape, installments.

    The topology tag is part of the key — a chain and a star with identical
    parameter arrays are different scheduling problems — and so is the
    installment tuple (it changes the LP's variable blocks).
    """
    return (
        f"{objective}|topo={inst.topology}|m={inst.m}|N={inst.N}|q={inst.q}".encode()
    )


def _content_key_single(
    inst: Instance, objective: str = "makespan", quantum: float = 1e-9
) -> str:
    """Unbatched reference derivation — one array at a time.

    Kept as the parity oracle for :func:`instance_content_keys` (the bulk
    path must be bit-identical) and as the per-instance baseline the
    hot-path bench compares against.  Not memoized on purpose.
    """
    h = hashlib.blake2b(digest_size=32)
    h.update(_header(inst, objective))
    for arr in _hash_parts(inst):
        h.update(quantize(arr, quantum).tobytes())
    return h.hexdigest()


def instance_content_keys(
    instances, objective: str = "makespan", quantum: float = 1e-9
) -> list:
    """Content keys for a whole population in one vectorized pass.

    Returns one key per instance, in caller order.  Memoized keys are
    returned without touching numpy at all; the rest are grouped by array
    shape, quantized as one stacked matrix, and hashed per instance over
    the precomputed bytes.  ``instance_content_key`` (and therefore
    ``Problem.key()`` and every cache slot) is this same derivation.
    """
    out: list = [None] * len(instances)
    memo_key = (objective, quantum)
    # One pass groups AND collects the row fragments: each miss appends its
    # parameter arrays (the _hash_parts order) to its shape group's parts
    # list, so the rows materialize with ONE np.concatenate per group —
    # per-array slice assignment was ~3x slower (~9 numpy round trips per
    # instance), and the m/N/topology *properties* are bypassed via direct
    # shape/attribute reads (4 Python-level property calls per instance add
    # up at population scale).
    groups: dict = {}  # (m, N, has_w_per_load) -> ([caller index, ...], parts)
    for i, inst in enumerate(instances):
        memo = inst.__dict__.get(_MEMO_ATTR)
        if memo is not None:
            k = memo.get(memo_key)
            if k is not None:
                out[i] = k
                continue
        p, ld = inst.platform, inst.loads
        wpl = inst.w_per_load
        grp = groups.get((p.w.shape[0], ld.v_comm.shape[0], wpl is not None))
        if grp is None:
            grp = groups[
                (p.w.shape[0], ld.v_comm.shape[0], wpl is not None)] = ([], [])
        grp[0].append(i)
        parts = grp[1]
        parts.append(p.w)
        parts.append(p.z)
        parts.append(p.tau)
        parts.append(p.latency)
        parts.append(ld.v_comm)
        parts.append(ld.v_comp)
        parts.append(ld.release)
        parts.append(ld.return_ratio)
        if wpl is not None:
            parts.append(wpl.ravel())

    blake = hashlib.blake2b
    hdr_cache: dict = {}  # (topology, m, N, q) -> header bytes
    for (m, N, has_wpl), (idxs, parts) in groups.items():
        # row layout: w[m] | z[m-1] | tau[m] | latency[m-1] | v_comm[N] |
        # v_comp[N] | release[N] | return_ratio[N] | w_per_load[m*N]?
        # — exactly the _hash_parts order, so row bytes == the sequential
        # per-array update stream of _content_key_single.
        L = 2 * m + 2 * (m - 1) + 4 * N + (m * N if has_wpl else 0)
        rows = np.concatenate(parts, dtype=np.float64).reshape(len(idxs), L)
        rows = _quantize_into(rows, quantum)
        for i, row in zip(idxs, rows):
            inst = instances[i]
            hk = (inst.platform.kind, m, N, inst.q)
            hdr = hdr_cache.get(hk)
            if hdr is None:
                hdr = hdr_cache[hk] = _header(inst, objective)
            h = blake(hdr, digest_size=32)
            h.update(row)  # contiguous row buffer — no tobytes copy
            key = h.hexdigest()
            memo = inst.__dict__.get(_MEMO_ATTR)
            if memo is None:
                memo = {}
                object.__setattr__(inst, _MEMO_ATTR, memo)
            memo[memo_key] = key
            out[i] = key
    return out


def instance_content_key(
    inst: Instance, objective: str = "makespan", quantum: float = 1e-9
) -> str:
    """Stable content hash of a quantized instance (+ objective).

    Memoized on the instance: the first derivation attaches the key, so
    replans/re-submits of the same (frozen) instance cost one dict probe.
    """
    memo = inst.__dict__.get(_MEMO_ATTR)
    if memo is not None:
        k = memo.get((objective, quantum))
        if k is not None:
            return k
    return instance_content_keys([inst], objective=objective, quantum=quantum)[0]


def instance_bucket_key(inst: Instance) -> tuple:
    """Structural key ``(topology, has_returns, m, T, q)`` for arena packing.

    Instances sharing this key have identical LP row patterns and ASAP
    recurrence shapes (the completeness rows depend on the cell -> load map,
    which the ``q`` tuple fixes; the precedence-row pattern depends on the
    topology and on whether the result-return phase is active).
    """
    return (
        inst.topology,
        inst.has_returns,
        inst.m,
        inst.total_installments,
        tuple(inst.q),
    )
