"""Closed forms of the motivating example (paper §3) and the single-load
star platform (the oracle for the topology-general LP).

Motivating example platform: m = 2 identical processors, w_1 = w_2 = lambda,
z_1 = 1; loads: N = 2 identical, V_comm = V_comp = 1.

Star closed form: the classical bus-network single-round result (Bharadwaj–
Ghose–Mani–Robertazzi): all processors participate and finish
simultaneously.  Under the one-port master with a FIXED activation order it
is the LP optimum exactly when the links are uniform (a bus); with
heterogeneous links the LP may beat it by skipping a slow-linked worker, so
in general it is only an upper bound — both regimes are golden-tested.
"""

from __future__ import annotations

import math

import numpy as np

from .instance import Chain, Instance, Loads, Star

__all__ = [
    "LAMBDA_SINGLE_INSTALLMENT",
    "LAMBDA_DIVERGENCE",
    "example_instance",
    "schedule_section_3_2",
    "makespan_1",
    "makespan_2",
    "single_inst_fractions_load1",
    "multi_inst_q2",
    "multi_inst_makespan",
    "hand_schedule_lambda_3_4",
    "star_single_load_fractions",
    "star_single_load_makespan",
    "star_bus_instance",
]

#: threshold above which [19] stays single-installment: (sqrt(3)+1)/2 ~= 1.366
LAMBDA_SINGLE_INSTALLMENT = (math.sqrt(3.0) + 1.0) / 2.0
#: threshold below which [19] finds no solution: (sqrt(17)+1)/8 ~= 0.64
LAMBDA_DIVERGENCE = (math.sqrt(17.0) + 1.0) / 8.0


def example_instance(lam: float, q=1) -> Instance:
    """The §3 instance for a given lambda (with Q_n = q installments)."""
    chain = Chain(w=[lam, lam], z=[1.0])
    loads = Loads(v_comm=[1.0, 1.0], v_comp=[1.0, 1.0])
    return Instance(chain, loads, q=q)


def schedule_section_3_2(lam: float) -> np.ndarray:
    """gamma [2, 2] of the simple single-installment schedule of §3.2."""
    d = 2 * lam**2 + 2 * lam + 1
    return np.array(
        [
            [(2 * lam**2 + 1) / d, (2 * lam + 1) / d],  # P_1: load 1, load 2
            [2 * lam / d, 2 * lam**2 / d],  # P_2
        ]
    )


def makespan_1(lam: float) -> float:
    """Makespan of the §3.2 schedule: 2·lam·(lam²+lam+1)/(2lam²+2lam+1)."""
    return 2 * lam * (lam**2 + lam + 1) / (2 * lam**2 + 2 * lam + 1)


def makespan_2(lam: float) -> float:
    """Makespan of [19]'s single-installment schedule (lam >= (sqrt(3)+1)/2):
    lam·(4lam+3) / (2(2lam+1))."""
    return lam * (4 * lam + 3) / (2 * (2 * lam + 1))


def single_inst_fractions_load1(lam: float) -> tuple[float, float]:
    """[19] fractions of load 1: gamma_1 = (lam+1)/(2lam+1), gamma_2 = lam/(2lam+1)."""
    return (lam + 1) / (2 * lam + 1), lam / (2 * lam + 1)


def multi_inst_q2(lam: float) -> int:
    """[19]'s installment count for load 2:
    Q_2 = ceil( ln((4lam²-lam-1)/(2lam²)) / ln lam ), with Q_2 = 2 at lam = 1."""
    if abs(lam - 1.0) < 1e-12:
        return 2
    num = (4 * lam**2 - lam - 1) / (2 * lam**2)
    if num <= 0:
        raise ValueError("no finite Q_2 (divergent regime)")
    return int(math.ceil(math.log(num) / math.log(lam)))


def multi_inst_makespan(lam: float) -> float:
    """[19]'s multi-installment makespan on the example:
    (1 - gamma_2^1(1))·lam + lam/2 (paper §3.4, case 3)."""
    g2 = lam / (2 * lam + 1)
    return (1 - g2) * lam + lam / 2


def star_single_load_fractions(w, z, v_comm: float, v_comp: float) -> np.ndarray:
    """Equal-finish fractions [m] for ONE load on a star, all participating.

    The master P_0 computes its fraction locally; the one-port master sends
    to workers 1..m-1 in index order, and every processor finishes at the
    common time T.  With C_i the end of worker i's receive,

        alpha_i = (T - C_{i-1}) / (w_i V_comp + z_{i-1} V_comm),
        C_i = C_{i-1} + z_{i-1} V_comm alpha_i,

    which telescopes to the product form below; sum alpha = 1 fixes T.
    """
    w = np.asarray(w, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    m = w.shape[0]
    T = star_single_load_makespan(w, z, v_comm, v_comp)
    alpha = np.zeros(m)
    alpha[0] = T / (w[0] * v_comp)
    remaining = T  # T - C_{i-1}
    for i in range(1, m):
        d = w[i] * v_comp + z[i - 1] * v_comm
        alpha[i] = remaining / d
        remaining *= w[i] * v_comp / d
    return alpha


def star_single_load_makespan(w, z, v_comm: float, v_comp: float) -> float:
    """Closed-form single-load star makespan (all-participate, equal finish):

        1/T = 1/(w_0 V_comp)
              + sum_{i>=1} [prod_{j<i} w_j V_comp / (w_j V_comp + z_{j-1} V_comm)]
                            / (w_i V_comp + z_{i-1} V_comm).

    Equals the schedule-LP optimum on bus platforms (uniform ``z``, no
    latency/tau/release/returns); an upper bound otherwise (the LP may skip
    a slow-linked worker under the fixed activation order).
    """
    w = np.asarray(w, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    m = w.shape[0]
    inv = 1.0 / (w[0] * v_comp)
    prod = 1.0
    for i in range(1, m):
        d = w[i] * v_comp + z[i - 1] * v_comm
        inv += prod / d
        prod *= w[i] * v_comp / d
    return 1.0 / inv


def star_bus_instance(w, z: float, v_comm: float = 1.0, v_comp: float = 1.0,
                      q: int = 1) -> Instance:
    """A bus platform (star with uniform link speed ``z``), one load."""
    w = np.asarray(w, dtype=np.float64)
    star = Star(w=w, z=np.full(max(w.shape[0] - 1, 0), float(z)))
    return Instance(star, Loads(v_comm=[v_comm], v_comp=[v_comp]), q=q)


def hand_schedule_lambda_3_4() -> tuple[Instance, np.ndarray, float]:
    """The better-than-[19] 2+2-installment schedule at lambda = 3/4 (§3.4):
    returns (instance with Q = (2,2), gamma [2, 4], expected makespan 781/653·3/4).
    Cell order: (load1, inst1), (load1, inst2), (load2, inst1), (load2, inst2).
    """
    inst = example_instance(0.75, q=[2, 2])
    gamma = np.array(
        [
            [0.0, 317.0 / 653.0, 0.0, 464.0 / 653.0],  # P_1
            [192.0 / 653.0, 144.0 / 653.0, 108.0 / 653.0, 81.0 / 653.0],  # P_2
        ]
    )
    return inst, gamma, (781.0 / 653.0) * 0.75
