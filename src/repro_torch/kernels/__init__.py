"""The port's hand-written Hopper kernels, each beside its plain PyTorch
version.

=====================  ==========================================  =========================
wrapper                replaces (JAX package)                      CUDA source
=====================  ==========================================  =========================
``simplex_pivot``      ``kernels/simplex_pivot.py`` (Pallas)       ``csrc/simplex_pivot.cu``
``asap_replay``        ``kernels/asap_replay.py`` (Pallas)         ``csrc/asap_replay.cu``
=====================  ==========================================  =========================

A wrapper launches its kernel for tensors on the card and runs the plain
version for tensors on the CPU, and never falls back from one to the
other.  ``<wrapper>.launches`` counts kernel launches.  The kernels are
compiled from ``csrc/`` at first use (:mod:`repro_torch.kernels.build`).
"""

from .asap_replay import asap_replay, asap_replay_plain
from .simplex_pivot import simplex_pivot, simplex_pivot_plain

__all__ = ["simplex_pivot", "simplex_pivot_plain", "asap_replay", "asap_replay_plain",
           "reset_launch_counts", "launch_counts"]


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    simplex_pivot.launches = 0
    asap_replay.launches = 0


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {"simplex_pivot": simplex_pivot.launches, "asap_replay": asap_replay.launches}
