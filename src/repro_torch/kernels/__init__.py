"""The port's hand-written Hopper kernels, each beside its plain PyTorch
version.

=====================  ==========================================  ==============================
wrapper                replaces (JAX package)                      CUDA source
=====================  ==========================================  ==============================
``simplex_pivot``      ``kernels/simplex_pivot.py`` (Pallas)       ``csrc/simplex_pivot.cu``
``asap_replay``        ``kernels/asap_replay.py`` (Pallas)         ``csrc/asap_replay.cu``
``flash_attention``    ``kernels/flash_attention.py`` (Pallas)     ``csrc/flash_attention.cu``
``decode_attention``   ``kernels/decode_attention.py`` (Pallas)    ``csrc/decode_attention.cu``
``ssd_scan``           ``kernels/ssd_scan.py`` (Pallas)            ``csrc/ssd_scan.cu``
``rms_norm``           ``kernels/rmsnorm.py`` (Pallas)             ``csrc/rmsnorm.cu``
=====================  ==========================================  ==============================

A wrapper launches its kernel for tensors on the card and runs the plain
version for tensors on the CPU, and never falls back from one to the
other.  ``<wrapper>.launches`` counts kernel launches.  The kernels are
compiled from ``csrc/`` at first use (:mod:`repro_torch.kernels.build`).
"""

from .asap_replay import asap_replay, asap_replay_plain
from .decode_attention import decode_attention, decode_attention_plain
from .flash_attention import flash_attention, flash_attention_plain
from .rmsnorm import rms_norm, rms_norm_plain
from .simplex_pivot import simplex_pivot, simplex_pivot_plain
from .ssd_scan import ssd_scan, ssd_scan_plain, ssd_scan_tolerance

__all__ = ["simplex_pivot", "simplex_pivot_plain", "asap_replay", "asap_replay_plain",
           "flash_attention", "flash_attention_plain", "decode_attention",
           "decode_attention_plain", "ssd_scan", "ssd_scan_plain", "ssd_scan_tolerance",
           "rms_norm", "rms_norm_plain", "reset_launch_counts", "launch_counts"]

_WRAPPERS = (simplex_pivot, asap_replay, flash_attention, decode_attention, ssd_scan, rms_norm)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for w in _WRAPPERS:
        w.launches = 0


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {w.__name__: w.launches for w in _WRAPPERS}
