"""Step builders of the port: the serve step (training comes with its own
slice)."""

from .train import make_serve_step

__all__ = ["make_serve_step"]
