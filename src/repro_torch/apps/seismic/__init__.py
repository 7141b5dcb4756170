"""Seismic inversion use case (paper §III-A / §IV-C.1)."""

from .solver import (SeismicConfig, forward_simulation, misfit_and_grad,  # noqa: F401
                     make_velocity_model)
from .workflow import build_forward_ensemble, run_forward_ensemble  # noqa: F401
