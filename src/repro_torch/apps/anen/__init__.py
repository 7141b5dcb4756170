"""Analog-Ensemble forecasting use case (paper §III-B / §IV-C.2)."""

from .anen import (AnEnConfig, AnEnData, make_dataset, compute_analogs,  # noqa: F401
                   dataset_from_numpy, idw_interpolate, rmse)
from .workflow import run_adaptive, run_random, compare_methods  # noqa: F401
