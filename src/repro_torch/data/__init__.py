"""Data pipeline substrate."""

from .pipeline import (DataConfig, SyntheticLMStream, Prefetcher,  # noqa: F401
                       make_stream)
