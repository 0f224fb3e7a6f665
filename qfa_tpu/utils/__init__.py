"""Utilities: run logging, metrics, profiling, numerical health."""

from .logging import MetricsWriter, make_logger, setup_run_dir
from .runtime import gpu_name_and_power, setup_compile_cache
from .profiling import (
    enable_nan_debugging,
    timed,
    trace,
    tree_health,
)

__all__ = [
    "gpu_name_and_power",
    "setup_compile_cache",
    "MetricsWriter",
    "make_logger",
    "setup_run_dir",
    "enable_nan_debugging",
    "timed",
    "trace",
    "tree_health",
]
