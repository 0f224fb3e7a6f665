"""Profiling and numerical-health utilities (SURVEY.md section 5).

* :func:`trace` — context manager around ``jax.profiler`` (TensorBoard-
  compatible traces; the reference has wall-clock timing only).
* :func:`timed` — ``block_until_ready``-aware wall timer.
* :func:`tree_health` — NaN/Inf and magnitude summary of a pytree, the
  framework's "sanitizer": JAX's pure-functional model has no data races to
  detect, so numerical health is the relevant failure mode (pair with
  ``jax.config.update('jax_debug_nans', True)`` for hard failure).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Iterator

import jax
import numpy as np

__all__ = [
    "trace",
    "timed",
    "tree_health",
    "enable_nan_debugging",
]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a device profile viewable in TensorBoard/XProf."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label: str = "", sink=print) -> Iterator[dict]:
    """Wall-clock a block, synchronizing outstanding device work at exit."""
    record: dict = {"label": label}
    t0 = time.perf_counter()
    try:
        yield record
    finally:
        (jax.effects_barrier if hasattr(jax, "effects_barrier") else lambda: None)()
        record["seconds"] = time.perf_counter() - t0
        if sink is not None:
            sink(f"[timed] {label}: {record['seconds']:.4f}s")


def tree_health(tree: Any) -> dict:
    """Per-leaf finite-ness and magnitude summary (host-side)."""
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        arr = np.asarray(leaf)
        name = jax.tree_util.keystr(path)
        out[name] = {
            "shape": list(arr.shape),
            "finite": bool(np.isfinite(arr).all()),
            "absmax": float(np.max(np.abs(arr))) if arr.size else 0.0,
            "absmean": float(np.mean(np.abs(arr))) if arr.size else 0.0,
        }
    return out


def enable_nan_debugging(enable: bool = True) -> None:
    """Fail fast on NaN production anywhere in jitted code."""
    jax.config.update("jax_debug_nans", enable)
