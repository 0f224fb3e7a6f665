"""Process set-up shared by every entry point: the persistent compile cache
and the accelerator's identity.

``cli.main``, ``serve.main``, ``chip_smoke.py`` and ``bench.py`` call
:func:`setup_compile_cache` before their first compilation, so every run of
the same program on the same machine reuses what an earlier one compiled.
"""

from __future__ import annotations

import os
import subprocess

import jax

__all__ = ["DEFAULT_CACHE_DIR", "setup_compile_cache", "gpu_name_and_power"]

#: the cache's one fixed place when ``JAX_COMPILATION_CACHE_DIR`` is unset:
#: inside the checkout (gitignored), never a temporary or per-process path —
#: the path is part of the cache key, so a directory that moves never hits.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def setup_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing else is set here. Otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR`. Call before the first compilation: JAX fixes
    the cache directory when it first compiles.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def gpu_name_and_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` as one line per card.

    Runs in a child process that does not import JAX, so it opens no
    second context on the card. Raises if ``nvidia-smi`` is missing or
    fails: a measurement without the card's name and limit is not kept.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
