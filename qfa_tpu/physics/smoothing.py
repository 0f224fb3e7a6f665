"""Smoothing utilities.

Two distinct smoothers exist in the reference and both are reproduced here:

* :func:`smooth_curve` — reflect-padded moving average used once, host-side,
  on the data-driven mean continuum (``/root/reference/QFA/utils.py:206-219``).
* :func:`sliding_mean` — edge-truncated sliding-window mean, the semantics of
  ``torch.nn.functional.avg_pool1d(..., count_include_pad=False)`` the
  reference applies to the model parameters every few epochs
  (``/root/reference/QFA/model.py:243-252``). Implemented as a fixed-shape
  cumulative-sum program so it jits and differentiates.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray

__all__ = ["smooth_curve", "sliding_mean"]


def smooth_curve(s: np.ndarray, window_len: int = 32) -> np.ndarray:
    """Reflect-padded moving average of a 1-D curve (host-side numpy).

    Matches the reference semantics exactly: reflect ``window_len - 1``
    samples at each end, convolve with a flat kernel, and crop back to the
    input length.
    """
    s = np.asarray(s)
    padded = np.r_[s[window_len - 1 : 0 : -1], s, s[-2 : -window_len - 1 : -1]]
    kernel = np.ones(window_len, dtype=float) / window_len
    y = np.convolve(kernel, padded, mode="valid")
    return y[int(window_len / 2 - 1) : -int(window_len / 2)]


def sliding_mean(x: Array, window: int, axis: int = -1) -> Array:
    """Edge-truncated centered sliding mean along ``axis``.

    For odd ``window`` = 2k+1, output[i] = mean(x[max(0,i-k) : i+k+1]),
    dividing by the actual number of in-range samples (no zero padding in the
    denominator) — identical to ``avg_pool1d(kernel, stride=1, padding=k,
    count_include_pad=False)``.

    Implemented with one cumulative sum (O(N), fixed shapes, jit-safe).
    """
    if window % 2 != 1:
        raise ValueError(f"sliding_mean requires an odd window, got {window}")
    k = window // 2
    x = jnp.moveaxis(x, axis, 0)
    n = x.shape[0]

    zero = jnp.zeros((1,) + x.shape[1:], dtype=x.dtype)
    csum = jnp.concatenate([zero, jnp.cumsum(x, axis=0)], axis=0)  # (n+1, ...)

    idx = jnp.arange(n)
    lo = jnp.clip(idx - k, 0, n)  # inclusive start
    hi = jnp.clip(idx + k + 1, 0, n)  # exclusive end
    windowed = csum[hi] - csum[lo]
    count = (hi - lo).astype(x.dtype)
    count = count.reshape((n,) + (1,) * (x.ndim - 1))
    return jnp.moveaxis(windowed / count, 0, axis)
