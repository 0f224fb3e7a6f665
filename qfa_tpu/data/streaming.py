"""Streaming training data path for datasets larger than device memory.

The resident path (``ResidualDataset`` + scanned epochs) is fastest but
requires the whole survey in device memory (~26 KB/spectrum at SDSS scale
in the four-plane layout). For larger corpora this module keeps the residual
arrays in host RAM and streams fixed-size batches to the device with a
prefetch queue, overlapping H2D transfer with compute (``jax.device_put``
is asynchronous).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .batch import SpectraBatch
from .loader import as_f32
from .grid import WavelengthGrid
from .loader import SpectraDataset, make_residuals

Array = jnp.ndarray

__all__ = ["HostResiduals", "make_host_residuals", "stream_batches"]


class HostResiduals(NamedTuple):
    """Residual training arrays pinned in host RAM (numpy)."""

    delta: np.ndarray  #: (N, Npix) float32
    error: np.ndarray  #: (N, Npix) float32
    zabs: np.ndarray  #: (N, Nb) float32
    mask: np.ndarray  #: (N, Npix) float32

    @property
    def size(self) -> int:
        return self.delta.shape[0]


def make_host_residuals(
    dataset: SpectraDataset,
    grid: WavelengthGrid,
    mu: np.ndarray,
    *,
    tau_which: str = "becker",
    taus: np.ndarray | None = None,
) -> HostResiduals:
    """Host-side variant of ``make_residuals`` (no device transfer).

    The tau evaluation runs chunked (``compute_taus``), so building the
    host arrays never stages a full-survey temporary on the accelerator —
    this path exists precisely for datasets bigger than device memory.
    """
    res = make_residuals(
        dataset, grid, mu, tau_which=tau_which, device_put=np.asarray,
        taus=taus,
    )
    return HostResiduals(
        delta=np.asarray(res.delta),
        error=np.asarray(res.error),
        zabs=np.asarray(res.zabs),
        mask=np.asarray(res.mask),
    )


def stream_batches(
    host: HostResiduals,
    batch_size: int,
    rng: np.random.Generator,
    *,
    prefetch: int = 2,
    sharding=None,
    drop_remainder: bool = False,
) -> Iterator[SpectraBatch]:
    """Shuffled epoch iterator with asynchronous device prefetch.

    Yields device-side :class:`SpectraBatch` objects; up to ``prefetch``
    batches are in flight ahead of the consumer. ``sharding`` optionally
    places each batch on a mesh (e.g. ``NamedSharding(mesh, P('data'))``).

    The tail batch is padded with weight-0 duplicate rows so every spectrum
    trains each epoch at a static compiled shape (reference behavior,
    ``/root/reference/QFA/dataloader.py:132-138``); pass
    ``drop_remainder=True`` for the old truncating behavior.
    """
    n = host.size
    if drop_remainder:
        n_batches = n // batch_size
        tail = 0
    else:
        n_batches = -(-n // batch_size)
        tail = n_batches * batch_size - n
    perm = rng.permutation(n)
    if tail:
        perm = np.concatenate([perm, np.zeros((tail,), perm.dtype)])
    perm = perm[: n_batches * batch_size].reshape(n_batches, batch_size)
    full_weight = jnp.ones((batch_size,), jnp.float32)
    if sharding is not None:
        full_weight = jax.device_put(full_weight, sharding)

    def put(i: int) -> SpectraBatch:
        if tail and i == n_batches - 1:
            # pad entries sit at the end of the last batch; keep them last
            # through the sort so the weights line up
            real = np.sort(perm[i][: batch_size - tail])
            idx = np.concatenate([real, perm[i][batch_size - tail:]])
            weight = np.ones((batch_size,), np.float32)
            weight[batch_size - tail:] = 0.0
            weight = (
                jax.device_put(weight, sharding)
                if sharding is not None
                else jax.device_put(weight)
            )
        else:
            idx = np.sort(perm[i])  # sorted gather is faster on the host
            weight = full_weight
        put_dev = (
            (lambda a: jax.device_put(a, sharding))
            if sharding is not None
            else jax.device_put
        )
        # bf16-stored host planes (capacity mode) compute in f32 like
        # every other engine; the mask keeps its dtype
        return SpectraBatch(
            delta=as_f32(put_dev(host.delta[idx])),
            error=as_f32(put_dev(host.error[idx])),
            zabs=as_f32(put_dev(host.zabs[idx])),
            mask=put_dev(host.mask[idx]),
            weight=weight,
        )

    queue = [put(i) for i in range(min(prefetch, n_batches))]
    for i in range(n_batches):
        if i + prefetch < n_batches:
            queue.append(put(i + prefetch))
        yield queue.pop(0)
