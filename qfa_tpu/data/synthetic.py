"""Synthetic spectra drawn from the QFA generative model.

Used by the end-to-end convergence tests (recovering F/Psi/omega from draws
of the model) and by the benchmark when no survey data is mounted. Follows
the generative story of arXiv:2207.02788 (cf. README of the reference):

    h ~ N(0, I)
    C = mu + F h                      (continuum)
    S = A * C + sqrt(D_noise) * eps   (observed flux)

with ``A = exp(-tau_lya(zabs))`` on the blue side and
``D_noise = A^2 Psi + omega * zdep + error^2``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.params import QFAParams
from ..models.qfa import absorption
from ..physics.tau import omega_func
from .batch import SpectraBatch
from .grid import WavelengthGrid
from .loader import SpectraDataset

Array = jnp.ndarray

__all__ = ["SyntheticSpectra", "generate"]


class SyntheticSpectra(NamedTuple):
    flux: Array  #: (N, Npix) observed (absorbed, noisy) flux.
    error: Array  #: (N, Npix) per-pixel noise sigma used.
    mask: Array  #: (N, Npix) float mask.
    zqso: Array  #: (N,)
    zabs: Array  #: (N, Nb)
    h: Array  #: (N, Nh) true latent factors.
    continuum: Array  #: (N, Npix) true unabsorbed continuum.

    def to_dataset(self) -> SpectraDataset:
        m = np.asarray(self.mask) > 0
        return SpectraDataset(
            flux=np.where(m, np.asarray(self.flux), 0.0).astype(np.float32),
            error=np.where(m, np.asarray(self.error), 0.0).astype(np.float32),
            mask=m,
            zqso=np.asarray(self.zqso, np.float32),
            paths=(),
            flux_ok=m,  # synthetic masking hits flux and error together
        )

    def to_batch(self, mu: Array, tau_which: str = "becker") -> SpectraBatch:
        """Residual batch ``delta = flux - mu * A`` ready for the likelihood."""
        nr = self.flux.shape[-1] - self.zabs.shape[-1]
        amp = absorption(self.zabs, nr, tau_which)
        delta = (self.flux - mu * amp) * self.mask
        return SpectraBatch(
            delta=delta,
            error=self.error * self.mask,
            zabs=self.zabs,
            mask=self.mask,
            weight=jnp.ones(self.flux.shape[:-1], self.flux.dtype),
        )


def generate(
    key: jax.Array,
    params: QFAParams,
    mu: Array,
    grid: WavelengthGrid,
    n: int,
    *,
    z_range: tuple[float, float] = (2.0, 3.5),
    error_scale: float = 0.1,
    mask_frac: float = 0.0,
    tau_which: str = "becker",
) -> SyntheticSpectra:
    """Draw ``n`` spectra from the generative model.

    ``mask_frac`` masks a random contiguous chunk of that fractional length
    per spectrum (emulating sky-line / bad-CCD masking).
    """
    k_z, k_h, k_noise, k_err, k_mask = jax.random.split(key, 5)
    npix, nh = params.F.shape
    nb = grid.nb

    zqso = jax.random.uniform(
        k_z, (n,), minval=z_range[0], maxval=z_range[1], dtype=jnp.float32
    )
    # traceable zabs (same formula as WavelengthGrid.zabs) so the whole
    # generator can run under jit with the grid closed over
    blue = jnp.asarray(grid.blue, jnp.float32)
    from .grid import LYA_WAVELENGTH

    zabs = (1.0 + zqso)[:, None] * blue / LYA_WAVELENGTH - 1.0
    h = jax.random.normal(k_h, (n, nh), jnp.float32)
    continuum = mu + jnp.matmul(
        h, params.F.T, precision=jax.lax.Precision.HIGHEST
    )

    amp = absorption(zabs, grid.nr, tau_which)
    zdep = omega_func(zabs, params.tau0, params.beta, params.c0)
    omega_full = jnp.concatenate(
        [params.omega * zdep, jnp.zeros((n, grid.nr), jnp.float32)], axis=-1
    )
    error = error_scale * (
        0.5 + jax.random.uniform(k_err, (n, npix), dtype=jnp.float32)
    )
    # total marginal variance given h is A^2 Psi + omega zdep + error^2
    d_noise = amp * amp * params.Psi + omega_full + error * error
    noise = jax.random.normal(k_noise, (n, npix), jnp.float32)
    flux = amp * continuum + jnp.sqrt(d_noise) * noise

    if mask_frac > 0:
        span = max(int(mask_frac * npix), 1)
        # maxval is exclusive: npix - span + 1 lets the chunk reach the red
        # edge (and keeps the range non-empty when span == npix)
        start = jax.random.randint(k_mask, (n, 1), 0, npix - span + 1)
        cols = jnp.arange(npix)[None, :]
        mask = ~((cols >= start) & (cols < start + span))
        mask = mask.astype(jnp.float32)
    else:
        mask = jnp.ones((n, npix), jnp.float32)

    return SyntheticSpectra(
        flux=flux,
        error=error,
        mask=mask,
        zqso=zqso,
        zabs=zabs,
        h=h,
        continuum=continuum,
    )
