"""QFA likelihood and posterior inference — batched, fixed-shape, jit-first.

This module replaces the reference's per-spectrum Python hot loop
(``/root/reference/QFA/model.py:98-103``, one dense Npix x Npix inverse per
spectrum) with a single fixed-shape tensor program over the whole batch:

1. elementwise assembly of the absorption amplitude ``A`` and noise diagonal
   ``D = A^2 Psi + omega * zdep + error^2`` (fused by XLA);
2. one (B, Npix) @ (Npix, Nh^2 + ...) GEMM for every capacitance matrix and
   data projection at once (see ``qfa_tpu.linalg.lowrank``);
3. batched Nh x Nh Cholesky factorizations and triangular solves.

Gradients come from ``jax.grad`` (exact by construction — the reference's
hand-derived gradients for F/tau0/c0/beta carry verified algebra bugs, see
SURVEY.md section 3), with an optional reference-compatible per-element batch
normalization (:func:`normalize_grads`).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..data.batch import SpectraBatch
from ..data.grid import zabs_from_zq
from ..data.loader import as_f32
from ..linalg import lowrank
from ..physics.tau import omega_func, tau as tau_line
from .params import QFAParams

Array = jnp.ndarray

__all__ = [
    "ModelOptions",
    "PredictResult",
    "GradCounts",
    "absorption",
    "noise_diagonal",
    "batch_factors",
    "batch_nll",
    "mean_nll",
    "loss_and_grads",
    "grad_counts",
    "normalize_grads",
    "normalize_with_counts",
    "summed_stats",
    "predict",
    "dense_predict",
    "make_delta",
]


class ModelOptions(NamedTuple):
    """Static model configuration (hashable — safe as a jit static arg).

    ``tau_which`` is a law name or an arbitrary callable ``tau(z)`` (the
    reference constructor form, ``/root/reference/QFA/model.py:26-33``;
    normalize user input with :func:`qfa_tpu.physics.tau.resolve_tau`).
    A callable is traced exactly. NOTE: callables hash by identity — reuse
    one ``ModelOptions`` instance to avoid recompilation.
    """

    #: mean-optical-depth law for the amplitude A: name or callable.
    tau_which: str | Callable = "becker"
    precision: lax.Precision = lax.Precision.HIGHEST


class PredictResult(NamedTuple):
    """Outputs of continuum prediction for a batch of spectra."""

    ll: Array  #: (B,) negative log-likelihood (OOD score).
    hmean: Array  #: (B, Nh) posterior mean of the latent factors.
    hcov: Array  #: (B, Nh, Nh) posterior covariance.
    #: (B, Npix) predicted unabsorbed continuum F hmean + mu (None when
    #: ``stats_only``).
    continuum: Array | None
    #: (B, Npix) predictive std sqrt(diag(F hcov F^T)) (None when
    #: ``stats_only``).
    continuum_std: Array | None


def absorption(
    zabs: Array, nr: int, tau_which: str | Callable = "becker"
) -> Array:
    """Per-pixel absorption amplitude ``A = [exp(-tau_lya(zabs)), 1...]``.

    Blue-side pixels are attenuated by the Ly-alpha mean optical depth at
    their absorber redshift; red-side pixels pass through
    (``/root/reference/QFA/model.py:125``). ``tau_which`` may be a law name
    or a callable ``tau(z)`` exactly like the reference's ``self.tau``
    (``/root/reference/QFA/model.py:125``). Shape (..., Nb + nr).
    """
    if callable(tau_which):
        a_blue = jnp.exp(-jnp.asarray(tau_which(zabs)))
    else:
        a_blue = jnp.exp(-tau_line(zabs, which=tau_which, series=1))
    ones = jnp.ones(zabs.shape[:-1] + (nr,), dtype=a_blue.dtype)
    return jnp.concatenate([a_blue, ones], axis=-1)


def noise_diagonal(
    params: QFAParams, batch: SpectraBatch, amp: Array
) -> tuple[Array, Array, Array]:
    """Masked noise diagonal ``D = A^2 Psi + omega * zdep + error^2``.

    Returns ``(dinv, log_d, zdep)`` where masked pixels have ``dinv = 0`` and
    ``log_d = 0`` (the masked-precision encoding of row deletion; see
    ``qfa_tpu.linalg.lowrank``). ``zdep`` is returned for reuse by gradients.
    (Reference: ``/root/reference/QFA/model.py:128-131``.)
    """
    nr = batch.npix - batch.nb
    zdep = omega_func(batch.zabs, params.tau0, params.beta, params.c0)
    omega_full = jnp.concatenate(
        [params.omega * zdep, jnp.zeros(zdep.shape[:-1] + (nr,), zdep.dtype)],
        axis=-1,
    )
    mask = batch.mask.astype(amp.dtype)
    d = amp * amp * params.Psi + omega_full + batch.error * batch.error
    safe_d = jnp.where(mask > 0, d, 1.0)
    dinv = mask / safe_d
    log_d = mask * jnp.log(safe_d)
    return dinv, log_d, zdep


def batch_factors(
    params: QFAParams,
    batch: SpectraBatch,
    options: ModelOptions = ModelOptions(),
    *,
    gram: Array | None = None,
) -> tuple[lowrank.LowRankFactors, Array]:
    """Factorize the masked likelihood for every spectrum in the batch.

    Returns the low-rank factors and the absorption amplitude ``A``.
    """
    nr = batch.npix - batch.nb
    amp = absorption(batch.zabs, nr, options.tau_which)
    dinv, log_d, _ = noise_diagonal(params, batch, amp)
    mask = batch.mask.astype(amp.dtype)
    factors = lowrank.factorize(
        params.F,
        batch.delta * mask,
        amp,
        dinv,
        log_d,
        mask,
        gram=gram,
        precision=options.precision,
    )
    return factors, amp


def batch_nll(
    params: QFAParams,
    batch: SpectraBatch,
    options: ModelOptions = ModelOptions(),
) -> Array:
    """Per-spectrum negative log-likelihood, shape (B,).

    Equals the reference's row-deleted quantity
    (``/root/reference/QFA/model.py:135``) for every masking pattern; padded
    rows (all-masked) evaluate to exactly 0.
    """
    factors, _ = batch_factors(params, batch, options)
    return lowrank.nll(factors)


def mean_nll(
    params: QFAParams,
    batch: SpectraBatch,
    options: ModelOptions = ModelOptions(),
) -> Array:
    """Weighted batch-mean NLL (padding-aware) — the training loss."""
    per = batch_nll(params, batch, options)
    w = batch.weight.astype(per.dtype)
    return jnp.sum(per * w) / jnp.maximum(jnp.sum(w), 1.0)


def _summed_nll(params, batch, options):
    per = batch_nll(params, batch, options)
    return jnp.sum(per * batch.weight.astype(per.dtype)), per


@partial(jax.jit, static_argnames=("options", "reference_norm"))
def loss_and_grads(
    params: QFAParams,
    batch: SpectraBatch,
    options: ModelOptions = ModelOptions(),
    reference_norm: bool = True,
) -> tuple[Array, QFAParams]:
    """Batch loss and parameter gradients.

    With ``reference_norm=True`` the summed gradients are divided per element
    by the number of spectra that could have contributed (the reference's
    nonzero-count averaging, ``/root/reference/QFA/model.py:104``); otherwise
    they are plain batch means.

    Returns:
        (mean nll over real rows, gradient pytree shaped like ``params``).
    """
    (total, per), grads = jax.value_and_grad(_summed_nll, has_aux=True)(
        params, batch, options
    )
    w = batch.weight.astype(total.dtype)
    n_real = jnp.maximum(jnp.sum(w), 1.0)
    loss = total / n_real
    if reference_norm:
        grads = normalize_grads(grads, batch)
    else:
        grads = jax.tree.map(lambda g: g / n_real, grads)
    return loss, grads


class GradCounts(NamedTuple):
    """Per-element contribution counts for reference-style grad averaging.

    Summable across data-parallel shards (a plain ``psum`` composes local
    counts into global ones).
    """

    pix: Array  #: (Npix,) spectra observing each pixel.
    scalar: Array  #: () spectra with at least one observed blue pixel.


def grad_counts(batch: SpectraBatch) -> GradCounts:
    """Count, per gradient element, how many spectra contributed."""
    mask = batch.mask.astype(jnp.float32)
    w = batch.weight.astype(mask.dtype)[:, None]
    pix = jnp.sum(mask * w, axis=0)
    any_blue = jnp.sum(mask[:, : batch.nb] * w, axis=1) > 0
    scalar = jnp.sum(any_blue.astype(mask.dtype))
    return GradCounts(pix=pix, scalar=scalar)


def normalize_with_counts(grads: QFAParams, counts: GradCounts) -> QFAParams:
    """Divide summed gradients by per-element contribution counts."""

    def div(g, c):
        return jnp.where(c > 0, g / jnp.maximum(c, 1.0), 0.0)

    nb = grads.omega.shape[0]
    return QFAParams(
        F=div(grads.F, counts.pix[:, None]),
        Psi=div(grads.Psi, counts.pix),
        omega=div(grads.omega, counts.pix[:nb]),
        tau0=div(grads.tau0, counts.scalar),
        c0=div(grads.c0, counts.scalar),
        beta=div(grads.beta, counts.scalar),
    )


def normalize_grads(grads: QFAParams, batch: SpectraBatch) -> QFAParams:
    """Reference-compatible per-element gradient averaging.

    The reference averages each gradient element over the spectra whose
    contribution was nonzero — i.e. over the spectra observing that pixel
    (``/root/reference/QFA/model.py:103-104``). Pixels observed by no
    spectrum get gradient 0 (the reference produces NaN there via 0/0; we
    deliberately repair that so such pixels simply don't move).
    """
    return normalize_with_counts(grads, grad_counts(batch))


def summed_stats(
    params: QFAParams,
    batch: SpectraBatch,
    options: ModelOptions = ModelOptions(),
) -> tuple[Array, Array, QFAParams, GradCounts]:
    """Per-shard sufficient statistics for a (possibly distributed) update.

    Returns ``(nll_sum, n_real, grads_sum, counts)`` — all plain sums over
    the local batch, so a data-parallel step just ``psum``s each and then
    applies :func:`normalize_with_counts` (or divides by ``n_real``).
    """
    (total, _per), grads = jax.value_and_grad(_summed_nll, has_aux=True)(
        params, batch, options
    )
    n_real = jnp.sum(batch.weight.astype(total.dtype))
    return total, n_real, grads, grad_counts(batch)


def make_delta(
    flux: Array, mu: Array, amp: Array, mask: Array
) -> Array:
    """Residual field ``delta = flux - mu * A`` with masked pixels zeroed.

    This is the *prediction-path* delta (single-line Ly-alpha absorption,
    ``/root/reference/QFA/model.py:165-166``); the training path builds delta
    with the full Lyman-series ``tau_total`` in the data layer.
    """
    m = mask.astype(amp.dtype)
    return (flux - mu * amp) * m


@partial(jax.jit, static_argnames=("options", "stats_only"))
def predict(
    params: QFAParams,
    mu: Array,
    flux: Array,
    error: Array,
    zabs: Array,
    mask: Array | None = None,
    options: ModelOptions = ModelOptions(),
    *,
    stats_only: bool = False,
    loglam: Array | None = None,
) -> PredictResult:
    """Batched continuum prediction + OOD scoring.

    Mirrors ``prediction_for_single_spectra``
    (``/root/reference/QFA/model.py:160-180``) for a whole batch in one
    program: likelihood (OOD score), posterior latents, predicted continuum
    ``F hmean + mu`` on the full unabsorbed grid, and its uncertainty.

    All array arguments may carry arbitrary leading batch dimensions.

    Compact input, for survey sweeps that keep the data on the device:

    * ``mask=None`` derives the mask from ``error > 0`` (the data layer
      stores every masked pixel with error 0);
    * with ``loglam`` (:func:`~qfa_tpu.data.grid.loglam_row`), ``zabs`` is
      the ``log1p(zqso)`` column (:func:`~qfa_tpu.data.grid.zq_column`,
      shape ``(...,)``) instead of the ``(..., Nb)`` absorber-redshift
      plane, which is rebuilt here.

    ``stats_only=True`` returns ``ll``, ``hmean`` and ``hcov`` only
    (``continuum`` and ``continuum_std`` are None): the OOD sweep, which
    writes no ``(B, Npix)`` planes.
    """
    # bfloat16-stored planes compute in float32, like the trainers
    flux, error = as_f32(flux), as_f32(error)
    if mask is None:
        mask = (error > 0.0).astype(flux.dtype)
    if loglam is not None:
        zabs = zabs_from_zq(zabs, loglam[: params.omega.shape[0]])
    nb = zabs.shape[-1]
    nr = flux.shape[-1] - nb
    amp = absorption(zabs, nr, options.tau_which)
    delta = make_delta(flux, mu, amp, mask)
    batch = SpectraBatch(
        delta=delta,
        error=error,
        zabs=zabs,
        mask=mask,
        weight=jnp.ones(flux.shape[:-1], flux.dtype),
    )
    factors, _ = batch_factors(params, batch, options)
    ll = lowrank.nll(factors)
    hmean, hcov = lowrank.solve_posterior(factors)
    if stats_only:
        return PredictResult(
            ll=ll, hmean=hmean, hcov=hcov, continuum=None, continuum_std=None
        )
    continuum = (
        jnp.matmul(hmean, params.F.T, precision=options.precision) + mu
    )
    fh = jnp.matmul(hcov, params.F.T, precision=options.precision)  # (B,Nh,Npix)
    var = jnp.einsum(
        "...hp,ph->...p", fh, params.F, precision=options.precision
    )
    return PredictResult(
        ll=ll,
        hmean=hmean,
        hcov=hcov,
        continuum=continuum,
        continuum_std=jnp.sqrt(jnp.maximum(var, 0.0)),
    )


def dense_predict(
    params: QFAParams,
    mu: Array,
    flux: Array,
    error: Array,
    zabs: Array,
    mask: Array,
    options: ModelOptions = ModelOptions(),
) -> PredictResult:
    """Dense O(Npix^3) reference for :func:`predict`, batch ``(B, Npix)``.

    Assembles the same absorption amplitude and noise diagonal, then takes
    the likelihood and the posterior from the dense masked covariance
    (:func:`~qfa_tpu.linalg.lowrank.dense_masked_nll`,
    :func:`~qfa_tpu.linalg.lowrank.dense_masked_posterior`) instead of the
    capacitance path. Every product runs at ``Precision.HIGHEST``. For the
    tests and the bring-up check, on small batches.
    """
    hp = lax.Precision.HIGHEST
    nr = flux.shape[-1] - zabs.shape[-1]
    amp = absorption(zabs, nr, options.tau_which)
    m = jnp.asarray(mask).astype(flux.dtype)
    delta = (flux - mu * amp) * m
    zdep = omega_func(zabs, params.tau0, params.beta, params.c0)
    omega_full = jnp.concatenate(
        [params.omega * zdep, jnp.zeros(zdep.shape[:-1] + (nr,), zdep.dtype)],
        axis=-1,
    )
    d = amp * amp * params.Psi + omega_full + error * error

    def one(delta, amp, d, m):
        ll = lowrank.dense_masked_nll(params.F, delta, amp, d, m)
        hmean, hcov = lowrank.dense_masked_posterior(params.F, delta, amp, d, m)
        return ll, hmean, hcov

    ll, hmean, hcov = jax.vmap(one)(delta, amp, d, m)
    continuum = jnp.matmul(hmean, params.F.T, precision=hp) + mu
    var = jnp.einsum("ph,bhk,pk->bp", params.F, hcov, params.F, precision=hp)
    return PredictResult(
        ll=ll, hmean=hmean, hcov=hcov, continuum=continuum,
        continuum_std=jnp.sqrt(jnp.maximum(var, 0.0)),
    )
