"""Masked low-rank-plus-diagonal Gaussian core.

The QFA marginal likelihood is a zero-mean Gaussian with covariance

    Sigma = Ftil Ftil^T + diag(D),     Ftil = diag(A) F,

where ``F`` is the (Npix, Nh) factor loading shared by every spectrum, ``A``
is a per-spectrum absorption amplitude and ``D`` a per-spectrum positive
diagonal. Missing pixels are handled by the reference with dynamic row
deletion (``/root/reference/QFA/model.py:121-124``) which cannot compile to a
fixed-shape XLA program; here they are handled with **masked precision**: a
masked pixel gets ``Dinv_i = 0`` (infinite variance), which reproduces the
row-deleted quantities exactly:

* quadratic form: masked pixels contribute 0 to ``delta^T Dinv delta``;
* capacitance: ``K = I + Ftil^T diag(Dinv) Ftil`` ignores masked rows;
* log-determinant: ``sum(mask * log D) + logdet K`` equals the submatrix
  log-determinant (matrix determinant lemma).

Everything is O(Npix * Nh^2) per spectrum and never materializes an
Npix x Npix matrix (the reference materializes the dense inverse,
``/root/reference/QFA/utils.py:32``).

Because ``F`` is shared, the batch of capacitance matrices is a single large
matmul against the precomputed Gram tensor ``G[p, i*Nh+j] = F[p,i] F[p,j]``:

    K[b] = I + reshape(W[b] @ G),    W[b, p] = A[b,p]^2 * Dinv[b,p]

i.e. one (B, Npix) @ (Npix, Nh^2) GEMM instead of B separate skinny
(Nh, Npix)@(Npix, Nh) products.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from . import smallchol

Array = jnp.ndarray

LOG_2PI = 1.8378770664093453

__all__ = [
    "LOG_2PI",
    "LowRankFactors",
    "gram_matrix",
    "batched_capacitance",
    "factorize",
    "solve_posterior",
    "nll",
    "dense_masked_nll",
    "dense_masked_posterior",
]


class LowRankFactors(NamedTuple):
    """Per-spectrum factorization of the masked low-rank Gaussian.

    Shapes below use ``B`` for arbitrary leading batch dims and ``Nh`` for the
    latent dimension.
    """

    chol: Array  #: (B, Nh, Nh) lower Cholesky of the capacitance K.
    w: Array  #: (B, Nh) projected data ``Ftil^T Dinv delta``.
    quad: Array  #: (B,) diagonal quadratic form ``delta^T Dinv delta``.
    logdet_d: Array  #: (B,) masked diagonal log-determinant ``sum m log D``.
    n_obs: Array  #: (B,) number of observed pixels.


def gram_matrix(f: Array) -> Array:
    """Flattened symmetric Gram tensor ``G[p, i*Nh+j] = F[p,i]*F[p,j]``.

    Shape (Npix, Nh*Nh). Computed once per training step; turns every
    per-spectrum capacitance into one big GEMM (see module docstring).
    """
    npix, nh = f.shape
    return (f[:, :, None] * f[:, None, :]).reshape(npix, nh * nh)


def batched_capacitance(
    gram: Array,
    weights: Array,
    *,
    precision=lax.Precision.HIGHEST,
) -> Array:
    """Capacitance matrices ``K = I + F^T diag(weights) F`` for a batch.

    Args:
        gram: (Npix, Nh*Nh) output of :func:`gram_matrix`.
        weights: (..., Npix) per-pixel weights (``A^2 * Dinv``).

    Returns:
        (..., Nh, Nh) symmetric positive-definite capacitance matrices.
    """
    nh = int(round(gram.shape[1] ** 0.5))
    k_flat = jnp.matmul(
        weights, gram, precision=precision, preferred_element_type=jnp.float32
    )
    k = k_flat.reshape(weights.shape[:-1] + (nh, nh))
    return k + jnp.eye(nh, dtype=k.dtype)


def factorize(
    f: Array,
    delta: Array,
    amp: Array,
    dinv: Array,
    log_d: Array,
    mask: Array,
    *,
    gram: Array | None = None,
    precision=lax.Precision.HIGHEST,
) -> LowRankFactors:
    """Factorize a batch of masked low-rank Gaussians.

    Args:
        f: (Npix, Nh) shared factor loadings.
        delta: (..., Npix) observed residual spectra.
        amp: (..., Npix) per-pixel amplitude A (absorption; 1 on red side).
        dinv: (..., Npix) masked inverse diagonal — **0 at masked pixels**.
        log_d: (..., Npix) ``log D`` with masked entries already zeroed.
        mask: (..., Npix) observation mask (1 observed / 0 missing).
        gram: optional precomputed :func:`gram_matrix` of ``f``.

    Returns:
        :class:`LowRankFactors` with leading dims ``...``.

    Every per-spectrum contraction — the Nh x Nh capacitance, the Nh data
    projection, and the three scalar reductions (quad / logdet_d / n_obs) —
    is packed into ONE stacked GEMM ``(..., 5, Npix) @ (Npix, Nh^2 + Nh + 1)``
    so the whole factorization is a single matrix product plus one fused
    elementwise producer. The unused cross terms cost extra FLOPs.
    """
    npix, nh = f.shape
    if gram is None:
        gram = gram_matrix(f)
    weights = amp * amp * dinv  # -> K
    u = amp * dinv * delta  # -> w
    q = delta * delta * dinv  # -> quad
    # stacked LHS: one GEMM row per contraction
    lhs = jnp.stack([weights, u, q, log_d, mask], axis=-2)  # (..., 5, Npix)
    ones = jnp.ones((npix, 1), f.dtype)
    rhs = jnp.concatenate([gram, f, ones], axis=1)  # (Npix, nh*nh + nh + 1)
    out = jnp.matmul(
        lhs, rhs, precision=precision, preferred_element_type=jnp.float32
    )  # (..., 5, nh*nh + nh + 1)
    k = out[..., 0, : nh * nh].reshape(out.shape[:-2] + (nh, nh))
    k = k + jnp.eye(nh, dtype=k.dtype)
    w = out[..., 1, nh * nh : nh * nh + nh]
    quad = out[..., 2, -1]
    logdet_d = out[..., 3, -1]
    n_obs = out[..., 4, -1]
    chol = smallchol.cholesky_small(k)
    return LowRankFactors(chol=chol, w=w, quad=quad, logdet_d=logdet_d, n_obs=n_obs)


def nll(factors: LowRankFactors) -> Array:
    """Negative log-likelihood ``-log N(delta | 0, Sigma)`` per spectrum.

        nll = 1/2 (delta^T Sigma^-1 delta + N log 2pi + logdet Sigma)

    with the Woodbury identity ``delta^T Sigma^-1 delta = quad - w^T K^-1 w``
    and the determinant lemma ``logdet Sigma = sum m log D + logdet K``.
    (Reference computes the same quantity with dense matrices,
    ``/root/reference/QFA/model.py:132-135``.)
    """
    y = smallchol.solve_lower_small(factors.chol, factors.w)
    mahal = factors.quad - jnp.sum(y * y, axis=-1)
    logdet_k = smallchol.logdet_from_chol(factors.chol)
    return 0.5 * (mahal + factors.n_obs * LOG_2PI + factors.logdet_d + logdet_k)


def solve_posterior(factors: LowRankFactors) -> tuple[Array, Array]:
    """Posterior mean and covariance of the latent factors ``h``.

    ``hcov = K^-1`` and ``hmean = K^-1 w`` — identical to the reference's
    ``(I + Ftil^T D^-1 Ftil)^-1`` path (``/root/reference/QFA/model.py:177-179``)
    but via Cholesky solves instead of explicit inversion.

    Returns:
        (hmean, hcov) with shapes (..., Nh) and (..., Nh, Nh).
    """
    hcov = smallchol.inverse_from_chol(factors.chol)
    hmean = smallchol.chol_solve_small(factors.chol, factors.w)
    return hmean, hcov


def dense_masked_nll(
    f: Array, delta: Array, amp: Array, d: Array, mask: Array
) -> Array:
    """O(Npix^3) dense-matrix reference for tests (single spectrum).

    Builds the full Npix x Npix covariance ``Ftil Ftil^T + diag(D)``
    (``/root/reference/QFA/model.py:125-135``) with ``jnp.linalg``, the
    masked rows and columns replaced by identity rows: the determinant and
    the solve then equal those of the row-deleted submatrix, while every
    shape stays fixed, so the reference jits, vmaps and differentiates.
    Every product runs at ``Precision.HIGHEST`` (float32 products would
    otherwise run in TF32 on a GPU, which is no reference).
    """
    m, _ftil, sigma = _dense_system(f, amp, d, mask)
    sub_delta = m * delta
    _sign, logdet = jnp.linalg.slogdet(sigma)
    sol = jnp.linalg.solve(sigma, sub_delta)
    mahal = jnp.dot(sub_delta, sol, precision=lax.Precision.HIGHEST)
    return 0.5 * (mahal + jnp.sum(m) * LOG_2PI + logdet)


def _dense_system(f, amp, d, mask):
    """Masked ``Ftil`` and the fixed-shape dense covariance (masked rows and
    columns replaced by identity rows) shared by the dense references."""
    m = jnp.asarray(mask).astype(f.dtype)
    ftil = (m * amp)[:, None] * f
    sigma = (
        jnp.matmul(ftil, ftil.T, precision=lax.Precision.HIGHEST)
        + jnp.diag(m * d + (1.0 - m))
    )
    return m, ftil, sigma


def dense_masked_posterior(
    f: Array, delta: Array, amp: Array, d: Array, mask: Array
) -> tuple[Array, Array]:
    """O(Npix^3) dense reference for the latent posterior (one spectrum).

    ``hmean = Ftil^T Sigma^-1 delta`` and ``hcov = I - Ftil^T Sigma^-1 Ftil``
    with the dense masked covariance of :func:`dense_masked_nll` — the
    covariance-side form, independent of the capacitance (Woodbury) path
    that :func:`solve_posterior` takes. Every product at HIGHEST precision.
    """
    hp = lax.Precision.HIGHEST
    m, ftil, sigma = _dense_system(f, amp, d, mask)
    rhs = jnp.concatenate([(m * delta)[:, None], ftil], axis=1)
    sol = jnp.linalg.solve(sigma, rhs)
    proj = jnp.matmul(ftil.T, sol, precision=hp)  # (Nh, 1 + Nh)
    return proj[:, 0], jnp.eye(f.shape[1], dtype=f.dtype) - proj[:, 1:]
