"""Unrolled Cholesky factorization/solves for tiny SPD matrices.

``jnp.linalg.cholesky`` + ``triangular_solve`` on a batch of Nh x Nh
matrices (Nh ~ 8) lower to library loop kernels that do not fuse with their
neighbours. For small static Nh the factorization is just ~Nh^2/2 scalar
formulas, so we unroll them into elementwise ops over the batch dimension —
XLA fuses the whole factor+solve+logdet chain into elementwise kernels, and
autodiff works through it for free.

Used by the likelihood hot path whenever Nh <= MAX_UNROLL_DIM.
"""

from __future__ import annotations

import jax.numpy as jnp

Array = jnp.ndarray

MAX_UNROLL_DIM = 16

__all__ = [
    "MAX_UNROLL_DIM",
    "cholesky_small",
    "solve_lower_small",
    "solve_upper_small",
    "chol_solve_small",
    "logdet_from_chol",
    "inverse_from_chol",
]


def cholesky_small(k: Array) -> Array:
    """Lower Cholesky of (..., n, n) SPD matrices, unrolled over n.

    Equivalent to ``jnp.linalg.cholesky`` (the strictly-upper triangle of the
    result is zero).
    """
    n = k.shape[-1]
    if n > MAX_UNROLL_DIM:
        return jnp.linalg.cholesky(k)
    col: list[list[Array]] = [[None] * n for _ in range(n)]
    for j in range(n):
        s = k[..., j, j]
        for p in range(j):
            s = s - col[j][p] * col[j][p]
        d = jnp.sqrt(s)
        inv_d = 1.0 / d
        col[j][j] = d
        for i in range(j + 1, n):
            s = k[..., i, j]
            for p in range(j):
                s = s - col[i][p] * col[j][p]
            col[i][j] = s * inv_d
    zero = jnp.zeros_like(k[..., 0, 0])
    rows = [
        jnp.stack([col[i][j] if j <= i else zero for j in range(n)], axis=-1)
        for i in range(n)
    ]
    return jnp.stack(rows, axis=-2)


def solve_lower_small(chol: Array, b: Array) -> Array:
    """Solve ``L y = b`` by unrolled forward substitution.

    ``chol``: (..., n, n) lower triangular; ``b``: (..., n).
    """
    n = chol.shape[-1]
    y: list[Array] = []
    for i in range(n):
        s = b[..., i]
        for j in range(i):
            s = s - chol[..., i, j] * y[j]
        y.append(s / chol[..., i, i])
    return jnp.stack(y, axis=-1)


def solve_upper_small(chol: Array, y: Array) -> Array:
    """Solve ``L^T x = y`` by unrolled back substitution (``chol`` lower)."""
    n = chol.shape[-1]
    x: list[Array] = [None] * n
    for i in reversed(range(n)):
        s = y[..., i]
        for j in range(i + 1, n):
            s = s - chol[..., j, i] * x[j]
        x[i] = s / chol[..., i, i]
    return jnp.stack(x, axis=-1)


def chol_solve_small(chol: Array, b: Array) -> Array:
    """Solve ``K x = b`` given the lower Cholesky of K."""
    return solve_upper_small(chol, solve_lower_small(chol, b))


def logdet_from_chol(chol: Array) -> Array:
    """``logdet K = 2 sum log diag(L)``."""
    diag = jnp.stack(
        [chol[..., i, i] for i in range(chol.shape[-1])], axis=-1
    )
    return 2.0 * jnp.sum(jnp.log(diag), axis=-1)


def inverse_from_chol(chol: Array) -> Array:
    """Full inverse ``K^-1`` from the Cholesky (n columns of solves)."""
    n = chol.shape[-1]
    eye = jnp.eye(n, dtype=chol.dtype)
    cols = [
        chol_solve_small(chol, jnp.broadcast_to(eye[i], chol.shape[:-2] + (n,)))
        for i in range(n)
    ]
    return jnp.stack(cols, axis=-1)
