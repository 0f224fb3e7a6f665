"""Low-rank linear-algebra kernels for the masked Gaussian likelihood."""

from .lowrank import (
    LOG_2PI,
    LowRankFactors,
    batched_capacitance,
    dense_masked_nll,
    dense_masked_posterior,
    factorize,
    gram_matrix,
    nll,
    solve_posterior,
)

__all__ = [
    "LOG_2PI",
    "LowRankFactors",
    "batched_capacitance",
    "dense_masked_nll",
    "dense_masked_posterior",
    "factorize",
    "gram_matrix",
    "nll",
    "solve_posterior",
]
