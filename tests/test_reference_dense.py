"""Prediction against the plain dense reference: every output of
:func:`qfa_tpu.models.predict` against :func:`qfa_tpu.models.dense_predict`
(the dense ``Npix x Npix`` covariance at HIGHEST precision) over every tau
law, masking pattern and latent width."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import qfa_tpu
from qfa_tpu.data.synthetic import generate
from qfa_tpu.models import ModelOptions, dense_predict, predict, random_init

TAUS = ["becker", "fg", "kamble", "mock"]
GRID = qfa_tpu.make_grid(1100.0, 1400.0, 2e-3)  # blue and red pixels


def true_params(nh, seed=0):
    p = random_init(jax.random.key(seed), GRID.npix, GRID.nb, nh)
    return p._replace(Psi=jnp.full((GRID.npix,), 0.05),
                      omega=jnp.full((GRID.nb,), 0.2),
                      tau0=jnp.asarray(0.1), c0=jnp.asarray(0.25),
                      beta=jnp.asarray(1.8))


def masked(pattern, n, seed=3):
    mask = np.ones((n, GRID.npix), np.float32)
    if pattern == "random30":
        rng = np.random.default_rng(seed)
        mask = (rng.uniform(size=mask.shape) > 0.3).astype(np.float32)
    elif pattern == "blue":
        mask[:, : GRID.nb] = 0.0
    elif pattern == "row":
        mask[1] = 0.0
    return jnp.asarray(mask)


MU = jnp.linspace(0.9, 1.3, GRID.npix).astype(jnp.float32)
_dense = jax.jit(dense_predict, static_argnums=(6,))
_generate = jax.jit(
    lambda key, params, tau: generate(key, params, MU, GRID, 4,
                                      tau_which=tau),
    static_argnums=(2,),
)


@pytest.mark.parametrize("nh", [1, 8, 16])
@pytest.mark.parametrize("pattern", ["none", "random30", "blue", "row"])
@pytest.mark.parametrize("tau", TAUS)
def test_predict_matches_dense_reference(tau, pattern, nh):
    """ll, posterior and continuum (with its std) of the capacitance path
    equal the dense covariance computation."""
    params = true_params(nh)
    syn = _generate(jax.random.key(1), params, tau)
    mask = masked(pattern, 4)
    flux, error = syn.flux * mask, syn.error * mask
    opts = ModelOptions(tau_which=tau)
    got = predict(params, MU, flux, error, syn.zabs, mask, opts)
    ref = _dense(params, MU, flux, error, syn.zabs, mask, opts)
    np.testing.assert_allclose(got.ll, ref.ll, rtol=3e-5, atol=3e-4)
    np.testing.assert_allclose(got.hmean, ref.hmean, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.hcov, ref.hcov, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got.continuum, ref.continuum, rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(got.continuum_std, ref.continuum_std,
                               rtol=1e-3, atol=1e-4)
    if pattern == "row":  # a fully masked row is the prior
        assert float(got.ll[1]) == 0.0
        np.testing.assert_allclose(got.hcov[1], np.eye(nh), atol=1e-6)
