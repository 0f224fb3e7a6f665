"""What only the card can check: the XLA path's float32 numerics on the GPU
at the SDSS width (Npix 1913, Nb 720, Nh 8) against the dense reference on
the CPU device.

On a machine with an NVIDIA GPU:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

Elsewhere every test here skips (the fixture finds no GPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import qfa_tpu
from qfa_tpu.data.grid import loglam_row, zq_column
from qfa_tpu.data.synthetic import generate
from qfa_tpu.infer import predict_resident
from qfa_tpu.models import dense_predict, predict, random_init

pytestmark = pytest.mark.gpu


def assert_ll_close(got, want, rtol, mask):
    """Likelihoods within ``rtol`` plus an absolute bound per spectrum:
    README's 2e-5 relative NLL bound applied to the magnitude of the
    per-pixel terms the NLL sums (about 2.5 nats per observed pixel), never
    below the CPU tests' 3e-4. Their float32 rounding scales with that
    magnitude, not with the result, and near-zero NLLs have no useful
    relative error (chip_smoke.ll_atol)."""
    got, want = np.asarray(got), np.asarray(want)
    atol = np.maximum(5e-5 * np.asarray(mask).sum(axis=1), 3e-4)
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert not bad.any(), (got[bad], want[bad], atol[bad])


@pytest.fixture(scope="module")
def gpu():
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda,cpu)")
    return devices[0]


@pytest.fixture(scope="module")
def sdss(gpu):
    grid = qfa_tpu.make_grid()
    params = random_init(jax.random.key(0), grid.npix, grid.nb, 8)
    params = params._replace(Psi=jnp.full((grid.npix,), 0.05),
                             omega=jnp.full((grid.nb,), 0.2))
    mu = jnp.full((grid.npix,), 1.1, jnp.float32)
    syn = generate(jax.random.key(1), params, mu, grid, 64, mask_frac=0.1)
    put = lambda t: jax.device_put(t, gpu)  # noqa: E731
    return grid, put(params), put(mu), put(syn)


def test_highest_precision_product_keeps_float32_on_gpu(gpu):
    """A product pinned to HIGHEST keeps float32 accuracy on the card
    (TF32's 10-bit mantissa would miss this bound by about 100x)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((512, 1913)).astype(np.float32)
    y = rng.standard_normal((1913, 73)).astype(np.float32)
    got = jnp.matmul(jax.device_put(x, gpu), jax.device_put(y, gpu),
                     precision=jax.lax.Precision.HIGHEST)
    want = x.astype(np.float64) @ y.astype(np.float64)
    scale = np.abs(x).astype(np.float64) @ np.abs(y).astype(np.float64)
    assert float(np.max(np.abs(np.asarray(got) - want) / scale)) < 1e-5


def test_predict_matches_dense_on_gpu(sdss):
    """The batched predictor on the card against the dense reference on the
    CPU, at the bounds of tests/test_model.py and tests/test_linalg.py
    (the likelihood's absolute bound scaled per observed pixel)."""
    grid, params, mu, syn = sdss
    flux, error = syn.flux * syn.mask, syn.error * syn.mask
    got = jax.device_get(predict(params, mu, flux, error, syn.zabs,
                                 syn.mask))
    cpu = jax.devices("cpu")[0]
    args = jax.device_put((params, mu, flux[:8], error[:8], syn.zabs[:8],
                           syn.mask[:8]), cpu)
    with jax.default_device(cpu):
        ref = jax.device_get(jax.jit(dense_predict)(*args))
    assert_ll_close(got.ll[:8], ref.ll, 3e-5, syn.mask[:8])
    np.testing.assert_allclose(got.hmean[:8], ref.hmean, rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(got.hcov[:8], ref.hcov, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got.continuum[:8], ref.continuum, rtol=1e-3,
                               atol=1e-3)


def test_stats_only_sweep_matches_predict_on_gpu(sdss):
    """The compact stats-only sweep and the four-plane predictor agree on
    the card (README's NLL bound, scaled per observed pixel, and the
    posterior's bound: the two programs sum in other orders)."""
    grid, params, mu, syn = sdss
    flux, error = syn.flux * syn.mask, syn.error * syn.mask
    full = predict(params, mu, flux, error, syn.zabs, syn.mask)
    lean = predict_resident(params, mu, flux, error, zq_column(syn.zqso),
                            None, batch_size=32, stats_only=True,
                            loglam=loglam_row(grid.wav))
    assert_ll_close(lean.ll, full.ll, 2e-5, syn.mask)
    np.testing.assert_allclose(np.asarray(lean.hmean),
                               np.asarray(full.hmean), rtol=1e-3, atol=1e-4)
