"""The predictor's survey options — stats-only output and the compact input
(mask derived from ``error > 0``, ``log1p(zqso)`` column in place of the
absorber-redshift plane) — against the four-plane predict path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import qfa_tpu
from qfa_tpu.data.grid import loglam_row, zq_column
from qfa_tpu.data.synthetic import generate
from qfa_tpu.models import predict, random_init


@pytest.fixture(scope="module")
def problem():
    grid = qfa_tpu.make_grid(1030.0, 1090.0, 1e-3)
    nh = 4
    params = random_init(jax.random.key(0), grid.npix, grid.nb, nh)
    params = params._replace(
        Psi=jnp.full((grid.npix,), 0.4),
        omega=jnp.full((grid.nb,), 0.7),
        tau0=jnp.asarray(0.12), c0=jnp.asarray(0.21), beta=jnp.asarray(1.7),
    )
    mu = jnp.linspace(0.9, 1.3, grid.npix).astype(jnp.float32)
    syn = generate(jax.random.key(1), params, mu, grid, 32, mask_frac=0.15)
    return grid, params, mu, syn


def compact(grid, syn):
    """The compact input: masked flux/error, zq column, loglam row."""
    return (syn.flux * syn.mask, syn.error * syn.mask, zq_column(syn.zqso),
            loglam_row(grid.wav))


def test_fused_predict_matches_xla_predict(problem):
    """Compact input (derived mask + zq column) == the four-plane path."""
    grid, params, mu, syn = problem
    ref = predict(params, mu, syn.flux, syn.error * syn.mask, syn.zabs,
                  syn.mask)
    flux, error, zq, llrow = compact(grid, syn)
    out = predict(params, mu, flux, error, zq, None, loglam=llrow)
    np.testing.assert_allclose(np.asarray(out.ll), np.asarray(ref.ll),
                               rtol=2e-5)
    np.testing.assert_allclose(np.asarray(out.hmean), np.asarray(ref.hmean),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.hcov), np.asarray(ref.hcov),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(np.asarray(out.continuum),
                               np.asarray(ref.continuum), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.continuum_std),
                               np.asarray(ref.continuum_std), rtol=1e-3,
                               atol=1e-5)


def test_fused_predict_derived_mask(problem):
    """mask=None derives the mask from error > 0 and matches."""
    grid, params, mu, syn = problem
    flux = syn.flux * syn.mask
    error = syn.error * syn.mask
    out_m = predict(params, mu, flux, error, syn.zabs, syn.mask)
    out_d = predict(params, mu, flux, error, syn.zabs, None)
    np.testing.assert_allclose(np.asarray(out_d.ll), np.asarray(out_m.ll),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(out_d.continuum),
                               np.asarray(out_m.continuum), rtol=1e-6)


def test_fused_predict_derive_zabs(problem):
    """The zq-column input (absorber redshifts rebuilt on the device)
    matches the zabs-plane run to float32 rounding."""
    grid, params, mu, syn = problem
    flux, error, zq, llrow = compact(grid, syn)
    out_p = predict(params, mu, flux, error, syn.zabs, syn.mask)
    out_c = predict(params, mu, flux, error, zq, syn.mask, loglam=llrow)
    np.testing.assert_allclose(np.asarray(out_c.ll), np.asarray(out_p.ll),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(out_c.hmean),
                               np.asarray(out_p.hmean), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out_c.continuum),
                               np.asarray(out_p.continuum), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.skipif(
    not __import__("os").path.isdir("/root/reference/data"),
    reason="reference data artifacts not present",
)
def test_fused_predict_golden_file():
    """The compact input reproduces the reference's stored golden outputs."""
    from qfa_tpu.models import load_npz

    grid = qfa_tpu.make_grid()
    params, mu = load_npz(
        "/root/reference/data/model_parameters.npz", compat_c0_bug=True
    )
    s = np.load("/root/reference/data/spec-4321-55504-0114.npz")
    mask = np.asarray(s["mask"], bool)
    flux = np.where(mask, s["flux"], 0.0).astype(np.float32)
    error = np.where(mask, s["error"], 0.0).astype(np.float32)
    out = predict(
        params, mu,
        jnp.asarray(flux)[None], jnp.asarray(error)[None],
        zq_column(jnp.asarray([float(s["z"])])),
        jnp.asarray(mask, jnp.float32)[None],
        loglam=loglam_row(grid.wav),
    )
    assert float(out.ll[0]) == pytest.approx(float(s["ll"]), abs=5e-3)
    np.testing.assert_allclose(np.asarray(out.hmean[0]), s["h"], atol=5e-5)
    np.testing.assert_allclose(np.asarray(out.continuum[0]), s["our"],
                               atol=5e-5)


def test_predict_dataset_fused_matches_host_path(problem):
    """The resident stats-only sweep in the compact input equals
    predict_dataset (host path with padded tail batches)."""
    from qfa_tpu.data.loader import SpectraDataset
    from qfa_tpu.infer import predict_dataset, predict_resident

    grid, params, mu, syn = problem
    m = np.asarray(syn.mask) > 0
    ds = SpectraDataset(
        flux=np.where(m, np.asarray(syn.flux), 0.0).astype(np.float32),
        error=np.where(m, np.asarray(syn.error), 0.0).astype(np.float32),
        mask=m,
        zqso=np.asarray(syn.zqso, np.float32),
        paths=(),
    )
    # 32 spectra in batches of 12 -> a padded tail batch
    a = predict_dataset(params, mu, ds, grid, batch_size=12)
    flux, error, zq, llrow = compact(grid, syn)
    for batch_size in (8, 16):
        b = predict_resident(params, mu, flux, error, zq, None,
                             batch_size=batch_size, stats_only=True,
                             loglam=llrow)
        assert b.continuum is None
        np.testing.assert_allclose(np.asarray(b.ll), np.asarray(a.ll),
                                   rtol=2e-5)
        np.testing.assert_allclose(np.asarray(b.hmean), np.asarray(a.hmean),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(b.hcov), np.asarray(a.hcov),
                                   rtol=1e-4, atol=1e-7)


def test_predict_dataset_fused_unsanitized_mask(problem):
    """When masked pixels carry error > 0 (mask not derivable from the
    error plane), passing the mask plane still matches the host path,
    while deriving it would not."""
    from qfa_tpu.data.loader import SpectraDataset
    from qfa_tpu.infer import predict_dataset

    grid, params, mu, syn = problem
    m = np.asarray(syn.mask) > 0
    ds = SpectraDataset(
        flux=np.where(m, np.asarray(syn.flux), 0.0).astype(np.float32),
        error=np.asarray(syn.error, np.float32),  # masked pixels keep error
        mask=m,
        zqso=np.asarray(syn.zqso, np.float32),
        paths=(),
    )
    assert not bool(np.all((ds.error > 0.0) == ds.mask))
    a = predict_dataset(params, mu, ds, grid, batch_size=8)
    zq, llrow = zq_column(syn.zqso), loglam_row(grid.wav)
    b = predict(params, mu, ds.flux, ds.error, zq, syn.mask, loglam=llrow)
    np.testing.assert_allclose(np.asarray(b.ll), np.asarray(a.ll), rtol=2e-5)
    np.testing.assert_allclose(np.asarray(b.continuum),
                               np.asarray(a.continuum), rtol=1e-4, atol=1e-5)
    derived = predict(params, mu, ds.flux, ds.error, zq, None, loglam=llrow)
    assert not np.allclose(np.asarray(derived.ll), np.asarray(a.ll),
                           rtol=2e-5)


def test_fused_predict_fully_masked_rows(problem):
    """Fully-masked rows are inert: ll = 0, posterior = prior."""
    grid, params, mu, syn = problem
    flux, error, zq, llrow = compact(grid, syn)
    flux = np.array(flux)
    error = np.array(error)
    flux[3] = 0.0
    error[3] = 0.0
    out = predict(params, mu, jnp.asarray(flux), jnp.asarray(error), zq,
                  None, loglam=llrow)
    assert float(out.ll[3]) == 0.0
    # prior posterior: hmean = 0, hcov = I
    np.testing.assert_allclose(np.asarray(out.hmean[3]), 0.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.hcov[3]),
                               np.eye(params.F.shape[1]), atol=1e-5)
    # continuum falls back to mu
    np.testing.assert_allclose(np.asarray(out.continuum[3]),
                               np.asarray(mu), atol=1e-5)
    # other rows unaffected
    ref = predict(params, mu, *compact(grid, syn)[:3], None, loglam=llrow)
    np.testing.assert_allclose(np.asarray(out.ll[:3]), np.asarray(ref.ll[:3]),
                               rtol=1e-6)


def test_fused_predict_stats_only(problem):
    """OOD-sweep mode: same ll/posterior, no continuum planes."""
    grid, params, mu, syn = problem
    flux, error, zq, llrow = compact(grid, syn)
    full = predict(params, mu, flux, error, zq, None, loglam=llrow)
    lean = predict(params, mu, flux, error, zq, None, loglam=llrow,
                   stats_only=True)
    assert lean.continuum is None and lean.continuum_std is None
    np.testing.assert_allclose(np.asarray(lean.ll), np.asarray(full.ll),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(lean.hmean),
                               np.asarray(full.hmean), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(lean.hcov), np.asarray(full.hcov),
                               rtol=1e-6)


def test_fused_predict_bf16_planes(problem):
    """bfloat16 flux/error storage tracks the f32 run within the data
    quantization level (survey-scale OOD sweeps)."""
    grid, params, mu, syn = problem
    flux, error, zq, llrow = compact(grid, syn)
    a = predict(params, mu, flux, error, zq, None, loglam=llrow)
    b = predict(params, mu, flux.astype(jnp.bfloat16),
                error.astype(jnp.bfloat16), zq, None, loglam=llrow)
    np.testing.assert_allclose(np.asarray(b.ll), np.asarray(a.ll), rtol=2e-2)
    np.testing.assert_allclose(np.asarray(b.continuum),
                               np.asarray(a.continuum), rtol=5e-2, atol=2e-2)


def test_fused_predict_bf16_out(problem):
    """bfloat16-stored planes are computed in float32: every output comes
    back float32, and the stats-only sweep equals the full run on them."""
    grid, params, mu, syn = problem
    flux, error, zq, llrow = compact(grid, syn)
    flux, error = flux.astype(jnp.bfloat16), error.astype(jnp.bfloat16)
    full = predict(params, mu, flux, error, zq, None, loglam=llrow)
    lean = predict(params, mu, flux, error, zq, None, loglam=llrow,
                   stats_only=True)
    for name in ("ll", "hmean", "hcov", "continuum", "continuum_std"):
        assert getattr(full, name).dtype == jnp.float32, name
    for name in ("ll", "hmean", "hcov"):
        np.testing.assert_allclose(np.asarray(getattr(lean, name)),
                                   np.asarray(getattr(full, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("nh", [1, 10])
def test_fused_predict_stats_layout_nh_edges(nh):
    """Stats-only sweep in the compact input at the latent-dim edges."""
    grid = qfa_tpu.make_grid(1030.0, 1060.0, 1e-3)
    params = random_init(jax.random.key(3), grid.npix, grid.nb, nh)
    mu = jnp.linspace(0.9, 1.3, grid.npix).astype(jnp.float32)
    syn = generate(jax.random.key(4), params, mu, grid, 16, mask_frac=0.1)
    ref = predict(params, mu, syn.flux, syn.error * syn.mask, syn.zabs,
                  syn.mask)
    flux, error, zq, llrow = compact(grid, syn)
    out = predict(params, mu, flux, error, zq, None, loglam=llrow,
                  stats_only=True)
    np.testing.assert_allclose(np.asarray(out.ll), np.asarray(ref.ll),
                               rtol=2e-5)
    np.testing.assert_allclose(np.asarray(out.hmean), np.asarray(ref.hmean),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(np.asarray(out.hcov), np.asarray(ref.hcov),
                               rtol=2e-4, atol=1e-7)
    assert out.hcov.shape == (16, nh, nh)


def test_fused_predict_permutation_equivariant(problem):
    """Each spectrum's outputs are independent of its batch neighbours:
    permuting the batch permutes every output."""
    grid, params, mu, syn = problem
    flux, error, zq, llrow = compact(grid, syn)
    perm = np.random.default_rng(5).permutation(flux.shape[0])
    a = predict(params, mu, flux, error, zq, None, loglam=llrow)
    b = predict(params, mu, flux[perm], error[perm], zq[perm], None,
                loglam=llrow)
    np.testing.assert_allclose(np.asarray(b.ll), np.asarray(a.ll)[perm],
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(b.hmean),
                               np.asarray(a.hmean)[perm], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(b.continuum),
                               np.asarray(a.continuum)[perm], rtol=1e-6,
                               atol=1e-7)
