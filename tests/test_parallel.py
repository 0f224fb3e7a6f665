"""Multi-device data parallelism on the 8-virtual-device CPU mesh.

Validates the SPMD training path: sharded resident dataset, per-shard
shuffling, psum'd gradient/count statistics — against the single-device
implementation on identical batch composition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import qfa_tpu
from qfa_tpu.data.batch import SpectraBatch
from qfa_tpu.data.loader import ResidualDataset
from qfa_tpu.data.synthetic import generate
from qfa_tpu.models import loss_and_grads, random_init
from qfa_tpu.parallel import (
    make_dp_epoch_fn,
    make_mesh,
    shard_dataset,
    shard_epoch_indices,
)
from qfa_tpu.train import TrainConfig, TrainState, adam
from qfa_tpu.train.loop import make_epoch_fn


NDEV = 8


@pytest.fixture(scope="module")
def problem():
    grid = qfa_tpu.make_grid(1030.0, 1080.0, 1e-3)
    true = random_init(jax.random.key(0), grid.npix, grid.nb, 4)
    mu = jnp.ones((grid.npix,), jnp.float32)
    syn = generate(jax.random.key(1), true, mu, grid, 128, mask_frac=0.15)
    b = syn.to_batch(mu)
    data = ResidualDataset(delta=b.delta, error=b.error, zabs=b.zabs, mask=b.mask)
    return grid, data


def fresh_state(grid, nh=4, seed=2):
    p = random_init(jax.random.key(seed), grid.npix, grid.nb, nh)
    return TrainState(p, adam.init(p))


def test_device_count():
    assert jax.device_count() == NDEV


def test_dataset_sharding_layout(problem):
    grid, data = problem
    mesh = make_mesh(NDEV)
    sharded = shard_dataset(data, mesh)
    shard_shapes = {
        s.data.shape for s in sharded.delta.addressable_shards
    }
    assert shard_shapes == {(128 // NDEV, grid.npix)}


def test_dp_epoch_matches_single_device_update(problem):
    """One DP epoch with the same *global* batch composition must produce the
    same parameters as the single-device epoch (up to float32 reduction
    order)."""
    grid, data = problem
    mesh = make_mesh(NDEV)
    cfg = TrainConfig(batch_size=32, learning_rate=1e-2, weight_decay=0.01)

    # DP path
    sharded = shard_dataset(data, mesh)
    idx = shard_epoch_indices(jax.random.key(5), data.size, cfg.batch_size, mesh)
    st_dp, loss_dp = make_dp_epoch_fn(cfg, mesh)(
        fresh_state(grid), sharded, idx
    )

    # Single-device path with the SAME global batches: device d's local
    # indices map to global rows d*shard + i.
    shard = data.size // NDEV
    idx_host = np.asarray(jax.device_get(idx.idx))  # (ndev, n_batches, local)
    n_batches = idx_host.shape[1]
    global_idx = np.concatenate(
        [idx_host[d] + d * shard for d in range(NDEV)], axis=1
    )  # (n_batches, batch)
    st_1, loss_1 = make_epoch_fn(cfg)(
        fresh_state(grid), data, jnp.asarray(global_idx)
    )

    assert float(loss_dp) == pytest.approx(float(loss_1), rel=1e-5)
    for a, b in zip(jax.tree.leaves(st_dp.params), jax.tree.leaves(st_1.params)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=5e-4, atol=1e-5
        )


def test_dp_scales_to_smaller_mesh(problem):
    grid, data = problem
    mesh = make_mesh(4)
    cfg = TrainConfig(batch_size=32, learning_rate=1e-2)
    sharded = shard_dataset(data, mesh)
    idx = shard_epoch_indices(jax.random.key(6), data.size, cfg.batch_size, mesh)
    st, loss = make_dp_epoch_fn(cfg, mesh)(fresh_state(grid), sharded, idx)
    assert np.isfinite(float(loss))
    for leaf in jax.tree.leaves(st.params):
        assert np.isfinite(np.asarray(leaf)).all()


def test_shard_epoch_indices_validation(problem):
    _, data = problem
    mesh = make_mesh(NDEV)
    with pytest.raises(ValueError):
        shard_epoch_indices(jax.random.key(0), 127, 32, mesh)  # n not divisible
    with pytest.raises(ValueError):
        shard_epoch_indices(jax.random.key(0), 128, 30, mesh)  # batch not divisible


def test_2d_mesh_data_pix_step_matches_single_device(problem):
    """The (data, pix) sharded training step must equal the single-device
    step on the same batch."""
    from qfa_tpu.parallel.tp import (
        make_mesh_2d,
        make_tp_step_fn,
        shard_batch_2d,
        shard_params_2d,
    )
    from qfa_tpu.data.batch import SpectraBatch
    from qfa_tpu.train.loop import make_step_fn

    # pixel sharding needs Npix divisible by the pix axis -> dedicated grid
    grid = qfa_tpu.make_grid(1030.0, 1080.0, 7.4e-4)
    assert grid.npix % 4 == 0
    true = random_init(jax.random.key(0), grid.npix, grid.nb, 4)
    mu = jnp.ones((grid.npix,), jnp.float32)
    syn = generate(jax.random.key(1), true, mu, grid, 32, mask_frac=0.15)
    b = syn.to_batch(mu)
    cfg = TrainConfig(batch_size=32, learning_rate=1e-2, weight_decay=0.01)
    batch = SpectraBatch(
        delta=b.delta, error=b.error, zabs=b.zabs, mask=b.mask,
        weight=jnp.ones((32,), jnp.float32),
    )

    # single device
    p0 = random_init(jax.random.key(3), grid.npix, grid.nb, 4)
    st1, loss1 = make_step_fn(cfg)(TrainState(p0, adam.init(p0)), batch)

    # 2x4 mesh
    mesh = make_mesh_2d(2, 4)
    p0b = random_init(jax.random.key(3), grid.npix, grid.nb, 4)
    state = TrainState(
        shard_params_2d(p0b, mesh),
        jax.tree.map(lambda x: x, adam.init(shard_params_2d(p0b, mesh))),
    )
    sbatch = shard_batch_2d(batch, mesh)
    st2, loss2 = make_tp_step_fn(cfg, mesh)(state, sbatch)

    assert float(loss2) == pytest.approx(float(loss1), rel=1e-5)
    for a, b in zip(jax.tree.leaves(st1.params), jax.tree.leaves(st2.params)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=5e-4, atol=1e-5
        )


def test_initialize_distributed_error_handling(monkeypatch):
    """Already-initialized is tolerated; real failures re-raise."""
    from qfa_tpu.parallel import initialize_distributed
    import jax as _jax

    calls = []

    def fake_ok(**kw):
        calls.append(kw)
        raise RuntimeError("backend already initialized somewhere")

    monkeypatch.setattr(_jax.distributed, "initialize", fake_ok)
    initialize_distributed(coordinator_address="h:1")  # swallowed
    assert calls

    def fake_bad(**kw):
        raise RuntimeError("connection to coordinator failed")

    monkeypatch.setattr(_jax.distributed, "initialize", fake_bad)
    with pytest.raises(RuntimeError, match="coordinator failed"):
        initialize_distributed(coordinator_address="h:1")



@pytest.mark.parametrize("reference_norm", [True, False])
@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_dp_epoch_mesh_sizes_match_single_device(problem, ndev,
                                                 reference_norm):
    """Exact DP on every mesh size, under both gradient normalizations,
    follows the single-device epoch on the same global batches."""
    grid, data = problem
    mesh = make_mesh(ndev)
    cfg = TrainConfig(batch_size=32, learning_rate=1e-2, weight_decay=0.01,
                      reference_norm=reference_norm)
    idx = shard_epoch_indices(jax.random.key(10 + ndev), data.size,
                              cfg.batch_size, mesh)
    st_dp, loss_dp = make_dp_epoch_fn(cfg, mesh)(
        fresh_state(grid), shard_dataset(data, mesh), idx
    )
    shard = data.size // ndev
    idx_host = np.asarray(jax.device_get(idx.idx))
    global_idx = np.concatenate(
        [idx_host[d] + d * shard for d in range(ndev)], axis=1
    )
    st_1, loss_1 = make_epoch_fn(cfg)(
        fresh_state(grid), data, jnp.asarray(global_idx)
    )
    assert float(loss_dp) == pytest.approx(float(loss_1), rel=1e-5)
    for a, b in zip(jax.tree.leaves(st_dp.params),
                    jax.tree.leaves(st_1.params)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=5e-4, atol=1e-5
        )


@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (2, 4)])
def test_2d_mesh_shapes_match_single_device(shape):
    """The (data, pix) step on every 2-D mesh shape equals one device."""
    from qfa_tpu.parallel.tp import (
        make_mesh_2d,
        make_tp_step_fn,
        shard_batch_2d,
        shard_params_2d,
    )
    from qfa_tpu.train.loop import make_step_fn

    grid = qfa_tpu.make_grid(1030.0, 1080.0, 7.4e-4)
    assert grid.npix % shape[1] == 0
    true = random_init(jax.random.key(0), grid.npix, grid.nb, 4)
    mu = jnp.ones((grid.npix,), jnp.float32)
    syn = generate(jax.random.key(1), true, mu, grid, 32, mask_frac=0.15)
    b = syn.to_batch(mu)
    cfg = TrainConfig(batch_size=32, learning_rate=1e-2, weight_decay=0.01)
    batch = SpectraBatch(
        delta=b.delta, error=b.error, zabs=b.zabs, mask=b.mask,
        weight=jnp.ones((32,), jnp.float32),
    )
    p0 = random_init(jax.random.key(3), grid.npix, grid.nb, 4)
    st1, loss1 = make_step_fn(cfg)(TrainState(p0, adam.init(p0)), batch)

    mesh = make_mesh_2d(*shape)
    p0b = shard_params_2d(
        random_init(jax.random.key(3), grid.npix, grid.nb, 4), mesh
    )
    st2, loss2 = make_tp_step_fn(cfg, mesh)(
        TrainState(p0b, adam.init(p0b)), shard_batch_2d(batch, mesh)
    )
    assert float(loss2) == pytest.approx(float(loss1), rel=1e-5)
    for a, b in zip(jax.tree.leaves(st1.params), jax.tree.leaves(st2.params)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=5e-4, atol=1e-5
        )


# ---- multi-device prediction ----------------------------------------------


@pytest.fixture(scope="module")
def infer_problem():
    grid = qfa_tpu.make_grid(1030.0, 1090.0, 1e-3)
    params = random_init(jax.random.key(0), grid.npix, grid.nb, 4)
    mu = jnp.linspace(0.9, 1.3, grid.npix).astype(jnp.float32)
    syn = generate(jax.random.key(1), params, mu, grid, 64, mask_frac=0.15)
    return grid, params, mu, syn


def test_dp_fused_predict_matches_single_device(infer_problem):
    """Full-mode sharded prediction over 8 devices == the single-device
    predictor (float32 rounding), outputs left sharded."""
    from qfa_tpu.models import predict
    from qfa_tpu.parallel import make_dp_predict_fn

    grid, params, mu, syn = infer_problem
    flux, err = syn.flux * syn.mask, syn.error * syn.mask
    ref = predict(params, mu, flux, err, syn.zabs, syn.mask)
    dp = make_dp_predict_fn(make_mesh(NDEV))(
        params, mu, flux, err, syn.zabs, syn.mask
    )
    for f in ref._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(ref, f)), np.asarray(getattr(dp, f)),
            rtol=2e-6, atol=2e-6, err_msg=f,
        )
    # outputs come back sharded over the batch axis — no gather happened
    assert {s.data.shape[0] for s in dp.ll.addressable_shards} == {
        64 // NDEV
    }


def test_dp_fused_predict_stats_only_production_layout(infer_problem):
    """The survey OOD layout (stats only, mask from error > 0, log1p(zqso)
    column) runs sharded and matches, with the continuum planes elided."""
    from qfa_tpu.data.grid import loglam_row, zq_column
    from qfa_tpu.models import predict
    from qfa_tpu.parallel import make_dp_predict_fn, shard_leaves

    grid, params, mu, syn = infer_problem
    flux, err = syn.flux * syn.mask, syn.error * syn.mask
    zq = zq_column(syn.zqso)
    llrow = loglam_row(grid.wav)
    mesh = make_mesh(NDEV)
    ref = predict(params, mu, flux, err, zq, None, stats_only=True,
                  loglam=llrow)
    # pre-sharded device inputs, as a resident survey sweep would hold them
    sflux, serr, szq = shard_leaves((flux, err, zq), mesh)
    dp = make_dp_predict_fn(mesh, has_mask=False, compact=True,
                            stats_only=True)(
        params, mu, sflux, serr, szq, llrow
    )
    assert dp.continuum is None and dp.continuum_std is None
    np.testing.assert_allclose(np.asarray(ref.ll), np.asarray(dp.ll),
                               rtol=2e-6)
    np.testing.assert_allclose(np.asarray(ref.hmean), np.asarray(dp.hmean),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np.asarray(ref.hcov), np.asarray(dp.hcov),
                               rtol=2e-5, atol=1e-7)


def test_predict_dataset_fused_on_mesh_matches_single_device(infer_problem):
    """predict_dataset(mesh=...) shards each batch over the mesh (padded
    tail included) and equals the single-device driver."""
    from qfa_tpu.data.loader import SpectraDataset
    from qfa_tpu.infer import predict_dataset

    grid, params, mu, syn = infer_problem
    m = np.asarray(syn.mask) > 0
    # 40 spectra in batches of 12 -> rounded up to 16 over 8 devices, so
    # the last batch pads 8 -> 16 inert rows
    ds = SpectraDataset(
        flux=np.where(m, np.asarray(syn.flux), 0.0)[:40].astype(np.float32),
        error=np.where(m, np.asarray(syn.error), 0.0)[:40].astype(np.float32),
        mask=m[:40],
        zqso=np.asarray(syn.zqso, np.float32)[:40],
        paths=(),
    )
    a = predict_dataset(params, mu, ds, grid, batch_size=12)
    b = predict_dataset(params, mu, ds, grid, batch_size=12,
                        mesh=make_mesh(NDEV))
    for f in ("ll", "hmean", "hcov", "continuum", "continuum_std"):
        assert getattr(b, f).shape[0] == 40
        np.testing.assert_allclose(
            np.asarray(getattr(b, f)), np.asarray(getattr(a, f)),
            rtol=2e-5, atol=2e-6, err_msg=f,
        )


def test_dp_fused_predict_compiles_with_zero_collectives(infer_problem):
    """The compiled SPMD prediction program contains NO collective ops —
    prediction has no cross-spectrum coupling."""
    from qfa_tpu.data.grid import loglam_row, zq_column
    from qfa_tpu.parallel.infer_dp import make_dp_predict_fn

    grid, params, mu, syn = infer_problem
    flux, err = syn.flux * syn.mask, syn.error * syn.mask
    fn = make_dp_predict_fn(make_mesh(NDEV), has_mask=False, compact=True)
    txt = fn.lower(
        params, mu, flux, err, zq_column(syn.zqso), loglam_row(grid.wav)
    ).compile().as_text()
    for word in ("all-reduce", "all-gather", "collective-permute",
                 "all-to-all", "reduce-scatter"):
        assert word not in txt, word


def test_dp_predict_rejects_2d_mesh():
    """Prediction shards over a 1-D data mesh only."""
    from qfa_tpu.parallel import make_dp_predict_fn
    from qfa_tpu.parallel.tp import make_mesh_2d

    with pytest.raises(ValueError, match="1-D"):
        make_dp_predict_fn(make_mesh_2d(2, 4))
