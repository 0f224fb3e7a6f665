"""Behaviours of the ``fit`` driver: schedule and epoch counter, smoothing,
checkpoints and resume, held-out validation, the non-finite guard, the
caller's buffers, the production latent width and bf16-stored planes."""

import logging
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import qfa_tpu
from qfa_tpu.data.loader import ResidualDataset, bf16_planes, epoch_indices
from qfa_tpu.data.synthetic import generate
from qfa_tpu.models import random_init
from qfa_tpu.train import TrainConfig, TrainState, adam, fit, make_epoch_fn
from qfa_tpu.train.checkpoint import latest_checkpoint, load_state
from qfa_tpu.train.loop import make_step_fn

NH = 4


@pytest.fixture(scope="module")
def problem():
    grid = qfa_tpu.make_grid(1030.0, 1090.0, 1e-3)
    true = random_init(jax.random.key(0), grid.npix, grid.nb, NH)
    mu = jnp.full((grid.npix,), 1.1, jnp.float32)
    syn = generate(jax.random.key(1), true, mu, grid, 64, mask_frac=0.15)
    b = syn.to_batch(mu)
    data = ResidualDataset(delta=b.delta, error=b.error, zabs=b.zabs,
                           mask=b.mask)
    return grid, mu, data


def init(grid, nh=NH, seed=5):
    return random_init(jax.random.key(seed), grid.npix, grid.nb, nh)


def test_fit_epoch_counter_drives_schedule(problem):
    """The learning-rate decay and Adam's bias correction follow the
    per-epoch counter: the same batches at epoch 0 and at epoch 25 give
    different updates, each equal to the plain Adam rule at its epoch."""
    grid, _, data = problem
    cfg = TrainConfig(batch_size=32, learning_rate=1e-2, weight_decay=0.01,
                      decay_alpha=0.5, decay_step=10)
    ei = epoch_indices(jax.random.key(3), data.size, cfg.batch_size)
    epoch_fn = make_epoch_fn(cfg)
    out = {}
    for epoch in (0, 25):
        p = init(grid)
        opt = adam.init(p)._replace(epoch=jnp.asarray(epoch, jnp.int32))
        st, _ = epoch_fn(TrainState(p, opt), data, ei.idx, ei.weight)
        assert int(st.opt_state.epoch) == epoch + 1
        out[epoch] = np.asarray(st.params.F)
    assert not np.allclose(out[0], out[25])
    # at epoch 25 the rate is lr * 0.5 ** 2: the first step moves F by at
    # most that much per entry (Adam's normalized step)
    step = np.abs(out[25] - np.asarray(init(grid).F))
    assert step.max() <= 2 * 1e-2 * 0.25 * 1.01


def test_fit_full_run_smooth_save_resume(problem, tmp_path):
    """Smoothing and saving on the epoch boundaries, and a resume from the
    full-state snapshot continues the uninterrupted trajectory."""
    grid, mu, data = problem
    cfg = TrainConfig(n_epochs=3, batch_size=24, learning_rate=1e-2,
                      weight_decay=0.0, smooth_interval=2, save_interval=2)
    out = str(tmp_path / "fit")
    # 64 rows, batch 24 -> a tail batch of 16 trains too
    params, history = fit(init(grid), data, mu, cfg, key=jax.random.key(6),
                          output_dir=out)
    assert len(history) == 3 and np.isfinite(history).all()
    assert os.path.exists(f"{out}/checkpoints/state_epoch_02.npz")
    st, _ = load_state(latest_checkpoint(f"{out}/checkpoints"))
    assert int(st.opt_state.epoch) == 2
    params_b, hist_b = fit(None, data, mu, cfg, key=jax.random.key(6),
                           initial_state=st)
    assert len(hist_b) == 1
    assert hist_b[0] == pytest.approx(history[2], rel=1e-5)
    np.testing.assert_allclose(np.asarray(params_b.F), np.asarray(params.F),
                               rtol=1e-5, atol=1e-7)


def test_fit_validation_logged_each_epoch(problem, caplog):
    """Held-out validation NLL is evaluated and logged every epoch."""
    grid, mu, data = problem
    cfg = TrainConfig(n_epochs=2, batch_size=32, learning_rate=1e-2,
                      weight_decay=0.0, smooth_interval=100,
                      save_interval=100)
    val = ResidualDataset(*(leaf[:16] for leaf in data))
    logger = logging.getLogger("test_fit_validation_logged_each_epoch")
    with caplog.at_level(logging.INFO, logger=logger.name):
        fit(init(grid), data, mu, cfg, key=jax.random.key(6), val_data=val,
            logger=logger)
    lines = [r.message for r in caplog.records if "val_loss" in r.message]
    assert len(lines) == 2
    vals = [float(re.search(r"val_loss:\s+(-?[\d.]+)", m).group(1))
            for m in lines]
    assert all(np.isfinite(v) for v in vals)


def test_fit_nh8_epoch_equals_step_chain():
    """At the production latent width (Nh 8, the unrolled factorization's
    common case) the scanned epoch equals the same steps run one by one."""
    grid = qfa_tpu.make_grid(1030.0, 1090.0, 1e-3)
    true = random_init(jax.random.key(0), grid.npix, grid.nb, 8)
    mu = jnp.full((grid.npix,), 1.1, jnp.float32)
    syn = generate(jax.random.key(1), true, mu, grid, 32, mask_frac=0.15)
    b = syn.to_batch(mu)
    data = ResidualDataset(delta=b.delta, error=b.error, zabs=b.zabs,
                           mask=b.mask)
    cfg = TrainConfig(batch_size=16, learning_rate=1e-2, weight_decay=0.01)
    rows = jax.random.permutation(jax.random.key(3), 32).reshape(2, 16)
    p = init(grid, 8)
    st_e, _ = make_epoch_fn(cfg)(TrainState(p, adam.init(p)), data, rows)
    p = init(grid, 8)
    st = TrainState(p, adam.init(p))
    step = make_step_fn(cfg)
    for r in rows:
        st, _ = step(st, data.gather(r))
    for name in ("F", "Psi", "omega", "tau0", "c0", "beta"):
        np.testing.assert_allclose(
            np.asarray(getattr(st_e.params, name)),
            np.asarray(getattr(st.params, name)), rtol=1e-5, atol=1e-7,
            err_msg=name,
        )


def test_fit_resume_reproduces_uninterrupted(problem, tmp_path):
    """Resuming mid-run from a checkpoint reproduces the remaining epochs
    of the uninterrupted run (per-epoch shuffle keys fold in the epoch)."""
    grid, mu, data = problem
    cfg = TrainConfig(n_epochs=5, batch_size=32, learning_rate=1e-2,
                      weight_decay=0.0, smooth_interval=100, save_interval=3)
    out = str(tmp_path / "rs")
    params_a, hist_a = fit(init(grid), data, mu, cfg, key=jax.random.key(6),
                           output_dir=out)
    st, _ = load_state(f"{out}/checkpoints/state_epoch_03.npz")
    assert int(st.opt_state.epoch) == 3
    params_b, hist_b = fit(None, data, mu, cfg, key=jax.random.key(6),
                           initial_state=st)
    np.testing.assert_allclose(hist_b, hist_a[3:], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(params_b.F),
                               np.asarray(params_a.F), rtol=1e-6, atol=1e-8)


def test_fit_keeps_caller_buffers(problem):
    """``fit`` must not donate the caller's dataset buffers."""
    grid, mu, data = problem
    cfg = TrainConfig(n_epochs=3, batch_size=32, learning_rate=1e-2,
                      weight_decay=0.0, smooth_interval=100,
                      save_interval=100)
    _, history = fit(init(grid), data, mu, cfg, key=jax.random.key(6))
    assert np.isfinite(np.asarray(data.delta)).all()
    assert np.isfinite(np.asarray(data.zabs)).all()
    assert np.isfinite(history).all()


def test_fit_rejects_nonfinite_steps(problem, tmp_path):
    """A poisoned spectrum (inf in the data) makes every step that draws
    it non-finite; those updates are rejected, so the run ends with finite
    parameters, and the interval checkpoint holds them. Without the guard
    the parameters go non-finite."""
    grid, mu, data = problem
    poisoned = data._replace(delta=data.delta.at[3, 10].set(jnp.inf))
    cfg = TrainConfig(n_epochs=2, batch_size=64, learning_rate=1e-2,
                      weight_decay=0.0, smooth_interval=100,
                      save_interval=2)
    out = str(tmp_path / "nan_guard")
    params, history = fit(init(grid), poisoned, mu, cfg,
                          key=jax.random.key(6), output_dir=out)
    # one batch per epoch holds the poisoned row: every update rejected
    assert len(history) == 2 and not np.isfinite(history).any()
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(init(grid))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    saved = np.load(f"{out}/checkpoints/model_parameters_epoch_02.npz")
    np.testing.assert_array_equal(saved["F"], np.asarray(init(grid).F))

    loose = TrainConfig(n_epochs=1, batch_size=64, learning_rate=1e-2,
                        weight_decay=0.0, reject_nonfinite=False,
                        stop_on_negative_loss=False)
    params_l, _ = fit(init(grid), poisoned, mu, loose, key=jax.random.key(6))
    assert not np.isfinite(np.asarray(params_l.F)).all()


def test_fit_bf16_planes_close_to_f32(problem):
    """bfloat16-stored delta/error planes: arithmetic stays f32, so the
    epoch tracks the f32 run within the data-quantization level."""
    grid, mu, data = problem
    cfg = TrainConfig(n_epochs=1, batch_size=32, learning_rate=1e-2,
                      weight_decay=0.01)
    lo = bf16_planes(data)
    assert lo.delta.dtype == jnp.bfloat16 and lo.zabs.dtype == jnp.float32
    p32, h32 = fit(init(grid), data, mu, cfg, key=jax.random.key(6))
    pbf, hbf = fit(init(grid), lo, mu, cfg, key=jax.random.key(6))
    assert pbf.F.dtype == jnp.float32  # the state stays f32
    np.testing.assert_allclose(hbf, h32, rtol=2e-2)
    np.testing.assert_allclose(np.asarray(pbf.F), np.asarray(p32.F),
                               rtol=0.1, atol=5e-3)
