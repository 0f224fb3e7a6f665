"""Command-line driver: ``python -m qfa_tpu.cli --cfg ... --type train|predict``.

Workflow mirrors the reference driver (``/root/reference/main.py``): config
from yaml + flags, config.yaml/log.txt dumped to the output dir, train and
predict modes — implemented on device-resident data with a jitted epoch
scan, data-parallel over a mesh when more than one device is visible.
"""

from __future__ import annotations

import argparse
import os
import time

import jax
import jax.numpy as jnp

from .config import ConfigNode, get_config

__all__ = ["build_parser", "main", "run_train", "run_predict"]


def _str2bool(value: str) -> bool:
    """argparse bool: ``--validation False`` must parse as False
    (``type=bool`` treats any non-empty string as True)."""
    if isinstance(value, bool):
        return value
    low = value.strip().lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {value!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Quasar Factor Analysis in JAX (train / predict)"
    )
    p.add_argument("--cfg", type=str, help="yaml configuration file")
    p.add_argument("--type", type=str, help="mode: train or predict")
    p.add_argument("--catalog", type=str, help="catalog csv (file,snr,z,num_mask)")
    p.add_argument("--data_dir", type=str, help="directory with spectra npz files")
    p.add_argument("--output_dir", type=str, help="run output directory")
    p.add_argument("--data_num", type=int, help="number of training spectra")
    p.add_argument("--validation_catalog", type=str)
    p.add_argument("--validation_num", type=int)
    p.add_argument("--validation_dir", type=str)
    p.add_argument("--validation", type=_str2bool)
    p.add_argument("--batch_size", type=int)
    p.add_argument("--n_epochs", type=int)
    p.add_argument("--nh", type=int, help="number of latent factors")
    p.add_argument("--tau", type=str, help="mean optical depth law")
    p.add_argument("--learning_rate", type=float)
    p.add_argument("--weight_decay", type=float)
    p.add_argument("--decay_alpha", type=float)
    p.add_argument("--decay_step", type=int)
    p.add_argument("--snr_min", type=float)
    p.add_argument("--snr_max", type=float)
    p.add_argument("--z_min", type=float)
    p.add_argument("--z_max", type=float)
    p.add_argument("--num_mask", type=int)
    p.add_argument("--nprocs", type=int)
    p.add_argument("--resume", type=str, help="checkpoint npz to resume from")
    p.add_argument("--seed", type=int)
    p.add_argument(
        "--opts", nargs="*", default=None, help="KEY.SUBKEY VALUE override pairs"
    )
    return p


def _load_training_data(cfg: ConfigNode, grid):
    from .data.loader import (
        SpectraDataset,
        estimate_mu,
        make_residuals,
        select_from_catalog,
        validation_concat_paths,
    )

    paths = select_from_catalog(
        cfg.DATA.CATALOG,
        cfg.DATA.DATA_DIR,
        cfg.DATA.DATA_NUM,
        snr_min=cfg.DATA.SNR_MIN,
        snr_max=cfg.DATA.SNR_MAX,
        z_min=cfg.DATA.Z_MIN,
        z_max=cfg.DATA.Z_MAX,
        num_mask=cfg.DATA.NUM_MASK,
        seed=cfg.SEED,
        output_dir=cfg.DATA.OUTPUT_DIR,
        prefix="train",
    )
    # Strict reference workflow parity (DATA.VALIDATION_CONCAT_COMPAT):
    # the reference loader CONCATENATES the validation spectra into the
    # training arrays before mu estimation — trained on, never evaluated
    # (/root/reference/QFA/dataloader.py:81-85). Default: held out below.
    # Missing validation files under the flag RAISE (parity, not fallback).
    extra = validation_concat_paths(
        cfg.DATA, cfg.SEED, output_dir=cfg.DATA.OUTPUT_DIR
    )
    concat_compat = extra is not None
    if concat_compat:
        paths = list(paths) + extra
    dataset = SpectraDataset.from_paths(paths, max_workers=cfg.DATA.NPROCS)
    from .data.loader import compute_taus

    taus = compute_taus(grid, dataset.zqso, tau_which=cfg.MODEL.TAU)
    mu = estimate_mu(
        dataset, grid, tau_which=cfg.MODEL.TAU,
        window=cfg.TRAIN.WINDOW_LENGTH_FOR_MU, taus=taus,
    )
    residuals = make_residuals(
        dataset, grid, mu, tau_which=cfg.MODEL.TAU, taus=taus
    )
    del taus

    # Held-out validation (the reference concatenates these spectra into the
    # training arrays, /root/reference/QFA/dataloader.py:81-85 — reproduced
    # above under DATA.VALIDATION_CONCAT_COMPAT; here they are evaluated,
    # never trained on).
    val_residuals = None
    if (not concat_compat and cfg.DATA.VALIDATION
            and os.path.exists(cfg.DATA.VALIDATION_CATALOG)):
        val_paths = select_from_catalog(
            cfg.DATA.VALIDATION_CATALOG,
            cfg.DATA.VALIDATION_DIR,
            cfg.DATA.VALIDATION_NUM,
            snr_min=cfg.DATA.SNR_MIN,
            snr_max=cfg.DATA.SNR_MAX,
            z_min=cfg.DATA.Z_MIN,
            z_max=cfg.DATA.Z_MAX,
            num_mask=cfg.DATA.NUM_MASK,
            seed=cfg.SEED + 1,
            output_dir=cfg.DATA.OUTPUT_DIR,
            prefix="validation",
        )
        val_dataset = SpectraDataset.from_paths(
            val_paths, max_workers=cfg.DATA.NPROCS
        )
        val_residuals = make_residuals(
            val_dataset, grid, mu, tau_which=cfg.MODEL.TAU
        )
    return dataset, mu, residuals, val_residuals


def _build_mesh(cfg: ConfigNode, batch_size: int | None, logger):
    """Data-parallel mesh from MESH.DATA_AXIS (-1 = all local devices).

    Returns None when a single device is selected or the batch size cannot
    be split across the mesh (logged). ``batch_size=None`` skips the
    divisibility check (prediction chunks pad themselves to the mesh)."""
    from .parallel import make_mesh

    want = cfg.MESH.DATA_AXIS
    ndev = jax.device_count() if want in (-1, 0) else min(want, jax.device_count())
    if ndev <= 1:
        return None
    if batch_size is not None and batch_size % ndev:
        logger.warning(
            "batch size %d not divisible by %d devices; training single-device",
            batch_size, ndev,
        )
        return None
    logger.info("data-parallel mesh over %d devices", ndev)
    return make_mesh(ndev)


def run_train(cfg: ConfigNode) -> None:
    from .data.grid import make_grid
    from .models import load_npz, random_init, save_npz
    from .models.qfa import ModelOptions
    from .train import TrainConfig, fit
    from .train.checkpoint import latest_checkpoint, load_state
    from .utils.logging import MetricsWriter, make_logger, setup_run_dir

    out = setup_run_dir(cfg.DATA.OUTPUT_DIR, cfg)
    logger = make_logger(out)
    grid = make_grid(cfg.DATA.LAMMIN, cfg.DATA.LAMMAX, cfg.DATA.LOGLAM_DELTA)

    if cfg.RUNTIME.DEBUG_NANS:
        from .utils.profiling import enable_nan_debugging

        enable_nan_debugging(True)
    if cfg.RUNTIME.PROFILE_DIR:
        jax.profiler.start_trace(cfg.RUNTIME.PROFILE_DIR)

    dataset, mu, residuals, val_residuals = _load_training_data(cfg, grid)
    logger.info(
        "loaded %d spectra (grid npix=%d nb=%d)", dataset.size, grid.npix, grid.nb
    )

    # Resume priority: (1) newest full-state checkpoint in the run dir
    # (exact trajectory continuation: params + Adam moments + epoch; fixes
    # reference bug 4, /root/reference/main.py:78-83), (2) explicit
    # MODEL.RESUME npz (params only), (3) fresh random init.
    params = None
    initial_state = None
    auto = latest_checkpoint(os.path.join(out, "checkpoints")) \
        if cfg.TRAIN.AUTO_RESUME else None
    if auto is not None:
        initial_state, _mu_saved = load_state(auto)
        params = initial_state.params
        # guard against silently restoring a stale/incompatible run from a
        # reused output dir: shape mismatches are an error, not a restore
        # (omega's length catches a changed blue/red split at equal npix)
        if (params.F.shape != (grid.npix, cfg.MODEL.NH)
                or params.omega.shape[0] != grid.nb):
            raise ValueError(
                f"auto-resume checkpoint {auto} has F shape "
                f"{params.F.shape} / omega length {params.omega.shape[0]} "
                f"but the current config wants ({grid.npix}, "
                f"{cfg.MODEL.NH}) / {grid.nb}; delete the stale "
                "checkpoints/ in the output dir, change DATA.OUTPUT_DIR, "
                "or set TRAIN.AUTO_RESUME False"
            )
        if cfg.MODEL.RESUME:
            logger.warning(
                "ignoring MODEL.RESUME=%s: auto-resuming the run already "
                "in %s instead (set TRAIN.AUTO_RESUME False to override)",
                cfg.MODEL.RESUME, out,
            )
        start = int(initial_state.opt_state.epoch)
        if start >= cfg.TRAIN.NEPOCHS:
            logger.warning(
                "auto-resumed state is already at epoch %d >= NEPOCHS=%d: "
                "no epochs will run and the saved model is the checkpoint "
                "as-is", start, cfg.TRAIN.NEPOCHS,
            )
        logger.info(
            "auto-resumed full training state from %s (epoch %d)",
            auto, start,
        )
    elif cfg.MODEL.RESUME and os.path.exists(cfg.MODEL.RESUME):
        params, _ = load_npz(cfg.MODEL.RESUME, compat_c0_bug=cfg.MODEL.COMPAT_C0_BUG)
        logger.info("resumed parameters from %s", cfg.MODEL.RESUME)
    else:
        params = random_init(
            jax.random.key(cfg.SEED), grid.npix, grid.nb, cfg.MODEL.NH
        )

    mesh = _build_mesh(cfg, cfg.DATA.BATCH_SIZE, logger)
    train_cfg = TrainConfig(
        n_epochs=cfg.TRAIN.NEPOCHS,
        batch_size=cfg.DATA.BATCH_SIZE,
        learning_rate=cfg.TRAIN.LEARNING_RATE,
        weight_decay=cfg.TRAIN.WEIGHT_DECAY,
        decay_alpha=cfg.TRAIN.DECAY_ALPHA,
        decay_step=cfg.TRAIN.DECAY_STEP,
        smooth_interval=cfg.TRAIN.SMOOTH_INTERVAL,
        save_interval=cfg.TRAIN.SAVE_INTERVAL,
        reference_norm=cfg.TRAIN.REFERENCE_NORM,
        options=ModelOptions(tau_which=cfg.MODEL.TAU),
    )
    if cfg.TRAIN.BF16_PLANES:
        # capacity mode: halve the resident delta/error bytes; every
        # trainer casts batches back to f32 before arithmetic
        from .data.loader import bf16_planes

        residuals = bf16_planes(residuals)
        logger.info(
            "capacity mode: bf16-stored delta/error planes "
            "(half the resident bytes; f32 arithmetic)"
        )
    with MetricsWriter(out) as metrics:
        params, history = fit(
            params, residuals, mu, train_cfg,
            key=jax.random.key(cfg.SEED),
            output_dir=out,
            logger=logger,
            metrics_cb=lambda e, loss, dt: metrics.write(
                epoch=e, loss=loss, seconds=dt,
                spectra_per_s=round(residuals.size / max(dt, 1e-9), 1),
            ),
            val_data=val_residuals,
            mesh=mesh,
            initial_state=initial_state,
        )
    save_npz(os.path.join(out, "model_parameters.npz"), params, mu)
    logger.info("training done: %d epochs, final loss %.3f", len(history),
                history[-1] if history else float("nan"))
    if cfg.RUNTIME.PROFILE_DIR:
        jax.profiler.stop_trace()
        logger.info("profiler trace written to %s", cfg.RUNTIME.PROFILE_DIR)


def run_predict(cfg: ConfigNode) -> None:
    from .data.grid import make_grid
    from .data.loader import SpectraDataset, read_predict_catalog
    from .infer.predict import (
        predict_dataset,
        write_consolidated_npz,
        write_npz_outputs,
    )
    from .models import load_npz
    from .models.qfa import ModelOptions
    from .utils.logging import make_logger, setup_run_dir

    out = setup_run_dir(cfg.DATA.OUTPUT_DIR, cfg)
    logger = make_logger(out)
    grid = make_grid(cfg.DATA.LAMMIN, cfg.DATA.LAMMAX, cfg.DATA.LOGLAM_DELTA)

    paths = read_predict_catalog(cfg.DATA.CATALOG, cfg.DATA.DATA_DIR)
    dataset = SpectraDataset.from_paths(paths, max_workers=cfg.DATA.NPROCS)
    params, mu = load_npz(cfg.MODEL.RESUME, compat_c0_bug=cfg.MODEL.COMPAT_C0_BUG)

    # shard each batch over the data mesh when >1 device is visible (no
    # collective: prediction has no cross-spectrum coupling)
    mesh = _build_mesh(cfg, None, logger)
    t0 = time.time()
    result = predict_dataset(
        params,
        jnp.asarray(mu),
        dataset,
        grid,
        batch_size=min(cfg.DATA.BATCH_SIZE, 4096),
        options=ModelOptions(tau_which=cfg.MODEL.TAU),
        mesh=mesh,
    )
    if cfg.RUNTIME.CONSOLIDATED_PREDICT:
        write_consolidated_npz(
            result, dataset.paths, os.path.join(out, "predictions.npz")
        )
    else:
        write_npz_outputs(result, dataset.paths, os.path.join(out, "predict"))
    dt = time.time() - t0
    logger.info(
        "predicted %d spectra in %.2f s (%.1f spectra/s)",
        dataset.size, dt, dataset.size / max(dt, 1e-9),
    )
    print(f"Finish predicting {dataset.size} spectra in {dt:.2f} seconds...")


def main(argv=None) -> None:
    from .utils.runtime import setup_compile_cache

    args = build_parser().parse_args(argv)
    cfg = get_config(args)
    setup_compile_cache()
    if cfg.TYPE == "train":
        run_train(cfg)
    elif cfg.TYPE == "predict":
        run_predict(cfg)
    else:
        raise SystemExit(f"TYPE must be 'train' or 'predict', got {cfg.TYPE!r}")


if __name__ == "__main__":
    main()
