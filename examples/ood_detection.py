"""Out-of-distribution detection demo — the reference's third headline
capability (``/root/reference/README.md:18-19``): the per-spectrum
marginal NLL under the trained factor model flags anomalous spectra.

This script trains a QFA model on synthetic in-distribution spectra,
injects three kinds of anomalies, scores EVERY spectrum with the
stats-only predictor (ll and posterior only, ~300 B/spectrum output; the
mask comes from ``error > 0`` and the absorber redshifts from a
``log1p(zqso)`` column), and reports how cleanly the NLL separates the
populations:

* ``broken``  — continuum replaced by an unrelated smooth shape
* ``dla``     — a deep, wide absorption trough (damped-Lya-like)
* ``noisy``   — reported errors 5x smaller than the true noise

Run: ``python examples/ood_detection.py`` (add ``--n 2048 --epochs 5``
for a quick run on a CPU).
"""

from __future__ import annotations

# allow running from a source checkout without installation
try:  # noqa: SIM105
    import qfa_tpu  # noqa: F401
except ModuleNotFoundError:
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse

import jax
import jax.numpy as jnp
import numpy as np

import qfa_tpu
from qfa_tpu.data.grid import loglam_row, zq_column
from qfa_tpu.data.loader import ResidualDataset
from qfa_tpu.data.synthetic import generate
from qfa_tpu.infer import predict_resident
from qfa_tpu.models import random_init
from qfa_tpu.train import TrainConfig, fit


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--n-anomalous", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=80)
    ap.add_argument("--learning-rate", type=float, default=1e-2)
    args = ap.parse_args()

    grid = qfa_tpu.make_grid()
    nh = 8
    # realistic generative scales (random_init's Psi=omega=1 would put ~1
    # sigma of model noise on every pixel and swallow any anomaly): a few
    # percent diagonal scatter + a low-rank continuum subspace of ~0.2 rms
    true = random_init(jax.random.key(0), grid.npix, grid.nb, nh)
    true = true._replace(
        F=0.3 * true.F,
        Psi=jnp.full((grid.npix,), 0.02, jnp.float32),
        omega=jnp.full((grid.nb,), 0.2, jnp.float32),
    )
    mu = jnp.ones((grid.npix,), jnp.float32) * 1.1

    # ---- in-distribution corpus + training --------------------------------
    syn = jax.jit(
        lambda k: generate(k, true, mu, grid, args.n, mask_frac=0.1)
    )(jax.random.key(1))
    full = jax.jit(lambda s: s.to_batch(mu))(syn)
    data = ResidualDataset(delta=full.delta, error=full.error,
                           zabs=full.zabs, mask=full.mask)
    cfg = TrainConfig(n_epochs=args.epochs, batch_size=2048,
                      weight_decay=0.0, learning_rate=args.learning_rate,
                      smooth_interval=10**9, save_interval=10**9,
                      stop_on_negative_loss=False)
    params, history = fit(
        random_init(jax.random.key(2), grid.npix, grid.nb, nh), data, mu,
        cfg, key=jax.random.key(3),
    )
    print(f"trained {args.epochs} epochs, final loss {history[-1]:.2f}")

    # ---- inject anomalies -------------------------------------------------
    k = args.n_anomalous
    flux = np.array(syn.flux * syn.mask)  # np.array: writable host copies
    error = np.array(syn.error * syn.mask)
    mask = np.asarray(syn.mask)
    rng = np.random.default_rng(7)
    idx = rng.choice(args.n, size=3 * k, replace=False)
    broken, dla, noisy = idx[:k], idx[k : 2 * k], idx[2 * k :]
    wav = np.asarray(grid.wav, np.float32)

    # unrelated smooth continuum (sinusoid over the grid)
    shape = 1.1 + 0.5 * np.sin(np.linspace(0, 6 * np.pi, grid.npix))
    flux[broken] = (shape[None, :]
                    + error[broken] * rng.standard_normal((k, grid.npix))
                    ) * mask[broken]
    # deep wide trough at a random center
    centers = rng.uniform(wav[200], wav[-200], size=k)
    widths = rng.uniform(15.0, 40.0, size=k)
    trough = 1.0 - 0.95 * np.exp(
        -((wav[None, :] - centers[:, None]) / widths[:, None]) ** 2
    )
    flux[dla] = flux[dla] * trough
    # over-confident errors
    error[noisy] = error[noisy] / 5.0

    labels = np.zeros(args.n, np.int32)
    labels[broken], labels[dla], labels[noisy] = 1, 2, 3

    # ---- score: stats-only sweep over the resident set ---------------------
    # compact input: mask derived from error > 0, log1p(zqso) column in
    # place of the zabs plane; on several devices the same sweep shards the
    # spectrum axis with zero collectives (qfa_tpu.parallel.make_dp_predict_fn)
    tb = 1024 if args.n % 1024 == 0 else args.n
    res = predict_resident(
        params, mu, jnp.asarray(flux), jnp.asarray(error),
        zq_column(syn.zqso), None, batch_size=tb, stats_only=True,
        loglam=loglam_row(grid.wav),
    )
    n_obs = (error > 0).sum(axis=1)
    scores = np.asarray(res.ll) / np.maximum(n_obs, 1.0)

    # ---- report separation ------------------------------------------------
    def auc(pos, neg):
        """P(score_pos > score_neg) by rank statistic."""
        allv = np.concatenate([pos, neg])
        ranks = allv.argsort().argsort().astype(np.float64) + 1
        r_pos = ranks[: len(pos)].sum()
        return (r_pos - len(pos) * (len(pos) + 1) / 2) / (
            len(pos) * len(neg)
        )

    clean = scores[labels == 0]
    print(f"clean    : median per-pixel NLL {np.median(clean):+.3f}")
    for name, lab in (("broken", 1), ("dla", 2), ("noisy", 3)):
        pop = scores[labels == lab]
        print(f"{name:<9}: median {np.median(pop):+.3f}   "
              f"AUC vs clean {auc(pop, clean):.3f}")
    top = np.argsort(-scores)[: 3 * k]
    hit = np.isin(top, idx).mean()
    print(f"precision@{3 * k} (top-scored vs injected): {hit:.3f}")


if __name__ == "__main__":
    main()
