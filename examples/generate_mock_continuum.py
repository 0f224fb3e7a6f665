"""Mock continuum generation via conditional density estimation.

Script equivalent of the reference's ``nb/generate_mock_continuum.ipynb``:
fit P(h | z, lum) on a catalog of latent embeddings, sample it, and
synthesize mock continua ``F h + mu``. The reference uses the external
``sbi`` package (SNPE); here the estimator is the built-in JAX mixture
density network (``qfa_tpu.models.mdn``).

Usage:
    python examples/generate_mock_continuum.py \
        --model model_parameters.npz --catalog sdss_catalog.csv \
        --n-mocks 100 --out mocks.npz

The catalog must provide columns ``h1..hNh, z, lum`` (the reference's
``sdss_catalog.csv`` schema). Without a catalog the script demonstrates the
pipeline on synthetic embeddings.
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

from qfa_tpu.models import load_npz
from qfa_tpu.models.mdn import MDNConfig, fit_mdn, sample_mock_continua


def load_catalog(path: str, nh: int):
    import pandas as pd

    cat = pd.read_csv(path)
    h = cat[[f"h{i + 1}" for i in range(nh)]].to_numpy(np.float32)
    cond = cat[["z", "lum"]].to_numpy(np.float32)
    return cond, h


def synthetic_catalog(key, nh: int, n: int = 5000):
    """Fallback demo data: embeddings correlated with (z, lum)."""
    kz, kl, kh = jax.random.split(key, 3)
    z = jax.random.uniform(kz, (n,), minval=2.0, maxval=3.5)
    lum = jax.random.uniform(kl, (n,), minval=-1.0, maxval=1.0)
    cond = jnp.stack([z, lum], 1)
    w = jax.random.normal(jax.random.key(7), (2, nh)) * 0.5
    h = cond @ w + 0.3 * jax.random.normal(kh, (n, nh))
    return np.asarray(cond), np.asarray(h)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True)
    p.add_argument("--catalog", default="", help="csv with h1..hNh, z, lum")
    p.add_argument("--n-mocks", type=int, default=100)
    p.add_argument("--n-steps", type=int, default=2000)
    p.add_argument("--out", default="mock_continua.npz")
    args = p.parse_args()

    params, mu = load_npz(args.model)
    nh = params.nh
    if args.catalog:
        cond, h = load_catalog(args.catalog, nh)
    else:
        print("no catalog given - demonstrating on synthetic embeddings")
        cond, h = synthetic_catalog(jax.random.key(0), nh)

    cfg = MDNConfig(cond_dim=2, out_dim=nh, n_components=8, hidden=(64, 64))
    mdn_params, info = fit_mdn(
        jax.random.key(1), cond, h, cfg, n_steps=args.n_steps
    )
    print(f"MDN fit: nll {info['losses'][0]:.3f} -> {info['losses'][-1]:.3f}")

    # one mock continuum per catalog row, for the first n_mocks rows
    probe = jnp.asarray(cond[: args.n_mocks])
    mocks = sample_mock_continua(
        mdn_params, jax.random.key(2), probe, params.F, mu, 1, cfg, info
    )[0]
    np.savez(args.out, continua=np.asarray(mocks), cond=np.asarray(probe))
    print(f"wrote {args.n_mocks} mock continua to {args.out} "
          f"(shape {tuple(mocks.shape)})")


if __name__ == "__main__":
    main()
