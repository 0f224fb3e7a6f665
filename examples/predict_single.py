"""Single-spectrum continuum prediction walkthrough.

Script equivalent of the reference's ``nb/predict.ipynb``: load a pretrained
model, predict the continuum of one spectrum with uncertainty, score it for
OOD, and draw posterior samples of the latent embedding.

Usage:
    python examples/predict_single.py \
        --model /root/reference/data/model_parameters.npz \
        --spectrum /root/reference/data/spec-4321-55504-0114.npz \
        [--compat-c0-bug]     # reproduce the reference's golden outputs
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
from qfa_tpu.models import load_npz, predict


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True, help="pretrained npz checkpoint")
    p.add_argument("--spectrum", required=True, help="spectrum npz (flux/error/z)")
    p.add_argument("--compat-c0-bug", action="store_true",
                   help="load beta into c0 like the reference loader")
    p.add_argument("--n-posterior-samples", type=int, default=5)
    p.add_argument("--out", default="", help="optional output npz path")
    args = p.parse_args()

    grid = qfa_tpu.make_grid()
    params, mu = load_npz(args.model, compat_c0_bug=args.compat_c0_bug)
    assert params.npix == grid.npix, "model grid mismatch"

    with np.load(args.spectrum) as f:
        flux = np.asarray(f["flux"], np.float32)
        error = np.asarray(f["error"], np.float32)
        z = float(f["z"])
    mask = (flux != -999.0) & (error != -999.0)
    flux = np.where(mask, flux, 0.0)
    error = np.where(mask, error, 0.0)
    zabs = jnp.asarray(grid.zabs(np.array([z])), jnp.float32)

    res = predict(
        params, mu,
        jnp.asarray(flux)[None], jnp.asarray(error)[None],
        zabs, jnp.asarray(mask)[None],
    )
    ll = float(res.ll[0])
    print(f"z = {z:.3f}, observed pixels = {int(mask.sum())}/{grid.npix}")
    print(f"negative log-likelihood (OOD score): {ll:.4f}")
    print(f"latent embedding h: {np.asarray(res.hmean[0]).round(4)}")
    cont = np.asarray(res.continuum[0])
    std = np.asarray(res.continuum_std[0])
    print(f"continuum: mean {cont.mean():.4f}, predictive std mean {std.mean():.4f}")

    # posterior sampling of h (notebook cell 11)
    hmean = np.asarray(res.hmean[0], np.float64)
    hcov = np.asarray(res.hcov[0], np.float64)
    samples = np.random.default_rng(0).multivariate_normal(
        hmean, hcov, size=args.n_posterior_samples
    )
    sampled_continua = samples @ np.asarray(params.F).T + np.asarray(mu)
    print(f"{args.n_posterior_samples} posterior continua drawn, "
          f"spread at center pixel: {sampled_continua[:, grid.npix // 2].std():.4f}")

    if args.out:
        np.savez(
            args.out,
            ll=np.float32(ll),
            hmean=hmean.astype(np.float32),
            hcov=hcov.astype(np.float32),
            cont=cont,
            uncertainty=std,
            posterior_continua=sampled_continua.astype(np.float32),
            wav=grid.wav,
        )
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
