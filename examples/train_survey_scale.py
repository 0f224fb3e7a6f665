"""Survey-scale training demo: hundreds of thousands of spectra resident on
one device.

The BASELINE.md north star asks for a 500k-spectrum factor-model training
run in under 10 minutes. This script builds a synthetic resident residual
set of ``--n`` SDSS-width spectra on the device (about 26 KB per spectrum
in the four-plane layout: delta, error, mask and the absorber-redshift
plane) and times the XLA scan-epoch trainer over it.

Usage (synthetic data by default):

    python examples/train_survey_scale.py --n 262144 --epochs 5

With a real survey, build the residual buffers through the data layer
instead (``SpectraDataset.from_paths`` -> ``estimate_mu`` ->
``make_residuals``) — everything downstream is identical.
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
import time

import jax
import jax.numpy as jnp

import qfa_tpu
from qfa_tpu.data.loader import ResidualDataset
from qfa_tpu.models import random_init
from qfa_tpu.train import TrainConfig, TrainState, adam, make_epoch_fn, train_epoch


def build_synthetic_resident(grid, n: int, seed: int = 0) -> ResidualDataset:
    """Resident residual buffers, generated chunk by chunk on the device
    with donation, so peak memory is the final footprint plus one chunk."""
    chunk = 32768
    if n % chunk:
        raise SystemExit(f"--n must be a multiple of {chunk}")

    @jax.jit
    def make_chunk(key):
        kz, kd, ke = jax.random.split(key, 3)
        z = jax.random.uniform(kz, (chunk,), jnp.float32, 2.0, 3.5)
        zabs = (1.0 + z)[:, None] * jnp.asarray(grid.blue, jnp.float32) / (
            qfa_tpu.data.LYA_WAVELENGTH
        ) - 1.0
        delta = 0.4 * jax.random.normal(kd, (chunk, grid.npix), jnp.float32)
        error = jax.random.uniform(
            ke, (chunk, grid.npix), jnp.float32, 0.05, 0.3
        )
        return delta, error, zabs, jnp.ones_like(error)

    @jax.jit
    def alloc():
        return (jnp.zeros((n, grid.npix), jnp.float32),
                jnp.zeros((n, grid.npix), jnp.float32),
                jnp.zeros((n, grid.nb), jnp.float32),
                jnp.zeros((n, grid.npix), jnp.float32))

    write = jax.jit(
        lambda buf, c, i: jax.lax.dynamic_update_slice(buf, c, (i, 0)),
        donate_argnums=(0,),
    )
    bufs = alloc()
    for i in range(n // chunk):
        parts = make_chunk(jax.random.fold_in(jax.random.key(seed), i))
        bufs = tuple(write(b, c, i * chunk) for b, c in zip(bufs, parts))
    jax.block_until_ready(bufs)
    return ResidualDataset(*bufs)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=262144)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch_size", type=int, default=4096)
    ap.add_argument("--nh", type=int, default=8)
    args = ap.parse_args()

    grid = qfa_tpu.make_grid()
    gb = args.n * (3 * grid.npix + grid.nb) * 4 / 2**30
    print(f"building {args.n:,} resident spectra ({gb:.1f} GiB on device)...")
    data = build_synthetic_resident(grid, args.n)

    params = random_init(jax.random.key(1), grid.npix, grid.nb, args.nh)
    cfg = TrainConfig(batch_size=args.batch_size)
    epoch_fn = make_epoch_fn(cfg)
    state = TrainState(params, adam.init(params))

    state, loss = train_epoch(state, data, jax.random.key(2), cfg, epoch_fn)
    print(f"epoch 0 loss {loss:.2f} (includes compilation)")
    t0 = time.perf_counter()
    for epoch in range(1, args.epochs):
        state, loss = train_epoch(
            state, data, jax.random.fold_in(jax.random.key(2), epoch), cfg,
            epoch_fn,
        )
    dt = (time.perf_counter() - t0) / max(args.epochs - 1, 1)
    print(f"{dt*1e3:.1f} ms/epoch -> {args.n/dt:,.0f} spectra/s; "
          f"500 epochs of {args.n:,} spectra project to "
          f"{500*dt/60:.2f} minutes (north star: <10)")
    print(f"final epoch loss {loss:.2f}")


if __name__ == "__main__":
    main()
