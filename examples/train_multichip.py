"""Data-parallel training across all available devices.

Demonstrates the SPMD training path: residual dataset sharded over a device
mesh, replicated parameters, one gradient/count psum per step. Runs on real
multi-chip hardware or on virtual CPU devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/train_multichip.py

For several hosts call ``qfa_tpu.parallel.initialize_distributed()``
first with the coordinator address, process count and process id.
"""

from __future__ import annotations

# allow running from a source checkout without installation
try:  # noqa: SIM105
    import qfa_tpu  # noqa: F401
except ModuleNotFoundError:
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import time

import jax

import jax.numpy as jnp
import numpy as np

import qfa_tpu
from qfa_tpu.data.loader import ResidualDataset
from qfa_tpu.data.synthetic import generate
from qfa_tpu.models import random_init
from qfa_tpu.parallel import (
    make_dp_epoch_fn,
    make_mesh,
    shard_dataset,
    shard_epoch_indices,
)
from qfa_tpu.train import TrainConfig, TrainState, adam


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="exact data-parallel training (one gradient psum per "
        "batch) over every visible device, then a sharded OOD sweep"
    )
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args()

    n_dev = jax.device_count()
    print(f"devices: {n_dev} x {jax.devices()[0].device_kind}")

    grid = qfa_tpu.make_grid()
    nh = 8
    n = 1024 * n_dev
    batch_size = 128 * n_dev

    true = random_init(jax.random.key(0), grid.npix, grid.nb, nh)
    mu = jnp.ones((grid.npix,), jnp.float32)
    syn = jax.jit(
        lambda k: generate(k, true, mu, grid, n, mask_frac=0.1)
    )(jax.random.key(1))
    b = syn.to_batch(mu)
    data = ResidualDataset(
        delta=b.delta, error=b.error, zabs=b.zabs, mask=b.mask
    )

    mesh = make_mesh()
    print(f"mesh: {dict(mesh.shape)}")
    sharded = shard_dataset(data, mesh)

    config = TrainConfig(
        n_epochs=args.epochs, batch_size=batch_size, learning_rate=5e-3,
        weight_decay=0.0, smooth_interval=1000, save_interval=1000,
        stop_on_negative_loss=False,
    )
    epoch_fn = make_dp_epoch_fn(config, mesh)
    params = random_init(jax.random.key(2), grid.npix, grid.nb, nh)
    state = TrainState(params, adam.init(params))

    key = jax.random.key(3)
    for epoch in range(config.n_epochs):
        key, sub = jax.random.split(key)
        t0 = time.perf_counter()
        idx = shard_epoch_indices(sub, n, config.batch_size, mesh)
        state, loss = epoch_fn(state, sharded, idx)
        jax.block_until_ready(state.params.F)
        dt = time.perf_counter() - t0
        print(
            f"epoch {epoch:02d}  loss {float(loss):9.2f}  "
            f"{n / dt:12,.0f} spectra/s ({n_dev} devices)"
        )

    # score the training corpus with the mesh-sharded stats-only sweep
    # (zero collectives: outputs stay sharded along the batch axis)
    from qfa_tpu.data.grid import loglam_row, zq_column
    from qfa_tpu.parallel import make_dp_predict_fn

    sweep = make_dp_predict_fn(mesh, has_mask=False, compact=True,
                               stats_only=True)
    t0 = time.perf_counter()
    res = sweep(
        state.params, mu, syn.flux * syn.mask, syn.error * syn.mask,
        zq_column(syn.zqso), loglam_row(grid.wav),
    )
    ll = np.asarray(res.ll)
    dt = time.perf_counter() - t0
    print(
        f"OOD sweep: {n} spectra in {dt:.3f} s "
        f"({n / dt:,.0f} spectra/s), median NLL {np.median(ll):.1f}"
    )


if __name__ == "__main__":
    main()
