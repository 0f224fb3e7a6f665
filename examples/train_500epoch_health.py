"""Long-horizon health check: 500 epochs of ``fit`` on the accelerator.

Trains the XLA scan-epoch trainer for the reference's full default
epoch budget (``/root/reference/QFA/config.py:30-62``: 500 epochs) on 65k
synthetic SDSS-scale spectra, asserting every epoch loss and every final
parameter stays finite, then measures how much of the init->true NLL gap
the fit closes. Run from the repo root: ``python examples/train_500epoch_health.py``.
"""

# allow running from a source checkout without installation
try:  # noqa: SIM105
    import qfa_tpu  # noqa: F401
except ModuleNotFoundError:
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse
import time
import jax, jax.numpy as jnp
import numpy as np
import qfa_tpu
from qfa_tpu.data.loader import ResidualDataset
from qfa_tpu.data.synthetic import generate
from qfa_tpu.models import random_init
from qfa_tpu.models.qfa import mean_nll
from qfa_tpu.train import TrainConfig, fit


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65536, help="synthetic spectra")
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--batch-size", type=int, default=4096)
    args = ap.parse_args(argv)

    grid = qfa_tpu.make_grid()
    nh = 8
    true = random_init(jax.random.key(0), grid.npix, grid.nb, nh)
    true = true._replace(Psi=jnp.full((grid.npix,), 0.3),
                         omega=jnp.full((grid.nb,), 0.5))
    mu = jnp.full((grid.npix,), 1.1, jnp.float32)
    syn = jax.jit(lambda k: generate(k, true, mu, grid, args.n, mask_frac=0.1))(jax.random.key(1))
    full = jax.jit(lambda s: s.to_batch(mu))(syn)
    data = ResidualDataset(delta=full.delta, error=full.error,
                           zabs=full.zabs, mask=full.mask)

    # Convergence-friendly hyper-parameters: the reference defaults
    # (weight_decay=0.1 on every parameter + lr decay 0.9^(epoch/10) +
    # smoothing every 5 epochs) regularize so hard that training parks ~1%
    # into the init->truth NLL gap; with wd=0 and a flat lr the fit closes
    # the gap within the first ~120 epochs (asserted below).
    # smooth_interval must NOT divide n_epochs: the periodic avg-pool smoothing
    # (reference semantics) otherwise lands on the FINAL epoch and the returned
    # params are freshly pooled with no recovery epochs (~10 epochs re-converge
    # after each smooth). --epochs is user-settable, so derive an interval
    # that never divides it (33 unless args.epochs is a 33-multiple).
    smooth_interval = 33
    while args.epochs and args.epochs % smooth_interval == 0:
        smooth_interval += 1
    cfg = TrainConfig(n_epochs=args.epochs, batch_size=args.batch_size,
                      learning_rate=1e-2, weight_decay=0.0, decay_alpha=1.0,
                      smooth_interval=smooth_interval, save_interval=10**9,
                      stop_on_negative_loss=True)
    p0 = random_init(jax.random.key(2), grid.npix, grid.nb, nh)
    batch = jax.jit(lambda s: s.to_batch(mu))(syn)
    # before training: the epoch donates the initial parameters
    loss_init = float(mean_nll(p0, batch))
    t0 = time.perf_counter()
    params, history = fit(p0, data, mu, cfg, key=jax.random.key(3))
    dt = time.perf_counter() - t0
    h = np.asarray(history)
    print(f"{args.epochs} epochs wall: {dt:.1f} s ({dt/len(h)*1e3:.1f} ms/epoch incl sync+smooth)")
    print(f"loss: {h[0]:.2f} -> min {h.min():.2f} (epoch {h.argmin()}) -> final {h[-1]:.2f}")
    assert np.isfinite(h).all(), "non-finite epoch loss!"
    for name in ("F", "Psi", "omega", "tau0", "c0", "beta"):
        leaf = np.asarray(getattr(params, name))
        assert np.isfinite(leaf).all(), f"non-finite {name}"
    loss_true = float(mean_nll(true, batch))
    loss_fit = float(mean_nll(params, batch))
    gap = (loss_init - loss_fit) / (loss_init - loss_true) * 100
    print(f"mean NLL: init {loss_init:.2f}  fitted {loss_fit:.2f}  true-params {loss_true:.2f}")
    print(f"gap closed: {gap:.1f}%")
    if args.epochs >= 120:  # the convergence horizon this check expects
        assert gap > 95.0, f"long-horizon training only closed {gap:.1f}% of the gap"


if __name__ == "__main__":
    main()
