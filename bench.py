"""Benchmark: the XLA train epoch and prediction sweeps on one GPU.

Stages, each at the SDSS grid (Npix 1913, Nb 720) with Nh 8 on synthetic
data drawn from the generative model:

* ``train``: the jitted scan epoch (``train.make_epoch_fn``) at batch 500;
* ``sweep``: the stats-only OOD sweep over a resident set in the compact
  input (``infer.predict_resident(stats_only=True)``, mask from
  ``error > 0``, ``log1p(zqso)`` column);
* ``predict``: the full resident prediction (continuum planes included).

Each stage warms up (compiles) first, then times whole calls that end in
``block_until_ready``. Every number is printed beside the device it ran on
and the card's name and power limit; the share of the HBM roof comes from
bytes counted from the shapes. A run that finds no GPU fails.

Prints progress on stderr and ONE JSON line on stdout:

    python bench.py [--n 65536] [--repeats 5]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

_T0 = time.perf_counter()

#: published HBM bandwidth by ``device_kind`` (NVIDIA's data sheet, SXM
#: part). A device that is not listed is an error, not a default.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def stage(msg: str) -> None:
    """Progress marker on stderr (stdout carries only the JSON line)."""
    print(f"[bench +{time.perf_counter() - _T0:6.1f}s] {msg}",
          file=sys.stderr, flush=True)


def make_problem(grid, nh: int, n: int, seed: int = 0):
    """Synthetic resident set: (true params, mu, spectra, residual data)."""
    from qfa_tpu.data.loader import ResidualDataset
    from qfa_tpu.data.synthetic import generate
    from qfa_tpu.models import random_init

    true = random_init(jax.random.key(seed), grid.npix, grid.nb, nh)
    true = true._replace(Psi=jnp.full((grid.npix,), 0.05, jnp.float32),
                         omega=jnp.full((grid.nb,), 0.2, jnp.float32))
    mu = jnp.full((grid.npix,), 1.1, jnp.float32)
    syn = jax.jit(
        lambda k: generate(k, true, mu, grid, n, mask_frac=0.1)
    )(jax.random.key(seed + 1))
    b = jax.jit(lambda s: s.to_batch(mu))(syn)
    data = ResidualDataset(delta=b.delta, error=b.error, zabs=b.zabs,
                           mask=b.mask)
    return true, mu, syn, data


def timed_calls(fn, repeats: int) -> list[float]:
    """Wall seconds of ``repeats`` calls of ``fn`` (each ends in
    ``block_until_ready``), after one untimed warm-up call."""
    jax.block_until_ready(fn(0))
    out = []
    for i in range(1, repeats + 1):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(i))
        out.append(time.perf_counter() - t0)
    return out


def bench_train(grid, data, nh: int, repeats: int) -> dict:
    from qfa_tpu.models import random_init
    from qfa_tpu.train import TrainConfig, TrainState, adam, make_epoch_fn
    from qfa_tpu.data.loader import batch_indices

    cfg = TrainConfig(batch_size=500)
    epoch_fn = make_epoch_fn(cfg)
    p0 = random_init(jax.random.key(7), grid.npix, grid.nb, nh)
    state = [TrainState(p0, adam.init(p0))]
    n_used = (data.size // cfg.batch_size) * cfg.batch_size

    def run(i):
        idx = batch_indices(jax.random.key(100 + i), data.size, cfg.batch_size)
        state[0], loss = epoch_fn(state[0], data, idx)
        return loss

    times = timed_calls(run, repeats)
    # the minimum bytes an epoch must read: the four resident planes
    per_spec = (3 * grid.npix + grid.nb) * 4
    return dict(seconds=times, spectra=n_used, bytes_per_spectrum=per_spec)


def bench_sweep(grid, params, mu, syn, repeats: int, stats_only: bool):
    from qfa_tpu.data.grid import loglam_row, zq_column
    from qfa_tpu.infer import predict_resident

    flux = syn.flux * syn.mask
    error = syn.error * syn.mask
    zq = zq_column(syn.zqso)
    loglam = loglam_row(grid.wav)
    n = flux.shape[0]
    nh = params.F.shape[1]

    def run(i):
        res = predict_resident(
            params, mu, flux, error, zq, None, batch_size=8192,
            stats_only=stats_only, loglam=loglam,
        )
        return res.ll

    times = timed_calls(run, repeats)
    per_spec = 2 * grid.npix * 4 + 4 + (1 + nh + nh * nh) * 4
    if not stats_only:
        per_spec += 2 * grid.npix * 4
    return dict(seconds=times, spectra=n, bytes_per_spectrum=per_spec)


def summarize(rec: dict, hbm: float) -> dict:
    med = float(np.median(rec["seconds"]))
    return dict(
        rec,
        median_s=med,
        us_per_spectrum=med / rec["spectra"] * 1e6,
        spectra_per_s=rec["spectra"] / med,
        hbm_roof_share=rec["spectra"] * rec["bytes_per_spectrum"] / hbm / med,
    )


def main(argv=None) -> None:
    import qfa_tpu
    from qfa_tpu.utils.runtime import gpu_name_and_power, setup_compile_cache

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65536,
                    help="resident spectra (a multiple of 8192)")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)

    setup_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; found {dev.platform}")
    if dev.device_kind not in HBM_BYTES_PER_S:
        raise SystemExit(f"no published peaks for {dev.device_kind!r}")
    hbm = HBM_BYTES_PER_S[dev.device_kind]
    card = gpu_name_and_power()
    stage(f"device {dev.device_kind} ({card})")

    grid = qfa_tpu.make_grid()
    nh = 8
    stage("data")
    true, mu, syn, data = make_problem(grid, nh, args.n)
    out = dict(device=dict(platform=dev.platform, kind=dev.device_kind,
                           count=jax.device_count()),
               card=card, grid=dict(npix=grid.npix, nb=grid.nb, nh=nh))
    stage("train epoch (batch 500)")
    out["train"] = summarize(bench_train(grid, data, nh, args.repeats), hbm)
    stage("stats-only sweep")
    out["sweep"] = summarize(
        bench_sweep(grid, true, mu, syn, args.repeats, stats_only=True), hbm
    )
    stage("full prediction")
    out["predict"] = summarize(
        bench_sweep(grid, true, mu, syn, args.repeats, stats_only=False), hbm
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
