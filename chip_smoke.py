"""Bring-up check on the GPU: QFA's main paths through the entry points a
user calls, at the SDSS grid (Npix 1913, Nb 720) with Nh 8 and one DESI
grid epoch, each checked against the dense reference.

    python chip_smoke.py               # one GPU; fails without one
    python chip_smoke.py --cards 4     # only the four-card phases
    python chip_smoke.py --rehearse    # every phase on the CPU, tiny grid

Phases (one GPU): 0 device; 1 train through ``qfa_tpu.cli`` on npz files
written from a seed; 2 predict through the CLI and compare with the dense
reference; 3 the stats-only OOD sweep against phase 2; 4 the HTTP server
of ``qfa_tpu.serve`` against direct calls; 5 one ``fit`` epoch and one
prediction batch at the DESI grid. ``--cards 4`` runs instead: exact-DP
training over a 4-card mesh against one card, the sharded predictor
against one card, and one ``parallel.tp`` step on a 2x2 mesh against one
device.

The reference is :func:`qfa_tpu.models.dense_predict` — the dense
``Npix x Npix`` covariance at ``Precision.HIGHEST`` — run on the CPU
device. Every comparison prints its error beside its bound. Any failure
raises, so the exit code is non-zero and no result line is printed. The
last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import os
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: comparison bounds ``(rtol, atol)`` and why. The likelihood and posterior
#: bounds are the CPU tests' for the same comparisons (tests/test_model.py,
#: tests/test_linalg.py); the rest follow from them. A likelihood's atol is
#: per observed pixel (:func:`ll_atol`): README's 2e-5 relative NLL bound
#: applied to the magnitude of the per-pixel terms the NLL sums, about 2.5
#: nats per observed pixel (|log D| + log 2 pi + delta^2 / D, halved).
TOL = {
    # low-rank likelihood vs dense_masked_nll (tests/test_model.py)
    "ll": (3e-5, 5e-5),
    # capacitance posterior vs the dense covariance-side posterior
    # (tests/test_linalg.py::test_posterior_matches_dense)
    "hmean": (1e-3, 1e-4),
    "hcov": (1e-3, 1e-5),
    # F @ hmean + mu: hmean's bound times at most Nh * max|F|
    "continuum": (1e-3, 1e-3),
    # one likelihood, two programs on the card: the zq-column sweep and the
    # four-plane CLI batch sum in different orders (README's NLL bound)
    "sweep_ll": (2e-5, 5e-5),
    # the server runs the same compiled block as a direct call
    "serve": (1e-6, 1e-6),
    # exact DP vs one card on identical global batches (tests/test_parallel)
    "dp_loss": (1e-5, 0.0),
    "dp_params": (5e-4, 1e-5),
    # one step's gradient through Adam's first moment: the gradient bound
    # of tests/test_reference_step.py
    "tp_moment": (2e-3, 0.0),
    # a quarter-size shard per card picks its own GEMM algorithm, so sums
    # run in another order than the single-card batch (README's NLL bound)
    "shard_ll": (2e-5, 5e-5),
    # the posterior's bound against the dense reference (test_linalg.py)
    "shard_post": (1e-3, 1e-4),
    # fit over the mesh shuffles per shard, so batches differ from the
    # single-card run: the epoch losses agree statistically, not exactly
    "fit_mesh_loss": (2e-2, 0.0),
}


def say(msg: str) -> None:
    print(msg, flush=True)


def ll_atol(tol: str, mask) -> np.ndarray:
    """Absolute bound of a likelihood comparison, per spectrum.

    The NLL sums one term of a few nats per observed pixel, and float32
    sums of those terms round in proportion to their magnitude, not to the
    result: a near-zero NLL (large terms cancelling) has no useful relative
    error, and on the GPU the GEMM's blocking, which depends on the batch
    size, sets the summation order. The bound is ``TOL[tol][1]`` per
    observed pixel, never below the CPU tests' 3e-4.
    """
    n_obs = np.asarray(mask).reshape(np.shape(mask)[0], -1).sum(axis=1)
    return np.maximum(TOL[tol][1] * n_obs, 3e-4)


def check(name: str, got, want, tol: str, atol=None) -> None:
    """Compare ``got`` with ``want`` under ``TOL[tol]`` (``atol`` overrides
    the absolute bound, e.g. per spectrum); raise on failure."""
    rtol, atol = TOL[tol][0], TOL[tol][1] if atol is None else atol
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    if not np.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = np.abs(got - want)
    excess = float(np.max(err - (atol + rtol * np.abs(want))))
    rel = float(np.max(err / np.maximum(np.abs(want), 1e-30)))
    verdict = "ok" if excess <= 0 else "FAIL"
    atol_txt = (f"{float(np.min(atol)):g}-{float(np.max(atol)):g}"
                if np.ndim(atol) else f"{atol:g}")
    say(f"  check {name}: max|d|={float(err.max()):.3e} max rel={rel:.3e} "
        f"bound rtol={rtol:g} atol={atol_txt} [{verdict}]")
    if excess > 0:
        raise AssertionError(f"{name} outside its bound")


class Phases:
    """Wall time, compile time (JAX's own compile events) and the device's
    peak memory for each phase."""

    COMPILE_EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self, jax) -> None:
        self.jax = jax
        self.compile_s = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **_kw) -> None:
        if event in self.COMPILE_EVENTS:
            self.compile_s += duration

    @contextlib.contextmanager
    def run(self, name: str):
        say(f"== phase {name}")
        t0, c0 = time.perf_counter(), self.compile_s
        yield
        wall = time.perf_counter() - t0
        comp = self.compile_s - c0
        stats = self.jax.devices()[0].memory_stats() or {}
        peak = stats.get("peak_bytes_in_use")
        peak_txt = "n/a" if peak is None else f"{peak / 2**20:.1f} MiB"
        say(f"== phase {name} done: wall {wall:.2f} s, of which compile "
            f"{comp:.2f} s; peak_bytes_in_use so far {peak_txt}")


def dense_reference(jax, params, mu, flux, error, zabs, mask, tau):
    """The dense float32 reference on the CPU device."""
    from qfa_tpu.models import ModelOptions, dense_predict

    cpu = jax.devices("cpu")[0]
    args = jax.device_put((params, mu, flux, error, zabs, mask), cpu)
    with jax.default_device(cpu):
        fn = jax.jit(dense_predict, static_argnums=(6,))
        return jax.device_get(fn(*args, ModelOptions(tau_which=tau)))


def compare_with_dense(label, res, ref, mask) -> None:
    """``res`` (ll, hmean[, continuum]) against a dense_predict result."""
    check(f"{label} ll", res["ll"], ref.ll, "ll", ll_atol("ll", mask))
    check(f"{label} hmean", res["hmean"], ref.hmean, "hmean")
    if "hcov" in res:
        check(f"{label} hcov", res["hcov"], ref.hcov, "hcov")
    if "continuum" in res:
        check(f"{label} continuum", res["continuum"], ref.continuum,
              "continuum")


def true_params(jax, grid, nh: int, seed: int):
    """Generative parameters with a realistic noise floor."""
    import jax.numpy as jnp

    from qfa_tpu.models import random_init

    p = random_init(jax.random.key(seed), grid.npix, grid.nb, nh)
    return p._replace(Psi=jnp.full((grid.npix,), 0.05, jnp.float32),
                      omega=jnp.full((grid.nb,), 0.2, jnp.float32))


def draw(jax, grid, params, mu, n: int, seed: int, chunk: int = 4096):
    """``n`` spectra from the generative model, drawn on the device in
    chunks, returned on the host."""
    from qfa_tpu.data.synthetic import generate

    chunk = min(chunk, n)
    gen = jax.jit(lambda k: generate(k, params, mu, grid, chunk,
                                     mask_frac=0.1))
    parts = [jax.device_get(gen(jax.random.fold_in(jax.random.key(seed), i)))
             for i in range(-(-n // chunk))]
    return jax.tree.map(lambda *xs: np.concatenate(xs)[:n], *parts)


def write_survey(syn, data_dir: str, catalog: str) -> list[str]:
    """Spectrum npz files (``-999`` on masked pixels) plus the training
    catalog (``file, snr, z, num_mask``)."""
    os.makedirs(data_dir, exist_ok=True)
    names = []
    mask = syn.mask > 0
    for i in range(syn.flux.shape[0]):
        name = f"spec-{i:06d}.npz"
        np.savez(os.path.join(data_dir, name),
                 flux=np.where(mask[i], syn.flux[i], -999.0),
                 error=np.where(mask[i], syn.error[i], -999.0),
                 z=syn.zqso[i])
        names.append(name)
    with open(catalog, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file", "snr", "z", "num_mask"])
        for name, z in zip(names, syn.zqso):
            w.writerow([name, 10.0, float(z), 0])
    return names


def grid_opts(grid_args) -> list[str]:
    return ["DATA.LAMMIN", repr(grid_args[0]), "DATA.LAMMAX",
            repr(grid_args[1]), "DATA.LOGLAM_DELTA", repr(grid_args[2])]


# -- one-card phases -----------------------------------------------------------


def phase_train(jax, ph, work, sizes, grid_args):
    import jax.numpy as jnp

    from qfa_tpu import native
    from qfa_tpu.cli import main as cli_main
    from qfa_tpu.data.grid import make_grid

    grid = make_grid(*grid_args)
    nh, seed = 8, 0
    with ph.run(f"1 train via the CLI (Npix {grid.npix}, Nb {grid.nb}, "
                f"Nh {nh}, {sizes['train']} spectra, batch {sizes['batch']})"):
        true = true_params(jax, grid, nh, seed)
        mu = jnp.full((grid.npix,), 1.1, jnp.float32)
        syn = draw(jax, grid, true, mu, sizes["train"], seed + 1)
        data_dir = os.path.join(work, "spectra")
        catalog = os.path.join(work, "catalog.csv")
        t0 = time.perf_counter()
        names = write_survey(syn, data_dir, catalog)
        say(f"  wrote {len(names)} spectrum files in "
            f"{time.perf_counter() - t0:.2f} s")
        out = os.path.join(work, "train")
        cli_main([
            "--type", "train", "--catalog", catalog, "--data_dir", data_dir,
            "--output_dir", out, "--data_num", str(sizes["train"]),
            "--batch_size", str(sizes["batch"]), "--n_epochs", "3",
            "--nh", str(nh), "--tau", "becker", "--seed", str(seed),
            "--opts", *grid_opts(grid_args),
        ])
        with open(os.path.join(out, "metrics.jsonl")) as f:
            losses = [json.loads(line)["loss"] for line in f]
        say(f"  epoch losses: {losses}")
        if len(losses) != 3 or not np.isfinite(losses).all():
            raise AssertionError(f"expected 3 finite epoch losses: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"loss did not fall: {losses}")
        if native.native_available():
            say(f"  spectra read by the native reader "
                f"({native.library_path()})")
        else:
            say(f"  native reader unavailable, Python reader used: "
                f"{native._build_error}")
    return grid, names, data_dir, os.path.join(out, "model_parameters.npz")


def phase_predict(jax, ph, work, sizes, grid_args, grid, names, data_dir,
                  ckpt):
    from qfa_tpu.cli import main as cli_main
    from qfa_tpu.data.loader import SpectraDataset
    from qfa_tpu.models import load_npz

    n = sizes["predict"]
    with ph.run(f"2 predict via the CLI ({n} spectra)"):
        pcat = os.path.join(work, "predict.csv")
        with open(pcat, "w") as f:
            f.writelines(name + "\n" for name in names[:n])
        out = os.path.join(work, "predict")
        cli_main([
            "--type", "predict", "--catalog", pcat, "--data_dir", data_dir,
            "--output_dir", out, "--resume", ckpt, "--nh", "8",
            "--tau", "becker", "--opts", "RUNTIME.CONSOLIDATED_PREDICT",
            "True", *grid_opts(grid_args),
        ])
        with np.load(os.path.join(out, "predictions.npz")) as r:
            got = {"ll": r["ll"], "hmean": r["hmean"][..., 0],
                   "hcov": r["hcov"], "continuum": r["cont"]}
            if list(r["paths"]) != names[:n]:
                raise AssertionError("prediction rows out of catalog order")
        for k, v in got.items():
            if v.shape[0] != n or not np.isfinite(v).all():
                raise AssertionError(f"{k}: shape {v.shape} or non-finite")
        params, mu = load_npz(ckpt)
        ds = SpectraDataset.from_paths(
            [os.path.join(data_dir, name) for name in names[:n]]
        )
        k = sizes["compare"]
        t0 = time.perf_counter()
        ref = dense_reference(
            jax, params, mu, ds.flux[:k], ds.error[:k],
            grid.zabs(ds.zqso[:k]).astype(np.float32),
            ds.mask[:k].astype(np.float32), "becker",
        )
        say(f"  dense reference for {k} spectra on the CPU: "
            f"{time.perf_counter() - t0:.2f} s")
        compare_with_dense(f"CLI predict[:{k}] vs dense",
                           {f: v[:k] for f, v in got.items()}, ref,
                           ds.mask[:k])
    return params, mu, ds, got


def phase_sweep(jax, ph, sizes, grid, params, mu, ds, got):
    import jax.numpy as jnp

    from qfa_tpu.data.grid import loglam_row, zq_column
    from qfa_tpu.infer import predict_resident

    n = ds.size
    bs = min(sizes["sweep_batch"], n)
    with ph.run(f"3 stats-only OOD sweep ({n} resident spectra, "
                f"batch {bs})"):
        flux, error = jnp.asarray(ds.flux), jnp.asarray(ds.error)
        zq = zq_column(jnp.asarray(ds.zqso))
        res = predict_resident(params, jnp.asarray(mu), flux, error, zq, None,
                               batch_size=bs, stats_only=True,
                               loglam=loglam_row(grid.wav))
        if res.continuum is not None:
            raise AssertionError("stats-only sweep returned planes")
        check("sweep ll vs CLI predict ll", jax.device_get(res.ll), got["ll"],
              "sweep_ll", ll_atol("sweep_ll", ds.mask))


def phase_serve(jax, ph, ckpt, grid_args, ds):
    from qfa_tpu.serve import QFAPredictor, make_http_server

    with ph.run("4 serve over HTTP (8 requests of 1-64 spectra)"):
        pred = QFAPredictor(ckpt, max_batch=64, tau_which="becker",
                            lammin=grid_args[0], lammax=grid_args[1],
                            loglam_delta=grid_args[2])
        pred.warmup()
        srv = make_http_server(pred, "127.0.0.1", 0)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                info = json.loads(r.read())
            say(f"  healthz: {info}")
            if info.get("status") != "ok" or info["npix"] != ds.flux.shape[1]:
                raise AssertionError(f"bad healthz {info}")
            start = 0
            for i, size in enumerate((1, 2, 5, 8, 17, 32, 63, 64)):
                sl = slice(start, start + size)
                start += size
                flux = np.where(ds.mask[sl], ds.flux[sl], -999.0)
                error = np.where(ds.mask[sl], ds.error[sl], -999.0)
                body = json.dumps({"flux": flux.tolist(),
                                   "error": error.tolist(),
                                   "zqso": ds.zqso[sl].tolist()}).encode()
                req = urllib.request.Request(
                    url + "/predict", data=body,
                    headers={"Content-Type": "application/json"})
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=120) as r:
                    out = json.loads(r.read())
                dt = time.perf_counter() - t0
                direct = pred.predict(flux, error, ds.zqso[sl])
                say(f"  request {i}: {size} spectra in {dt * 1e3:.1f} ms")
                for key in ("ll", "hmean", "continuum"):
                    check(f"request {i} {key} vs direct", out[key],
                          direct[key], "serve")
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=60)
        if thread.is_alive():
            raise AssertionError("server thread did not stop")


def phase_desi(jax, ph, sizes):
    import jax.numpy as jnp

    from qfa_tpu.config import load_config
    from qfa_tpu.data.grid import make_grid
    from qfa_tpu.data.loader import ResidualDataset
    from qfa_tpu.models import predict, random_init
    from qfa_tpu.train import TrainConfig, fit

    if sizes["desi_grid"] is None:
        cfg = load_config(os.path.join(ROOT, "configs", "desi_train.yaml"))
        grid = make_grid(cfg.DATA.LAMMIN, cfg.DATA.LAMMAX,
                         cfg.DATA.LOGLAM_DELTA)
        batch = cfg.DATA.BATCH_SIZE
    else:
        grid = make_grid(*sizes["desi_grid"])
        batch = sizes["batch"]
    n, nh = sizes["desi"], 8
    with ph.run(f"5 DESI grid (Npix {grid.npix}, Nb {grid.nb}): one fit "
                f"epoch on {n} resident spectra, one prediction batch"):
        true = true_params(jax, grid, nh, 3)
        mu = jnp.full((grid.npix,), 1.1, jnp.float32)
        syn = draw(jax, grid, true, mu, n, 4, chunk=min(n, 1024))
        b = jax.jit(lambda s: s.to_batch(mu))(
            jax.tree.map(jnp.asarray, syn))
        data = ResidualDataset(delta=b.delta, error=b.error, zabs=b.zabs,
                               mask=b.mask)
        params, hist = fit(
            random_init(jax.random.key(5), grid.npix, grid.nb, nh), data, mu,
            TrainConfig(n_epochs=1, batch_size=batch), key=jax.random.key(6),
        )
        say(f"  fit epoch loss {hist}")
        if len(hist) != 1 or not np.isfinite(hist).all():
            raise AssertionError(f"bad DESI epoch {hist}")
        flux = syn.flux * syn.mask
        error = syn.error * syn.mask
        res = jax.device_get(predict(
            params, mu, jnp.asarray(flux[:batch]), jnp.asarray(error[:batch]),
            jnp.asarray(syn.zabs[:batch]), jnp.asarray(syn.mask[:batch])))
        for f in res._fields:
            if not np.isfinite(getattr(res, f)).all():
                raise AssertionError(f"non-finite DESI {f}")
        k = 2
        t0 = time.perf_counter()
        ref = dense_reference(jax, params, mu, flux[:k], error[:k],
                              syn.zabs[:k], syn.mask[:k], "becker")
        say(f"  dense reference for {k} spectra on the CPU: "
            f"{time.perf_counter() - t0:.2f} s")
        compare_with_dense(f"DESI predict[:{k}] vs dense",
                           {"ll": res.ll[:k], "hmean": res.hmean[:k],
                            "hcov": res.hcov[:k],
                            "continuum": res.continuum[:k]}, ref,
                           syn.mask[:k])


# -- four-card phases ----------------------------------------------------------


def resident_set(jax, grid, n: int, seed: int):
    import jax.numpy as jnp

    from qfa_tpu.data.loader import ResidualDataset

    true = true_params(jax, grid, 8, seed)
    mu = jnp.full((grid.npix,), 1.1, jnp.float32)
    syn = jax.tree.map(jnp.asarray, draw(jax, grid, true, mu, n, seed + 1))
    b = jax.jit(lambda s: s.to_batch(mu))(syn)
    return mu, syn, ResidualDataset(delta=b.delta, error=b.error,
                                    zabs=b.zabs, mask=b.mask)


def phase_dp(jax, ph, sizes, grid, cards):
    import jax.numpy as jnp

    from qfa_tpu.models import random_init
    from qfa_tpu.parallel import (
        make_dp_epoch_fn,
        make_mesh,
        shard_dataset,
        shard_epoch_indices,
    )
    from qfa_tpu.train import TrainConfig, TrainState, adam, fit
    from qfa_tpu.train.loop import make_epoch_fn

    n, bs = sizes["train"], sizes["batch"]
    with ph.run(f"A exact-DP training over {cards} cards vs one card "
                f"({n} spectra, batch {bs}, 3 epochs)"):
        mu, _syn, data = resident_set(jax, grid, n, 0)
        mesh = make_mesh(cards)
        cfg = TrainConfig(n_epochs=3, batch_size=bs)

        def fresh():
            p = random_init(jax.random.key(2), grid.npix, grid.nb, 8)
            return TrainState(p, adam.init(p))

        dp_fn = make_dp_epoch_fn(cfg, mesh)
        one_fn = make_epoch_fn(cfg)
        sharded = shard_dataset(data, mesh)
        st_dp, st_1 = fresh(), fresh()
        shard = n // cards
        for epoch in range(3):
            ei = shard_epoch_indices(jax.random.key(10 + epoch), n, bs, mesh)
            t0 = time.perf_counter()
            st_dp, loss_dp = dp_fn(st_dp, sharded, ei)
            loss_dp = float(loss_dp)
            t_dp = time.perf_counter() - t0
            idx, wt = (np.asarray(jax.device_get(a)) for a in ei)
            gidx = np.concatenate([idx[d] + d * shard for d in range(cards)],
                                  axis=1)
            gwt = np.concatenate([wt[d] for d in range(cards)], axis=1)
            t0 = time.perf_counter()
            st_1, loss_1 = one_fn(st_1, data, jnp.asarray(gidx),
                                  jnp.asarray(gwt))
            loss_1 = float(loss_1)
            t_1 = time.perf_counter() - t0
            say(f"  epoch {epoch}: loss {cards} cards {loss_dp:.6f} "
                f"({t_dp:.3f} s), one card {loss_1:.6f} ({t_1:.3f} s)")
            check(f"epoch {epoch} loss, {cards} cards vs one", loss_dp,
                  loss_1, "dp_loss")
        for name in st_1.params._fields:
            check(f"param {name} after 3 epochs, {cards} cards vs one",
                  jax.device_get(getattr(st_dp.params, name)),
                  jax.device_get(getattr(st_1.params, name)), "dp_params")
        # the user-facing entry: fit(mesh=...) against fit on one card
        # (fresh parameters each: the epoch donates its state)
        _, hist_mesh = fit(fresh().params, data, mu, cfg,
                           key=jax.random.key(7), mesh=mesh)
        _, hist_one = fit(fresh().params, data, mu, cfg,
                          key=jax.random.key(7))
        say(f"  fit losses: {cards} cards {hist_mesh}, one card {hist_one}")
        if not hist_mesh[-1] < hist_mesh[0]:
            raise AssertionError(f"mesh fit loss did not fall: {hist_mesh}")
        check(f"fit epoch losses, {cards} cards vs one", hist_mesh, hist_one,
              "fit_mesh_loss")


def phase_shard_predict(jax, ph, sizes, grid, cards):
    from qfa_tpu.models import predict
    from qfa_tpu.parallel import make_dp_predict_fn, make_mesh

    n = sizes["predict"]
    with ph.run(f"B sharded prediction over {cards} cards vs one card "
                f"({n} spectra)"):
        mu, syn, _ = resident_set(jax, grid, n, 20)
        params = true_params(jax, grid, 8, 20)
        flux, error = syn.flux * syn.mask, syn.error * syn.mask
        one = jax.device_get(predict(params, mu, flux, error, syn.zabs,
                                     syn.mask))
        fn = make_dp_predict_fn(make_mesh(cards))
        dp = fn(params, mu, flux, error, syn.zabs, syn.mask)
        if {s.data.shape[0] for s in dp.ll.addressable_shards} != {
                n // cards}:
            raise AssertionError("sharded outputs were gathered")
        dp = jax.device_get(dp)
        check(f"ll, {cards} cards vs one", dp.ll, one.ll, "shard_ll",
              ll_atol("shard_ll", jax.device_get(syn.mask)))
        for f in ("hmean", "hcov", "continuum", "continuum_std"):
            check(f"{f}, {cards} cards vs one", getattr(dp, f),
                  getattr(one, f), "shard_post")


def phase_tp(jax, ph, grid):
    import jax.numpy as jnp

    from qfa_tpu.data.batch import SpectraBatch
    from qfa_tpu.models import random_init
    from qfa_tpu.parallel.tp import (
        make_mesh_2d,
        make_tp_step_fn,
        shard_batch_2d,
        shard_params_2d,
    )
    from qfa_tpu.train import TrainConfig, TrainState, adam
    from qfa_tpu.train.loop import make_step_fn

    bs = 500 if grid.npix > 1000 else 16
    with ph.run(f"C one (data x pix) step on a 2x2 mesh vs one device "
                f"(batch {bs})"):
        mu, _syn, data = resident_set(jax, grid, bs, 30)
        # the pixel axis splits in two; an odd grid gains one masked pixel
        pad = grid.npix % 2

        def padded(x, value=0.0):
            return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)],
                           constant_values=value)

        batch = SpectraBatch(delta=padded(data.delta),
                             error=padded(data.error), zabs=data.zabs,
                             mask=padded(data.mask),
                             weight=jnp.ones((bs,), jnp.float32))
        def init():
            p = random_init(jax.random.key(3), grid.npix, grid.nb, 8)
            return p._replace(F=jnp.pad(p.F, [(0, pad), (0, 0)]),
                              Psi=padded(p.Psi, 1.0))

        cfg = TrainConfig(batch_size=bs)
        p0 = init()
        st1, loss1 = make_step_fn(cfg)(TrainState(p0, adam.init(p0)), batch)
        st1 = jax.device_get(st1)
        mesh = make_mesh_2d(2, 2)
        p2 = shard_params_2d(init(), mesh)
        st2, loss2 = make_tp_step_fn(cfg, mesh)(
            TrainState(p2, adam.init(p2)), shard_batch_2d(batch, mesh))
        check("tp step loss, 2x2 vs one", float(loss2), float(loss1),
              "dp_loss")
        for name in st1.params._fields:
            # Adam's first moment holds the gradient; the first step moves
            # each parameter by lr * sign(moment), so parameters are
            # compared where that sign is not a rounding-level coin flip
            m1 = np.asarray(getattr(st1.opt_state.m, name))
            scale = float(np.max(np.abs(m1)))
            check(f"tp moment {name}, 2x2 vs one",
                  jax.device_get(getattr(st2.opt_state.m, name)), m1,
                  "tp_moment", atol=1e-4 * scale)
            moved = np.abs(m1) > 1e-2 * scale
            check(f"tp param {name}, 2x2 vs one",
                  np.asarray(jax.device_get(getattr(st2.params, name)))[moved],
                  np.asarray(getattr(st1.params, name))[moved], "dp_params")


# -- driver ------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(4,), default=None,
                    help="run only the four-card phases")
    ap.add_argument("--rehearse", action="store_true",
                    help="run on the CPU at a tiny grid (no GPU needed)")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import qfa_tpu

    if os.path.dirname(os.path.dirname(os.path.abspath(qfa_tpu.__file__))) \
            != ROOT:
        raise SystemExit(f"qfa_tpu imported from {qfa_tpu.__file__}, not "
                         f"from this checkout")
    from qfa_tpu.utils.runtime import gpu_name_and_power, setup_compile_cache

    cache = setup_compile_cache()
    import jax
    import jaxlib

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found "
                         f"{dev.platform} ({dev.device_kind})")
    ph = Phases(jax)
    with ph.run("0 device"):
        # the card's name and power limit, as nvidia-smi prints them
        say(gpu_name_and_power() if dev.platform == "gpu"
            else "  card: none (CPU)")
        say(f"  jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
            f"{len(jax.devices())} x {dev.platform} ({dev.device_kind})")
        say(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
        say(f"  compile cache: {cache}")
    if args.rehearse:
        sdss = (1030.0, 1120.0, 5e-4)
        sizes = dict(train=256, batch=16, predict=192, compare=8,
                     sweep_batch=16, desi=64, desi_grid=(1030.0, 1200.0, 4e-4))
    else:
        from qfa_tpu.data.grid import (
            DEFAULT_DLOGLAM,
            DEFAULT_LAMMAX,
            DEFAULT_LAMMIN,
        )

        sdss = (DEFAULT_LAMMIN, DEFAULT_LAMMAX, DEFAULT_DLOGLAM)
        sizes = dict(train=8192, batch=500, predict=2048, compare=64,
                     sweep_batch=1024, desi=2048, desi_grid=None)

    if args.cards:
        if jax.device_count() < args.cards:
            raise SystemExit(f"--cards {args.cards}: JAX sees "
                             f"{jax.device_count()} devices")
        from qfa_tpu.data.grid import make_grid

        grid = make_grid(*sdss)
        phase_dp(jax, ph, sizes, grid, args.cards)
        phase_shard_predict(jax, ph, sizes, grid, args.cards)
        phase_tp(jax, ph, grid)
    else:
        with tempfile.TemporaryDirectory(prefix="qfa-smoke-") as work:
            grid, names, data_dir, ckpt = phase_train(jax, ph, work, sizes,
                                                      sdss)
            params, mu, ds, got = phase_predict(jax, ph, work, sizes, sdss,
                                                grid, names, data_dir, ckpt)
            phase_sweep(jax, ph, sizes, grid, params, mu, ds, got)
            phase_serve(jax, ph, ckpt, sdss, ds)
        phase_desi(jax, ph, sizes)
    say(json.dumps({
        "ok": True,
        **({"rehearsal": True} if args.rehearse else {}),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
