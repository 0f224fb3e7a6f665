"""Online serving: a warm fixed-shape predictor behind a stdlib HTTP API.

The reference's only inference entry points are a batch CLI loop writing
one npz per spectrum (``/root/reference/main.py:86-100``) and a notebook
(``/root/reference/nb/predict.ipynb``) — there is no online-serving
surface at all. For production deployment this module adds one:

* :class:`QFAPredictor` — loads a checkpoint once, compiles ONE
  fixed-shape prediction program (requests are padded to ``max_batch``
  and chunked above it, so no shape ever recompiles), and serves
  the full reference prediction contract per spectrum
  (``/root/reference/QFA/model.py:160-180``): ``ll`` (OOD score),
  posterior ``hmean``/``hcov``, ``continuum`` and ``continuum_std``.
* :func:`make_http_server` / :func:`main` — a dependency-free
  ``ThreadingHTTPServer`` exposing ``POST /predict`` (JSON in/out) and
  ``GET /healthz``.

The device path is the same batched program the batch CLI uses
(:func:`qfa_tpu.models.predict`).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np

from .data.grid import (
    DEFAULT_DLOGLAM as REFERENCE_LOGLAM_DELTA,
    DEFAULT_LAMMAX as REFERENCE_LAMMAX,
    DEFAULT_LAMMIN as REFERENCE_LAMMIN,
    make_grid,
)
from .data.loader import MISSING
from .models import load_npz
from .models.qfa import ModelOptions, predict

__all__ = ["QFAPredictor", "make_http_server", "main"]


class QFAPredictor:
    """Warm fixed-shape continuum predictor for online serving.

    Parameters
    ----------
    checkpoint:
        Path to a reference-schema npz (``mu, F, Psi, omega, tau0, c0,
        beta`` — ``/root/reference/QFA/model.py:254-295``).
    max_batch:
        The one compiled batch shape. Requests are zero-padded up to it
        and chunked above it — no request shape ever triggers a
        recompile (serving latency stays flat after warmup).
    """

    def __init__(
        self,
        checkpoint: str,
        *,
        max_batch: int = 64,
        tau_which: str = "becker",
        compat_c0_bug: bool = False,
        lammin: float = REFERENCE_LAMMIN,
        lammax: float = REFERENCE_LAMMAX,
        loglam_delta: float = REFERENCE_LOGLAM_DELTA,
    ) -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be positive")
        self.params, self.mu = load_npz(
            checkpoint, compat_c0_bug=compat_c0_bug
        )
        self.grid = make_grid(lammin, lammax, loglam_delta)
        npix = int(self.params.F.shape[0])
        if self.grid.npix != npix:
            raise ValueError(
                f"checkpoint has Npix={npix} but the wavelength grid "
                f"[{lammin}, {lammax}) at dloglam={loglam_delta} has "
                f"{self.grid.npix} pixels — pass the grid the model was "
                "trained on"
            )
        self.options = ModelOptions(tau_which=tau_which)
        self.max_batch = max_batch
        self._mu_dev = jnp.asarray(self.mu)
        self._lock = threading.Lock()
        self._requests = 0

    # ------------------------------------------------------------------
    def _run_block(self, flux, error, zabs, mask):
        """One fixed-shape (max_batch, Npix) device call."""
        res = predict(
            self.params, self._mu_dev,
            jnp.asarray(flux), jnp.asarray(error), jnp.asarray(zabs),
            jnp.asarray(mask), self.options,
        )
        return res.ll, res.hmean, res.hcov, res.continuum, res.continuum_std

    def predict(
        self,
        flux: np.ndarray,
        error: np.ndarray,
        zqso: np.ndarray,
        mask: np.ndarray | None = None,
    ) -> dict:
        """Predict a batch of spectra; returns host numpy arrays.

        Accepts the reference's ``-999.`` missing-pixel sentinel in flux
        or error (``/root/reference/QFA/dataloader.py:24-28``) on top of
        an optional explicit ``mask``.
        """
        flux = np.asarray(flux, np.float32)
        error = np.asarray(error, np.float32)
        zqso = np.atleast_1d(np.asarray(zqso, np.float32))
        if flux.size == 0 and zqso.size == 0:
            # normalize an empty request (JSON `[]` arrives as shape (0,),
            # which np.atleast_2d would turn into (1, 0) and trip the npix
            # check) so it reaches the empty-result path below
            flux = flux.reshape(0, self.grid.npix)
            error = error.reshape(0, self.grid.npix)
        flux = np.atleast_2d(flux)
        error = np.atleast_2d(error)
        n, npix = flux.shape
        if npix != self.grid.npix:
            raise ValueError(
                f"request has {npix} pixels, model grid has {self.grid.npix}"
            )
        if error.shape != flux.shape or zqso.shape != (n,):
            raise ValueError(
                f"shape mismatch: flux {flux.shape}, error {error.shape}, "
                f"zqso {zqso.shape}"
            )
        m = (flux != MISSING) & (error != MISSING) & (error > 0.0)
        if mask is not None:
            m &= np.atleast_2d(np.asarray(mask)).astype(bool)
        flux = np.where(m, flux, 0.0).astype(np.float32)
        error = np.where(m, error, 0.0).astype(np.float32)
        zabs = self.grid.zabs(zqso).astype(np.float32)
        mf = m.astype(np.float32)
        if n == 0:  # an empty request is a valid (empty) result
            nh = int(self.params.F.shape[1])
            f32 = np.float32
            return {
                "ll": np.zeros((0,), f32),
                "hmean": np.zeros((0, nh), f32),
                "hcov": np.zeros((0, nh, nh), f32),
                "continuum": np.zeros((0, npix), f32),
                "continuum_std": np.zeros((0, npix), f32),
                "n_obs": np.zeros((0,), np.int64),
            }

        mb = self.max_batch
        parts = []
        with self._lock:
            self._requests += 1
            for s in range(0, n, mb):
                e = min(s + mb, n)
                pad = mb - (e - s)

                def prep(x):
                    x = x[s:e]
                    if pad:
                        x = np.concatenate(
                            [x, np.zeros((pad,) + x.shape[1:], x.dtype)]
                        )
                    return x

                out = self._run_block(
                    prep(flux), prep(error), prep(zabs), prep(mf)
                )
                # slice on the host: a device slice compiles once per
                # request size
                parts.append([np.asarray(o)[: e - s] for o in out])
        ll, hmean, hcov, cont, std = (
            np.concatenate([p[i] for p in parts]) for i in range(5)
        )
        return {
            "ll": ll, "hmean": hmean, "hcov": hcov,
            "continuum": cont, "continuum_std": std,
            "n_obs": m.sum(axis=1),
        }

    def warmup(self) -> None:
        """Compile the serving program before taking traffic."""
        z = np.full((1,), 2.5, np.float32)
        f = np.ones((1, self.grid.npix), np.float32)
        e = np.full((1, self.grid.npix), 0.1, np.float32)
        self.predict(f, e, z)

    @property
    def info(self) -> dict:
        return {
            "status": "ok",
            "npix": int(self.grid.npix),
            "nh": int(self.params.F.shape[1]),
            "max_batch": int(self.max_batch),
            "tau": self.options.tau_which,
            "requests": self._requests,
        }


def make_http_server(
    predictor: QFAPredictor, host: str = "127.0.0.1", port: int = 8777
) -> ThreadingHTTPServer:
    """Bind (but do not start) the serving endpoint.

    ``POST /predict`` body: ``{"flux": [[...]], "error": [[...]],
    "zqso": [...], "mask": [[...]]?}`` -> the per-spectrum prediction
    contract as JSON lists. ``GET /healthz`` -> model metadata.
    Call ``serve_forever()`` on the result (or use :func:`main`).
    """

    def jsonable(v: np.ndarray) -> list:
        # strict-JSON safety: non-finite outputs (a NaN flux in the
        # request, float32 overflow in the likelihood) become null, never
        # the bare NaN/Infinity tokens json.dumps emits by default —
        # those break standards-compliant clients (JSON.parse, jq, Go)
        if v.dtype.kind == "f" and not np.isfinite(v).all():
            obj = v.astype(object)
            obj[~np.isfinite(v)] = None
            return obj.tolist()
        return v.tolist()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload, allow_nan=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path == "/healthz":
                self._send(200, predictor.info)
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802 (stdlib API)
            if self.path != "/predict":
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                req = json.loads(
                    self.rfile.read(int(self.headers["Content-Length"]))
                )
                out = predictor.predict(
                    np.asarray(req["flux"], np.float32),
                    np.asarray(req["error"], np.float32),
                    np.asarray(req["zqso"], np.float32),
                    np.asarray(req["mask"]) if "mask" in req else None,
                )
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, {"error": str(e)})
                return
            self._send(200, {k: jsonable(v) for k, v in out.items()})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> None:
    """``qfa-tpu-serve``: load a checkpoint and serve predictions."""
    import argparse

    from .utils.runtime import setup_compile_cache

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--ckpt", required=True, help="model npz checkpoint")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8777)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--tau", default="becker",
                    choices=["becker", "fg", "kamble", "mock"])
    ap.add_argument("--compat-c0-bug", action="store_true")
    ap.add_argument("--lammin", type=float, default=REFERENCE_LAMMIN)
    ap.add_argument("--lammax", type=float, default=REFERENCE_LAMMAX)
    ap.add_argument("--dloglam", type=float, default=REFERENCE_LOGLAM_DELTA)
    args = ap.parse_args(argv)
    setup_compile_cache()

    pred = QFAPredictor(
        args.ckpt, max_batch=args.max_batch, tau_which=args.tau,
        compat_c0_bug=args.compat_c0_bug,
        lammin=args.lammin, lammax=args.lammax, loglam_delta=args.dloglam,
    )
    pred.warmup()
    srv = make_http_server(pred, args.host, args.port)
    print(
        f"qfa-tpu-serve: npix="
        f"{pred.info['npix']}, nh={pred.info['nh']} — listening on "
        f"http://{args.host}:{srv.server_address[1]}",
        flush=True,
    )
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()


if __name__ == "__main__":
    main()
