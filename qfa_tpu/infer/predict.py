"""Batch inference pipeline: continuum prediction + OOD scoring at scale.

The reference predicts one spectrum at a time in a Python loop and writes an
npz per spectrum (``/root/reference/main.py:86-100``). Here prediction runs
in fixed-size padded device batches through one compiled program; outputs are
streamed back and written per spectrum in the same npz schema
(``ll, hmean, hcov, cont, uncertainty``) for drop-in compatibility, plus an
optional consolidated single-file output.
"""

from __future__ import annotations

import functools
import os
from typing import Iterator, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..data.grid import WavelengthGrid
from ..data.loader import SpectraDataset
from ..models.params import QFAParams
from ..models.qfa import ModelOptions, PredictResult, predict

Array = jnp.ndarray

__all__ = [
    "predict_dataset",
    "predict_resident",
    "write_npz_outputs",
    "write_consolidated_npz",
    "ood_scores",
]


def _batched(n: int, batch: int) -> Iterator[tuple[int, int]]:
    for start in range(0, n, batch):
        yield start, min(start + batch, n)


def predict_dataset(
    params: QFAParams,
    mu: Array,
    dataset: SpectraDataset,
    grid: WavelengthGrid,
    *,
    batch_size: int = 1024,
    options: ModelOptions = ModelOptions(),
    mesh=None,
) -> PredictResult:
    """Predict continua for a whole dataset in fixed-size padded batches.

    Every batch reuses one compiled program (the tail batch is padded up to
    ``batch_size``). Returns stacked host-side results for all ``N`` spectra.

    ``mesh`` (a 1-D :class:`jax.sharding.Mesh`) shards every batch over
    its devices (:func:`qfa_tpu.parallel.make_dp_predict_fn`, no
    collective); the batch size is rounded up to a multiple of the device
    count.
    """
    n = dataset.size
    zabs_all = grid.zabs(dataset.zqso).astype(np.float32)
    # convert once up front: astype always copies, so doing it per batch
    # would copy the whole (N, Npix) dataset for every batch (O(N^2/batch)).
    flux_all = np.ascontiguousarray(dataset.flux, np.float32)
    error_all = np.ascontiguousarray(dataset.error, np.float32)
    mask_all = np.ascontiguousarray(dataset.mask, np.float32)
    run = functools.partial(predict, options=options)
    put = jnp.asarray
    if mesh is not None:
        from ..parallel.infer_dp import make_dp_predict_fn
        from ..parallel.mesh import data_sharding

        ndev = mesh.devices.size
        batch_size = -(-batch_size // ndev) * ndev
        run = make_dp_predict_fn(mesh, options=options)
        put = lambda x: jax.device_put(x, data_sharding(mesh, x.ndim))  # noqa: E731
    outs: list[PredictResult] = []
    from ..utils.progress import progress

    for start, end in progress(
        list(_batched(n, batch_size)), desc="predict", min_items=64
    ):
        b = end - start
        pad = batch_size - b

        def prep(x: np.ndarray) -> Array:
            x = x[start:end]
            if pad:
                x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
            return put(x)

        res = run(
            params,
            mu,
            prep(flux_all),
            prep(error_all),
            prep(zabs_all),
            prep(mask_all),
        )
        # slice on the host: a device slice would compile for the tail size
        outs.append(jax.tree.map(lambda a: np.asarray(a)[:b], res))
    return PredictResult(
        *(np.concatenate([getattr(o, f) for o in outs]) for f in PredictResult._fields)
    )


@functools.partial(
    jax.jit, static_argnames=("batch_size", "options", "stats_only")
)
def predict_resident(
    params: QFAParams,
    mu: Array,
    flux: Array,
    error: Array,
    zabs: Array,
    mask: Array | None = None,
    *,
    batch_size: int = 4096,
    options: ModelOptions = ModelOptions(),
    stats_only: bool = False,
    loglam: Array | None = None,
) -> PredictResult:
    """High-throughput prediction over a device-resident dataset.

    One compiled ``lax.scan`` over contiguous batches — amortizes dispatch
    and keeps all traffic on-device (use :func:`predict_dataset` for
    host-side datasets / per-file npz output). ``N`` must be a multiple of
    ``batch_size`` (pad with masked rows otherwise).

    ``stats_only``, ``mask=None`` and ``loglam`` (with ``zabs`` the
    ``log1p(zqso)`` column) select the OOD sweep and the compact input of
    :func:`~qfa_tpu.models.predict`.
    """
    n = flux.shape[0]
    if n % batch_size:
        raise ValueError(f"N={n} must be a multiple of batch_size={batch_size}")
    n_batches = n // batch_size

    def reshape(x):
        return x.reshape((n_batches, batch_size) + x.shape[1:])

    def step(_, xs):
        fl, er, za, mk = xs
        res = predict(
            params, mu, fl, er, za, mk, options,
            stats_only=stats_only, loglam=loglam,
        )
        return None, res

    planes = (flux, error, zabs, mask)
    _, results = jax.lax.scan(
        step, None, jax.tree.map(reshape, planes)
    )
    return jax.tree.map(lambda x: x.reshape((n,) + x.shape[2:]), results)


@functools.partial(jax.jit, static_argnames=("batch_size", "options"))
def score_resident(
    params: QFAParams,
    mu: Array,
    flux: Array,
    error: Array,
    zabs: Array,
    mask: Array,
    *,
    batch_size: int = 8192,
    options: ModelOptions = ModelOptions(),
) -> Array:
    """OOD scores only (per-spectrum NLL) over a resident dataset.

    The full :func:`predict_resident` writes ~2 x Npix floats per spectrum
    (continuum + uncertainty); a survey-scale OOD selection pass needs one
    scalar. This path evaluates just the likelihood — the cheapest possible
    scan over the data.
    """
    from ..data.batch import SpectraBatch
    from ..models.qfa import absorption, batch_nll, make_delta

    n = flux.shape[0]
    if n % batch_size:
        raise ValueError(f"N={n} must be a multiple of batch_size={batch_size}")
    nb = zabs.shape[-1]
    nr = flux.shape[-1] - nb
    n_batches = n // batch_size

    def reshape(x):
        return x.reshape((n_batches, batch_size) + x.shape[1:])

    def step(_, xs):
        fl, er, za, mk = xs
        amp = absorption(za, nr, options.tau_which)
        batch = SpectraBatch(
            delta=make_delta(fl, mu, amp, mk),
            error=er,
            zabs=za,
            mask=mk,
            weight=jnp.ones(fl.shape[:-1], fl.dtype),
        )
        return None, batch_nll(params, batch, options)

    _, ll = jax.lax.scan(
        step, None, (reshape(flux), reshape(error), reshape(zabs), reshape(mask))
    )
    return ll.reshape(n)


def write_npz_outputs(
    result: PredictResult,
    paths: Sequence[str],
    output_dir: str,
) -> None:
    """Write one npz per spectrum in the reference output schema
    (keys ``ll, hmean, hcov, cont, uncertainty``;
    ``/root/reference/main.py:94-98``)."""
    from ..utils.progress import progress

    os.makedirs(output_dir, exist_ok=True)
    for i, p in progress(
        list(enumerate(paths)), desc="writing predictions", total=len(paths)
    ):
        name = os.path.basename(str(p))
        np.savez(
            os.path.join(output_dir, name),
            ll=np.float32(result.ll[i]),
            hmean=np.asarray(result.hmean[i], np.float32)[:, None],
            hcov=np.asarray(result.hcov[i], np.float32),
            cont=np.asarray(result.continuum[i], np.float32),
            uncertainty=np.asarray(result.continuum_std[i], np.float32),
        )


def write_consolidated_npz(
    result: PredictResult,
    paths: Sequence[str],
    out_path: str,
) -> None:
    """Write ALL predictions into one npz (stacked arrays + source paths).

    The survey-scale alternative to :func:`write_npz_outputs` (the
    reference writes one file per spectrum, ``/root/reference/main.py:
    94-98`` — millions of files at production scale). Keys match the
    per-spectrum schema stacked along axis 0, plus ``paths`` — including
    the reference's ``(nh, 1)`` column shape for ``hmean``, so
    ``r["hmean"][i]`` is exactly what the per-file layout stores.
    """
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(
        out_path,
        ll=np.asarray(result.ll, np.float32),
        hmean=np.asarray(result.hmean, np.float32)[..., None],
        hcov=np.asarray(result.hcov, np.float32),
        cont=np.asarray(result.continuum, np.float32),
        uncertainty=np.asarray(result.continuum_std, np.float32),
        paths=np.asarray([os.path.basename(str(p)) for p in paths]),
    )


def sample_posterior_continua(
    params: QFAParams,
    mu: Array,
    result: PredictResult,
    key: jax.Array,
    n_samples: int,
) -> Array:
    """Draw continuum realizations from the latent posterior.

    ``h ~ N(hmean, hcov)`` per spectrum, mapped through ``F h + mu`` — the
    library form of the reference notebook's posterior sampling cell
    (``nb/predict.ipynb`` cell 11, via np.random.multivariate_normal).

    Returns shape ``(n_samples, B, Npix)``.
    """
    chol = jnp.linalg.cholesky(result.hcov)  # (B, Nh, Nh)
    eps = jax.random.normal(
        key, (n_samples,) + result.hmean.shape, result.hmean.dtype
    )
    hp = jax.lax.Precision.HIGHEST
    h = result.hmean + jnp.einsum("bij,sbj->sbi", chol, eps, precision=hp)
    return jnp.einsum("sbh,ph->sbp", h, params.F, precision=hp) + mu


def ood_scores(result: PredictResult, n_obs: np.ndarray | None = None) -> np.ndarray:
    """Out-of-distribution score per spectrum.

    The marginal NLL is the reference's OOD statistic (``README.md:18-19`` of
    the reference); optionally normalized per observed pixel so spectra with
    different masking are comparable.
    """
    ll = np.asarray(result.ll)
    if n_obs is None:
        return ll
    return ll / np.maximum(np.asarray(n_obs), 1.0)


def select_ood(
    result: PredictResult,
    *,
    top_k: int | None = None,
    quantile: float | None = None,
    n_obs: np.ndarray | None = None,
) -> np.ndarray:
    """OOD selection pass: indices of the most anomalous spectra.

    Rank spectra by (per-pixel-normalized) NLL descending and return either
    the ``top_k`` indices or everything above the given score ``quantile``.
    """
    scores = ood_scores(result, n_obs)
    order = np.argsort(-scores)
    if top_k is not None:
        return order[:top_k]
    if quantile is not None:
        cut = np.quantile(scores, quantile)
        return order[: int(np.sum(scores >= cut))]
    return order
