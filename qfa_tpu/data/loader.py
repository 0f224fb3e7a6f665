"""Data layer: spectra files -> fixed-shape device-resident tensors.

Replaces the reference's host-side loader
(``/root/reference/QFA/dataloader.py``) with a device-resident design:

* npz spectra are read concurrently (thread pool — ``np.load`` is
  IO-bound) into **fixed padded (N, Npix) buffers with masks**; missing
  pixels (sentinel ``-999.``) become ``mask = 0`` with sanitized flux/error.
* the residual field ``delta = flux - mu * exp(-tau_total)`` is computed
  **once** on device for the whole dataset (the reference recomputes it on
  the host for every batch of every epoch,
  ``/root/reference/QFA/dataloader.py:135``).
* epoch shuffling is a ``jax.random.permutation`` of indices; batches are
  gathered on device — zero host->device traffic in steady state
  ("resident" mode). A streaming iterator is provided for datasets larger
  than device memory.

Catalog semantics (snr/z/num_mask filtering, sampling with replacement when
the selection is too small, train-catalog dump) mirror
``/root/reference/QFA/dataloader.py:47-55``.
"""

from __future__ import annotations

import csv
import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..physics.smoothing import smooth_curve
from ..physics.tau import tau_total
from .batch import SpectraBatch
from .grid import WavelengthGrid

Array = jnp.ndarray

MISSING = -999.0

__all__ = [
    "MISSING",
    "SpectraDataset",
    "read_spectrum",
    "read_spectra",
    "select_from_catalog",
    "validation_concat_paths",
    "read_predict_catalog",
    "compute_taus",
    "estimate_mu",
    "make_residuals",
    "ResidualDataset",
    "as_f32",
    "bf16_planes",
    "batch_indices",
    "EpochIndices",
    "epoch_indices",
]


def read_spectrum(
    path: str,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, float, np.ndarray]:
    """Load one spectrum npz (keys ``flux, error, z``) and derive its mask.

    Missing pixels are flagged with the ``-999.`` sentinel in either flux or
    error (``/root/reference/QFA/dataloader.py:24-28``); they are masked and
    sanitized to 0 so no sentinel value can leak into device arithmetic.

    The raw ``flux != -999`` indicator (``flux_ok``) is kept separately
    because the reference's mu-estimate denominator counts exactly that —
    including pixels masked only through ``error``
    (``/root/reference/QFA/dataloader.py:111``).
    """
    with np.load(path) as f:
        flux = np.asarray(f["flux"], np.float32)
        error = np.asarray(f["error"], np.float32)
        z = float(f["z"])
    flux_ok = flux != MISSING
    mask = flux_ok & (error != MISSING)
    flux = np.where(mask, flux, 0.0).astype(np.float32)
    error = np.where(mask, error, 0.0).astype(np.float32)
    return flux, error, mask, z, flux_ok


def read_spectra(
    paths: Sequence[str], max_workers: int = 16, engine: str = "auto"
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Read many spectra concurrently into stacked arrays.

    Returns (flux, error, mask, zqso, flux_ok) with shapes (N, Npix) x3,
    (N,), (N, Npix); ``flux_ok`` is the raw flux-non-sentinel indicator
    needed for exact reference mu semantics (see :func:`read_spectrum`).

    ``engine``: ``"native"`` uses the C++ thread-pool reader
    (``qfa_tpu.native``, ~6x faster, parses the zip containers directly into
    the output buffers), ``"python"`` the ThreadPoolExecutor + np.load path,
    ``"auto"`` prefers native with silent fallback.
    """
    if engine not in ("auto", "native", "python"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine in ("auto", "native") and paths:
        from .. import native

        if native.native_available():
            with np.load(paths[0]) as probe:
                npix = int(probe["flux"].shape[0])
            return native.read_spectra_native(paths, npix, max_workers)
        if engine == "native":
            raise RuntimeError("native reader requested but unavailable")
    from ..utils.progress import progress

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        rows = list(
            progress(
                pool.map(read_spectrum, paths),
                desc="reading spectra",
                total=len(paths),
            )
        )
    flux = np.stack([r[0] for r in rows])
    error = np.stack([r[1] for r in rows])
    mask = np.stack([r[2] for r in rows])
    z = np.array([r[3] for r in rows], np.float32)
    flux_ok = np.stack([r[4] for r in rows])
    return flux, error, mask, z, flux_ok


def select_from_catalog(
    catalog_csv: str,
    data_dir: str,
    num: int,
    *,
    snr_min: float = 2.0,
    snr_max: float = 100.0,
    z_min: float = 2.0,
    z_max: float = 3.5,
    num_mask: int = 0,
    seed: int | None = None,
    output_dir: str | None = None,
    prefix: str = "train",
) -> list[str]:
    """Filter a catalog CSV and sample ``num`` file paths.

    The catalog must provide columns ``file, snr, z, num_mask``. Sampling is
    with replacement when fewer than ``num`` rows survive the cut (reference
    behavior). If ``output_dir`` is given, the chosen file list is written to
    ``{prefix}-catalog.csv`` for reproducibility.
    """
    with open(catalog_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    if rows:
        missing = {"file", "snr", "z", "num_mask"} - set(rows[0])
        if missing:
            raise ValueError(
                f"catalog {catalog_csv!r} lacks the column(s) "
                f"{sorted(missing)} (needs file, snr, z, num_mask)"
            )

    def value(text: str | None) -> float:
        # an empty cell fails every cut (it is NaN)
        return float(text) if text and text.strip() else float("nan")

    pool = np.asarray(
        [
            r["file"]
            for r in rows
            if snr_min <= value(r["snr"]) <= snr_max
            and z_min <= value(r["z"]) <= z_max
            and value(r["num_mask"]) <= num_mask
        ],
        dtype=object,
    )
    if len(pool) == 0:
        raise ValueError("catalog selection is empty — relax the cuts")
    rng = np.random.default_rng(seed)
    files = rng.choice(pool, size=num, replace=len(pool) < num)
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        with open(
            os.path.join(output_dir, f"{prefix}-catalog.csv"), "w", newline=""
        ) as f:
            csv.writer(f).writerows([name] for name in files)
    return [os.path.join(data_dir, f) for f in files]


def validation_concat_paths(
    data_cfg, seed: int, *, output_dir: str | None = None
) -> list[str] | None:
    """Reference-parity training-set composition under
    ``DATA.VALIDATION_CONCAT_COMPAT``: the extra validation paths to
    concatenate into the training list, or ``None`` when the compat
    behavior is off.

    The reference loader concatenates the validation spectra into the
    training arrays before mu estimation — trained on, never evaluated
    (``/root/reference/QFA/dataloader.py:81-85``). When the flag is ON but
    the validation catalog or directory is missing this RAISES instead of
    silently degrading to the held-out composition. That is a deliberate
    deviation, not parity: the reference gates the concat on
    ``os.path.exists`` and silently skips a missing validation file
    (``/root/reference/QFA/dataloader.py:81``) — this repo refuses that
    silent divergence because the flag's whole purpose is exact
    training-set composition.
    """
    if not getattr(data_cfg, "VALIDATION_CONCAT_COMPAT", False):
        return None
    if not getattr(data_cfg, "VALIDATION", False):
        # The reference only concatenates when DATA.VALIDATION is on
        # (/root/reference/QFA/dataloader.py:81) — but silently ignoring
        # the compat flag would contradict its fail-loudly contract, so
        # the contradictory config is an error, not a no-op.
        raise ValueError(
            "DATA.VALIDATION_CONCAT_COMPAT requires DATA.VALIDATION: the "
            "reference gates the concat on DATA.VALIDATION "
            "(/root/reference/QFA/dataloader.py:81); enable both, or drop "
            "the compat flag for the held-out composition"
        )
    for what, path in (("catalog", data_cfg.VALIDATION_CATALOG),
                       ("directory", data_cfg.VALIDATION_DIR)):
        if not path or not os.path.exists(path):
            raise FileNotFoundError(
                "DATA.VALIDATION_CONCAT_COMPAT is on but the validation "
                f"{what} {path!r} does not exist — refusing to silently "
                "fall back to the held-out composition (the flag requests "
                "the reference's exact training-set composition, "
                "/root/reference/QFA/dataloader.py:81-85)"
            )
    return list(select_from_catalog(
        data_cfg.VALIDATION_CATALOG,
        data_cfg.VALIDATION_DIR,
        data_cfg.VALIDATION_NUM,
        snr_min=data_cfg.SNR_MIN,
        snr_max=data_cfg.SNR_MAX,
        z_min=data_cfg.Z_MIN,
        z_max=data_cfg.Z_MAX,
        num_mask=data_cfg.NUM_MASK,
        seed=seed + 1,
        output_dir=output_dir,
        prefix="validation",
    ))


def read_predict_catalog(catalog: str, data_dir: str) -> list[str]:
    """Read a predict-mode catalog (plain file list) into spectrum paths,
    sniffing an accidental header row.

    The reference reads the predict catalog with pandas' DEFAULT header
    (``/root/reference/QFA/dataloader.py:88-91``), so the first line of a
    headerless file list is consumed as a column name and that spectrum
    silently skipped. Here every row is kept (the first field of each
    non-blank CSV row is a file name) — but a
    catalog ported from a reference workflow may carry a real header
    line, which would otherwise gain a bogus first "file". Detection: if
    the first row's resolved path does not exist while some later row's
    does AND the row does not look like a filename at all (no
    dot-suffix anywhere in its basename and no path separator — header
    tokens are words like ``file`` or ``spec_path``), it is a header —
    dropped with a warning. A missing-but-path-like first row (e.g. a
    deleted ``.npz`` or ``.fits.gz``) instead RAISES: silently dropping
    a real spectrum would misalign every downstream output against the
    user's catalog (see MIGRATION.md behavioral difference 6).
    """
    import warnings

    with open(catalog, newline="") as f:
        files = [row[0] for row in csv.reader(f) if row and row[0].strip()]
    paths = [os.path.join(data_dir, str(f)) for f in files]
    if (
        len(paths) > 1
        and not os.path.exists(paths[0])
        and any(os.path.exists(p) for p in paths[1:])
    ):
        first = str(files[0])
        # Any dot-suffix (covers .npz, .fits.gz, .fz, … — an extension
        # whitelist would silently drop a missing real spectrum with an
        # unlisted suffix) or a path separator marks the row as a
        # filename, not a header token.
        if "." in os.path.basename(first) or "/" in first or os.sep in first:
            raise FileNotFoundError(
                f"predict catalog {catalog!r}: first row {files[0]!r} "
                "looks like a spectrum file but does not exist (later "
                "rows do) — refusing to sniff it away as a header line; "
                "fix the path or remove the row"
            )
        warnings.warn(
            f"predict catalog {catalog!r}: first row {files[0]!r} is not "
            "an existing spectrum file but later rows are — treating it "
            "as a header line and skipping it (the reference's "
            "pd.read_csv default header would have consumed it too; see "
            "MIGRATION.md)",
            stacklevel=2,
        )
        paths = paths[1:]
    return paths


class SpectraDataset(NamedTuple):
    """Host-side dataset of observed spectra on the common grid."""

    flux: np.ndarray  #: (N, Npix) float32, 0 where masked.
    error: np.ndarray  #: (N, Npix) float32, 0 where masked.
    mask: np.ndarray  #: (N, Npix) bool.
    zqso: np.ndarray  #: (N,) float32.
    paths: tuple  #: file names (may be empty for synthetic data).
    flux_ok: np.ndarray | None = None  #: (N, Npix) bool, raw flux != -999.

    @property
    def size(self) -> int:
        return self.flux.shape[0]

    @property
    def npix(self) -> int:
        return self.flux.shape[1]

    @classmethod
    def from_paths(cls, paths: Sequence[str], max_workers: int = 16
                   ) -> "SpectraDataset":
        flux, error, mask, z, flux_ok = read_spectra(paths, max_workers)
        return cls(flux=flux, error=error, mask=mask, zqso=z,
                   paths=tuple(paths), flux_ok=flux_ok)


def compute_taus(
    grid: WavelengthGrid,
    zqso: np.ndarray,
    *,
    tau_which: str = "becker",
    chunk: int = 32768,
) -> np.ndarray:
    """``tau_total`` over the blue grid for every spectrum, (N, Nb) float32.

    Computed in ``chunk``-row pieces pulled straight back to host so the
    accelerator never holds more than one chunk of temporaries — the
    full-survey (N, Nb) evaluation would otherwise exhaust device memory at
    exactly the beyond-device-memory scales the streaming path exists for. The result is shared
    by :func:`estimate_mu` and :func:`make_residuals` (pass it as ``taus``)
    instead of being recomputed by each.
    """
    n = len(zqso)
    wav = jnp.asarray(grid.wav)
    out = np.empty((n, grid.nb), np.float32)
    for s in range(0, n, chunk):
        z = jnp.asarray(np.asarray(zqso[s : s + chunk], np.float32))
        out[s : s + len(z)] = np.asarray(
            tau_total(wav, z, which=tau_which), np.float32
        )
    return out


def estimate_mu(
    dataset: SpectraDataset,
    grid: WavelengthGrid,
    *,
    tau_which: str = "becker",
    window: int = 16,
    compat_denominator: bool = True,
    taus: np.ndarray | None = None,
) -> np.ndarray:
    """Data-driven mean continuum estimate.

    Each spectrum is de-absorbed on the blue side (``flux * exp(+tau_total)``)
    and the per-pixel masked average is smoothed
    (``/root/reference/QFA/dataloader.py:110-112``).

    ``compat_denominator=True`` reproduces the reference's denominator
    exactly — the per-pixel count of raw non-sentinel *flux* values
    (``np.sum(flux != -999.)``, ``/root/reference/QFA/dataloader.py:111``),
    which includes pixels masked only through ``error`` and can therefore
    differ from the numerator's full mask (SURVEY.md section 3 quirk 7).
    ``False`` uses the actual mask count. Pixels observed nowhere yield 0
    instead of the reference's NaN.
    """
    if taus is None:
        taus = compute_taus(grid, dataset.zqso, tau_which=tau_which)
    deabsorb = np.concatenate(
        [np.exp(taus), np.ones((dataset.size, grid.nr), np.float32)], axis=1
    )
    num = np.sum(dataset.flux * deabsorb * dataset.mask, axis=0)
    if compat_denominator:
        if dataset.flux_ok is not None:
            den = np.sum(dataset.flux_ok, axis=0).astype(np.float64)
        else:
            # datasets built without the raw indicator (e.g. synthetic):
            # with sanitized buffers flux==0 means masked, so this count
            # differs only for genuinely zero observed flux.
            den = np.sum(dataset.flux != 0.0, axis=0).astype(np.float64)
    else:
        den = np.sum(dataset.mask, axis=0).astype(np.float64)
    mu = np.where(den > 0, num / np.maximum(den, 1.0), 0.0)
    return smooth_curve(mu, window_len=window).astype(np.float32)


class ResidualDataset(NamedTuple):
    """Device-resident training tensors (everything the likelihood needs)."""

    delta: Array  #: (N, Npix)
    error: Array  #: (N, Npix)
    zabs: Array  #: (N, Nb)
    mask: Array  #: (N, Npix) float32

    @property
    def size(self) -> int:
        return self.delta.shape[0]

    def gather(self, idx: Array, weight: Array | None = None) -> SpectraBatch:
        """Assemble a batch by index gather (device-side, jit-safe).

        ``weight`` (optional, (B,)) marks padding rows with 0 — used by the
        tail batch of an epoch, whose pad entries duplicate row 0 but must
        contribute nothing. bfloat16-stored planes (:func:`bf16_planes`
        capacity mode) are cast to f32 here, so every engine computes in
        f32 regardless of the storage dtype.
        """
        return SpectraBatch(
            delta=as_f32(self.delta[idx]),
            error=as_f32(self.error[idx]),
            zabs=as_f32(self.zabs[idx]),
            mask=self.mask[idx],
            weight=jnp.ones(idx.shape, jnp.float32)
            if weight is None
            else weight.astype(jnp.float32),
        )


def as_f32(x: Array) -> Array:
    """Promote bfloat16-STORED arrays (capacity mode) back to f32.

    The single cast rule every trainer shares: storage may be bf16
    (:func:`bf16_planes`), arithmetic is always f32. No-op for any other
    dtype.
    """
    if x.dtype != jnp.bfloat16:
        return x
    return x.astype(jnp.float32)


def bf16_planes(data: ResidualDataset) -> ResidualDataset:
    """Cast the streamed delta/error planes to bfloat16.

    Halves the resident device-memory footprint and per-epoch traffic of
    the two big planes; the trainers cast each batch back to f32
    (:func:`as_f32`), so all arithmetic, moments and the Cholesky chain
    stay f32 — only the STORED data loses mantissa
    (8 bits, ~0.3% relative, far below the spectra's noise level). zabs
    and mask keep their dtype.
    """
    return data._replace(
        delta=data.delta.astype(jnp.bfloat16),
        error=data.error.astype(jnp.bfloat16),
    )


def make_residuals(
    dataset: SpectraDataset,
    grid: WavelengthGrid,
    mu: np.ndarray,
    *,
    tau_which: str = "becker",
    device_put=None,
    taus: np.ndarray | None = None,
) -> ResidualDataset:
    """Compute the training residual field for the whole dataset at once.

    ``delta = flux - mu * exp(-tau_total(lambda, zqso))`` on the blue side,
    ``flux - mu`` on the red side (``/root/reference/QFA/dataloader.py:135``),
    masked pixels zeroed. ``device_put`` may be a function (e.g. a sharded
    ``jax.device_put``) applied to each array. ``taus`` (optional) reuses a
    :func:`compute_taus` result instead of recomputing it.
    """
    if taus is None:
        taus = compute_taus(grid, dataset.zqso, tau_which=tau_which)
    absorb = np.concatenate(
        [np.exp(-taus), np.ones((dataset.size, grid.nr), np.float32)], axis=1
    ).astype(np.float32)
    mask = dataset.mask.astype(np.float32)
    delta = (dataset.flux - np.asarray(mu, np.float32) * absorb) * mask
    zabs = grid.zabs(dataset.zqso).astype(np.float32)
    put = device_put if device_put is not None else jnp.asarray
    return ResidualDataset(
        delta=put(delta.astype(np.float32)),
        error=put(dataset.error),
        zabs=put(zabs),
        mask=put(mask),
    )


def batch_indices(
    key: jax.Array, n: int, batch_size: int, *, drop_remainder: bool = True
) -> Array:
    """Shuffled epoch index matrix of shape (n_batches, batch_size).

    The tail that doesn't fill a batch is dropped when ``drop_remainder``
    (keeps every step the same compiled shape); use :func:`epoch_indices`
    to train the tail batch too (the reference does,
    ``/root/reference/QFA/dataloader.py:132-138``).
    """
    perm = jax.random.permutation(key, n)
    n_batches = n // batch_size
    if not drop_remainder and n % batch_size:
        raise NotImplementedError("use epoch_indices for tail-batch epochs")
    return perm[: n_batches * batch_size].reshape(n_batches, batch_size)


class EpochIndices(NamedTuple):
    """Shuffled epoch indices covering EVERY spectrum.

    The tail batch is padded up to the fixed batch size with weight-0
    duplicate entries, so each compiled step keeps a static shape while the
    partial final batch still trains (reference behavior,
    ``/root/reference/QFA/dataloader.py:132-138``; the round-1 trainer
    silently dropped the remainder).
    """

    idx: Array  #: (n_batches, batch_size) int32 row indices.
    weight: Array  #: (n_batches, batch_size) float32, 0 on pad entries.


def epoch_indices(key: jax.Array, n: int, batch_size: int) -> EpochIndices:
    """Shuffled full-coverage epoch indices (see :class:`EpochIndices`)."""
    perm = jax.random.permutation(key, n)
    n_batches = -(-n // batch_size)
    pad = n_batches * batch_size - n
    idx = jnp.concatenate([perm, jnp.zeros((pad,), perm.dtype)])
    wt = jnp.concatenate(
        [jnp.ones((n,), jnp.float32), jnp.zeros((pad,), jnp.float32)]
    )
    return EpochIndices(
        idx=idx.reshape(n_batches, batch_size),
        weight=wt.reshape(n_batches, batch_size),
    )
