"""Multi-device prediction: shard the spectrum axis over a device mesh.

The reference's predict path is a sequential per-spectrum host loop
(``/root/reference/main.py:86-100`` calling
``/root/reference/QFA/model.py:160-180``); it has no distributed support
of any kind (SURVEY.md §2 "parallelism components"). Here the batched
predictor (:func:`qfa_tpu.models.predict`) runs SPMD over a 1-D data
mesh: the model is tiny and replicated, the ``(N, Npix)`` planes are
sharded over the batch axis, and every device runs the same program on
its local shard. Prediction has no cross-spectrum coupling, so there is
**no collective at all** — per-spectrum outputs come back sharded along the
batch axis, and each matches the single-device result to float32 rounding
(pinned by ``tests/test_parallel.py``).
"""

from __future__ import annotations

import functools

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ..models.qfa import ModelOptions, PredictResult, predict

__all__ = ["make_dp_predict_fn"]


@functools.lru_cache(maxsize=16)
def make_dp_predict_fn(
    mesh: Mesh,
    *,
    options: ModelOptions = ModelOptions(),
    has_mask: bool = True,
    compact: bool = False,
    stats_only: bool = False,
):
    """Build the jitted SPMD prediction step for ``mesh``.

    Returns ``fn(params, mu, flux, error, zabs, [mask], [loglam]) ->
    PredictResult`` with ``flux``/``error``/``zabs`` (and ``mask``)
    sharded over the mesh's first axis and ``params``/``mu``/``loglam``
    replicated. ``has_mask=False`` derives the mask from ``error > 0`` and
    ``compact=True`` takes the ``log1p(zqso)`` column plus the ``loglam``
    row in place of the zabs plane (the compact input of
    :func:`~qfa_tpu.models.predict`). ``stats_only`` returns ``ll``,
    ``hmean`` and ``hcov`` only. ``N`` must divide evenly over the mesh.
    Cached per (mesh, statics).
    """
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"make_dp_predict_fn shards over a 1-D data mesh; got axes "
            f"{mesh.axis_names}"
        )
    axis = mesh.axis_names[0]

    def local_predict(params, mu, flux, error, zabs, *rest):
        rest = list(rest)
        mask = rest.pop(0) if has_mask else None
        loglam = rest.pop(0) if compact else None
        return predict(
            params, mu, flux, error, zabs, mask, options,
            stats_only=stats_only, loglam=loglam,
        )

    rep, row = P(), P(axis, None)
    in_specs = (
        rep, rep, row, row, P(axis) if compact else row,
        *([row] if has_mask else []),
        *([rep] if compact else []),
    )
    out_specs = PredictResult(
        ll=P(axis), hmean=row, hcov=P(axis, None, None),
        continuum=None if stats_only else row,
        continuum_std=None if stats_only else row,
    )
    return jax.jit(jax.shard_map(
        local_predict, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    ))
