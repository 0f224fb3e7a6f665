"""Exact data-parallel training via ``shard_map``.

Every optimizer step consumes the globally summed gradient, so a run over
any mesh follows the single-device trajectory up to float32 summation
order.

SPMD layout:

* the resident dataset is sharded along the spectrum axis (``P('data')``);
* parameters and optimizer state are replicated (``P()``) — the model is
  tiny, so replicating and all-reducing gradients is the right trade
  (one 18k-85k-parameter psum per step);
* each step, every device gathers a local sub-batch from its own shard,
  computes local gradient sums and contribution counts, and one ``psum``
  over the data axis produces the exact same global normalized gradient the
  single-device path computes — including the reference's per-element
  nonzero-count averaging, which becomes a psum of count arrays
  (SURVEY.md section 5 "distributed backend").

Epoch shuffling is per-shard (each device permutes its own shard), which is
standard data-parallel sampling; the composition of shard assignment +
per-shard permutation is a valid global shuffle for i.i.d. data.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..data.batch import SpectraBatch
from ..data.loader import EpochIndices, ResidualDataset
from ..models.params import clip_params
from ..models.qfa import normalize_with_counts, summed_stats
from ..train import adam
from ..train.loop import TrainConfig, TrainState

Array = jnp.ndarray

__all__ = [
    "shard_dataset",
    "shard_epoch_indices",
    "make_dp_epoch_fn",
    "dp_train_epoch",
]


def shard_dataset(data: ResidualDataset, mesh: Mesh) -> ResidualDataset:
    """Place the resident dataset sharded along the spectrum axis."""
    axis = mesh.axis_names[0]

    def put(x):
        return jax.device_put(
            x, NamedSharding(mesh, P(axis, *([None] * (x.ndim - 1))))
        )

    return ResidualDataset(*(put(leaf) for leaf in data))


def shard_epoch_indices(
    key: jax.Array,
    n: int,
    batch_size: int,
    mesh: Mesh,
    *,
    n_real: int | None = None,
) -> EpochIndices:
    """Per-shard shuffled epoch indices + weights, shapes
    (ndev, n_batches, local_bs) each, sharded over axis 0.

    Index values are LOCAL rows into each device's shard. Weights are 0 on
    tail-batch pad entries and on dataset padding rows: when ``n_real < n``
    (the resident dataset was padded up to a device multiple), global rows
    ``>= n_real`` never contribute. Every real spectrum appears exactly once
    per epoch (the reference trains the tail batch too,
    ``/root/reference/QFA/dataloader.py:132-138``).
    """
    ndev = mesh.devices.size
    if n % ndev:
        raise ValueError(f"dataset size {n} not divisible by {ndev} devices")
    if batch_size % ndev:
        raise ValueError(f"batch size {batch_size} not divisible by {ndev}")
    if n_real is None:
        n_real = n
    shard_n = n // ndev
    local_bs = batch_size // ndev
    n_batches = -(-shard_n // local_bs)
    pad = n_batches * local_bs - shard_n
    keys = jax.random.split(key, ndev)
    perms = jnp.stack([jax.random.permutation(k, shard_n) for k in keys])
    perms = jnp.concatenate(
        [perms, jnp.zeros((ndev, pad), perms.dtype)], axis=1
    )
    # weight 0 for pad entries and for dataset padding rows (global >= n_real)
    shard_starts = (jnp.arange(ndev) * shard_n)[:, None]
    wt = jnp.concatenate(
        [
            (perms[:, :shard_n] + shard_starts < n_real).astype(jnp.float32),
            jnp.zeros((ndev, pad), jnp.float32),
        ],
        axis=1,
    )
    idx = perms.reshape(ndev, n_batches, local_bs)
    wt = wt.reshape(ndev, n_batches, local_bs)
    axis = mesh.axis_names[0]
    spec = NamedSharding(mesh, P(axis, None, None))
    return EpochIndices(
        idx=jax.device_put(idx, spec), weight=jax.device_put(wt, spec)
    )


def make_dp_epoch_fn(
    config: TrainConfig,
    mesh: Mesh,
    *,
    n_real: int | None = None,
) -> Callable:
    """Build the jitted SPMD one-epoch function (one ``lax.scan``).

    Signature: ``(state, data, idx) -> (state, mean_loss)`` with ``data``
    sharded by :func:`shard_dataset` and ``idx`` by
    :func:`shard_epoch_indices`. The state stays replicated; all
    communication is one gradient/count psum per batch.
    """
    adam_cfg = config.adam_config()
    axis = mesh.axis_names[0]
    ndev = mesh.devices.size

    def local_epoch(
        state: TrainState, data: ResidualDataset, ei: EpochIndices
    ):
        # Inside shard_map: data leaves are the local shard, ei leaves are
        # (1, n_batches, local_bs) — drop the unit mesh dim.
        idx = ei.idx[0]
        wts = ei.weight[0]

        def batch_step(carry: TrainState, xs):
            from ..data.loader import as_f32

            b_idx, b_wt = xs
            # bf16-stored planes (capacity mode) are cast to f32 per batch
            batch = SpectraBatch(
                delta=as_f32(data.delta[b_idx]),
                error=as_f32(data.error[b_idx]),
                zabs=as_f32(data.zabs[b_idx]),
                mask=data.mask[b_idx] * b_wt[:, None],
                weight=b_wt.astype(jnp.float32),
            )
            total, batch_n_real, grads, counts = summed_stats(
                carry.params, batch, config.options
            )
            # The one collective of the step: global sums over the data axis.
            # (batch_n_real = real rows in THIS batch; the enclosing n_real
            # parameter is the whole dataset's real row count.)
            total, batch_n_real, grads, counts = jax.lax.psum(
                (total, batch_n_real, grads, counts), axis
            )
            if config.reference_norm:
                grads = normalize_with_counts(grads, counts)
            else:
                grads = jax.tree.map(
                    lambda g: g / jnp.maximum(batch_n_real, 1.0), grads
                )
            new_params, new_opt = adam.apply_update(
                carry.params, grads, carry.opt_state, adam_cfg
            )
            new_params = clip_params(new_params, config.bounds)
            loss = total / jnp.maximum(batch_n_real, 1.0)
            new_state = TrainState(new_params, new_opt)
            if config.reject_nonfinite:
                from ..train.loop import guard_nonfinite

                new_state, _ok = guard_nonfinite(new_state, carry, loss)
            return new_state, loss

        state, losses = jax.lax.scan(batch_step, state, (idx, wts))
        # reference epoch-loss bookkeeping: sum of batch means over
        # floor(N_real / batch_size) (/root/reference/QFA/model.py:206-213).
        # ``n_real`` (when given) is the REAL row count — the resident
        # dataset may carry zero-weight padding up to a device multiple.
        n_total = (
            n_real if n_real is not None else data.delta.shape[0] * ndev
        )
        niter = max(n_total // config.batch_size, 1)
        return (
            TrainState(state.params, adam.next_epoch(state.opt_state)),
            jnp.sum(losses) / niter,
        )

    rep = P()
    sharded = jax.shard_map(
        local_epoch,
        mesh=mesh,
        # prefix specs: replicated state, spectrum-axis-sharded data leaves,
        # device-major epoch indices/weights.
        in_specs=(rep, P(axis, None), P(axis, None, None)),
        out_specs=(rep, rep),
        check_vma=False,
    )
    # Place inputs before the jit sees them (rationale in
    # mesh.jit_with_placed_inputs).
    from .mesh import jit_with_placed_inputs

    return jit_with_placed_inputs(
        sharded, mesh,
        (P(), P(axis, None), P(axis, None, None)),
        donate_argnums=(0,),
    )


def dp_train_epoch(
    state: TrainState,
    data: ResidualDataset,
    key: jax.Array,
    config: TrainConfig,
    mesh: Mesh,
    epoch_fn=None,
) -> tuple[TrainState, float]:
    """Run one data-parallel epoch; returns (state, mean loss)."""
    if epoch_fn is None:
        epoch_fn = make_dp_epoch_fn(config, mesh)
    idx = shard_epoch_indices(key, data.size, config.batch_size, mesh)
    state, loss = epoch_fn(state, data, idx)
    return state, float(loss)
