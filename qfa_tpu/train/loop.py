"""Training loop: jit-compiled epoch steps over a device-resident dataset.

The reference's epoch (``/root/reference/QFA/model.py:183-231``) is a Python
loop that crosses the host->device boundary per batch and runs a Python loop
per spectrum. Here one epoch is a single compiled program:

    lax.scan over shuffled batch indices
      -> gather batch from the resident dataset
      -> value_and_grad of the masked likelihood (whole batch at once)
      -> reference-normalized gradients -> Adam update -> clip

Epoch-boundary behaviors (per-epoch Adam counter, periodic smoothing and
checkpointing, negative-loss early stop) live in the outer Python loop, as
they do in the reference.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..data.batch import SpectraBatch
from ..data.loader import ResidualDataset, batch_indices
from ..models.params import (
    DEFAULT_BOUNDS,
    ParamBounds,
    QFAParams,
    clip_params,
    save_npz,
    smooth_params,
)
from ..models.qfa import ModelOptions, loss_and_grads
from . import adam

Array = jnp.ndarray

__all__ = [
    "TrainConfig",
    "TrainState",
    "train_epoch",
    "fit",
    "fit_streaming",
    "make_ckpt_saver",
    "make_epoch_fn",
    "make_sliced_epoch_fn",
    "make_step_fn",
    "make_val_fn",
    "reshuffle_dataset",
    "guard_nonfinite",
]


def guard_nonfinite(new_state, old_state, loss):
    """Failure detection: reject an update that produced non-finite values.

    Returns the new state when the loss and every new parameter are finite,
    otherwise the old state (the optimizer moments are rolled back too, so a
    poisoned batch leaves no trace). All-elementwise — fuses into the update.
    """
    ok = jnp.isfinite(loss)
    for leaf in jax.tree.leaves(new_state.params):
        ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(leaf)))
    guarded = jax.tree.map(
        lambda n, o: jnp.where(ok, n, o), new_state, old_state
    )
    return guarded, ok


@dataclass(frozen=True)
class TrainConfig:
    """Static training configuration."""

    n_epochs: int = 500
    batch_size: int = 500
    learning_rate: float = 1e-3
    weight_decay: float = 0.1
    decay_alpha: float = 0.9
    decay_step: int = 10
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    smooth_interval: int = 5
    save_interval: int = 5
    reference_norm: bool = True  #: per-element nonzero-count grad averaging.
    stop_on_negative_loss: bool = True
    reject_nonfinite: bool = True  #: skip updates whose loss/params go NaN/Inf.
    options: ModelOptions = ModelOptions()
    bounds: ParamBounds = DEFAULT_BOUNDS

    def adam_config(self) -> adam.AdamConfig:
        return adam.AdamConfig(
            learning_rate=self.learning_rate,
            b1=self.b1,
            b2=self.b2,
            eps=self.eps,
            weight_decay=self.weight_decay,
            decay_alpha=self.decay_alpha,
            decay_step=self.decay_step,
        )


@jax.tree_util.register_pytree_node_class
@dataclass
class TrainState:
    """Mutable training state (a pytree: donate/jit/shard freely)."""

    params: QFAParams
    opt_state: adam.AdamState

    def tree_flatten(self):
        return (self.params, self.opt_state), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def make_step_fn(config: TrainConfig):
    """Single jitted training step ``(state, batch) -> (state, loss)``.

    Used by the streaming path (datasets larger than HBM) where batches
    arrive from a host prefetch queue instead of a device-resident scan.
    """
    adam_cfg = config.adam_config()

    @partial(jax.jit, donate_argnums=(0,))
    def step_fn(state: TrainState, batch):
        loss, grads = loss_and_grads(
            state.params, batch, config.options,
            reference_norm=config.reference_norm,
        )
        new_params, new_opt = adam.apply_update(
            state.params, grads, state.opt_state, adam_cfg
        )
        new_params = clip_params(new_params, config.bounds)
        new_state = TrainState(new_params, new_opt)
        if config.reject_nonfinite:
            new_state, _ok = guard_nonfinite(new_state, state, loss)
        return new_state, loss

    return step_fn


def make_ckpt_saver(output_dir: str, mu, save_full_state: bool) -> Callable:
    """Epoch-checkpoint writer shared by both trainers (fit, fit_streaming):
    the reference npz cadence/naming
    (``/root/reference/QFA/model.py:230-231``) plus an optional full-state
    snapshot (params + Adam moments + epoch) for exact resume."""

    def _save(state, ckpt):
        save_npz(
            f"{output_dir}/checkpoints/model_parameters_epoch_{ckpt:02d}.npz",
            state.params,
            mu,
        )
        if save_full_state:
            from .checkpoint import save_state

            save_state(
                f"{output_dir}/checkpoints/state_epoch_{ckpt:02d}.npz",
                state,
                mu,
            )

    return _save


def make_val_fn(val_data: ResidualDataset | None, options) -> Callable | None:
    """Held-out validation evaluator ``params -> mean NLL`` (or None).

    The batch is a jit ARGUMENT, never a closed-over constant, so the
    validation set is not baked into the compiled program. Shared by
    ``fit`` and ``fit_streaming``.
    """
    if val_data is None:
        return None
    from ..data.batch import SpectraBatch
    from ..models.qfa import mean_nll

    from ..data.loader import as_f32

    val_batch = SpectraBatch(
        delta=as_f32(val_data.delta),
        error=as_f32(val_data.error),
        zabs=as_f32(val_data.zabs),
        mask=val_data.mask,
        weight=jnp.ones((val_data.size,), jnp.float32),
    )
    _val_nll = jax.jit(lambda p, b: mean_nll(p, b, options))

    def val_fn(p):
        return _val_nll(p, val_batch)

    return val_fn


def fit_streaming(
    params: QFAParams,
    host_data,
    mu,
    config: TrainConfig,
    *,
    seed: int = 0,
    logger: logging.Logger | None = None,
    prefetch: int = 2,
    sharding=None,
    step_fn=None,
    output_dir: str | None = None,
    val_data: ResidualDataset | None = None,
    initial_state: TrainState | None = None,
    metrics_cb: Callable[[int, float, float], None] | None = None,
    save_full_state: bool = True,
) -> tuple[QFAParams, list]:
    """Training from host RAM with asynchronous batch prefetch.

    First-class peer of :func:`fit` — same epoch-boundary semantics
    (smoothing, early stop), same checkpointing (reference npz + full-state
    snapshots every ``save_interval``), held-out validation and full-state
    resume via ``initial_state`` — for residual datasets larger than HBM
    (``host_data`` is a ``qfa_tpu.data.streaming.HostResiduals``). The tail
    batch trains with weight-0 padding. Per-epoch shuffles are seeded by
    ``seed + epoch``, so a resumed run continues the exact uninterrupted
    trajectory. ``step_fn`` may override the update step (default
    :func:`make_step_fn`).
    """
    from ..data.streaming import stream_batches

    state = (
        initial_state
        if initial_state is not None
        else TrainState(params, adam.init(params))
    )
    start_epoch = int(jax.device_get(state.opt_state.epoch))
    if step_fn is None:
        step_fn = make_step_fn(config)
    history: list = []
    niter = max(host_data.size // config.batch_size, 1)

    val_fn = make_val_fn(val_data, config.options)

    _save = make_ckpt_saver(output_dir, mu, save_full_state)

    for epoch in range(start_epoch, config.n_epochs):
        rng = np.random.default_rng(seed + epoch)
        t0 = time.perf_counter()
        losses = []
        for batch in stream_batches(
            host_data, config.batch_size, rng, prefetch=prefetch,
            sharding=sharding,
        ):
            state, loss = step_fn(state, batch)
            losses.append(loss)
        # reference epoch-loss bookkeeping: sum of batch means / floor(N/B)
        epoch_loss = float(jnp.sum(jnp.stack(losses))) / niter
        dt = time.perf_counter() - t0
        history.append(epoch_loss)
        val_loss = None
        if val_fn is not None:
            val_loss = float(val_fn(jax.device_get(state.params)))
        msg = (
            f"epoch: {epoch:03d}/{config.n_epochs:03d}  ;  "
            f"loss:  {epoch_loss:.2f}  ;  time:  {dt:.2f} s"
        )
        if val_loss is not None:
            msg += f"  ;  val_loss:  {val_loss:.2f}"
        if logger is not None:
            logger.info(msg)
        if metrics_cb is not None:
            metrics_cb(epoch, epoch_loss, dt)
        state = TrainState(state.params, adam.next_epoch(state.opt_state))
        ckpt = epoch + 1
        if config.stop_on_negative_loss and epoch_loss < 0.0:
            state = TrainState(smooth_params(state.params), state.opt_state)
            if output_dir:
                _save(state, ckpt)
            break
        if ckpt % config.smooth_interval == 0:
            state = TrainState(smooth_params(state.params), state.opt_state)
        if output_dir and ckpt % config.save_interval == 0:
            _save(state, ckpt)
    return state.params, history


def make_epoch_fn(
    config: TrainConfig,
) -> Callable[..., tuple[TrainState, Array]]:
    """Build the jitted one-epoch function: scan of batch updates.

    The returned function has signature ``(state, data, idx, wt=None) ->
    (state, epoch_loss)`` where ``idx`` is the (n_batches, batch_size)
    shuffled index matrix for this epoch and ``wt`` the optional matching
    weight matrix (0 on tail-batch pad entries, see
    ``data.loader.epoch_indices``).

    ``epoch_loss`` follows the reference's bookkeeping: the sum of batch
    mean-losses divided by ``data_size // batch_size``
    (``/root/reference/QFA/model.py:206-213`` — the tail batch adds its
    mean on top, so with a tail the "mean" can exceed a true average).
    """
    adam_cfg = config.adam_config()
    step = _make_batch_step(config, adam_cfg)

    @partial(jax.jit, donate_argnums=(0,))
    def epoch_fn(
        state: TrainState, data: ResidualDataset, idx: Array, wt=None
    ):
        def batch_step(carry: TrainState, xs):
            if wt is None:
                batch = data.gather(xs)
            else:
                batch = data.gather(xs[0], xs[1])
            return step(carry, batch)

        xs = idx if wt is None else (idx, wt)
        state, losses = jax.lax.scan(batch_step, state, xs)
        niter = max(data.delta.shape[0] // config.batch_size, 1)
        return (
            TrainState(state.params, adam.next_epoch(state.opt_state)),
            jnp.sum(losses) / niter,
        )

    return epoch_fn


def _make_batch_step(config: TrainConfig, adam_cfg):
    def step(carry: TrainState, batch):
        loss, grads = loss_and_grads(
            carry.params,
            batch,
            config.options,
            reference_norm=config.reference_norm,
        )
        new_params, new_opt = adam.apply_update(
            carry.params, grads, carry.opt_state, adam_cfg
        )
        new_params = clip_params(new_params, config.bounds)
        new_state = TrainState(new_params, new_opt)
        if config.reject_nonfinite:
            new_state, _ok = guard_nonfinite(new_state, carry, loss)
        return new_state, loss

    return step


def _reshuffle_impl(data: ResidualDataset, key: jax.Array) -> ResidualDataset:
    perm = jax.random.permutation(key, data.delta.shape[0])
    return jax.tree.map(lambda x: jnp.take(x, perm, axis=0), data)


_reshuffle_donating = partial(jax.jit, donate_argnums=(0,))(_reshuffle_impl)
_reshuffle_copying = jax.jit(_reshuffle_impl)


def reshuffle_dataset(
    data: ResidualDataset, key: jax.Array, *, donate: bool = True
) -> ResidualDataset:
    """Physically permute the resident dataset.

    ``donate=True`` (default) consumes the old buffers — never reuse
    arrays passed in; pass ``donate=False`` to keep the caller's buffers
    valid (one extra copy). Used by the sliced epoch mode: shuffle the
    data occasionally, serve batches as contiguous slices in between.
    """
    fn = _reshuffle_donating if donate else _reshuffle_copying
    return fn(data, key)


def make_sliced_epoch_fn(
    config: TrainConfig,
) -> Callable[[TrainState, ResidualDataset, Array], tuple[TrainState, Array]]:
    """Epoch function serving batches as contiguous slices (zero-copy).

    A random batch gather makes XLA materialize the gathered rows; a
    ``dynamic_slice`` instead fuses into the first consumer — no copy. Composition of batches is fixed
    between physical reshuffles (:func:`reshuffle_dataset`); shuffle order
    of the batches is still randomized every epoch via ``offsets``.

    Signature: ``(state, data, offsets) -> (state, mean_loss)`` with
    ``offsets`` a (n_batches,) int32 array of row offsets (multiples of the
    batch size, permuted).
    """
    adam_cfg = config.adam_config()
    step = _make_batch_step(config, adam_cfg)
    b = config.batch_size

    @partial(jax.jit, donate_argnums=(0,))
    def epoch_fn(state: TrainState, data: ResidualDataset, offsets: Array):
        from ..data.loader import as_f32

        weight = jnp.ones((b,), jnp.float32)

        def batch_step(carry: TrainState, off):
            sl = lambda x: jax.lax.dynamic_slice_in_dim(x, off, b, axis=0)
            # bf16-stored planes (capacity mode) are cast to f32 per slice
            batch = SpectraBatch(
                delta=as_f32(sl(data.delta)),
                error=as_f32(sl(data.error)),
                zabs=as_f32(sl(data.zabs)),
                mask=sl(data.mask),
                weight=weight,
            )
            return step(carry, batch)

        state, losses = jax.lax.scan(batch_step, state, offsets)
        return (
            TrainState(state.params, adam.next_epoch(state.opt_state)),
            jnp.mean(losses),
        )

    return epoch_fn


def train_epoch(
    state: TrainState,
    data: ResidualDataset,
    key: jax.Array,
    config: TrainConfig,
    epoch_fn=None,
) -> tuple[TrainState, float]:
    """Run one shuffled epoch (tail batch included); returns (state, loss)."""
    from ..data.loader import epoch_indices

    if epoch_fn is None:
        epoch_fn = make_epoch_fn(config)
    if data.size % config.batch_size:
        ei = epoch_indices(key, data.size, config.batch_size)
        state, loss = epoch_fn(state, data, ei.idx, ei.weight)
    else:
        idx = batch_indices(key, data.size, config.batch_size)
        state, loss = epoch_fn(state, data, idx)
    return state, float(loss)


def fit(
    params: QFAParams,
    data: ResidualDataset,
    mu,
    config: TrainConfig,
    *,
    key: jax.Array | None = None,
    output_dir: str | None = None,
    logger: logging.Logger | None = None,
    metrics_cb: Callable[[int, float, float], None] | None = None,
    val_data: ResidualDataset | None = None,
    mesh=None,
    initial_state: TrainState | None = None,
    save_full_state: bool = True,
) -> tuple[QFAParams, list]:
    """Full training run with reference epoch-boundary semantics.

    Smoothing every ``smooth_interval`` epochs, checkpoints every
    ``save_interval`` epochs (reference npz schema plus — when
    ``save_full_state`` — a full-state snapshot with the Adam moments and
    epoch counter, see ``train.checkpoint``), early stop when the epoch
    loss goes negative (then smooth + save + break,
    ``/root/reference/QFA/model.py:222-231``).

    ``mesh``: optional ``jax.sharding.Mesh`` — the epoch runs data-parallel
    (``parallel.dp``): the resident dataset is sharded over the spectrum
    axis (padded with zero-weight rows up to a device multiple), parameters
    stay replicated, one gradient/count psum per step.

    ``initial_state``: resume from a full :class:`TrainState` (params +
    Adam moments + epoch counter); training continues at the stored epoch
    with the exact uninterrupted trajectory (per-epoch shuffle keys are
    ``fold_in(key, epoch)``, so they do not depend on how many epochs this
    process already ran).

    ``val_data``: optional held-out set evaluated (mean NLL) after every
    epoch. NOTE: the reference merely concatenates its "validation" spectra
    into the training arrays (``/root/reference/QFA/dataloader.py:81-85``);
    here validation is an actual held-out evaluation.

    Returns (final params, per-epoch loss history for epochs run here).
    """
    key = jax.random.key(0) if key is None else key
    state = (
        initial_state
        if initial_state is not None
        else TrainState(params, adam.init(params))
    )
    start_epoch = int(jax.device_get(state.opt_state.epoch))
    history: list = []

    if mesh is not None:
        from ..parallel.dp import (
            make_dp_epoch_fn,
            shard_dataset,
            shard_epoch_indices,
        )

        ndev = mesh.devices.size
        n_real = data.size
        if config.batch_size % ndev:
            raise ValueError(
                f"batch size {config.batch_size} not divisible by the "
                f"{ndev}-device mesh"
            )
        if n_real % ndev:
            pad = ndev - n_real % ndev
            data = ResidualDataset(
                *(
                    jnp.concatenate(
                        [leaf, jnp.zeros((pad,) + leaf.shape[1:], leaf.dtype)]
                    )
                    for leaf in data
                )
            )
        data = shard_dataset(data, mesh)
        dp_epoch_fn = make_dp_epoch_fn(config, mesh, n_real=n_real)

        def run_epoch(state, sub):
            ei = shard_epoch_indices(
                sub, data.size, config.batch_size, mesh, n_real=n_real
            )
            state, loss = dp_epoch_fn(state, data, ei)
            return state, float(loss)

    else:
        epoch_fn = make_epoch_fn(config)

        def run_epoch(state, sub):
            return train_epoch(state, data, sub, config, epoch_fn)

    val_fn = make_val_fn(val_data, config.options)

    _save = make_ckpt_saver(output_dir, mu, save_full_state)

    for epoch in range(start_epoch, config.n_epochs):
        sub = jax.random.fold_in(key, epoch)
        t0 = time.perf_counter()
        state, loss = run_epoch(state, sub)
        dt = time.perf_counter() - t0
        history.append(loss)
        val_loss = None
        if val_fn is not None:
            val_loss = float(val_fn(jax.device_get(state.params)))
        msg = (
            f"epoch: {epoch:03d}/{config.n_epochs:03d}  ;  "
            f"loss:  {loss:.2f}  ;  time:  {dt:.2f} s"
        )
        if val_loss is not None:
            msg += f"  ;  val_loss:  {val_loss:.2f}"
        if logger is not None:
            logger.info(msg)
        if metrics_cb is not None:
            metrics_cb(epoch, loss, dt)

        ckpt = epoch + 1
        if config.stop_on_negative_loss and loss < 0.0:
            state.params = smooth_params(state.params)
            if output_dir:
                _save(state, ckpt)
            break
        if ckpt % config.smooth_interval == 0:
            state.params = smooth_params(state.params)
        if output_dir and ckpt % config.save_interval == 0:
            _save(state, ckpt)

    return state.params, history
