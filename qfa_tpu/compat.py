"""Reference-API compatibility facade.

Object-oriented shims mirroring the upstream public surface
(``/root/reference/QFA/model.py`` class ``QFA`` and
``/root/reference/QFA/dataloader.py`` class ``Dataloader``) on top of the
functional core, so code written against the reference ports with an
import change. Semantics follow the reference except for its verified bugs
(SURVEY.md section 3): gradients are exact (autodiff), ``load_from_npz``
loads ``c0`` correctly unless ``compat_c0_bug=True``, and resume works.

Arrays in/out are numpy/JAX interchangeably; device placement is implicit
(JAX default device).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .data.batch import SpectraBatch
from .data.grid import make_grid
from .data.loader import (
    ResidualDataset,
    SpectraDataset,
    estimate_mu,
    make_residuals,
    select_from_catalog,
)
from .models import params as params_mod
from .models import qfa as qfa_mod
from .models.params import QFAParams
from .train import TrainConfig, fit as fit_fn

__all__ = ["QFA", "Dataloader", "Adam", "step_scheduler"]


class _StepScheduler:
    """Reference step-decay schedule with introspectable parameters.

    Callable like the reference's closure
    (``/root/reference/QFA/optimizer.py:79-99``): ``lr * alpha ** ((i+1) //
    step)``; exposes ``alpha``/``step`` so :meth:`QFA.train` can recover the
    decay hyper-parameters from a passed optimizer.
    """

    def __init__(self, alpha: float, step: int) -> None:
        self.alpha = float(alpha)
        self.step = int(step)

    def __call__(self, i, lr):
        return lr * self.alpha ** ((i + 1) // self.step)


def step_scheduler(alpha: float, step: int) -> _StepScheduler:
    """Reference-API scheduler factory
    (``/root/reference/QFA/optimizer.py:79-99``)."""
    return _StepScheduler(alpha, step)


class Adam:
    """Reference-API optimizer (``/root/reference/QFA/optimizer.py:11-76``).

    Full drop-in: ``update(params, g)`` / ``reset(params)`` / ``step()`` /
    ``scheduled_lr`` match the reference's hand-rolled Adam exactly (L2
    weight decay folded into the gradient before the moment updates,
    per-call bias correction from the per-EPOCH counter ``i``), so the
    reference's own training-loop idiom — ``self.parameters =
    optimizer.update(self.parameters, grads); optimizer.step()``
    (``/root/reference/QFA/model.py:207-215``) — runs verbatim against
    this facade (tests/test_compat.py). When passed to :meth:`QFA.train`,
    the same numerics run fused inside the jit-compiled trainer
    (``qfa_tpu.train.adam.apply_update``) instead of per-call.

    Moments initialize lazily on the first :meth:`update` when ``params``
    is not given at construction (the reference requires it; here it stays
    optional for the hyper-holder use with :meth:`QFA.train`).
    """

    def __init__(
        self,
        params=None,
        device=None,
        scheduler=None,
        learning_rate: float = 1e-2,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 1e-3,
    ) -> None:
        self.learning_rate = learning_rate
        self.b1 = b1
        self.b2 = b2
        self.eps = eps
        self.device = device
        self.weight_decay = weight_decay
        self.scheduler = scheduler
        self.m: Dict[str, jnp.ndarray] | None = None
        self.v: Dict[str, jnp.ndarray] | None = None
        if params is not None:
            self.reset(params)
        self.i = 0

    def update(
        self, params: Dict[str, jnp.ndarray], g: Dict[str, jnp.ndarray]
    ) -> Dict[str, jnp.ndarray]:
        """One Adam step over a dict of arrays; returns the updated dict.

        Reference semantics (``/root/reference/QFA/optimizer.py:37-52``):
        ``g += wd * p``; moment EMAs; bias correction with the per-epoch
        counter ``i`` (advanced only by :meth:`step`); the schedule applies
        through :attr:`scheduled_lr`. Identical numerics to the functional
        ``train.adam.apply_update`` (asserted in tests).
        """
        if self.m is None:
            # lazy moment init (constructor got no params); unlike
            # reset(), the counter i is left as the caller set it
            self.m = {
                k: jnp.zeros_like(jnp.asarray(params[k], jnp.float32))
                for k in params
            }
            self.v = {
                k: jnp.zeros_like(jnp.asarray(params[k], jnp.float32))
                for k in params
            }
        g = {k: jnp.asarray(g[k], jnp.float32) for k in g}
        p32 = {k: jnp.asarray(params[k], jnp.float32) for k in g}
        g = {k: g[k] + self.weight_decay * p32[k] for k in g}
        self.m = {
            k: (1.0 - self.b1) * g[k] + self.b1 * self.m[k] for k in g
        }
        self.v = {
            k: (1.0 - self.b2) * g[k] * g[k] + self.b2 * self.v[k] for k in g
        }
        bc1 = 1.0 - self.b1 ** (self.i + 1)
        bc2 = 1.0 - self.b2 ** (self.i + 1)
        lr = self.scheduled_lr
        return {
            k: p32[k] - lr * (self.m[k] / bc1)
            / (jnp.sqrt(self.v[k] / bc2) + self.eps)
            for k in params
        }

    def reset(self, params: Dict[str, jnp.ndarray]) -> None:
        """Zero the moments and the counter
        (``/root/reference/QFA/optimizer.py:54-63``)."""
        self.m = {
            k: jnp.zeros_like(jnp.asarray(params[k], jnp.float32))
            for k in params
        }
        self.v = {
            k: jnp.zeros_like(jnp.asarray(params[k], jnp.float32))
            for k in params
        }
        self.i = 0

    def step(self) -> None:
        self.i += 1

    @property
    def scheduled_lr(self):
        if callable(self.scheduler):
            return self.scheduler(self.i, self.learning_rate)
        return self.learning_rate


class QFA:
    """Drop-in-style facade over the functional QFA core.

    Mirrors the reference constructor and methods
    (``/root/reference/QFA/model.py:24-316``); ``device`` is accepted for
    signature compatibility and ignored (JAX manages placement).
    """

    def __init__(
        self,
        Nb: int,
        Nr: int,
        Nh: int,
        device=None,
        tau="becker",
        model_params: Optional[Dict[str, np.ndarray]] = None,
        seed: int = 0,
    ) -> None:
        self.Nb, self.Nr, self.Nh = Nb, Nr, Nh
        self.Npix = Nb + Nr
        self.Nparams = params_mod.num_params(self.Npix, Nb, Nh)
        # The reference constructor takes tau as a CALLABLE built by
        # partial(tau, which=config.MODEL.TAU) (/root/reference/main.py:87,
        # /root/reference/QFA/model.py:26-33). resolve_tau recovers the law
        # name from that idiom (or a plain name / law function); an opaque
        # callable is kept verbatim and traced exactly — never silently
        # substituted.
        from .physics.tau import resolve_tau

        self.tau_which = resolve_tau(tau)
        self._options = qfa_mod.ModelOptions(tau_which=self.tau_which)
        self._seed = seed
        self.mu = None
        if model_params is not None:
            self._params = QFAParams(
                F=jnp.asarray(model_params["F"], jnp.float32),
                Psi=jnp.asarray(model_params["Psi"], jnp.float32),
                omega=jnp.asarray(model_params["omega"], jnp.float32),
                tau0=jnp.asarray(model_params["tau0"], jnp.float32),
                c0=jnp.asarray(model_params["c0"], jnp.float32),
                beta=jnp.asarray(model_params["beta"], jnp.float32),
            )
        else:
            self.random_init_func()

    # -- parameters ---------------------------------------------------------
    def random_init_func(self) -> None:
        self._params = params_mod.random_init(
            jax.random.key(self._seed), self.Npix, self.Nb, self.Nh
        )

    @property
    def parameters(self) -> Dict[str, jnp.ndarray]:
        return self._params.as_dict()

    @parameters.setter
    def parameters(self, params_dict: Dict[str, jnp.ndarray]) -> None:
        self._params = params_mod.clip_params(QFAParams(**params_dict))

    def clip(self) -> None:
        self._params = params_mod.clip_params(self._params)

    def smooth(self) -> None:
        self._params = params_mod.smooth_params(self._params)

    # -- likelihood ----------------------------------------------------------
    def _as_batch(self, delta, error, zabs, mask) -> SpectraBatch:
        to2d = lambda x: jnp.atleast_2d(jnp.asarray(x, jnp.float32))
        mask2 = jnp.atleast_2d(jnp.asarray(mask)).astype(jnp.float32)
        return SpectraBatch(
            delta=to2d(delta) * mask2,
            error=to2d(error) * mask2,
            zabs=to2d(zabs),
            mask=mask2,
            weight=jnp.ones((mask2.shape[0],), jnp.float32),
        )

    def forward(self, delta, error, zabs, mask):
        """Batch mean NLL + reference-normalized gradients (dict).

        Equivalent to the reference's ``forward``
        (``/root/reference/QFA/model.py:74-105``) but vectorized over the
        batch and with exact (autodiff) gradients.
        """
        batch = self._as_batch(delta, error, zabs, mask)
        loss, grads = qfa_mod.loss_and_grads(
            self._params, batch, self._options, reference_norm=True
        )
        return loss, grads.as_dict()

    def loglikelihood_and_gradient_for_single_spectra(
        self, delta, error, zabs, mask
    ):
        """Single-spectrum NLL + gradient dict
        (``/root/reference/QFA/model.py:107-158``)."""
        batch = self._as_batch(delta, error, zabs, mask)
        total, _n, grads, _c = qfa_mod.summed_stats(
            self._params, batch, self._options
        )
        return total, grads.as_dict()

    def prediction_for_single_spectra(self, flux, error, zabs, mask):
        """(ll, hmean, hcov, continuum, uncertainty) for one spectrum
        (``/root/reference/QFA/model.py:160-180``). ``hmean`` is returned as
        an (Nh, 1) column like the reference."""
        if self.mu is None:
            raise RuntimeError("model.mu is unset — load a checkpoint first")
        res = qfa_mod.predict(
            self._params,
            jnp.asarray(self.mu, jnp.float32),
            jnp.atleast_2d(jnp.asarray(flux, jnp.float32)),
            jnp.atleast_2d(jnp.asarray(error, jnp.float32)),
            jnp.atleast_2d(jnp.asarray(zabs, jnp.float32)),
            jnp.atleast_2d(jnp.asarray(mask)).astype(jnp.float32),
            self._options,
        )
        return (
            res.ll[0],
            res.hmean[0][:, None],
            res.hcov[0],
            res.continuum[0],
            res.continuum_std[0],
        )

    # -- training ------------------------------------------------------------
    def train(
        self,
        optimizer=None,
        dataloader=None,
        n_epochs: int = 500,
        output_dir: str = "./result",
        save_interval: int = 5,
        smooth_interval: int = 5,
        quiet: bool = False,
        logger=None,
        learning_rate: float = 1e-3,
        weight_decay: float = 0.1,
        decay_alpha: float = 0.9,
        decay_step: int = 10,
    ) -> None:
        """Train on a :class:`Dataloader`'s data.

        ``optimizer`` may be None (hyper-parameters are taken from the
        keyword arguments) or a reference-style/:class:`Adam` optimizer:
        ``learning_rate``/``weight_decay`` are read from it, and when its
        ``scheduler`` exposes ``alpha``/``step`` (as
        :func:`step_scheduler`'s does) the decay schedule is honored too.
        Schedules passed as opaque closures cannot be introspected — pass
        ``decay_alpha``/``decay_step`` explicitly in that case.
        """
        if dataloader is None:
            raise ValueError("dataloader is required")
        b1, b2, eps = 0.9, 0.999, 1e-8
        if optimizer is not None:
            learning_rate = getattr(optimizer, "learning_rate", learning_rate)
            weight_decay = getattr(optimizer, "weight_decay", weight_decay)
            b1 = float(getattr(optimizer, "b1", b1))
            b2 = float(getattr(optimizer, "b2", b2))
            eps = float(getattr(optimizer, "eps", eps))
            sched = getattr(optimizer, "scheduler", None)
            if sched is not None and hasattr(sched, "alpha") and hasattr(sched, "step"):
                decay_alpha = float(sched.alpha)
                decay_step = int(sched.step)
        self.mu = jnp.asarray(dataloader.mu, jnp.float32)
        config = TrainConfig(
            n_epochs=n_epochs,
            batch_size=dataloader.batch_size,
            learning_rate=learning_rate,
            weight_decay=weight_decay,
            decay_alpha=decay_alpha,
            decay_step=decay_step,
            b1=b1,
            b2=b2,
            eps=eps,
            smooth_interval=smooth_interval,
            save_interval=save_interval,
            options=self._options,
        )
        # terminal per-epoch print when not quiet, reference format
        # (/root/reference/QFA/model.py:217-218).
        metrics_cb = None
        if not quiet:
            def metrics_cb(epoch, loss, dt):
                print(
                    "epoch: {:03d}/{:03d}  ;  loss:  {:.2f}  ;  "
                    "time:  {:.2f} s ".format(epoch, n_epochs, loss, dt)
                )
        params, _history = fit_fn(
            self._params,
            dataloader.residuals(),
            self.mu,
            config,
            key=jax.random.key(self._seed),
            output_dir=output_dir,
            logger=logger,
            metrics_cb=metrics_cb,
        )
        self._params = params

    # -- checkpoints ----------------------------------------------------------
    def save_to_npz(self, output_dir: str, file_name: str) -> None:
        import os

        params_mod.save_npz(
            os.path.join(output_dir, file_name), self._params, self.mu
        )

    def load_from_npz(self, path: str, compat_c0_bug: bool = False) -> None:
        self._params, self.mu = params_mod.load_npz(
            path, compat_c0_bug=compat_c0_bug
        )


class Dataloader:
    """Facade over the data layer with the reference iteration protocol
    (``/root/reference/QFA/dataloader.py:58-191``): ``next_batch`` /
    ``have_next_batch`` / ``rewind`` / ``__getitem__`` / ``mu``.
    """

    def __init__(self, config, seed: int = 0):
        self.grid = make_grid(
            config.DATA.LAMMIN, config.DATA.LAMMAX, config.DATA.LOGLAM_DELTA
        )
        self.Nb, self.Nr = self.grid.nb, self.grid.nr
        self.wav_grid = self.grid.wav
        self.type = config.TYPE
        self.batch_size = config.DATA.BATCH_SIZE
        self.tau_which = config.MODEL.TAU
        self._rng = np.random.default_rng(seed)

        if self.type == "train":
            paths = select_from_catalog(
                config.DATA.CATALOG,
                config.DATA.DATA_DIR,
                config.DATA.DATA_NUM,
                snr_min=config.DATA.SNR_MIN,
                snr_max=config.DATA.SNR_MAX,
                z_min=config.DATA.Z_MIN,
                z_max=config.DATA.Z_MAX,
                num_mask=config.DATA.NUM_MASK,
                seed=seed,
                output_dir=config.DATA.OUTPUT_DIR or None,
                prefix="train",
            )
            # reference loader behavior: VALIDATION spectra are
            # CONCATENATED into the training arrays (trained on, and they
            # shape the mu estimate — /root/reference/QFA/dataloader.py:
            # 81-85), reproduced under DATA.VALIDATION_CONCAT_COMPAT
            from .data.loader import validation_concat_paths

            extra = validation_concat_paths(
                config.DATA, seed,
                output_dir=config.DATA.OUTPUT_DIR or None,
            )
            if extra is not None:
                paths = list(paths) + extra
        elif self.type == "predict":
            # header=None keeps every row (the reference's pd.read_csv
            # default header consumes the first line of a headerless
            # list, /root/reference/QFA/dataloader.py:88-91); an actual
            # header row in a ported catalog is sniffed and dropped —
            # see data.loader.read_predict_catalog / MIGRATION.md #6
            from .data.loader import read_predict_catalog

            paths = read_predict_catalog(
                config.DATA.CATALOG, config.DATA.DATA_DIR
            )
        else:
            raise NotImplementedError("TYPE should be in ['train', 'predict']!")

        self.dataset = SpectraDataset.from_paths(
            paths, max_workers=config.DATA.NPROCS
        )
        self.pathlist = np.asarray(self.dataset.paths)
        self.zqso = self.dataset.zqso
        self.zabs = self.grid.zabs(self.zqso).astype(np.float32)
        self.data_size = self.dataset.size
        from .data.loader import compute_taus

        taus = compute_taus(self.grid, self.zqso, tau_which=self.tau_which)
        self._mu = estimate_mu(
            self.dataset,
            self.grid,
            tau_which=self.tau_which,
            window=config.TRAIN.WINDOW_LENGTH_FOR_MU,
            taus=taus,
        )
        self._residuals = make_residuals(
            self.dataset, self.grid, self._mu, tau_which=self.tau_which,
            taus=taus,
        )
        self._order = np.arange(self.data_size)
        self.cur = 0

    # -- reference iteration protocol ----------------------------------------
    def have_next_batch(self) -> bool:
        return self.cur < self.data_size

    def next_batch(self):
        """(delta, error, zabs, mask) device arrays for the next batch."""
        start, end = self.cur, min(self.cur + self.batch_size, self.data_size)
        self.cur = end
        idx = jnp.asarray(self._order[start:end])
        batch = self._residuals.gather(idx)
        return batch.delta, batch.error, batch.zabs, batch.mask

    def sample(self):
        """A random batch (the reference's ``sample`` crashes; fixed here)."""
        idx = jnp.asarray(
            self._rng.integers(0, self.data_size, size=self.batch_size)
        )
        batch = self._residuals.gather(idx)
        return batch.delta, batch.error, batch.zabs, batch.mask

    def rewind(self) -> None:
        self._rng.shuffle(self._order)
        self.cur = 0

    def set_tau(self, tau) -> None:
        """Switch the mean-optical-depth law used for the training residuals.

        Mirrors ``/root/reference/QFA/dataloader.py:169-173``: affects
        subsequently served batches (the precomputed residual field is
        rebuilt); ``mu`` keeps the law it was estimated with, exactly as in
        the reference (mu is computed once at construction). ``tau`` may be
        a law name (``"becker"``/``"fg"``/``"kamble"``/``"mock"``) or a
        callable ``tau(wav_grid, zqso) -> (N, Nb)`` like the reference's.
        """
        if callable(tau):
            taus = np.asarray(tau(self.wav_grid, self.zqso), np.float32)
            absorb = np.concatenate(
                [np.exp(-taus), np.ones((self.data_size, self.Nr), np.float32)],
                axis=1,
            )
            mask = self.dataset.mask.astype(np.float32)
            delta = (
                self.dataset.flux - np.asarray(self._mu, np.float32) * absorb
            ) * mask
            self._residuals = self._residuals._replace(
                delta=jnp.asarray(delta.astype(np.float32))
            )
        else:
            self.tau_which = str(tau)
            self._residuals = make_residuals(
                self.dataset, self.grid, self._mu, tau_which=self.tau_which
            )

    def set_device(self, device) -> None:
        """Accepted for reference API parity
        (``/root/reference/QFA/dataloader.py:175-179``); JAX manages device
        placement, so this only records the request."""
        self._device = device

    def residuals(self) -> ResidualDataset:
        """The device-resident dataset (for the fast functional trainers)."""
        return self._residuals

    def __len__(self) -> int:
        return self.data_size

    def __getitem__(self, idx):
        """(flux, error, zabs, mask, path) for prediction workflows."""
        return (
            jnp.asarray(self.dataset.flux[idx]),
            jnp.asarray(self.dataset.error[idx]),
            jnp.asarray(self.zabs[idx]),
            jnp.asarray(self.dataset.mask[idx]),
            self.pathlist[idx] if len(self.pathlist) else "",
        )

    @property
    def mu(self) -> np.ndarray:
        return self._mu
