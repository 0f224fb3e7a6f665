"""qfa_tpu — Quasar Factor Analysis in JAX.

A from-scratch JAX/XLA framework for unsupervised quasar-continuum
modeling with the capabilities of the PyTorch reference (ZechangSun/QFA,
arXiv:2207.02788): probabilistic continuum prediction with uncertainty,
spectral embedding, and out-of-distribution detection via the marginal
likelihood of a masked low-rank-plus-diagonal Gaussian.

Design: fixed-shape masked arithmetic instead of per-spectrum row deletion,
batched Gram-GEMM capacitance factorization instead of dense Npix x Npix
inverses, autodiff gradients, data-parallel sharding over a device mesh.
"""

from . import infer, linalg, models, parallel, physics, train
from .config import ConfigNode, default_config, load_config
from .data.batch import SpectraBatch, pad_batch
from .data.grid import WavelengthGrid, make_grid
from .models import (
    ModelOptions,
    PredictResult,
    QFAParams,
    batch_nll,
    clip_params,
    load_npz,
    loss_and_grads,
    predict,
    random_init,
    save_npz,
    smooth_params,
)

__version__ = "0.2.0"

__all__ = [
    "infer",
    "linalg",
    "models",
    "parallel",
    "physics",
    "train",
    "ConfigNode",
    "default_config",
    "load_config",
    "SpectraBatch",
    "pad_batch",
    "WavelengthGrid",
    "make_grid",
    "ModelOptions",
    "PredictResult",
    "QFAParams",
    "batch_nll",
    "clip_params",
    "load_npz",
    "loss_and_grads",
    "predict",
    "random_init",
    "save_npz",
    "smooth_params",
    "__version__",
]
