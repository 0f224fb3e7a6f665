"""Inference: batched continuum prediction, OOD scoring, npz outputs."""

from .predict import (
    ood_scores,
    predict_dataset,
    predict_resident,
    sample_posterior_continua,
    score_resident,
    select_ood,
    write_npz_outputs,
)

__all__ = [
    "ood_scores",
    "predict_dataset",
    "predict_resident",
    "sample_posterior_continua",
    "score_resident",
    "select_ood",
    "write_npz_outputs",
]
