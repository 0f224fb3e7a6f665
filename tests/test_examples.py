"""Smoke tests for the user-facing example scripts.

The reference ships notebooks as its de-facto examples (SURVEY §2 #12-13);
here the equivalents are argparse scripts under ``examples/``. These tests
pin the two cheap invariants a user hits first: every script exposes a
clean ``--help`` (none starts device work at import), and the single-
spectrum predict walkthrough runs end-to-end against the golden artifacts
(`/root/reference/data/`, the same files the parity tests consume).
"""

import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "*.py")))
# prepend (not replace) ROOT, keeping whatever PYTHONPATH the caller set
ENV = {
    **os.environ,
    "JAX_PLATFORMS": "cpu",
    "PYTHONPATH": os.pathsep.join(
        [ROOT] + ([os.environ["PYTHONPATH"]]
                  if os.environ.get("PYTHONPATH") else [])
    ),
}

REF_MODEL = "/root/reference/data/model_parameters.npz"
REF_SPEC = "/root/reference/data/spec-4321-55504-0114.npz"


def test_examples_exist():
    names = {os.path.basename(p) for p in EXAMPLES}
    assert {"predict_single.py", "generate_mock_continuum.py",
            "ood_detection.py", "train_multichip.py",
            "train_survey_scale.py", "train_500epoch_health.py"} <= names


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_example_help_is_clean(path):
    """--help must exit 0 without launching any training/inference."""
    proc = subprocess.run(
        [sys.executable, path, "--help"],
        capture_output=True, text=True, env=ENV, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr
    assert "usage:" in proc.stdout.lower()


@pytest.mark.skipif(not os.path.exists(REF_MODEL), reason="no reference data")
def test_predict_single_end_to_end(tmp_path):
    out = tmp_path / "pred.npz"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "predict_single.py"),
         "--model", REF_MODEL, "--spectrum", REF_SPEC, "--out", str(out),
         "--compat-c0-bug"],
        capture_output=True, text=True, env=ENV, timeout=400,
    )
    assert proc.returncode == 0, proc.stderr
    assert out.exists()
    import numpy as np

    saved = np.load(out)
    # the notebook-walkthrough outputs: ll + posterior + continuum + samples
    for key in ("ll", "hmean", "hcov", "cont", "uncertainty",
                "posterior_continua", "wav"):
        assert key in saved, key
        assert np.isfinite(saved[key]).all(), key
    # golden ll from the stored reference outputs (SURVEY §6)
    assert abs(float(saved["ll"]) - (-510.2292)) < 5e-3
