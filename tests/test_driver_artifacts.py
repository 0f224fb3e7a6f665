"""The driver's round-end entry points must stay importable.

``bench.py`` and ``__graft_entry__.py`` run on the accelerator; a
Python-level regression (syntax error, renamed import, moved symbol) in
either would only show there. Importing them on the CPU
test platform exercises every module-level statement and the symbol
lookups without launching device work (both gate execution behind
``if __name__ == "__main__"``).
"""

import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, f"{name}.py")
    )
    mod = importlib.util.module_from_spec(spec)
    # registered so dataclasses/typing resolution inside the module works
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(name, None)
    return mod


def test_bench_importable():
    bench = _load("bench")
    assert callable(bench.main)
    # the stage helpers the measurement path calls must exist
    for sym in ("stage", "make_problem", "bench_train", "bench_sweep"):
        assert hasattr(bench, sym), sym


def test_graft_entry_importable():
    entry_mod = _load("__graft_entry__")
    assert callable(entry_mod.entry)
    assert callable(entry_mod.dryrun_multichip)
    # entry() must build a jittable fn + example args without device work
    fn, args = entry_mod.entry()
    assert callable(fn) and isinstance(args, tuple)

def test_python_dash_m_qfa_tpu_dispatches_to_cli():
    """``python -m qfa_tpu`` mirrors the reference's ``python main.py`` entry
    (/root/reference/main.py:16-42): the module entry must parse args and
    reject an invalid TYPE through the same ``cli.main`` dispatcher."""
    import subprocess

    proc = subprocess.run(
        [sys.executable, "-m", "qfa_tpu", "--type", "bogus"],
        capture_output=True,
        text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT},
        timeout=240,
    )
    assert proc.returncode != 0
    assert "TYPE must be 'train' or 'predict'" in proc.stderr + proc.stdout
