"""Process set-up and the main path's dependencies: ``chip_smoke.py``'s CPU
rehearsal and its refusals, the compile cache's location, the YAML-subset
config reader, removed config keys, the CSV catalog reader, the native
reader's build key, and the imports the package may not need."""

import glob
import os
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import yaml

from qfa_tpu.config import (
    REMOVED_KEYS,
    default_config,
    dump_yaml,
    load_config,
    parse_yaml,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_py(args, env_extra=None, cwd=ROOT, timeout=600, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT})
    env.pop("XLA_FLAGS", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def gitignored():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        return {line.strip() for line in f}


def result_lines(stdout):
    return [ln for ln in stdout.splitlines() if ln.startswith('{"ok"')]


# -- chip_smoke.py --------------------------------------------------------------


def test_chip_smoke_rehearse_on_cpu():
    """Every phase runs end to end on the CPU at a tiny grid, and the last
    line is the result object."""
    proc = run_py(["chip_smoke.py", "--rehearse"])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith('{"ok": true')
    assert '"platform": "cpu"' in last and '"rehearsal": true' in last
    for phase in ("1 train", "2 predict", "3 stats-only", "4 serve",
                  "5 DESI"):
        assert f"== phase {phase}" in proc.stdout
    assert "FAIL" not in proc.stdout


def test_chip_smoke_refuses_without_gpu():
    proc = run_py(["chip_smoke.py"], timeout=300)
    assert proc.returncode != 0
    assert not result_lines(proc.stdout)
    assert "needs a GPU" in proc.stdout + proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script fails, printing no
    result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = run_py(["chip_smoke.py"], env_extra={"PYTHONPATH": ""},
                  cwd=str(tmp_path), timeout=300)
    assert proc.returncode != 0
    assert not result_lines(proc.stdout)


# -- compile cache ----------------------------------------------------------------

_COMPILE = textwrap.dedent("""
    import sys
    from qfa_tpu.utils.runtime import setup_compile_cache
    where = setup_compile_cache()
    import jax, jax.numpy as jnp
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.jit(lambda x: jnp.sin(x) * float(sys.argv[1]))(jnp.ones(7))
    print(where)
""")


@pytest.mark.parametrize("with_env", [True, False])
def test_compile_cache_location(tmp_path, with_env):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land there;
    without it, in the one fixed, gitignored directory of the checkout."""
    from qfa_tpu.utils.runtime import DEFAULT_CACHE_DIR

    if with_env:
        where = str(tmp_path / "cache")
        env = {"JAX_COMPILATION_CACHE_DIR": where}
    else:
        where = DEFAULT_CACHE_DIR
        env = {}
        assert where == os.path.join(ROOT, ".jax_cache")
        assert ".jax_cache/" in gitignored()
    before = set(glob.glob(os.path.join(where, "*")))
    salt = repr(float(np.random.default_rng().uniform(1.0, 2.0)))
    proc = run_py(["-c", _COMPILE, salt], env_extra=env,
                  drop=("JAX_COMPILATION_CACHE_DIR",), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == where
    assert set(glob.glob(os.path.join(where, "*"))) - before


# -- config reader -------------------------------------------------------------------


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml"))),
    ids=os.path.basename,
)
def test_config_reader_matches_yaml(path):
    """The YAML-subset reader parses every shipped config exactly as a
    YAML library does."""
    with open(path) as f:
        text = f.read()
    assert parse_yaml(text) == (yaml.safe_load(text) or {})


def test_config_dump_reads_back_everywhere():
    """The dumped run config reads back identically through the subset
    reader and through a YAML library."""
    cfg = load_config(opts=["MODEL.TAU", "fg", "DATA.LOGLAM_DELTA", "1e-4"])
    text = cfg.dump()
    assert parse_yaml(text) == cfg.to_dict()
    assert yaml.safe_load(text) == cfg.to_dict()
    nested = {"A": {"B": [1, 2.5, "x y", None, True], "C": "it's"}}
    assert yaml.safe_load(dump_yaml(nested)) == nested
    assert parse_yaml(dump_yaml(nested)) == nested


def test_config_reader_rejects_what_it_cannot_read():
    with pytest.raises(ValueError, match="line 2"):
        parse_yaml("A:\n\tB: 1\n")
    with pytest.raises(ValueError, match="line 1"):
        parse_yaml("just a scalar\n")


@pytest.mark.parametrize("how", ["file", "opts"])
@pytest.mark.parametrize("key", sorted(REMOVED_KEYS))
def test_removed_key_fails_by_name(tmp_path, key, how):
    """A config that still sets a removed TRAIN key fails, naming it."""
    section, name = key.split(".")
    with pytest.raises(ValueError, match=re.escape(key)):
        if how == "file":
            path = tmp_path / "old.yaml"
            path.write_text(f"{section}:\n  {name}: 1\n")
            load_config(str(path))
        else:
            load_config(opts=[key, "1"])
    assert name not in default_config()[section]


# -- catalogs ---------------------------------------------------------------------------


def test_select_from_catalog_csv(tmp_path):
    """The csv-module catalog reader: cuts, an empty cell failing every
    cut, the written train catalog, and a missing column named."""
    from qfa_tpu.data.loader import select_from_catalog

    cat = tmp_path / "cat.csv"
    cat.write_text("file,snr,z,num_mask\n"
                   "a.npz,5,2.5,0\n"
                   "b.npz,1,2.5,0\n"   # fails snr
                   "c.npz,,2.5,0\n"    # empty snr fails every cut
                   "d.npz,9,3.9,0\n"   # fails z
                   "e.npz,7,3.0,0\n")
    paths = select_from_catalog(str(cat), "/data", 6, seed=0,
                                output_dir=str(tmp_path), prefix="train")
    assert {os.path.basename(p) for p in paths} == {"a.npz", "e.npz"}
    assert all(p.startswith("/data/") for p in paths)
    written = (tmp_path / "train-catalog.csv").read_text().split()
    assert sorted(written) == sorted(os.path.basename(p) for p in paths)
    bad = tmp_path / "bad.csv"
    bad.write_text("file,snr,z\na.npz,5,2.5\n")
    with pytest.raises(ValueError, match="num_mask"):
        select_from_catalog(str(bad), "/data", 1)


# -- native reader ------------------------------------------------------------------------


def test_native_library_keyed_on_source(tmp_path, monkeypatch):
    """The library's name carries a hash of the source it was built from,
    in the gitignored build directory, so a library built from another
    source is never loaded."""
    from qfa_tpu import native

    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(
        ROOT, "qfa_tpu", "native", "_build")
    src = tmp_path / "npz_reader.cpp"
    src.write_text(open(native._SRC).read() + "\n// edited\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    assert native.library_path() != path
    assert "qfa_tpu/native/_build/" in gitignored()


# -- imports --------------------------------------------------------------------------------


def test_no_pallas_import_and_no_platform_branch():
    """No module of the package, nor the entry scripts, imports Pallas, and
    nothing branches on a platform name other than the GPU or the CPU."""
    files = glob.glob(os.path.join(ROOT, "qfa_tpu", "**", "*.py"),
                      recursive=True)
    files += [os.path.join(ROOT, f) for f in
              ("bench.py", "__graft_entry__.py", "chip_smoke.py")]
    files += glob.glob(os.path.join(ROOT, "examples", "*.py"))
    compared = re.compile(r"platform[^\n]*?[!=]=\s*['\"](\w+)['\"]")
    for f in files:
        src = open(f).read()
        assert "jax.experimental.pallas" not in src, f
        assert set(compared.findall(src)) <= {"gpu", "cpu"}, f


_BLOCKED = textwrap.dedent("""
    import importlib.abc, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("pandas", "yaml"):
                raise ImportError(f"{name} is blocked")

    sys.meta_path.insert(0, Block())
    import os
    import numpy as np
    import qfa_tpu.cli
    import jax
    import qfa_tpu
    from qfa_tpu.data.synthetic import generate
    from qfa_tpu.models import random_init

    work = sys.argv[1]
    grid = qfa_tpu.make_grid(1030.0, 1120.0, 5e-4)
    true = random_init(jax.random.key(0), grid.npix, grid.nb, 3)
    syn = generate(jax.random.key(1), true, 1.2 + 0 * true.Psi, grid, 24,
                   mask_frac=0.1)
    os.makedirs(f"{work}/spectra")
    rows = ["file,snr,z,num_mask"]
    for i in range(24):
        m = np.asarray(syn.mask[i]) > 0
        np.savez(f"{work}/spectra/s{i}.npz",
                 flux=np.where(m, np.asarray(syn.flux[i]), -999.0),
                 error=np.where(m, np.asarray(syn.error[i]), -999.0),
                 z=float(syn.zqso[i]))
        rows.append(f"s{i}.npz,10,{float(syn.zqso[i])},0")
    open(f"{work}/cat.csv", "w").write("\\n".join(rows) + "\\n")
    open(f"{work}/pred.csv", "w").write(
        "\\n".join(f"s{i}.npz" for i in range(6)) + "\\n")
    grid_opts = ["DATA.LAMMIN", "1030.0", "DATA.LAMMAX", "1120.0",
                 "DATA.LOGLAM_DELTA", "5e-4"]
    qfa_tpu.cli.main(["--type", "train", "--catalog", f"{work}/cat.csv",
                      "--data_dir", f"{work}/spectra", "--output_dir",
                      f"{work}/train", "--data_num", "24", "--batch_size",
                      "8", "--n_epochs", "2", "--nh", "3", "--num_mask",
                      "40", "--opts", *grid_opts])
    qfa_tpu.cli.main(["--type", "predict", "--catalog", f"{work}/pred.csv",
                      "--data_dir", f"{work}/spectra", "--output_dir",
                      f"{work}/predict", "--resume",
                      f"{work}/train/model_parameters.npz", "--opts",
                      *grid_opts])
    assert "pandas" not in sys.modules and "yaml" not in sys.modules
    print("CLI-OK", len(os.listdir(f"{work}/predict/predict")))
""")


def test_cli_train_predict_without_pandas_or_yaml(tmp_path):
    """``import qfa_tpu.cli`` and a CLI train and predict run succeed with
    pandas and yaml blocked from import."""
    proc = run_py(["-c", _BLOCKED, str(tmp_path)], timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "CLI-OK 6" in proc.stdout
