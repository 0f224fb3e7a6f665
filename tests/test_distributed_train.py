"""Real multi-process data-parallel TRAINING.

tests/test_distributed.py proves two actual ``jax.distributed`` processes
can form a mesh and psum a constant; this module runs the production DP
epoch (``parallel.dp.make_dp_epoch_fn`` — per-batch gradient/count psums
inside a ``lax.scan``) across two real single-device CPU processes and
checks the updated parameters against the single-device epoch on the same
global batch composition (SURVEY.md section 5 "distributed backend"; the
reference has no distributed code at all).

Both workers construct the identical problem deterministically (host
numpy handed to ``jax.device_put`` against the global mesh — the
documented multi-process pattern for replicated host data), so the test
exercises exactly what a real multi-host run does: replicated state,
process-sharded data, one collective per step.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

# problem constants shared by the parent and the worker subprocesses
N = 64  #: spectra (32 per process)
NH = 4
BS = 16  #: global batch (8 per process, 4 batches per epoch)
LR = 1e-2
WD = 0.01
GRID = (1030.0, 1080.0, 1e-3)


def build_data_np():
    """Deterministic synthetic residual dataset as host numpy leaves."""
    import jax
    import jax.numpy as jnp

    import qfa_tpu
    from qfa_tpu.data.synthetic import generate
    from qfa_tpu.models import random_init

    grid = qfa_tpu.make_grid(*GRID)
    true = random_init(jax.random.key(0), grid.npix, grid.nb, NH)
    mu = jnp.ones((grid.npix,), jnp.float32)
    syn = generate(jax.random.key(1), true, mu, grid, N, mask_frac=0.15)
    b = syn.to_batch(mu)
    return {
        k: np.asarray(getattr(b, k))
        for k in ("delta", "error", "zabs", "mask")
    }


def build_state_np():
    """Deterministic fresh TrainState with host-numpy leaves."""
    import jax

    import qfa_tpu
    from qfa_tpu.models import random_init
    from qfa_tpu.train import TrainState, adam

    grid = qfa_tpu.make_grid(*GRID)
    p = random_init(jax.random.key(2), grid.npix, grid.nb, NH)
    return jax.tree.map(np.asarray, TrainState(p, adam.init(p)))


def epoch_index_plan(ndev: int):
    """Fixed (no-shuffle) per-device epoch indices: device-local rows in
    order, all weight 1 (N divides BS, so no tail padding)."""
    lbs = BS // ndev
    nb = (N // ndev) // lbs
    idx = np.broadcast_to(
        np.arange(nb * lbs, dtype=np.int32).reshape(1, nb, lbs),
        (ndev, nb, lbs),
    ).copy()
    wt = np.ones((ndev, nb, lbs), np.float32)
    return idx, wt


_WORKER = r"""
import importlib.util, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax

# jax.distributed.initialize must run before anything touches the XLA
# backend; qfa_tpu's import materializes jnp constants, so load
# parallel/mesh.py standalone first (it only imports jax/numpy).
_spec = importlib.util.spec_from_file_location("qfa_mesh", sys.argv[3])
qfa_mesh = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(qfa_mesh)
qfa_mesh.initialize_distributed(
    coordinator_address=sys.argv[1],
    num_processes=2,
    process_id=int(sys.argv[2]),
)
assert jax.process_count() == 2, jax.process_count()
assert jax.local_device_count() == 1

import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from test_distributed_train import BS, LR, WD, build_data_np, \
    build_state_np, epoch_index_plan

from qfa_tpu.data.loader import EpochIndices, ResidualDataset
from qfa_tpu.parallel import make_dp_epoch_fn
from qfa_tpu.train import TrainConfig

mesh = qfa_mesh.make_mesh()  # both processes' devices
assert mesh.devices.size == 2


def put(x, spec):
    return jax.device_put(x, NamedSharding(mesh, spec))


leaves = build_data_np()
data = ResidualDataset(
    **{k: put(v, P("data", None)) for k, v in leaves.items()}
)
state = jax.tree.map(lambda x: put(x, P()), build_state_np())
idx, wt = epoch_index_plan(2)
ei = EpochIndices(
    idx=put(idx, P("data", None, None)),
    weight=put(wt, P("data", None, None)),
)
cfg = TrainConfig(batch_size=BS, learning_rate=LR, weight_decay=WD)
state, loss = make_dp_epoch_fn(cfg, mesh)(state, data, ei)
# loss and params are replicated -> the local shard is the full value
fsum = float(np.abs(np.asarray(jax.device_get(state.params.F))).sum())
print(f"RESULT {float(loss):.9e} {fsum:.9e}", flush=True)
jax.distributed.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two_process(worker_src: str) -> list[tuple[float, ...]]:
    """Spawn two single-CPU-device worker processes, collect their
    ``RESULT ...`` lines, and assert both replicas agree."""
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    addr = f"127.0.0.1:{_free_port()}"
    env = {
        k: v
        for k, v in os.environ.items()
        # XLA_FLAGS: each worker must see exactly ONE local CPU device.
        if k != "XLA_FLAGS"
    }
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [root, here, env.get("PYTHONPATH", "")]
    )
    mesh_py = os.path.join(root, "qfa_tpu", "parallel", "mesh.py")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", worker_src, addr, str(pid), mesh_py],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
    results = [
        tuple(float(t) for t in line.split()[1:])
        for out in outs
        for line in out.splitlines()
        if line.startswith("RESULT")
    ]
    assert len(results) == 2
    # both processes hold the same replicated result
    np.testing.assert_allclose(results[0], results[1], rtol=1e-6)
    return results


def test_two_process_dp_epoch_matches_single_device():
    """Two real processes run the production DP epoch; the replicated
    result must match the single-device epoch on the same global batches."""
    results = _run_two_process(_WORKER)

    # single-device reference on the same global batch composition:
    # device d's local row i is global row d*shard + i
    import jax
    import jax.numpy as jnp

    from qfa_tpu.data.loader import ResidualDataset
    from qfa_tpu.train import TrainConfig
    from qfa_tpu.train.loop import make_epoch_fn

    leaves = build_data_np()
    data = ResidualDataset(**{k: jnp.asarray(v) for k, v in leaves.items()})
    idx, _ = epoch_index_plan(2)
    shard = N // 2
    global_idx = np.concatenate(
        [idx[d] + d * shard for d in range(2)], axis=1
    )
    cfg = TrainConfig(batch_size=BS, learning_rate=LR, weight_decay=WD)
    state = jax.tree.map(jnp.asarray, build_state_np())
    state, loss = make_epoch_fn(cfg)(state, data, jnp.asarray(global_idx))
    fsum = float(np.abs(np.asarray(state.params.F)).sum())

    assert results[0][0] == pytest.approx(float(loss), rel=1e-4)
    assert results[0][1] == pytest.approx(fsum, rel=1e-4)
