"""Real multi-process ``jax.distributed`` exercise.

``parallel.mesh.initialize_distributed`` wraps
``jax.distributed.initialize``; the unit test in tests/test_parallel.py
monkeypatches the underlying call, so this module runs the REAL thing:
two CPU processes on localhost form a coordination service, build a
global 2-device mesh, and psum a value across processes (SURVEY.md
section 5 "distributed backend"; the reference has no distributed code
at all).
"""

import os
import socket
import subprocess
import sys

import numpy as np

_WORKER = r"""
import importlib.util, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from jax.sharding import PartitionSpec as P

# jax.distributed.initialize must run before ANYTHING touches the XLA
# backend, and importing the qfa_tpu package initializes it (module-level
# jnp constants) — so load parallel/mesh.py standalone (it only imports
# jax/numpy) and call the real wrapper first.
_spec = importlib.util.spec_from_file_location("qfa_mesh", sys.argv[3])
qfa_mesh = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(qfa_mesh)
initialize_distributed = qfa_mesh.initialize_distributed
make_mesh = qfa_mesh.make_mesh

initialize_distributed(
    coordinator_address=sys.argv[1],
    num_processes=2,
    process_id=int(sys.argv[2]),
)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 2, jax.device_count()
assert jax.local_device_count() == 1
# second call must be a no-op (the wrapper swallows only
# already-initialized errors)
initialize_distributed(
    coordinator_address=sys.argv[1],
    num_processes=2,
    process_id=int(sys.argv[2]),
)
mesh = make_mesh()  # 1-D mesh over BOTH processes' devices
import jax.numpy as jnp

fn = jax.jit(
    jax.shard_map(
        lambda x: jax.lax.psum(x, "data"), mesh=mesh,
        in_specs=P(), out_specs=P(),
    )
)
out = float(fn(jnp.asarray(3.0 + int(sys.argv[2]))))
print(f"PSUM {out}", flush=True)
jax.distributed.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_psum(tmp_path):
    """Two actual processes: coordinator + worker, global mesh, psum."""
    addr = f"127.0.0.1:{_free_port()}"
    env = {
        k: v
        for k, v in os.environ.items()
        # XLA_FLAGS: each process must see exactly ONE local CPU device.
        if k != "XLA_FLAGS"
    }
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    mesh_py = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "qfa_tpu", "parallel", "mesh.py",
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, addr, str(pid), mesh_py],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=180)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
    # replicated input per process: proc0 holds 3.0, proc1 holds 4.0; the
    # data axis spans the two single-device processes, so each replica's
    # shard_map sees its own value and the psum sums ONE value per device
    vals = [
        float(line.split()[1])
        for out in outs
        for line in out.splitlines()
        if line.startswith("PSUM")
    ]
    assert len(vals) == 2
    # both processes agree on the reduced value
    assert vals[0] == vals[1]
    assert np.isfinite(vals[0])
