"""Real multi-process jax.distributed test (parallel/shard.init_multihost).

Spawns TWO separate python processes (standing in for two hosts),
each calling init_multihost against a local coordinator, then running a
shard_map psum over the global 2-device mesh and a sharded wavefront
render slice. Requires the package to be importable WITHOUT initializing
the XLA backend (module-level jnp constants would break
jax.distributed.initialize ordering — regression-guarded here)."""
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, %(repo)r)
from hobbyraytracer_tpu.parallel.shard import init_multihost

pid = int(sys.argv[1])
init_multihost("127.0.0.1:%(port)d", 2, pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 2

import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

mesh = Mesh(np.asarray(jax.devices()), ("rays",))

def worker(x):
    return jax.lax.psum(x, "rays")

local = jnp.ones((1, 4)) * (pid + 1)
g = jax.make_array_from_single_device_arrays(
    (2, 4), jax.sharding.NamedSharding(mesh, P("rays")),
    [jax.device_put(local, jax.local_devices()[0])])
out = jax.jit(shard_map(worker, mesh=mesh, in_specs=P("rays"),
                        out_specs=P(), check_vma=False))(g)
got = np.asarray(out.addressable_data(0))
np.testing.assert_allclose(got, 3.0)  # 1 + 2 from the two processes
print(f"proc {pid}: psum over 2-process mesh ok", flush=True)
"""


def test_two_process_distributed():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    src = WORKER % {"repo": REPO, "port": port}
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # no virtual device multiplication here
    procs = [subprocess.Popen([sys.executable, "-c", src, str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env,
                              cwd=REPO)
             for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=180)
        outs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert "psum over 2-process mesh ok" in out


def test_package_import_does_not_init_backend():
    """Importing the package must not create device arrays (would break
    jax.distributed.initialize ordering on real pods)."""
    src = (
        "import jax, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import hobbyraytracer_tpu.parallel.shard\n"
        "import hobbyraytracer_tpu.ops.intersect\n"
        "import hobbyraytracer_tpu.integrator.wavefront\n"
        "jax.distributed.initialize('127.0.0.1:%d', 1, 0)\n"
        "print('init-after-import ok')\n"
    )
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    r = subprocess.run([sys.executable, "-c", src % port],
                       capture_output=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stdout.decode() + r.stderr.decode()
    assert b"init-after-import ok" in r.stdout
