"""Multi-host bring-up integration test.

Spawns TWO real OS processes with a localhost coordinator, calls the
library's ``initialize_distributed`` + ``runtime_info`` in each, builds a
mesh spanning both processes' (virtual) CPU devices, runs one sharded
operator apply, and asserts parity with the single-process oracle — the
fake-backend tier for ``parallel/init.py`` (SURVEY §4's JLArrays-tier
analogue: same code path as a multi-host GPU bring-up, CPU devices
standing in for the cards).
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

_CHILD = textwrap.dedent(
    """
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    pid, port = int(sys.argv[1]), sys.argv[2]
    from linops_tpu.parallel.init import initialize_distributed, runtime_info

    initialize_distributed(f"localhost:{port}", num_processes=2,
                           process_id=pid)
    # idempotency: a second call must be a no-op, not a crash
    initialize_distributed(f"localhost:{port}", num_processes=2,
                           process_id=pid)
    info = runtime_info()
    assert info["process_count"] == 2, info
    assert info["global_devices"] == 2 * info["local_devices"], info

    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import linops_tpu as lo
    from linops_tpu.parallel.sharded import shard_operator

    ndev = info["global_devices"]
    n = 16 * ndev
    mesh = Mesh(np.array(jax.devices()), ("d",))
    sh = NamedSharding(mesh, P("d"))
    dh = (np.arange(n, dtype=np.float32) % 7.0) + 1.0
    xh = np.linspace(0.5, 1.5, n, dtype=np.float32)

    def mk(host):
        return jax.make_array_from_callback(
            (n,), sh, lambda idx: host[idx])

    d, x = mk(dh), mk(xh)
    op = shard_operator(lo.opDiagonal(d), mesh)
    y = jax.jit(lambda o, v: o @ v)(op, x)
    # every process checks ITS addressable shards against the oracle
    for s in y.addressable_shards:
        np.testing.assert_allclose(
            np.asarray(s.data), (dh * xh)[s.index], rtol=1e-6)

    # one cross-process collective: global mean via a replicated-out jit
    g = jax.jit(lambda v: jnp.sum(v),
                out_shardings=NamedSharding(mesh, P()))(x)
    np.testing.assert_allclose(float(g), float(xh.sum()), rtol=1e-5)
    print(f"child {pid} ok: {info}")
    """
)


def test_two_process_bringup(tmp_path):
    port = socket.socket()
    port.bind(("localhost", 0))
    portno = port.getsockname()[1]
    port.close()

    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + ":" + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), str(portno)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed bring-up timed out:\n" + "\n".join(outs))
    joined = "\n---\n".join(outs)
    if any(p.returncode != 0 for p in procs):
        low = joined.lower()
        # platforms whose jaxlib lacks multi-process CPU collectives
        if ("unimplemented" in low or "not supported" in low
                or "unavailable: connection" in low):
            pytest.skip("multi-process CPU collectives unsupported here:\n"
                        + joined[-800:])
        pytest.fail("distributed bring-up failed:\n" + joined)
    assert "child 0 ok" in joined and "child 1 ok" in joined
