"""Multi-PROCESS distributed execution test (VERDICT round-1 item 1).

Spawns N python processes, each with ONE local CPU device, forming a
jax.distributed cluster (gloo collectives). The sharded fused verifier
then runs across the process-spanning mesh — the same code path a
multi-host deployment uses, with the interconnect replaced by local TCP. Asserts
acceptance of a valid batch and rejection of a tampered one on every
process.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_cluster(nproc: int, timeout: int = 900):
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # one CPU device per process
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(i), str(nproc), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return procs, outs


@pytest.mark.parametrize("nproc", [2])
def test_multiprocess_sharded_verification(nproc):
    procs, outs = _run_cluster(nproc)
    for i, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-30:])
        assert p.returncode == 0, f"proc {i} failed:\n{tail}"
        assert f"MP-INIT proc={i} global_devices={nproc}" in out, tail
        assert f"MP-RESULT proc={i} valid=True" in out, tail
        assert f"MP-RESULT proc={i} tampered=False" in out, tail
        assert f"MP-DONE proc={i}" in out, tail
