"""Multi-process jax.distributed path, executed for real on CPU.

BASELINE config 5 mandates a multi-host software path; this spawns two OS
processes that form a real jax.distributed cluster (coordinator on
localhost), each contributing 4 virtual CPU devices to an 8-device mesh, and runs the sharded pipeline
end-to-end with cross-process halo exchange + psum convergence. Each worker
verifies its addressable output shards against the NumPy oracle
(tests/distributed_worker.py).
"""
import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "distributed_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clean_env() -> dict:
    env = {
        k: v
        for k, v in os.environ.items()
        if not k.startswith(("JAX_", "XLA_"))
    }
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_pod(nprocs: int, cols: int) -> None:
    port = _free_port()
    env = _clean_env()
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(port), str(i), str(nprocs),
             str(cols)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(nprocs)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"OK process={i} shards_checked=4" in out, out


@pytest.mark.slow
def test_two_process_pod():
    """2 processes x 4 devices, (1, 8, 1) mesh: row halos cross the
    process boundary."""
    _run_pod(2, cols=1)


@pytest.mark.slow
def test_four_process_pod_2d():
    """4 processes x 4 devices, (1, 2, 8) mesh: BOTH the row and the
    column halo exchanges cross process boundaries (local devices pack
    the x axis first)."""
    _run_pod(4, cols=8)
