"""Multi-process smoke test: 2 jax.distributed processes, 4 virtual CPU
devices each, one sharded step (launch/multihost_smoke.py — the analog
of the reference's srun -n8 SLURM launch, scripts/runme3D.sh:18)."""

import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(600)
def test_two_process_distributed_step(tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)  # the script sets its own device count
    procs = [
        subprocess.Popen(
            [sys.executable, "launch/multihost_smoke.py",
             "--coord", f"localhost:{port}", "--nproc", "2",
             "--pid", str(pid)],
            cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=540)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 and ("gloo" in out.lower()
                                  or "collectives" in out.lower()
                                  or "DistributedRuntime" in out):
            pytest.skip(f"distributed CPU runtime unsupported here: "
                        f"{out[-500:]}")
        assert p.returncode == 0, f"proc {pid}:\n{out[-3000:]}"
        assert f"proc {pid}/2: global_devices=8" in out, out[-1000:]
    # both ranks computed the same replicated stats
    line0 = [l for l in outs[0].splitlines() if l.startswith("proc 0")][0]
    line1 = [l for l in outs[1].splitlines() if l.startswith("proc 1")][0]
    assert line0.split("iters=")[1] == line1.split("iters=")[1]
