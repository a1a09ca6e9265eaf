"""StallWatchdog (utils/timers.py): the wedged-runtime guard.

A wedged device runtime blocks forever inside a device call (a
255-grid production run once froze 29+ minutes mid-batch), so the
watchdog's only safe action is os._exit — which kills the interpreter,
so every firing test runs in a subprocess.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code):
    return subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=120)


def test_watchdog_fires_on_stall():
    r = _run("""
import time
from navierstokes3d_tpu.utils.timers import StallWatchdog
StallWatchdog(0.3, message="resume me").start()
time.sleep(30)   # a 'wedged device call': never beats
print("unreachable")
""")
    assert r.returncode == 3, (r.returncode, r.stderr[-500:])
    assert "STALL" in r.stderr and "resume me" in r.stderr
    assert "unreachable" not in r.stdout


def test_watchdog_quiet_with_beats_and_stop():
    r = _run("""
import time
from navierstokes3d_tpu.utils.timers import StallWatchdog
w = StallWatchdog(0.5).start()
for _ in range(8):      # regular progress for ~1.2s > timeout
    time.sleep(0.15)
    w.beat()
w.stop()
time.sleep(0.8)         # after stop() a stall must NOT fire
print("done")
""")
    assert r.returncode == 0, (r.returncode, r.stderr[-500:])
    assert "done" in r.stdout and "STALL" not in r.stderr


def test_cli_stall_timeout_completes(tmp_path):
    """A healthy run with --stall-timeout armed completes normally."""
    r = subprocess.run(
        [sys.executable, "-m", "navierstokes3d_tpu.run",
         "--preset", "multi", "--nx", "9", "--nt", "2",
         "--dtype", "float32", "--platform", "cpu",
         "--ckpt-dir", str(tmp_path / "ck"),
         "--stall-timeout", "600", "--quiet"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "STALL" not in r.stderr
