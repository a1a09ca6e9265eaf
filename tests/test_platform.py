"""Platform plumbing that every entry point shares: the peak table the
benchmark divides by, the compile-cache location, the advection
default, and the refusals of bench.py and chip_smoke.py when
JAX finds no GPU."""

import os
import subprocess
import sys

import pytest

import jax

import navierstokes3d_tpu as ns
from navierstokes3d_tpu.utils import cache, peaks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


def test_peak_table_has_h100_sxm():
    assert peaks.peak_hbm_gbps(H100) == 3350.0
    assert peaks.device_peaks(H100)["f32_tflops"] == 67.0


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB",
                                  "nvidia h100 80gb hbm3"])
def test_peak_table_refuses_unknown_kind(kind):
    """An unknown device (or a differently spelt one) is an error, never
    a default rate."""
    with pytest.raises(KeyError, match="no published peaks"):
        peaks.peak_hbm_gbps(kind)


def test_peak_table_default_kind_is_first_device():
    # the CPU test backend is not in the table
    with pytest.raises(KeyError, match=repr(jax.devices()[0].device_kind)):
        peaks.device_peaks()


@pytest.mark.parametrize("pair,fields", [(False, 5), (True, 7)])
def test_pt_sweep_bytes(pair, fields):
    assert peaks.pt_sweep_bytes(255 * 153 * 153, 4, pair) == \
        fields * 255 * 153 * 153 * 4


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.compile_cache_dir() == str(tmp_path)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.compile_cache_dir() == os.path.join(ROOT, ".cache", "jax")


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    try:
        assert cache.enable_compile_cache() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("compat", [False, True])
def test_advect_default_is_gather(monkeypatch, compat):
    """The reference's gather, measured faster on the GPU (PERF.md)."""
    monkeypatch.delenv("NS3D_ADVECT", raising=False)
    s = ns.ChorinSolver(ns.preset_multi(nx=9, compat=compat,
                                        dtype="float32"))
    assert s.advect_method == "gather"


def test_advect_env_override(monkeypatch):
    monkeypatch.setenv("NS3D_ADVECT", "selectshift")
    s = ns.ChorinSolver(ns.preset_multi(nx=9, compat=True))
    assert s.advect_method == "selectshift"


def _run(args, cwd=ROOT):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_four_cards_refuses_cpu():
    r = _run(["chip_smoke.py", "--four-cards"])
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the checkout it cannot import the solver."""
    import shutil
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_chip_smoke_arguments():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    a = chip_smoke.parse_args([])
    assert not a.four_cards
    assert a.out == os.path.join(ROOT, ".cache", "chip_smoke")
    a = chip_smoke.parse_args(["--four-cards", "--out", "x"])
    assert a.four_cards and a.out == "x"
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--bogus"])


def test_bench_refuses_cpu():
    r = _run(["bench.py", "--steps", "1"])
    assert r.returncode != 0
    assert "measures a GPU" in r.stderr
    assert r.stdout.strip() == ""


def test_sweep_trace_refuses_cpu(tmp_path):
    r = _run([os.path.join("benchmarks", "sweep_trace.py"),
              "--out", str(tmp_path)])
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert r.stdout.strip() == ""


def test_run_without_vis_needs_no_plotting(tmp_path):
    """run.py imports matplotlib/PIL only for --vis/--animate."""
    code = ("import sys\n"
            "for m in ('matplotlib', 'PIL', 'flax'):\n"
            "    sys.modules[m] = None\n"
            "from navierstokes3d_tpu.run import main\n"
            "main(['--preset', 'multi', '--nx', '9', '--nt', '2', '--save',"
            f" '--out-dir', {str(tmp_path)!r}, '--quiet'])\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"steps"' in r.stdout


def test_package_import_needs_no_flax_or_plotting():
    code = ("import sys\n"
            "for m in ('matplotlib', 'PIL', 'flax'):\n"
            "    sys.modules[m] = None\n"
            "import navierstokes3d_tpu, navierstokes3d_tpu.parallel.fullstep\n"
            "import navierstokes3d_tpu.io\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr[-2000:]
