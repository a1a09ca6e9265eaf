"""Profiling/observability utilities (utils/profiling.py, utils/timers
.py) — the aux subsystem the reference lacks entirely (SURVEY.md §5).
Smoke-level: the trace context writes real artifacts and profile_steps
returns the north-star metrics."""

import glob
import os

import navierstokes3d_tpu as ns
from navierstokes3d_tpu.utils.profiling import profile_steps, trace


def test_profile_steps_summary_and_trace(tmp_path, monkeypatch):
    import jax
    from navierstokes3d_tpu.utils import peaks
    cfg = ns.preset_multi(nx=9, nt=1, compat=False, dtype="float32")
    s = ns.ChorinSolver(cfg)
    state = s.init_state()
    state, _ = s.step_jit(state)   # warm (profile assumes compiled)
    # the CPU has no entry in the peak table (utils/peaks.py): give it a
    # nominal rate, which only exercises the roofline arithmetic
    monkeypatch.setitem(peaks.PEAKS, jax.devices()[0].device_kind,
                        {"hbm_gbps": 50.0})
    out = profile_steps(s, state, n_steps=2, trace_dir=str(tmp_path / "tr"))
    assert out["poisson_iters_per_sec"] > 0
    assert out["time_per_step_s"] > 0
    assert out["roofline_iters_per_sec"] > 0
    assert 0 < out["roofline_fraction"]
    files = glob.glob(str(tmp_path / "tr" / "**" / "*"), recursive=True)
    assert any(os.path.isfile(f) for f in files), "no trace artifacts"


def test_trace_context_manager(tmp_path):
    import jax.numpy as jnp
    with trace(str(tmp_path / "t2")) as d:
        (jnp.ones((8, 8)) * 2).sum().block_until_ready()
    assert glob.glob(d + "/**/*", recursive=True)


def test_profile_steps_refuses_unknown_device_peak():
    """A device missing from the peak table (here the CPU) is an error,
    never an assumed peak."""
    import pytest
    s = ns.ChorinSolver(ns.preset_multi(nx=9, nt=1, compat=False,
                                        dtype="float32"))
    state, _ = s.step_jit(s.init_state())
    with pytest.raises(KeyError, match="no published peaks"):
        profile_steps(s, state, n_steps=1)


def _sweep_trace():
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "benchmarks", "sweep_trace.py")
    spec = importlib.util.spec_from_file_location("sweep_trace", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_reduction_on_synthetic_events():
    """benchmarks/sweep_trace.py's reduction: 3 sweeps of two kernels
    with a 10 ns gap after each sweep, plus one kernel outside."""
    st = _sweep_trace()
    ev = [("pre", 0.0, 50.0)]
    t = 60.0
    for _ in range(3):
        ev += [("a", t, 20.0), ("b", t + 20.0, 30.0)]
        t += 60.0
    assert st.busy_ns(ev) == 50.0 + 3 * 50.0
    assert st.busy_ns([("x", 0.0, 10.0), ("y", 5.0, 10.0)]) == 15.0
    m = st.sweep_metrics(ev, 3)
    assert sorted(m["sweep_kernels"]) == ["a", "b"]
    assert m["fusions_per_sweep"] == 2.0
    assert m["device_ns_per_sweep"] == 50.0
    assert abs(m["gap_ns_per_sweep"] - 20.0 / 3) < 1e-9
    assert abs(m["idle_share"] - (1 - 200.0 / 230.0)) < 1e-12


def test_trace_reduction_reads_a_recorded_trace(tmp_path):
    """device_kernel_events on a real (CPU) profiler trace: the jitted
    fusion shows up on the host plane with its duration."""
    import jax
    import jax.numpy as jnp
    st = _sweep_trace()
    f = jax.jit(lambda x: jnp.sin(x) * 2 + 1)
    x = jnp.ones((256, 256))
    f(x).block_until_ready()
    with trace(str(tmp_path / "t3")):
        for _ in range(3):
            x = f(x)
        x.block_until_ready()
    path = glob.glob(str(tmp_path / "t3" / "**" / "*.xplane.pb"),
                     recursive=True)[-1]
    ev = st.device_kernel_events(path, plane_prefix="/host:CPU")
    assert ev and all(d > 0 for _, _, d in ev)
    assert st.busy_ns(ev) > 0
    import pytest
    with pytest.raises(ValueError, match="no plane"):
        st.device_kernel_events(path, plane_prefix="/device:GPU:0")
