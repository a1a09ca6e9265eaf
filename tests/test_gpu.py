"""Checks that need an NVIDIA GPU. Skipped elsewhere (the `gpu_backend`
fixture decides at run time); chip_smoke.py runs them on the card."""

import numpy as np
import pytest

import navierstokes3d_tpu as ns
from navierstokes3d_tpu.utils.peaks import peak_hbm_gbps


@pytest.mark.gpu
def test_peak_table_knows_this_gpu(gpu_backend):
    """The benchmark's roofline needs this card's published HBM rate."""
    assert peak_hbm_gbps(gpu_backend.device_kind) > 1000.0


@pytest.mark.gpu
def test_f32_step_on_gpu_converges(gpu_backend):
    s = ns.ChorinSolver(ns.preset_multi(nx=31, nt=1, compat=False,
                                        dtype="float32"))
    st, stats = s.step_jit(s.init_state())
    assert st.pr.devices() == {gpu_backend}
    assert float(stats.err) < s.cfg.numerics.eps_it
    assert int(stats.iters) < s.grid.niter
    assert np.isfinite(np.asarray(st.vx)).all()
