"""I/O layer: binary format parity, MAT round-trip, checkpoint/resume."""

import os
import subprocess
import sys

import numpy as np
import pytest

import navierstokes3d_tpu as ns
from navierstokes3d_tpu.io import binio, checkpoint, matio


def test_bin_roundtrip_column_major(tmp_path):
    """The .bin layout must match Julia's column-major write
    (NavierStokes3D_multi_gpu.jl:27-30): element (i,j,k) at flat index
    i + j*n1 + k*n1*n2."""
    a = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    p = binio.save_array(str(tmp_path / "t"), a)
    raw = np.fromfile(p, dtype=np.float32)
    assert raw[0] == a[0, 0, 0]
    assert raw[1] == a[1, 0, 0]          # i fastest
    assert raw[2] == a[0, 1, 0]          # then j
    assert raw[2 * 3] == a[0, 0, 1]      # then k
    back = binio.load_array(p, a.shape)
    np.testing.assert_array_equal(back, a.astype(np.float32))


def test_save_fields_naming(tmp_path):
    paths = binio.save_fields(str(tmp_path), 7,
                              {"C": np.zeros((2, 2, 2)),
                               "Pr": np.ones((2, 2, 2))})
    assert paths["C"].endswith("out_C_v_0007.bin")
    assert os.path.exists(paths["Pr"])


def test_mat_roundtrip(tmp_path):
    pr = np.random.default_rng(0).random((3, 4, 5))
    p = matio.save_step_mat(str(tmp_path), 3, pr, pr, pr, pr, pr,
                            0.1, 0.2, 0.3)
    d = matio.load_step_mat(p)
    np.testing.assert_allclose(d["Pr"], pr)
    assert float(np.asarray(d["dx"]).reshape(-1)[0]) == 0.1


def test_checkpoint_resume_bitexact(tmp_path):
    """A resumed run must continue exactly where the original stopped."""
    cfg = ns.preset_multi(nx=9, nt=4, compat=False)
    solver = ns.ChorinSolver(cfg)

    state = solver.init_state()
    for _ in range(2):
        state, _ = solver.step_jit(state)
    ck = checkpoint.save_checkpoint(str(tmp_path / "ckpt_0000002.npz"),
                                    state, 2)
    # continue the original
    cont = state
    for _ in range(2):
        cont, _ = solver.step_jit(cont)
    # resume from disk and continue
    resumed, it = checkpoint.load_checkpoint(str(tmp_path / "ckpt_0000002.npz"),
                                             dtype=cfg.numerics.jnp_dtype)
    assert it == 2
    for _ in range(2):
        resumed, _ = solver.step_jit(resumed)
    for name in ("pr", "vx", "vy", "vz", "c", "dprdtau"):
        np.testing.assert_array_equal(np.asarray(getattr(cont, name)),
                                      np.asarray(getattr(resumed, name)),
                                      err_msg=name)


def test_cli_end_to_end(tmp_path):
    """Drive the CLI: short run with save+vis+checkpoint, then resume."""
    base = [sys.executable, "-m", "navierstokes3d_tpu.run",
            "--preset", "multi", "--nx", "9", "--dtype", "float32",
            "--platform", "cpu",
            "--out-dir", str(tmp_path / "out"),
            "--viz-dir", str(tmp_path / "viz"),
            "--ckpt-dir", str(tmp_path / "ck"), "--quiet"]
    r = subprocess.run(base + ["--nt", "4", "--save", "--vis",
                               "--nvis", "2", "--nsave", "2",
                               "--checkpoint-every", "2", "--animate"],
                       capture_output=True, text=True,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr[-2000:]
    assert (tmp_path / "out" / "out_Pr_v_0001.bin").exists()
    assert (tmp_path / "viz" / "3D_NavierStokes_xy_Pr_0001.png").exists()
    assert (tmp_path / "ck" / "ckpt_0000004.npz").exists()
    # --animate assembled the frames into the showcase GIFs
    # (reference README.md:58-93)
    gif = tmp_path / "viz" / "Vx_xy.gif"
    assert gif.exists() and gif.stat().st_size > 0
    assert (tmp_path / "viz" / "Pr_xz.gif").exists()
    # resume toward a LARGER total horizon: --nt is the TOTAL step count
    # (the reference's nt, gpu.jl:44-51), so this runs steps 5-6 only
    frame1 = tmp_path / "viz" / "3D_NavierStokes_xy_Pr_0001.png"
    frame1_mtime = frame1.stat().st_mtime
    r2 = subprocess.run(base + ["--nt", "6", "--resume",
                                "--checkpoint-every", "2",
                                "--vis", "--nvis", "2"],
                        capture_output=True, text=True,
                        cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r2.returncode == 0, r2.stderr[-2000:]
    # --quiet suppresses the "resumed from" notice; the step-6 checkpoint
    # proves the continuation ran exactly steps 5-6
    assert (tmp_path / "ck" / "ckpt_0000006.npz").exists()
    # frame numbering continues from the step (it // nvis), so the
    # resumed run writes frame 0003 (step 6) and must NOT restart at 0
    # and overwrite the original frames
    assert (tmp_path / "viz" / "3D_NavierStokes_xy_Pr_0003.png").exists()
    assert frame1.stat().st_mtime == frame1_mtime, \
        "resume overwrote an earlier frame (index counter restarted)"
    # re-running the ORIGINAL command with --resume completes (and here
    # is already complete): it must NOT run nt further steps
    r3 = subprocess.run(base + ["--nt", "4", "--resume"],
                        capture_output=True, text=True,
                        cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r3.returncode == 0, r3.stderr[-2000:]
    assert "nothing to do" in r3.stderr


def test_native_io_roundtrip(tmp_path):
    """C++ runtime (csrc/ns3dio.cpp): format parity with the NumPy path,
    sync + async, and read-back."""
    from navierstokes3d_tpu.io import native
    if native.lib() is None:
        pytest.skip("native toolchain unavailable")
    a = np.random.default_rng(1).random((7, 5, 3)).astype(np.float32)
    p_native = str(tmp_path / "n")
    p_numpy = str(tmp_path / "p")
    assert native.write_f32(p_native + ".bin", a)
    np.asarray(a, dtype=np.float32).flatten(order="F").tofile(p_numpy + ".bin")
    with open(p_native + ".bin", "rb") as f1, open(p_numpy + ".bin", "rb") as f2:
        assert f1.read() == f2.read(), "byte-identical to reference layout"
    back = native.read_f32(p_native + ".bin", a.shape)
    np.testing.assert_array_equal(back, a)
    # async path: queue several, drain, verify
    for i in range(5):
        assert native.write_f32(str(tmp_path / f"a{i}.bin"), a + i,
                                asynchronous=True)
    native.drain()
    for i in range(5):
        back = native.read_f32(str(tmp_path / f"a{i}.bin"), a.shape)
        np.testing.assert_array_equal(back, a + np.float32(i))


def test_compat_api_run_navierstokes3d(tmp_path):
    """Drop-in reference entry function: signature, side effects, returns."""
    from navierstokes3d_tpu.compat_api import run_navierstokes3d
    c, pr, vx, vy, vz = run_navierstokes3d(
        do_vis=False, do_save=True, do_print=False, nx=10, nt=1,
        out_dir=str(tmp_path / "out"))
    # gathered inner shapes as the reference returns (multi_gpu.jl:386-390)
    assert c.shape == (8, 4, 4)
    assert vx.shape == (9, 4, 4)
    assert (tmp_path / "out" / "out_Pr_v_0000.bin").exists()
    assert not np.isnan(pr).any()


def test_compat_api_runme(tmp_path):
    """Drop-in gpu-script entry function: .mat snapshots + return state."""
    from navierstokes3d_tpu.compat_api import runme
    state = runme(do_vis=False, do_save=True, nx=10, nt=1,
                  out_dir=str(tmp_path / "out"))
    assert (tmp_path / "out" / "step_0.mat").exists()
    assert not np.isnan(np.asarray(state.pr)).any()


def test_cli_jsonl_log(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "navierstokes3d_tpu.run", "--nx", "9",
         "--nt", "2", "--dtype", "float32", "--platform", "cpu", "--quiet",
         "--log-jsonl", str(tmp_path / "steps.jsonl")],
        capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr[-2000:]
    import json as _json
    lines = [_json.loads(l) for l in open(tmp_path / "steps.jsonl")]
    assert len(lines) == 2 and lines[0]["it"] == 1 and "err" in lines[0]


def test_cli_sync_every_pipelines_steps(tmp_path):
    """--sync-every 3: steps pipeline between host syncs but every
    per-step record still lands (batched stats processing)."""
    r = subprocess.run(
        [sys.executable, "-m", "navierstokes3d_tpu.run", "--nx", "9",
         "--nt", "5", "--dtype", "float32", "--platform", "cpu",
         "--quiet", "--sync-every", "3",
         "--log-jsonl", str(tmp_path / "steps.jsonl")],
        capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr[-2000:]
    import json as _json
    lines = [_json.loads(l) for l in open(tmp_path / "steps.jsonl")]
    assert [l["it"] for l in lines] == [1, 2, 3, 4, 5]
    assert all("err" in l and "iters" in l for l in lines)
    summary = _json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["steps"] == 4  # summary skips the compile step


def test_cli_shard_map_comm(tmp_path):
    """CLI --comm shard_map drives the explicit ppermute-halo Poisson path
    with halo batching on a virtual mesh."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run(
        [sys.executable, "-m", "navierstokes3d_tpu.run", "--nx", "16",
         "--nt", "2", "--dtype", "float32", "--platform", "cpu",
         "--mesh", "2x2x2", "--comm", "shard_map", "--halo-width", "2",
         "--quiet"],
        capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "poisson_iters_per_sec" in r.stdout


def test_cli_independent_vis_save_cadence(tmp_path):
    """--nvis 3 --nsave 5 over 6 steps: viz frames at it=0,3,6; saves at
    it=0,5. The reference checks the two cadences independently
    (gpu.jl:143,168); .mat snapshots are keyed by the step number with
    full-shape fields (gpu.jl:169)."""
    out = tmp_path / "out"
    vdir = tmp_path / "viz"
    r = subprocess.run(
        [sys.executable, "-m", "navierstokes3d_tpu.run", "--nx", "9",
         "--nt", "6", "--dtype", "float32", "--platform", "cpu", "--quiet",
         "--vis", "--save", "--nvis", "3", "--nsave", "5",
         "--out-dir", str(out), "--viz-dir", str(vdir)],
        capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr[-2000:]
    # saves: frames 0000 (init) + 0001 (it=5), nothing else
    assert (out / "out_Pr_v_0000.bin").exists()
    assert (out / "out_Pr_v_0001.bin").exists()
    assert not (out / "out_Pr_v_0002.bin").exists()
    # .mat keyed by step it with full-shape fields (9 x 6 x 6 grid)
    assert (out / "step_0.mat").exists()
    assert (out / "step_5.mat").exists()
    assert not (out / "step_1.mat").exists()
    from navierstokes3d_tpu.io.matio import load_step_mat
    m = load_step_mat(str(out / "step_5.mat"))
    assert m["Pr"].shape == (9, 6, 6) and m["Vx"].shape == (10, 6, 6)
    # viz frames 0 (init), 1 (it=3), 2 (it=6)
    pngs = sorted(p.name for p in vdir.glob("3D_NavierStokes_xy_Pr_*.png"))
    assert pngs == [f"3D_NavierStokes_xy_Pr_{i:04d}.png" for i in range(3)]


def test_cli_abort_on_nan(tmp_path):
    """--abort-on-nan: a NaN-poisoned resume state makes the first step's
    residual non-finite; the run must exit non-zero AFTER writing a
    snapshot of the offending state whose name does NOT match the
    checkpoint pattern — a later --resume must load the last GOOD
    checkpoint, never the poisoned state (the reference only breaks the
    Poisson loop and keeps stepping, gpu.jl:135)."""
    import jax.numpy as jnp

    cfg = ns.preset_multi(nx=9, nt=1, compat=False, dtype="float32")
    solver = ns.ChorinSolver(cfg)
    state = solver.init_state()
    bad = np.asarray(state.pr).copy()
    bad[3, 2, 2] = np.nan
    state = state.replace(pr=jnp.asarray(bad))
    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    checkpoint.save_checkpoint(str(ckdir / "ckpt_0000003.npz"), state, 3,
                               pressure_split=solver.pressure_split)
    r = subprocess.run(
        [sys.executable, "-m", "navierstokes3d_tpu.run",
         "--preset", "multi", "--nx", "9", "--dtype", "float32",
         "--platform", "cpu", "--ckpt-dir", str(ckdir), "--resume",
         "--nt", "6", "--abort-on-nan", "--quiet"],
        capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode != 0
    assert "non-finite residual" in r.stderr
    assert (ckdir / "nanstate_0000004.npz").exists()
    # the poisoned snapshot must NOT shadow the resume chain
    assert checkpoint.latest_checkpoint(str(ckdir)).endswith(
        "ckpt_0000003.npz")
