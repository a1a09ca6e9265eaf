"""Trace one step of the `pt` solve on the GPU and reduce it to per-sweep
metrics; time the two advection backends at the same grid.

What it prints (one JSON object per line on stdout, details in
<out>/sweep_trace.json):
  * steady seconds per step (host clock, profiler off, chained steps);
  * from a jax.profiler trace of one step: device busy time, idle share,
    the kernels that run once per Poisson sweep, fusions per sweep,
    device time per sweep and the device gap between sweeps, against
    the sweep's HBM bound (utils/peaks.pt_sweep_bytes at the card's
    published rate);
  * advection alone (jit of ops/advect.advect on the step's fields) and
    whole steps, for 'gather' and 'selectshift', in turns
    (gather, selectshift, selectshift, gather).

Usage: python benchmarks/sweep_trace.py [--preset gpu] [--nx 255]
       [--out chiprun_out/sweep_trace]
It exits non-zero, having measured nothing, when JAX finds no GPU.
"""

import argparse
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def device_kernel_events(xplane_path, plane_prefix="/device:GPU:0"):
    """(name, start_ns, duration_ns) of every kernel the trace recorded on
    the device plane `plane_prefix`. Derived lines ('XLA Ops',
    'XLA Modules', ...) are skipped when stream lines exist, so each
    kernel counts once."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(xplane_path)
    planes = [p for p in pd.planes if p.name.startswith(plane_prefix)]
    if not planes:
        raise ValueError(f"no plane {plane_prefix!r} in {xplane_path}: "
                         f"{[p.name for p in pd.planes]}")
    lines = list(planes[0].lines)
    streams = [ln for ln in lines if ln.name.startswith("Stream")]
    out = []
    for ln in streams or lines:
        for e in ln.events:
            if e.duration_ns > 0:
                out.append((e.name, float(e.start_ns), float(e.duration_ns)))
    out.sort(key=lambda t: t[1])
    return out


def busy_ns(events):
    """Length of the union of the events' [start, start+duration)."""
    total, end = 0.0, -1.0
    for _, s, d in sorted(events, key=lambda t: t[1]):
        e = s + d
        if s >= end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def sweep_metrics(events, sweeps):
    """Reduce one traced step to per-sweep numbers. A kernel belongs to
    the sweep when it ran at least 0.9 * sweeps times."""
    counts, dur = {}, {}
    for name, _, d in events:
        counts[name] = counts.get(name, 0) + 1
        dur[name] = dur.get(name, 0.0) + d
    per_sweep = sorted(n for n, c in counts.items() if c >= 0.9 * sweeps)
    sweep_ev = [e for e in events if e[0] in per_sweep]
    window = events[-1][1] + events[-1][2] - events[0][1]
    busy = busy_ns(events)
    res = dict(kernels=len(events), window_ns=window, busy_ns=busy,
               idle_share=1.0 - busy / window,
               sweep_kernels={n: dict(count=counts[n], total_ns=dur[n])
                              for n in per_sweep},
               memcpy_events=sum(c for n, c in counts.items()
                                 if "memcpy" in n.lower()))
    if sweep_ev and sweeps:
        s_win = (sweep_ev[-1][1] + sweep_ev[-1][2]) - sweep_ev[0][1]
        s_busy = busy_ns(sweep_ev)
        res.update(
            fusions_per_sweep=len(sweep_ev) / sweeps,
            device_ns_per_sweep=s_busy / sweeps,
            gap_ns_per_sweep=(s_win - s_busy) / sweeps,
            wall_ns_per_sweep=s_win / sweeps)
    top = sorted(dur.items(), key=lambda kv: -kv[1])[:15]
    res["top_kernels"] = [dict(name=n, count=counts[n], total_ns=t)
                          for n, t in top]
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=("gpu", "multi"), default="gpu")
    ap.add_argument("--nx", type=int, default=255)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "sweep_trace"))
    args = ap.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"sweep_trace: JAX found no GPU (platform "
                         f"{dev.platform!r}); nothing was measured")

    import navierstokes3d_tpu as ns
    from navierstokes3d_tpu.ops.advect import advect
    from navierstokes3d_tpu.utils.cache import enable_compile_cache
    from navierstokes3d_tpu.utils.peaks import peak_hbm_gbps, pt_sweep_bytes
    enable_compile_cache()
    os.makedirs(args.out, exist_ok=True)
    report = dict(device=dev.device_kind, platform=dev.platform)

    def emit(**kw):
        report.update(kw)
        print(json.dumps(kw), flush=True)

    make = ns.preset_gpu if args.preset == "gpu" else ns.preset_multi
    cfg = make(nx=args.nx, nt=1, compat=False, dtype="float32")
    solver = ns.ChorinSolver(cfg)
    g = solver.grid
    cells = g.nx * g.ny * g.nz

    state = solver.init_state()
    for _ in range(2):  # both step structures (pr_lo appears at step 2)
        state, stats = solver.step_jit(state)
    jax.block_until_ready(state.pr)

    # steady step time, profiler off
    t0 = time.perf_counter()
    all_stats = []
    for _ in range(args.steps):
        state, stats = solver.step_jit(state)
        all_stats.append(stats)
    jax.block_until_ready(state.pr)
    wall = (time.perf_counter() - t0) / args.steps
    iters = [int(s.iters) for s in all_stats]
    emit(phase="steady", grid=[g.nx, g.ny, g.nz], s_per_step=wall,
         iters=iters, iters_ext=[int(s.iters_ext or 0) for s in all_stats],
         err=[float(s.err) for s in all_stats])

    # one traced step (the trace itself stays out of --out: tens of MB)
    tdir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".cache", "sweep_trace")
    with jax.profiler.trace(tdir):
        state, stats = solver.step_jit(state)
        jax.block_until_ready(state.pr)
    n_it, n_ext = int(stats.iters), int(stats.iters_ext or 0)
    path = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    m = sweep_metrics(device_kernel_events(path), n_it)
    pair = n_it - n_ext if solver.accuracy == "extended" else 0
    bound_ns = ((pair * pt_sweep_bytes(cells, 4, True)
                 + (n_it - pair) * pt_sweep_bytes(cells, 4, False))
                / (peak_hbm_gbps() * 1e9) / n_it * 1e9)
    m.update(iters=n_it, iters_ext=n_ext, hbm_bound_ns_per_sweep=bound_ns)
    if "device_ns_per_sweep" in m:
        m["hbm_share"] = bound_ns / m["device_ns_per_sweep"]
    emit(phase="trace", **{k: v for k, v in m.items()
                           if k not in ("top_kernels",
                                        "sweep_kernels")})
    emit(phase="trace_kernels", sweep_kernels=[
        (n[:60], v["count"], round(v["total_ns"] / n_it))
        for n, v in m["sweep_kernels"].items()],
        top=[(k["name"][:60], k["count"], round(k["total_ns"] / 1e3))
             for k in m["top_kernels"]])
    report["trace_detail"] = m
    emit(phase="memory", peak_bytes_in_use=(
        dev.memory_stats() or {}).get("peak_bytes_in_use"))

    # advection alone, both backends, on this step's fields
    fields = (state.vx, state.vy, state.vz, state.c)
    adv = {meth: jax.jit(lambda vx, vy, vz, c, _m=meth: advect(
        vx, vy, vz, c, g.dt, g.dx, g.dy, g.dz, compat=False, method=_m,
        with_stats=True, k=solver.advect_k)) for meth in ("gather",
                                                          "selectshift")}
    times = {"gather": [], "selectshift": []}
    for meth in ("gather", "selectshift"):
        jax.block_until_ready(adv[meth](*fields))
    for meth in ("gather", "selectshift", "selectshift", "gather"):
        x = fields
        t0 = time.perf_counter()
        for _ in range(10):
            x = adv[meth](*x)[:4]
        jax.block_until_ready(x)
        times[meth].append((time.perf_counter() - t0) / 10)
    emit(phase="advect_alone", ms_gather=[t * 1e3 for t in times["gather"]],
         ms_selectshift=[t * 1e3 for t in times["selectshift"]])

    # whole steps with each backend, in turns, from copies of one state
    solvers = {}
    for meth in ("gather", "selectshift"):
        s = ns.ChorinSolver(cfg)
        s.advect_method = meth
        solvers[meth] = s
        jax.block_until_ready(s.step_jit(jax.tree.map(jnp.copy, state))[0].pr)
    step_t = {"gather": [], "selectshift": []}
    for meth in ("gather", "selectshift", "selectshift", "gather"):
        st = jax.tree.map(jnp.copy, state)
        jax.block_until_ready(st.pr)
        t0 = time.perf_counter()
        for _ in range(2):
            st, sts = solvers[meth].step_jit(st)
        jax.block_until_ready(st.pr)
        step_t[meth].append((time.perf_counter() - t0) / 2)
    emit(phase="advect_step", s_gather=step_t["gather"],
         s_selectshift=step_t["selectshift"])

    with open(os.path.join(args.out, "sweep_trace.json"), "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
