#!/usr/bin/env python3
"""On-card smoke test: the full sea-ice step on an NVIDIA GPU.

Run from the root of a checkout, one process per machine:

    python3 chip_smoke.py           # phases 1-4, one GPU
    python3 chip_smoke.py --multi   # phase 5 only, four GPUs

1. Device: card name and power limit (nvidia-smi), JAX version and
   devices.  Anything but a GPU is refused.
2. gx1-size (320x384 cyclic/closed lat-lon, repo-made land mask), f32,
   ndte=120, analytic forcing, guards on: one model day (24 steps)
   through `driver.IceModelRun`, with runtime diagnostics, one history
   file and one restart (read back and compared); then the EVP, remap
   and column-physics phases timed alone, with Newton iteration counts.
3. ACCESS-OM 0.25-degree tripole (1440x1080), f32, ndte=120, guards
   on: a few steps through `IceModelRun`, phases as in 2.
4. Correctness on the gx1-size grid, 3 steps: GPU f64 against the host
   CPU backend f64 (median pointwise errors after step 1 bounded, the
   largest printed and located), and GPU f32 against GPU f64; global
   integrals after step 3 bounded for both.
5. ``--multi``: 0.25-degree tripole and 320x384 closed, each sharded
   2x2 over four GPUs against the unsharded step on one
   (`parallel/twin.py`), with the k-halo EVP/remap paths asserted
   engaged.

XLA:GPU takes ~5 minutes to compile a step program, so all programs
are traced first and then compiled concurrently.  Any failure exits
non-zero; no phase is skipped.  Step and compile times are smoke
numbers (one short window, cold compile cache), printed beside the
card's name and power limit.  The last line of standard output is one
JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chip_smoke_out")

FIELDS = ("aicen", "vicen", "vsnon", "eicen", "uvel", "vvel", "tsfcn",
          "sst")
CORRECTNESS_STEPS = 3
# The step is chaotic in EVP: its 120 subcycles amplify any roundoff
# difference until it saturates at the size of the iteration's own
# noise.  GPU f64 and CPU f64 (same arithmetic, other summation order
# and FMA contraction; no matrix products, so no TF32) make no decision
# differently after step 1 on the H100 (no iceumask or ice-presence
# flip, no cell at the tinyarea floor), yet differ by a median 1.1e-2 of
# the largest |vvel| over ice cells, about as much as GPU f32 does
# (5.0e-2).  Pointwise errors are therefore bounded only against gross
# breakage: the step-1 medians over ice cells, at ~10x the H100
# readings (aicen 3.4e-6, vicen 1.8e-6, vsnon 2.8e-6, eicen 1.7e-6, uvel
# 9.6e-4, vvel 1.1e-2, tsfcn 2.9e-8, sst 1.2e-9), since the CPU side
# may run on another host CPU.  The largest are printed and located.
F64_MEDIAN_LIMITS = dict(aicen=3e-5, vicen=2e-5, vsnon=3e-5, eicen=2e-5,
                         uvel=1e-2, vvel=0.1, tsfcn=3e-7, sst=1e-8)
# Global integrals after CORRECTNESS_STEPS steps, GPU f64 vs CPU f64:
# ~10x the H100 readings (area 1.2e-7, volume 1.9e-9, snow 5.0e-8,
# enthalpy 1.9e-9, tsfc_aw 2.3e-7, speed 4.1e-5, sst 2.4e-13).  A GPU
# f32 run fails every one of them.
F64_LIMITS = dict(area=2e-6, volume=2e-8, snow=5e-7, enthalpy=2e-8,
                  tsfc_aw=3e-6, speed=5e-4, sst=3e-12)
# GPU f32 vs GPU f64: PARITY.md's 1e-4 bound for f32-vs-f64 drift of
# hemispheric integrals (readings <= 2.4e-5 on the H100); ice speed:
# 1.5x the reading of 3.38e-3 (bit-identical in three runs).
F32_LIMITS = dict(area=1e-4, volume=1e-4, snow=1e-4, enthalpy=1e-4,
                  tsfc_aw=1e-4, speed=5e-3, sst=1e-4)

def log(msg=""):
    print(msg, flush=True)


def card_lines() -> list[str]:
    """`nvidia-smi --query-gpu=name,power.limit` lines (a child process
    that stays off JAX)."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi unavailable ({e})"]
    lines = proc.stdout.strip().splitlines()
    return lines or [f"nvidia-smi gave nothing: {proc.stderr.strip()}"]


def phase_device(need: int) -> str:
    import jax

    cards = card_lines()
    for line in cards:
        log(f"card: {line}")
    log(f"jax {jax.__version__}")
    devs = jax.devices()
    log(f"devices: {devs}")
    if devs[0].platform != "gpu":
        raise SystemExit(
            "chip_smoke: no GPU — JAX's first device is "
            f"{devs[0].platform!r} ({devs[0].device_kind}); this smoke "
            "test runs only on an NVIDIA GPU")
    if len(devs) < need:
        raise SystemExit(f"chip_smoke: need {need} GPUs, JAX sees "
                         f"{len(devs)}")
    return cards[0]


def compile_all(lowered: dict) -> dict:
    """Compile every lowered program concurrently (XLA releases the
    GIL); returns {key: (executable, seconds)}."""
    def one(item):
        key, low = item
        t0 = time.perf_counter()
        exe = low.compile()
        return key, (exe, time.perf_counter() - t0)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(lowered)) as ex:
        out = dict(ex.map(one, lowered.items()))
    log(f"compiled {len(out)} programs concurrently in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{'/'.join(k)} {s:.1f} s" for k, (_, s) in out.items()))
    return out


def check_state(state, tag):
    """Finite prognostics, area fractions in [0, 1], some ice."""
    import jax
    import numpy as np

    for path, leaf in jax.tree_util.tree_leaves_with_path(state):
        a = np.asarray(leaf)
        if a.dtype.kind == "f" and not np.all(np.isfinite(a)):
            raise AssertionError(f"{tag}: non-finite {path}")
    aice = np.asarray(state.aicen).sum(0)
    if aice.min() < 0.0 or aice.max() > 1.0 + 1e-5:
        raise AssertionError(f"{tag}: aice out of [0, 1]: "
                             f"{aice.min()} .. {aice.max()}")
    if not aice.max() > 0.0:
        raise AssertionError(f"{tag}: no ice left")
    return float(aice.sum())


# -- one deployment: driver run + per-phase probes ----------------------

def _clock(run):
    import jax.numpy as jnp

    cal = run.calendar
    return (jnp.asarray(cal.yday, run.dtype),
            jnp.asarray(cal.sec, run.dtype))


def _probes(run):
    """The step's three heavy phases, each jitted alone on the run's
    state: column physics (the model's radiation + `_step_therm1`, with
    per-cell Newton iteration counts), EVP and remap."""
    import jax

    from cice4_tpu import model as M
    from cice4_tpu.ops import itd as itd_ops
    from cice4_tpu.ops.evp import evp
    from cice4_tpu.ops.remap import transport_remap
    from cice4_tpu.state import freezing_temperature

    cfg, grid, model = run.cfg, run.grid, run.model
    dt, tc = cfg.run.dt, cfg.transport
    f = run.forcing_provider(run.calendar.yday, run.calendar.sec)
    yday, sec = _clock(run)

    def column(state):
        if cfg.radiation.prep_radiation:
            sw = M._prep_radiation(model, state, f)
        else:
            sw = M._step_radiation(model, state, grid, f, yday, sec, dt)
        Tf = freezing_temperature(cfg, f.sss)
        _, fx, _ = M._step_therm1(model, state, grid, f, sw, Tf, yday, dt)
        return fx["niter_cell"], fx["strairxT"], fx["strairyT"]

    def dynamics(state, strx, stry):
        agg = itd_ops.aggregate(state, grid.tmask)
        s, _ = evp(state, grid, cfg.dynamics, dt, agg["aice"], agg["vice"],
                   agg["vsno"], state.aicen, state.vicen, agg["aice0"],
                   f.uocn, f.vocn, f.ss_tltx, f.ss_tlty, strx, stry)
        return s.uvel, s.vvel, s.stressp

    def remap(state):
        s, aice0 = transport_remap(state, grid, dt, tc.integral_order,
                                   tc.l_dp_midpt, tc.l_fixed_area)
        return s.aicen, s.vicen, s.eicen, aice0

    plane = jax.ShapeDtypeStruct((grid.ny, grid.nx), run.dtype)
    return dict(column=jax.jit(column).lower(run.state),
                evp=jax.jit(dynamics).lower(run.state, plane, plane),
                remap=jax.jit(remap).lower(run.state))


def lower_deployment(tag, cfg):
    """Initialize an f32 `IceModelRun` and trace its step and probes."""
    import jax
    import jax.numpy as jnp

    from cice4_tpu.driver import IceModelRun

    t0 = time.perf_counter()
    run = IceModelRun(cfg, dtype=jnp.float32,
                      log=lambda m: log(f"  [{tag}] {m}"))
    run.initialize()
    jax.block_until_ready(run.state.aicen)
    forcing = run.forcing_provider(run.calendar.yday, run.calendar.sec,
                                   cal=run.calendar, state=run.state)
    lowered = {(tag, "step"): run._step.lower(run.state, forcing,
                                              *_clock(run))}
    lowered.update({(tag, k): v for k, v in _probes(run).items()})
    log(f"{tag}: grid {run.grid.ny}x{run.grid.nx}, init + trace "
        f"{time.perf_counter() - t0:.1f} s")
    return run, forcing, lowered


def timed(exe, args, n):
    import jax

    out = exe(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = exe(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n, out


def run_deployment(tag, run, forcing, exes, nsteps, timed_n, card):
    """Run `nsteps` through `IceModelRun` (guards, diagnostics,
    history, restart as its config says), then time the bare step and
    the phase probes on the evolved state."""
    import jax
    import numpy as np

    from cice4_tpu.guards import raise_on_violation

    step = exes[(tag, "step")][0]
    log(f"{tag}: step memory_analysis: {step.memory_analysis()}")
    t0 = time.perf_counter()
    run.run(1)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    run.run(nsteps - 1)
    t_drv = (time.perf_counter() - t0) / (nsteps - 1)
    area = check_state(run.state, tag)

    state = run.state
    t_bare, out = timed(step, (state, forcing) + _clock(run), timed_n)
    raise_on_violation(out[1]["_guards"])
    peak = (jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use", -1)
    cells = run.grid.ny * run.grid.nx
    log(f"{tag}: SMOKE on {card}: first driver step {t_first:.2f} s; "
        f"driver {t_drv * 1e3:.2f} ms/step over {nsteps - 1} steps "
        f"(forcing, guards, history, diagnostics included); bare step "
        f"{t_bare * 1e3:.2f} ms ({cells / t_bare:.3e} cell-steps/s, "
        f"{150.0 / t_bare:.0f} simulated days/hour) over "
        f"{timed_n}; process peak_bytes_in_use {peak / 2**30:.2f} GiB; "
        f"ice area sum {area:.4f}")

    t_col, (niter_cell, strx, stry) = timed(
        exes[(tag, "column")][0], (state,), timed_n)
    t_evp, _ = timed(exes[(tag, "evp")][0], (state, strx, stry), timed_n)
    t_remap, _ = timed(exes[(tag, "remap")][0], (state,), timed_n)
    ice = np.asarray(state.aicen) > 0.0
    nc = np.asarray(niter_cell)
    # the solve loops until every cell of a category has converged
    niter = nc.reshape(nc.shape[0], -1).max(1)
    log(f"{tag}: SMOKE phases alone on {card}: column physics "
        f"(radiation + therm1) {t_col * 1e3:.2f} ms, EVP ndte=120 "
        f"{t_evp * 1e3:.2f} ms, remap {t_remap * 1e3:.2f} ms; Newton "
        f"iterations paid per category {niter.tolist()} vs "
        f"needed per ice cell: mean {nc[ice].mean():.2f}, max {nc.max()} "
        f"({int(ice.sum())} of {ice.size} category-cells have ice)")
    return run


def deployment_configs():
    from cice4_tpu.config import access_om_config, gx1_size_config

    common = {"dynamics.ndte": 120, "forcing.atm_data_type": "analytic",
              "run.guards": True}

    def dirs(name, **extra):
        d = os.path.join(OUT, name)
        return dict(common, **extra, **{
            "run.history_dir": os.path.join(d, "history") + "/",
            "run.restart_dir": os.path.join(d, "restart") + "/",
            "run.pointer_file": os.path.join(d, "restart", "pointer")})

    gx1 = gx1_size_config().with_values(**dirs(
        "gx1", **{"run.diagfreq": 12,
                  "run.histfreq": ("d", "x", "x", "x", "x"),
                  "run.dumpfreq": "d", "run.dumpfreq_n": 1}))
    acc = access_om_config(1440, 1080).with_values(**dirs(
        "access025", **{"run.diagfreq": 2}))
    return gx1, acc


def check_outputs(run):
    """The gx1 day wrote one history file and one restart that reads
    back bit-equal."""
    import numpy as np

    from cice4_tpu.io.restart import load_restart, read_pointer

    hist = sorted(glob.glob(os.path.join(run.cfg.run.history_dir, "*")))
    if len(hist) != 1:
        raise AssertionError(f"expected one history file, found {hist}")
    path = read_pointer(run.cfg.run.pointer_file)
    back, header = load_restart(path, run.state)
    for name in FIELDS:
        if not np.array_equal(np.asarray(getattr(back, name)),
                              np.asarray(getattr(run.state, name))):
            raise AssertionError(f"restart {name} differs")
    log(f"gx1-size: history {os.path.basename(hist[0])} "
        f"({os.path.getsize(hist[0])} B), restart "
        f"{os.path.basename(path)} @ step {header['istep']} read back "
        "bit-equal")


# -- phase 4: correctness ----------------------------------------------

def _trajectory(run, exe, nsteps):
    """`nsteps` of a compiled step from the run's initial state, with
    per-step forcing, guards and calendar as in `IceModelRun.run`.
    Returns the fields after the first step (with its EVP diagnostics)
    and after the last."""
    import numpy as np

    from cice4_tpu.guards import raise_on_violation

    cal, prov, state = run.calendar, run.forcing_provider, run.state
    tarea = np.asarray(run.grid.tarea, np.float64)
    snaps = []
    for k in range(nsteps):
        f = prov(cal.yday, cal.sec, cal=cal, state=state)
        state = prov.ocean_update(state, cal, run.cfg.run.dt)
        state, fx = exe(state, f, *_clock(run))
        raise_on_violation(fx["_guards"])
        cal.advance()
        if k in (0, nsteps - 1):
            snap = {n: np.asarray(getattr(state, n), np.float64)
                    for n in FIELDS}
            snap.update(tarea=tarea, iceumask=np.asarray(state.iceumask),
                        **{n: np.asarray(fx[n], np.float64) for n in
                           ("divu", "shear", "prs_sig", "strength")})
            snaps.append(snap)
    return snaps[0], snaps[-1]


def _integrals(r):
    """Global integrals: ice area, volume, snow volume, enthalpy, the
    ice-area-weighted surface temperature, ice speed and SST."""
    import numpy as np

    def tot(x):
        return float(np.sum(x * r["tarea"]))

    return dict(area=tot(r["aicen"]), volume=tot(r["vicen"]),
                snow=tot(r["vsnon"]), enthalpy=tot(r["eicen"]),
                tsfc_aw=tot(r["aicen"] * r["tsfcn"]),
                speed=tot(np.hypot(r["uvel"], r["vvel"])), sst=tot(r["sst"]))


def _integral_errors(ref, got):
    """Relative error of each global integral."""
    ia, ib = _integrals(ref), _integrals(got)
    return {k: abs(ia[k] - ib[k]) / max(abs(ia[k]), 1e-300) for k in ia}


def _pointwise(ref, got):
    """Per field, |a-b| / max|a| over the ice cells of `ref` (U cells
    for velocities): (largest, median)."""
    import numpy as np

    out = {}
    for k in FIELDS:
        ice = ref["iceumask"] if k in ("uvel", "vvel") \
            else ref["aicen"].sum(0) > 0.0
        e = np.abs(ref[k] - got[k]) / max(float(np.max(np.abs(ref[k]))),
                                          1e-300)
        e = e[np.broadcast_to(ice, e.shape)]
        out[k] = (float(e.max()), float(np.median(e)))
    return out


def _locate(ref, got, ecc):
    """Where two step-1 states part: decision flips, and the cell with
    the largest velocity difference with its strain-rate invariant
    Delta (from the step's cell-mean divu/shear) in units of the
    tinyarea floor (Delta = puny)."""
    import numpy as np

    from cice4_tpu.constants import puny

    flips_u = int(np.sum(ref["iceumask"] != got["iceumask"]))
    flips_a = int(np.sum((ref["aicen"] > 0.0) != (got["aicen"] > 0.0)))
    at_floor = int(np.sum((ref["strength"] > 0.0)
                          & (ref["prs_sig"] < ref["strength"] * (1 - 1e-9))))
    delta = np.sqrt(ref["divu"] ** 2 + ref["shear"] ** 2 / ecc) / puny
    # U(j, i) is the NE corner of T(j, i), T(j, i+1), T(j+1, i), T(j+1, i+1)
    du = np.minimum.reduce([np.roll(delta, s, (0, 1)) for s in
                            ((0, 0), (0, -1), (-1, 0), (-1, -1))])
    dv = np.hypot(ref["uvel"] - got["uvel"], ref["vvel"] - got["vvel"])
    speed = np.hypot(ref["uvel"], ref["vvel"])
    vmax = float(speed.max())
    j, i = np.unravel_index(np.argmax(dv), dv.shape)
    ice = ref["iceumask"]
    edges = (0.0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, np.inf)
    bins = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = ice & (du >= lo) & (du < hi)
        if m.any():
            bins.append(f"[{lo:g},{hi:g}) {int(m.sum())} cells max "
                        f"{dv[m].max() / vmax:.1e}")
    return (f"iceumask flips {flips_u} of {int(ice.sum())} U cells, "
            f"ice-presence flips {flips_a}, T cells at the tinyarea floor "
            f"{at_floor}; largest |dvel| {dv[j, i] / vmax:.3e} of max "
            f"speed at U({j},{i}): speed {speed[j, i]:.3e} m/s, aice "
            f"{ref['aicen'].sum(0)[j, i]:.5f}, Delta/puny {du[j, i]:.3e}, "
            f"strength {ref['strength'][j, i]:.3e} N/m; "
            "|dvel|/max speed by Delta/puny: " + "; ".join(bins))


def lower_correctness(cfg):
    """Initialize f64 runs of `cfg` on the GPU and on the host CPU and
    trace their steps (x64 on while tracing, off again after, so that
    the f32 phases keep their types)."""
    import jax
    import jax.numpy as jnp

    from cice4_tpu.driver import IceModelRun

    jax.config.update("jax_enable_x64", True)
    runs, lowered = {}, {}
    try:
        for where, dev in (("gpu", jax.devices()[0]),
                           ("cpu", jax.devices("cpu")[0])):
            with jax.default_device(dev):
                run = IceModelRun(cfg, jnp.float64,
                                  log=lambda m: None).initialize()
                f = run.forcing_provider(run.calendar.yday,
                                         run.calendar.sec)
                lowered[(where, "f64")] = run._step.lower(
                    run.state, f, *_clock(run))
            runs[where] = (run, dev)
    finally:
        jax.config.update("jax_enable_x64", False)
    return runs, lowered


def phase_correctness(cfg, run32, step32, runs64, exes):
    """GPU f32 (the phase-2 executable) vs GPU f64 vs CPU f64 from the
    same initial state on `cfg`'s grid."""
    import jax

    n = CORRECTNESS_STEPS
    # f32 first, with x64 off: x64 changes how host scalars promote
    gpu32 = _trajectory(run32, step32, n)
    jax.config.update("jax_enable_x64", True)
    res = {}
    for where, (run, dev) in runs64.items():
        with jax.default_device(dev):
            res[where] = _trajectory(run, exes[(where, "f64")][0], n)

    bad = []
    grid = f"{cfg.domain.ny_global}x{cfg.domain.nx_global}"
    log(f"correctness {grid}, GPU f64 vs CPU f64 after step 1: "
        + _locate(res["cpu"][0], res["gpu"][0], cfg.dynamics.ecc))
    for label, ref, got, limits, medians in (
            ("GPU f64 vs CPU f64", res["cpu"], res["gpu"], F64_LIMITS,
             F64_MEDIAN_LIMITS),
            ("GPU f32 vs GPU f64", res["gpu"], gpu32, F32_LIMITS, None)):
        for i, step in ((0, 1), (1, n)):
            pw = _pointwise(ref[i], got[i])
            log(f"correctness {grid}, {label}, rel err over ice cells "
                f"after step {step} (largest/median): " + ", ".join(
                    f"{k} {v[0]:.3e}/{v[1]:.1e}" for k, v in pw.items()))
            if medians is not None and i == 0:
                bad += [f"{label}: step-1 median {k} {v[1]:.3e} > "
                        f"{medians[k]:g}" for k, v in pw.items()
                        if not v[1] <= medians[k]]
        err = _integral_errors(ref[1], got[1])
        log(f"correctness {grid}, {label}, integral rel err after step "
            f"{n}: " + ", ".join(f"{k} {v:.3e} (<= {limits[k]:g})"
                                 for k, v in err.items()))
        bad += [f"{label}: integral {k} {v:.3e} > {limits[k]:g}"
                for k, v in err.items() if not v <= limits[k]]
    if bad:
        raise AssertionError("; ".join(bad))


# -- phase 5: four cards -------------------------------------------------

def phase_multi():
    from cice4_tpu.config import access_om_config, gx1_size_config
    from cice4_tpu.parallel.mesh import make_mesh
    from cice4_tpu.parallel.twin import TWIN_RTOL, twin_compare, twin_lower

    mesh = make_mesh(4)
    log(f"multi: mesh {dict(mesh.shape)}")
    # the remap k-halo path excludes tripole grids (ROADMAP R4)
    cases = (("access025 tripole", access_om_config(1440, 1080), False),
             ("gx1-size closed", gx1_size_config(), True))
    twins, lowered = {}, {}
    for tag, cfg, _ in cases:
        cfg = cfg.with_values(**{"dynamics.ndte": 120,
                                 "forcing.atm_data_type": "analytic"})
        t0 = time.perf_counter()
        twins[tag] = (cfg, twin_lower(cfg, mesh))
        lowered[(tag, "ref")] = twins[tag][1]["ref"]
        lowered[(tag, "sharded")] = twins[tag][1]["sharded"]
        log(f"multi {tag}: init + trace {time.perf_counter() - t0:.1f} s")
    exes = compile_all(lowered)
    bad = []
    for tag, _, want_remap in cases:
        cfg, twin = twins[tag]
        res = twin_compare(twin, exes[(tag, "ref")][0],
                           exes[(tag, "sharded")][0])
        log(f"multi {tag} ({cfg.domain.ny_global}x{cfg.domain.nx_global}):"
            f" 1-vs-4 worst {res['worst']:.3e} (limit {TWIN_RTOL:g}), "
            f"finite {res['finite']}, k-halo EVP {res['evp_khalo']}, "
            f"k-halo remap {res['remap_khalo']}; "
            + ", ".join(f"{k} {v:.2e}" for k, v in res["errors"].items()))
        if not (res["finite"] and res["worst"] < TWIN_RTOL):
            bad.append(f"{tag}: 1-vs-4 mismatch")
        if not res["evp_khalo"]:
            bad.append(f"{tag}: k-halo EVP path not engaged")
        if want_remap and not res["remap_khalo"]:
            bad.append(f"{tag}: k-halo remap path not engaged")
    if bad:
        raise AssertionError("; ".join(bad))


def single_card(card):
    import jax.numpy as jnp

    from cice4_tpu.driver import IceModelRun

    gx1_cfg, acc_cfg = deployment_configs()
    t0 = time.perf_counter()
    gx1, gx1_f, low = lower_deployment("gx1-size", gx1_cfg)
    acc, acc_f, low2 = lower_deployment("access025", acc_cfg)
    run32 = IceModelRun(gx1_cfg, jnp.float32, log=lambda m: None)
    run32.initialize()
    runs64, low3 = lower_correctness(gx1_cfg)
    exes = compile_all({**low, **low2, **low3})
    log(f"phase compile ok ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    run_deployment("gx1-size", gx1, gx1_f, exes, 24, 10, card)
    check_outputs(gx1)
    log(f"phase gx1-size ok ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    run_deployment("access025", acc, acc_f, exes, 4, 3, card)
    log(f"phase access025 ok ({time.perf_counter() - t0:.1f} s)")
    del acc, acc_f
    t0 = time.perf_counter()
    phase_correctness(gx1_cfg, run32, exes[("gx1-size", "step")][0],
                      runs64, exes)
    log(f"phase correctness ok ({time.perf_counter() - t0:.1f} s)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU sharded-vs-unsharded check")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    try:
        from cice4_tpu.compile_cache import enable_compile_cache
    except ImportError:
        raise SystemExit("chip_smoke: cice4_tpu not found — run from the "
                         "root of a checkout of the repository")
    enable_compile_cache()
    card = phase_device(4 if args.multi else 1)

    import jax

    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    t0 = time.perf_counter()
    if args.multi:
        phase_multi()
    else:
        single_card(card)
    log(f"all phases ok in {time.perf_counter() - t0:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
