"""Root-cause the gx3-month thermo energy-conservation violation.

Runs the gx3 month on true-CPU f64, checking the vthermo guard
synchronously each step; at the first violation, saves the pre-step
state + forcing (/tmp/vthermo_bad.npz) and replays the thermo phase
with a per-term energy breakdown at the worst cell.

Usage: python tools/debug_vthermo.py [max_steps]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from cice4_tpu.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from cice4_tpu.config import gx3_config
from cice4_tpu.driver import IceModelRun

MAXN = int(sys.argv[1]) if len(sys.argv) > 1 else 72
DT = jnp.float64


def main():
    cfg = gx3_config().with_values(**{
        "dynamics.ndte": 120,
        "run.diagfreq": 24,
        "run.npt": MAXN,
        "run.histfreq": ("x",) * 5,
        "run.dumpfreq": "x",
        "run.year_init": 1997,
    })
    run = IceModelRun(cfg, dtype=DT, log=lambda *_: None)
    run.initialize()
    cal = run.calendar

    import dataclasses
    for n in range(MAXN):
        prev_state = run.state
        f = run.forcing_provider(cal.yday, cal.sec, cal=cal,
                                 state=run.state)
        yday, sec = jnp.asarray(cal.yday, DT), jnp.asarray(cal.sec, DT)
        run.state, fluxes = run._step(run.state, f, yday, sec)
        g = fluxes.pop("_guards", {})
        name = "thermo energy conservation (W/m^2)"
        rec = g.get(name)
        if rec is not None and int(rec["count"]) > 0:
            j, i = int(rec["j"]), int(rec["i"])
            print(f"step {n}: VIOLATION count={int(rec['count'])} "
                  f"at (j={j}, i={i}) worst={float(rec['worst']):.6e}")
            # save pre-step state + forcing
            d = {}
            for fld in dataclasses.fields(prev_state):
                v = getattr(prev_state, fld.name)
                if isinstance(v, dict):
                    for k2, v2 in v.items():
                        d[f"trcrn_{k2}"] = np.asarray(v2)
                elif v is not None and hasattr(v, "shape"):
                    d[fld.name] = np.asarray(v)
            for k2 in f.__dataclass_fields__:
                v = getattr(f, k2)
                if v is not None and hasattr(v, "shape"):
                    d[f"forcing_{k2}"] = np.asarray(v)
            d["yday"] = np.asarray(yday)
            d["sec"] = np.asarray(sec)
            d["bad_j"] = j
            d["bad_i"] = i
            np.savez("/tmp/vthermo_bad.npz", **d)
            print("saved /tmp/vthermo_bad.npz")
            replay(run, prev_state, f, yday, j, i)
            return
        cal.advance()
        if (n + 1) % 24 == 0:
            print(f"step {n+1} ok")
    print("no violation in", MAXN, "steps")


def replay(run, state, f, yday, j, i):
    """Re-run the thermo phase eagerly, printing the budget at (j,i)."""
    from cice4_tpu import constants as cn
    from cice4_tpu import model as M
    from cice4_tpu.ops import itd as itd_ops
    from cice4_tpu.ops.therm_vertical import (frzmlt_bottom_lateral,
                                              thermo_vertical_category)
    from cice4_tpu.ops.atmo import atmo_boundary_layer
    from cice4_tpu.state import freezing_temperature

    model = run.model
    grid = run.grid
    cfg = model.cfg
    dt = cfg.run.dt
    Tf = freezing_temperature(cfg, f.sss)

    # mirror _step's pre-thermo sequence: prep_radiation / shortwave
    if cfg.radiation.prep_radiation:
        sw = M._prep_radiation(model, state, f)
    else:
        sw = M._step_radiation(model, state, grid, f, yday,
                               jnp.zeros_like(yday), dt)
    agg = itd_ops.aggregate(state, grid.tmask)
    Tbot, fbot, rside = frzmlt_bottom_lateral(
        model.thermo, dt, agg["aice"], state.frzmlt, state.eicen,
        state.esnon, state.sst, Tf, state.strocnxT, state.strocnyT)

    cell = (slice(None), j, i)
    print("\n--- cell state (cat, j={}, i={}) ---".format(j, i))
    for nm in ("aicen", "vicen", "vsnon", "tsfcn"):
        print(f"{nm:8s}", np.asarray(getattr(state, nm))[cell])
    print("eicen", np.asarray(state.eicen)[:, :, j, i])
    print("esnon", np.asarray(state.esnon)[:, :, j, i])
    print("frzmlt", float(state.frzmlt[j, i]), "sst", float(state.sst[j, i]),
          "Tf", float(Tf[j, i]), "Tbot", float(Tbot[j, i]),
          "fbot", float(fbot[j, i]))
    for nm in ("Tair", "potT", "Qa", "rhoa", "flw", "fsnow", "wind"):
        v = getattr(f, nm)
        if v is not None:
            print(f"f.{nm:6s}", float(v[j, i]))

    for c in range(state.ncat):
        one = lambda a: jnp.asarray(a)[..., j:j + 1, i:i + 1]
        bl = atmo_boundary_layer("ice", one(state.tsfcn[c]), one(f.potT),
                                 one(f.uatm), one(f.vatm), one(f.wind),
                                 one(f.zlvl), one(f.Qa), one(f.rhoa),
                                 cfg.thermo.calc_strair)
        st, fx = thermo_vertical_category(
            model.thermo, dt, one(state.aicen[c]), one(state.vicen[c]),
            one(state.vsnon[c]), one(state.tsfcn[c]),
            one(state.eicen[c]), one(state.esnon[c]),
            one(f.flw), one(f.potT), one(f.Qa), one(f.rhoa),
            one(f.fsnow), one(fbot), one(Tbot), one(Tf),
            bl["lhcoef"], bl["shcoef"],
            one(sw["fswsfc"][c]), one(sw["fswint"][c]),
            one(sw["fswthru"][c]),
            one(sw["Sswabs"][c]), one(sw["Iswabs"][c]))
        g = lambda d, k: float(np.asarray(d[k]).reshape(-1)[0])
        einp = (g(fx, "fsurfn") - g(fx, "flatn") + float(sw["fswint"][c, j, i])
                - g(fx, "fhocnn") - float(f.fsnow[j, i]) * cn.Lfresh) * dt
        de = g(fx, "efinal") - g(fx, "einit")
        print(f"cat {c}: einit={g(fx,'einit'):.6e} efinal={g(fx,'efinal'):.6e}"
              f" de={de:.6e} einp={einp:.6e} ferr={(de-einp)/dt:+.6e}"
              f" niter={int(np.asarray(fx['niter']).max())}")
        if abs((de - einp) / dt) > 1e-3:
            print("  -> BAD CATEGORY; fluxes:")
            for k in ("fsurfn", "flatn", "fcondtopn", "fhocnn", "evapn",
                      "meltt", "melts", "meltb", "congel", "snoice"):
                print(f"     {k:10s} {g(fx, k):+.6e}")


if __name__ == "__main__":
    main()
