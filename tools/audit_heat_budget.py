"""Phase-by-phase global heat-budget audit on gx3 (finds which phase
breaks the runtime_diags herr closure).

For each phase of ice_step, prints the hemispheric change in total
ice+snow energy and the heat fluxes that phase books; their mismatch
is that phase's contribution to herr.
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

from cice4_tpu import constants as cn
from cice4_tpu import model as M
from cice4_tpu.config import gx3_config
from cice4_tpu.driver import IceModelRun
from cice4_tpu.state import freezing_temperature

cfg = gx3_config().with_values(**{
    "dynamics.ndte": 120, "run.diagfreq": 1, "run.npt": 3,
    "run.histfreq": ("x",) * 5, "run.dumpfreq": "x",
    "run.year_init": 1997})
run = IceModelRun(cfg, dtype=jnp.float64, log=lambda *_: None)
run.initialize()
grid = run.grid
model = run.model
dt = cfg.run.dt

NSPIN = int(sys.argv[1]) if len(sys.argv) > 1 else 1
cal = run.calendar
for _ in range(NSPIN):
    f = run.forcing_provider(cal.yday, cal.sec, cal=cal, state=run.state)
    run.state, _fx = run._step(run.state, f, jnp.asarray(cal.yday),
                               jnp.asarray(cal.sec))
    cal.advance()

state = run.state
f = run.forcing_provider(cal.yday, cal.sec, cal=cal, state=run.state)
yday = jnp.asarray(cal.yday)


def etot(st, hem):
    tar = grid.tarean if hem == "n" else grid.tareas
    e = jnp.sum(st.eicen, (0, 1)) + jnp.sum(st.esnon, (0, 1))
    return float(jnp.sum(e * tar))


def gsum(x, hem):
    tar = grid.tarean if hem == "n" else grid.tareas
    return float(jnp.sum(x * tar))


Tf = freezing_temperature(cfg, f.sss)
if cfg.radiation.prep_radiation:
    sw = M._prep_radiation(model, state, f)
else:
    sw = M._step_radiation(model, state, grid, f, yday, jnp.zeros(()), dt)

for hem in ("n", "s"):
    print(f"===== hemisphere {hem} =====")
    e0 = etot(state, hem)

    s1, fx1, init = M._step_therm1(model, state, grid, f, sw, Tf, yday, dt)
    e1 = etot(s1, hem)
    # energy input booked by therm1: aice-weighted (fsurf - flat +
    # fswint(adjusted) - fhocn)*dt - snow enthalpy input... therm1 books
    # fhocn/fresh etc. per-cell already weighted (merge_fluxes * w)
    w = init["aicen_init"]
    fswint_adj = fx1.get("fswint_gbm")
    einp1 = gsum(fx1["fsurf"] - fx1["flat"] - fx1["fhocn"], hem) * dt
    # interior SW: need adjusted per-cat; approximate with sw dict
    # (pre-adjustment) to show the gap
    einp1_sw = gsum(jnp.sum(sw["fswint"] * w, 0), hem) * dt
    sn_in = gsum(f.fsnow * jnp.sum(w, 0), hem) * dt * cn.Lfresh
    print(f"therm1: dE={e1-e0: .6e}  booked(fsurf-flat-fhocn)dt+fswint*dt-sn*Lf="
          f"{einp1 + einp1_sw - sn_in: .6e}  miss={(e1-e0)-(einp1+einp1_sw-sn_in): .3e}")

    s2, fx2 = M._step_therm2(model, s1, grid, dict(fx1), init, Tf, dt)
    e2 = etot(s2, hem)
    dfhocn = gsum(fx2["fhocn"] - fx1["fhocn"], hem) * dt
    frz_heat = gsum(jnp.maximum(state.frzmlt, 0.0), hem) * dt
    print(f"therm2: dE={e2-e1: .6e}  -d(fhocn)*dt={-dfhocn: .6e} "
          f" fhfrz*dt={frz_heat: .6e}  miss={(e2-e1)-(-dfhocn+frz_heat): .3e}")

    s3, fx3 = M._step_dynamics(model, s2, grid, f, dict(fx2), dt)
    e3 = etot(s3, hem)
    dfhocn3 = gsum(fx3["fhocn"] - fx2["fhocn"], hem) * dt
    print(f"dyn   : dE={e3-e2: .6e}  -d(fhocn)*dt={-dfhocn3: .6e}"
          f"  miss={(e3-e2)-(-dfhocn3): .3e}")

    if cfg.radiation.prep_radiation:
        sw3 = M._step_radiation(model, s3, grid, f, yday, jnp.zeros(()), dt)
    else:
        sw3 = sw
    s4, fx4 = M._coupling_prep(model, s3, grid, f, sw3, dict(fx3), Tf, dt)
    e4 = etot(s4, hem)
    dfhocn4 = gsum(fx4.get("fhocn_gbm", fx4["fhocn"]) - fx3["fhocn"], hem) * dt
    print(f"cpl   : dE={e4-e3: .6e}  -d(fhocn)*dt={-dfhocn4: .6e}"
          f"  miss={(e4-e3)-(-dfhocn4): .3e}")
