"""Exact therm1/therm2 global energy ledger audit (gx3, f64 CPU)."""
import os, sys
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
    "run.histfreq": ("x",)*5, "run.dumpfreq": "x", "run.year_init": 1997})
run = IceModelRun(cfg, dtype=jnp.float64, log=lambda *_: None)
run.initialize()
grid, model, dt, cal = run.grid, run.model, cfg.run.dt, run.calendar
NSPIN = int(sys.argv[1]) if len(sys.argv) > 1 else 2
for _ in range(NSPIN):
    f = run.forcing_provider(cal.yday, cal.sec, cal=cal, state=run.state)
    run.state, _ = run._step(run.state, f, jnp.asarray(cal.yday), jnp.asarray(cal.sec))
    cal.advance()
state = run.state
f = run.forcing_provider(cal.yday, cal.sec, cal=cal, state=run.state)
yday = jnp.asarray(cal.yday)
Tf = freezing_temperature(cfg, f.sss)
sw = M._prep_radiation(model, state, f) if cfg.radiation.prep_radiation \
    else M._step_radiation(model, state, grid, f, yday, jnp.zeros(()), dt)

def etot(st, tar):
    return float(jnp.sum((jnp.sum(st.eicen,(0,1))+jnp.sum(st.esnon,(0,1)))*tar))

import os as _os
_os.environ["CICE4_DEBUG_THERM1"] = "1"
s1, fx1, init = M._step_therm1(model, state, grid, f, sw, Tf, yday, dt)
dbg = fx1.pop("_dbg_therm1")
w = init["aicen_init"]
for hem, tar in (("n", grid.tarean), ("s", grid.tareas)):
    g = lambda x: float(jnp.sum(x*tar))
    E0 = etot(state, tar); E1 = etot(s1, tar)
    einit_g = g(jnp.sum(dbg["einit"]*w,0))
    efinal_g = g(jnp.sum(dbg["efinal"]*w,0))
    evap_g = g(jnp.sum(dbg["evapn"]*w,0))*cn.Lvap*dt
    print(f"[{hem}] clamp(pre): einit_g-E0 = {einit_g-E0: .4e}")
    print(f"[{hem}] post ledger: E1-(efinal_g+evapLvap) = {E1-(efinal_g+evap_g): .4e}")
    de_cols = efinal_g - einit_g
    booked = g(jnp.sum((dbg["fsurfn"]-dbg["flatn"]+dbg["fswint"]
                        -dbg["fhocnn"])*w,0))*dt - g(f.fsnow*jnp.sum(w,0))*cn.Lfresh*dt
    print(f"[{hem}] therm1 col-ledger miss = {de_cols-booked: .4e}  (dE={E1-E0: .4e})")

s2, fx2 = M._step_therm2(model, s1, grid, dict(fx1), init, Tf, dt)
for hem, tar in (("n", grid.tarean), ("s", grid.tareas)):
    g = lambda x: float(jnp.sum(x*tar))
    E1 = etot(s1, tar); E2 = etot(s2, tar)
    dfhocn = (g(fx2["fhocn"]) - g(fx1["fhocn"]))*dt
    frz = g(jnp.maximum(state.frzmlt,0.0))*dt
    print(f"[{hem}] therm2 dE={E2-E1: .5e} expected(-frz-dfhocn)={-frz-dfhocn: .5e} miss={E2-E1+frz+dfhocn: .4e}")
