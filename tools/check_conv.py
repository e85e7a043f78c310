"""Diagnose which Newton convergence condition fails for category 0."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from cice4_tpu.compile_cache import enable_compile_cache  # noqa: E402
enable_compile_cache()

import jax.numpy as jnp

from cice4_tpu.config import gx1_config
from cice4_tpu.grid import make_grid
from cice4_tpu.io.forcing_data import AnalyticForcing
from cice4_tpu import model as M
from cice4_tpu.model import Model
from cice4_tpu.state import init_state, freezing_temperature
from cice4_tpu.ops import itd as itd_ops
from cice4_tpu.ops import therm_vertical as tv
from cice4_tpu.ops.therm_vertical import frzmlt_bottom_lateral
from cice4_tpu.ops.atmo import atmo_boundary_layer
from cice4_tpu import constants as cn


def main():
    cfg = gx1_config()
    grid = make_grid(cfg, dtype=jnp.float32)
    model = Model.create(cfg)
    state = init_state(cfg, grid, model.itd, dtype=jnp.float32)
    provider = AnalyticForcing(cfg, grid, jnp.float32)
    f = provider(1.0, 0.0)
    dt = cfg.run.dt
    yday, sec = jnp.float32(80.0), jnp.float32(0.0)
    Tf = freezing_temperature(cfg, f.sss)

    @jax.jit
    def _full(state):
        s, _ = M.ice_step(model, state, grid, f, yday, sec)
        return s

    for _ in range(int(os.environ.get("SPINUP", "24"))):
        state = _full(state)
    jax.block_until_ready(state.aicen)

    sw = M._step_radiation(model, state, grid, f, yday, sec, dt)
    agg = itd_ops.aggregate(state, grid.tmask)
    Tbot, fbot, rside = frzmlt_bottom_lateral(
        model.thermo, dt, agg["aice"], state.frzmlt, state.eicen,
        state.esnon, state.sst, Tf, state.strocnxT, state.strocnyT)

    n = 0
    p = model.thermo
    aicen, vicen, vsnon = state.aicen[n], state.vicen[n], state.vsnon[n]
    tsfcn, eicen, esnon = state.tsfcn[n], state.eicen[n], state.esnon[n]
    bl = atmo_boundary_layer("ice", tsfcn, f.potT, f.uatm, f.vatm,
                             f.wind, f.zlvl, f.Qa, f.rhoa, True)

    # replicate the setup in thermo_vertical_category
    nilyr, nslyr = p.nilyr, p.nslyr
    has_ice = aicen > cn.puny
    a_safe = jnp.maximum(aicen, cn.puny)
    tmlt = jnp.asarray(p.tmlt)[:nilyr, None, None]
    Tsf = tsfcn
    hin = jnp.where(has_ice, vicen / a_safe, 0.0)
    hsn = jnp.where(has_ice, vsnon / a_safe, 0.0)
    hilyr = jnp.where(has_ice, hin / nilyr, 1.0)
    hslyr = hsn / nslyr
    v_safe = jnp.maximum(vsnon, cn.puny)
    snow_ok = (hslyr > tv.hs_min / nslyr) & has_ice
    qsn = jnp.where(snow_ok[None], esnon * nslyr / v_safe[None],
                    -cn.rhos * cn.Lfresh)
    Tsn = (cn.Lfresh + qsn / cn.rhos) / cn.cp_ice
    Tsn = jnp.minimum(Tsn, 0.0)
    qsn = jnp.where(Tsn >= 0.0, -cn.rhos * cn.Lfresh, qsn)
    vi_safe = jnp.maximum(vicen, cn.puny)
    qin = jnp.where(has_ice[None], eicen * nilyr / vi_safe[None],
                    -cn.rhoi * cn.Lfresh)
    Tin = tv.tin_from_qin(p, qin, tmlt)
    fix = Tin > 0.0
    Tin = jnp.where(fix, 0.0, Tin)
    qin = jnp.where(fix, -cn.rhoi * cn.Lfresh, qin)
    einit = jnp.sum(hslyr[None] * qsn, 0) + jnp.sum(hilyr[None] * qin, 0)

    out = tv.temperature_changes(p, dt, has_ice, f.rhoa, f.flw, f.potT,
                                 f.Qa, bl["shcoef"], bl["lhcoef"],
                                 sw["fswsfc"][n], sw["fswint"][n],
                                 sw["fswthru"][n], sw["Sswabs"][n],
                                 sw["Iswabs"][n], hilyr, hslyr, qin, Tin,
                                 qsn, Tsn, Tsf, Tbot, einit)
    bad = ~out["converged"] & has_ice
    nbad = int(jnp.sum(bad))
    print(f"cat0: niter={int(out['niter'])} unconverged cells={nbad} "
          f"of {int(jnp.sum(has_ice))}")
    if nbad:
        idx = jnp.argwhere(bad)[:8]
        for (j, i) in idx:
            j, i = int(j), int(i)
            print(f"  cell ({j},{i}): aicen={float(aicen[j,i]):.3e} "
                  f"hin={float(hin[j,i]):.4f} hsn={float(hsn[j,i]):.4f} "
                  f"Tsf={float(out['Tsf'][j,i]):.4f} "
                  f"Tbot={float(Tbot[j,i]):.4f} "
                  f"fswsfc={float(sw['fswsfc'][n][j,i]):.3f} "
                  f"fswint={float(sw['fswint'][n][j,i]):.3f} "
                  f"einit={float(einit[j,i]):.4e} "
                  f"why={int(out['why'][j,i]):05b} "
                  f"(1=Tsf>0 2=osc 4=dTsf 8=flux 16=energy)")
        # dump the first bad cell's full inputs for offline iteration
        import numpy as np
        j, i = (int(x) for x in idx[0])
        np.savez("/tmp/badcell.npz",
                 rhoa=f.rhoa[j, i], flw=f.flw[j, i], potT=f.potT[j, i],
                 Qa=f.Qa[j, i],
                 shcoef=bl["shcoef"][j, i], lhcoef=bl["lhcoef"][j, i],
                 fswsfc=sw["fswsfc"][n][j, i], fswint=sw["fswint"][n][j, i],
                 fswthru=sw["fswthru"][n][j, i],
                 Sswabs=sw["Sswabs"][n][:, j, i],
                 Iswabs=sw["Iswabs"][n][:, j, i],
                 hilyr=hilyr[j, i], hslyr=hslyr[j, i],
                 qin=qin[:, j, i], Tin=Tin[:, j, i],
                 qsn=qsn[:, j, i], Tsn=Tsn[:, j, i],
                 Tsf=Tsf[j, i], Tbot=Tbot[j, i], einit=einit[j, i])
        print("saved /tmp/badcell.npz")


if __name__ == "__main__":
    main()
