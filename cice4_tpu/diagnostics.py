"""Runtime diagnostics: hemispheric integrals and budget-closure checks.

Equivalent of ``source/ice_diagnostics.F90`` — `runtime_diags:105-844`
(the per-`diagfreq` global/hemispheric sums and the heat/fresh-water/
salt budget-closure errors printed as the log tables the reference
ships for regression diffing, ``ice.log.Linux.LANL.coyote:193-775``),
`init_mass_diags:853-927` (start-of-step totals the budgets difference
against), and `print_points:936-1062` / `print_state:1071-1220` cell
probes.

All reductions are plain `jnp.sum` over the dense global fields — under
sharding XLA lowers them to `psum` over the mesh (the reference's
`global_sum`); a compiled program's reduction order is fixed, so a
rerun of the same executable reproduces its sums bit for bit (the
REPRODUCIBLE-mode property)
(``mpi/ice_global_reductions.F90:200-230``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cice4_tpu import constants as cn
from cice4_tpu.grid import Grid
from cice4_tpu.ops.itd import aggregate
from cice4_tpu.state import State


def init_mass_diags(state: State, grid: Grid):
    """Start-of-step totals for budget closure
    (``ice_diagnostics.F90 init_mass_diags:853-927``): per hemisphere,
    total ice+snow mass `totm`, ice-only mass `totmi`, and total
    internal energy `tote`."""
    agg = aggregate(state, grid.tmask)
    vice, vsno = agg["vice"], agg["vsno"]
    etot = agg["eice"] + agg["esno"]
    out = {}
    for hem, tar in (("n", grid.tarean), ("s", grid.tareas)):
        mice = cn.rhoi * jnp.sum(vice * tar)
        msnw = cn.rhos * jnp.sum(vsno * tar)
        out[f"totm_{hem}"] = mice + msnw
        out[f"totmi_{hem}"] = mice
        out[f"tote_{hem}"] = jnp.sum(etot * tar)
    return out


def runtime_diags(state: State, grid: Grid, fluxes=None, forcing=None,
                  init_diag=None, dt=None, update_ocn_f=False,
                  calc_Tsfc=True):
    """Hemispheric diagnostics dict of scalars (all jnp 0-d arrays).

    With only (state, grid): the state block of the reference table
    (area/extent/volume/KE/speeds).  With `fluxes` (the step's merged
    flux dict) it adds max strength, mean albedo, and — when
    `init_diag` (from :func:`init_mass_diags` at step start) and
    `forcing` are also given — the full heat / fresh-water / salt
    budget-closure errors of ``runtime_diags:370-560``.
    """
    agg = aggregate(state, grid.tmask)
    aice, vice, vsno = agg["aice"], agg["vice"], agg["vsno"]
    etot_f = agg["eice"] + agg["esno"]

    out = {}
    for hem, tar in (("n", grid.tarean), ("s", grid.tareas)):
        out[f"area_{hem}"] = jnp.sum(aice * tar) * cn.m2_to_km2
        out[f"extent_{hem}"] = jnp.sum(
            (aice > 0.15).astype(aice.dtype) * tar) * cn.m2_to_km2
        out[f"volume_{hem}"] = jnp.sum(vice * tar)          # m^3
        out[f"snw_vol_{hem}"] = jnp.sum(vsno * tar)
        out[f"etot_{hem}"] = jnp.sum(etot_f * tar)

    # kinetic energy, rms/max speed (":210-248"; KE on the T grid with
    # T-cell mass, rms speed derived from KE as the reference does)
    umass_t = cn.rhoi * vice + cn.rhos * vsno
    spd2 = state.uvel**2 + state.vvel**2
    ke_t = 0.5 * umass_t * spd2
    for hem, tar, lm in (("n", grid.tarean, grid.lmask_n),
                         ("s", grid.tareas, grid.lmask_s)):
        ket = jnp.sum(ke_t * tar)
        out[f"ke_{hem}"] = ket
        mass = (cn.rhoi * out[f"volume_{hem}"]
                + cn.rhos * out[f"snw_vol_{hem}"])
        urms2 = 2.0 * ket / (mass + cn.puny)
        out[f"rms_speed_{hem}"] = jnp.sqrt(jnp.maximum(urms2, 0.0))
        m = lm & grid.umask
        out[f"max_speed_{hem}"] = jnp.sqrt(
            jnp.max(jnp.where(m, spd2, 0.0)))
        # max ice volume (mean thickness incl. open water, ":292-294")
        out[f"hmax_{hem}"] = jnp.max(jnp.where(lm & grid.tmask, vice, 0.0))

    out["tot_ice_mass"] = jnp.sum(umass_t * grid.tarea * grid.hm)
    out["tot_energy"] = out["etot_n"] + out["etot_s"]

    if fluxes is None:
        out["max_strength_n"] = jnp.zeros((), aice.dtype)
        out["max_strength_s"] = jnp.zeros((), aice.dtype)
        return out

    # maximum ice strength, kN/m (":340-345")
    strength = fluxes["strength"]
    for hem, lm in (("n", grid.lmask_n), ("s", grid.lmask_s)):
        out[f"max_strength_{hem}"] = jnp.max(
            jnp.where(lm & grid.tmask, strength, 0.0)) / 1000.0

    # mean albedo over sunlit ice (":240-289")
    if all(k in fluxes for k in ("alvdr", "alidr", "alvdf", "alidf",
                                 "coszen")):
        alb = (fluxes["alvdr"] * cn.awtvdr + fluxes["alidr"] * cn.awtidr
               + fluxes["alvdf"] * cn.awtvdf + fluxes["alidf"] * cn.awtidf)
        sunlit = fluxes["coszen"] > cn.puny
        for hem, tar in (("n", grid.tarean), ("s", grid.tareas)):
            w = jnp.where(sunlit, tar, 0.0)
            a_alb = jnp.sum(aice * w)
            out[f"albedo_{hem}"] = jnp.where(
                a_alb > 0.0, jnp.sum(aice * alb * w) / jnp.maximum(
                    a_alb, cn.puny), 0.0)

    if init_diag is None or forcing is None or dt is None:
        return out

    # ------------------------------------------------------------------
    # budget closure (":370-560").  All *_gbm fields are grid-box means
    # saved before scale_fluxes divided by aice.
    # ------------------------------------------------------------------
    f = forcing
    aice_init = fluxes["aice_init"]
    # NB: the downwelling-LW term is weighted by the PRE-step aice —
    # the weight merge_fluxes used for every other component.  The
    # reference weights it by the post-step aggregate
    # (ice_diagnostics.F90:421-424), which leaks O(flw * daice/step)
    # into herr; with the init weight the closure is exact.
    fhatm_cell = jnp.where(
        grid.tmask,
        (fluxes["fswabs_gbm"] - fluxes["fswthru_gbm"]
         + fluxes["fsens_gbm"] + fluxes["flwout_gbm"]
         + f.flw * aice_init) if calc_Tsfc else
        (fluxes["fsurf_gbm"] - fluxes["flat_gbm"]), 0.0)
    frz_cell = fluxes["frazil"] * cn.rhoi  # m/step -> kg/m^2 over dt

    for hem, tar in (("n", grid.tarean), ("s", grid.tareas)):
        rn = jnp.sum(f.frain * aice_init * tar) * dt
        sn = jnp.sum(f.fsnow * aice_init * tar) * dt
        evp = jnp.sum(fluxes["evap_gbm"] * tar) * dt
        frz = jnp.sum(frz_cell * tar)
        sfresh = jnp.sum(fluxes["fresh_gbm"] * tar) * dt
        sfsalt = jnp.sum(fluxes["fsalt_gbm"] * tar) * dt
        fhocn = jnp.sum(fluxes["fhocn_gbm"] * tar)
        fhatm = jnp.sum(fhatm_cell * tar)
        frzmlt_used = fluxes.get("frzmlt_init", state.frzmlt)
        fhfrz = jnp.sum(jnp.maximum(frzmlt_used, 0.0) * tar)

        mice = cn.rhoi * out[f"volume_{hem}"]
        msnw = cn.rhos * out[f"snw_vol_{hem}"]
        mtot = mice + msnw
        delmi = mtot - init_diag[f"totm_{hem}"]
        delmx = mice - init_diag[f"totmi_{hem}"]
        if not update_ocn_f:
            delmx = delmx - frz

        # total water flux into the ice (":510-527")
        flux = rn + sn + evp - sfresh
        if not update_ocn_f:
            flux = flux + frz
        flux = jnp.where(out[f"area_{hem}"] > 0.0, flux, 0.0)
        out[f"werr_{hem}"] = (flux - delmi) / (mtot + 1.0)

        # heat budget (":529-540"); latent heat cancels with the
        # enthalpy of the evaporated ice/snow by construction
        etot = out[f"etot_{hem}"]
        delei = etot - init_diag[f"tote_{hem}"]
        fhatm = fhatm + (-sn * cn.Lfresh + evp * cn.Lvap) / dt
        hnet = (fhatm - fhocn - fhfrz) * dt
        out[f"herr_{hem}"] = (hnet - delei) / (etot - 1.0)

        # salt budget (":542-556")
        mslt = mice * cn.ice_ref_salinity * 1.0e-3
        delmslt = delmx * cn.ice_ref_salinity * 1.0e-3
        out[f"serr_{hem}"] = (sfsalt + delmslt) / (mslt + 1.0)

        out[f"rain_{hem}"] = rn
        out[f"snow_{hem}"] = sn
        out[f"evap_{hem}"] = evp
        out[f"frazil_{hem}"] = frz
        out[f"fresh_{hem}"] = sfresh
        out[f"fsalt_{hem}"] = sfsalt
        out[f"fhatm_{hem}"] = fhatm
        out[f"fhocn_{hem}"] = fhocn
        out[f"fhfrz_{hem}"] = fhfrz
        out[f"mice_{hem}"] = mice
        out[f"msnw_{hem}"] = msnw
        out[f"delmi_{hem}"] = delmi
        out[f"wflux_{hem}"] = flux
        out[f"hnet_{hem}"] = hnet
        out[f"delei_{hem}"] = delei
        out[f"mslt_{hem}"] = mslt
    return out


def format_diags(istep, d) -> str:
    """Log-table formatting matching the reference diagnostics tables
    (``runtime_diags:649-844`` write statements)."""
    g = lambda k: float(d[k]) if k in d else 0.0
    have = lambda k: k in d
    lines = [
        f"istep = {istep}",
        "                           Arctic              Antarctic",
        f"total ice area  (km^2) = {g('area_n'):22.13e} {g('area_s'):22.13e}",
        f"total ice extent(km^2) = {g('extent_n'):22.13e} {g('extent_s'):22.13e}",
        f"total ice volume (m^3) = {g('volume_n'):22.13e} {g('volume_s'):22.13e}",
        f"total snw volume (m^3) = {g('snw_vol_n'):22.13e} {g('snw_vol_s'):22.13e}",
        f"tot kinetic energy (J) = {g('ke_n'):22.13e} {g('ke_s'):22.13e}",
        f"rms ice speed    (m/s) = {g('rms_speed_n'):22.13e} {g('rms_speed_s'):22.13e}",
    ]
    if have("albedo_n"):
        lines.append(f"average albedo         = {g('albedo_n'):22.13e}"
                     f" {g('albedo_s'):22.13e}")
    lines += [
        f"max ice volume     (m) = {g('hmax_n'):22.13e} {g('hmax_s'):22.13e}",
        f"max ice speed    (m/s) = {g('max_speed_n'):22.13e} {g('max_speed_s'):22.13e}",
        f"max strength    (kN/m) = {g('max_strength_n'):22.13e} {g('max_strength_s'):22.13e}",
    ]
    if have("werr_n"):
        lines += [
            "----------------------------",
            f"arwt rain h2o kg in dt = {g('rain_n'):22.13e} {g('rain_s'):22.13e}",
            f"arwt snow h2o kg in dt = {g('snow_n'):22.13e} {g('snow_s'):22.13e}",
            f"arwt evap h2o kg in dt = {g('evap_n'):22.13e} {g('evap_s'):22.13e}",
            f"arwt frzl h2o kg in dt = {g('frazil_n'):22.13e} {g('frazil_s'):22.13e}",
            f"arwt frsh h2o kg in dt = {g('fresh_n'):22.13e} {g('fresh_s'):22.13e}",
            f"arwt ice mass (kg)     = {g('mice_n'):22.13e} {g('mice_s'):22.13e}",
            f"arwt snw mass (kg)     = {g('msnw_n'):22.13e} {g('msnw_s'):22.13e}",
            f"arwt tot mass chng(kg) = {g('delmi_n'):22.13e} {g('delmi_s'):22.13e}",
            f"arwt water flux        = {g('wflux_n'):22.13e} {g('wflux_s'):22.13e}",
            f"water flux error       = {g('werr_n'):22.13e} {g('werr_s'):22.13e}",
            "----------------------------",
            f"arwt atm heat flux (W) = {g('fhatm_n'):22.13e} {g('fhatm_s'):22.13e}",
            f"arwt ocn heat flux (W) = {g('fhocn_n'):22.13e} {g('fhocn_s'):22.13e}",
            f"arwt frzl heat flux(W) = {g('fhfrz_n'):22.13e} {g('fhfrz_s'):22.13e}",
            f"arwt tot energy    (J) = {g('etot_n'):22.13e} {g('etot_s'):22.13e}",
            f"arwt net heat      (J) = {g('hnet_n'):22.13e} {g('hnet_s'):22.13e}",
            f"arwt tot energy chng(J)= {g('delei_n'):22.13e} {g('delei_s'):22.13e}",
            f"heat error             = {g('herr_n'):22.13e} {g('herr_s'):22.13e}",
            "----------------------------",
            f"arwt salt mass (kg)    = {g('mslt_n'):22.13e} {g('mslt_s'):22.13e}",
            f"arwt salt flux in dt   = {g('fsalt_n'):22.13e} {g('fsalt_s'):22.13e}",
            f"salt flux error        = {g('serr_n'):22.13e} {g('serr_s'):22.13e}",
        ]
    return "\n".join(lines)


def find_points(grid: Grid, latlon_deg):
    """Nearest-ocean-cell (j, i) for each (lat, lon) in degrees — the
    reference's `init_diags:936-1062` point search."""
    import numpy as np
    tlat = np.asarray(grid.tlat) * cn.rad_to_deg
    tlon = np.asarray(grid.tlon) * cn.rad_to_deg
    hm = np.asarray(grid.hm) > 0
    pts = []
    for lat, lon in latlon_deg:
        d = (tlat - lat) ** 2 + (np.minimum(
            np.abs(tlon - lon), 360.0 - np.abs(tlon - lon))) ** 2
        d = np.where(hm, d, np.inf)
        j, i = np.unravel_index(int(np.argmin(d)), d.shape)
        pts.append((int(j), int(i)))
    return pts


def point_diags(state: State, grid: Grid, fluxes, forcing, dt, points):
    """Per-point probe values (``runtime_diags print_points
    block:560-649``): state + fluxes at fixed diagnostic cells."""
    agg = aggregate(state, grid.tmask)
    out = []
    for (j, i) in points:
        aice = agg["aice"][j, i]
        safe = jnp.maximum(aice, cn.puny)
        d = {
            "lat": float(grid.tlat[j, i]) * cn.rad_to_deg,
            "lon": float(grid.tlon[j, i]) * cn.rad_to_deg,
            "Tair": forcing.Tair[j, i] - cn.Tffresh,
            "Qa": forcing.Qa[j, i],
            "fsnow": forcing.fsnow[j, i] * dt / cn.rhos,
            "frain": forcing.frain[j, i] * dt / cn.rhow,
            "flw": forcing.flw[j, i],
            "aice": aice,
            "hiavg": jnp.where(aice > 0, agg["vice"][j, i] / safe, 0.0),
            "hsavg": jnp.where(aice > 0, agg["vsno"][j, i] / safe, 0.0),
            "Tsfc": agg["tsfc"][j, i],
            "sst": state.sst[j, i],
            "frzmlt": state.frzmlt[j, i],
            "evap": fluxes["evap"][j, i] * dt / cn.rhoi,
            "fswabs": fluxes["fswabs"][j, i],
            "flwout": fluxes["flwout"][j, i],
            "flat": fluxes["flat"][j, i],
            "fsens": fluxes["fsens"][j, i],
            "fsurf": fluxes["fsurf"][j, i],
            "fcondtop": fluxes["fcondtop"][j, i],
            "meltt": fluxes["meltt"][j, i],
            "meltb": fluxes["meltb"][j, i],
            "meltl": fluxes["meltl"][j, i],
            "snoice": fluxes["snoice"][j, i],
            "frazil": fluxes["frazil"][j, i],
            "congel": fluxes["congel"][j, i],
            "fhocn": -fluxes["fhocn"][j, i],
        }
        out.append({k: (float(v) if hasattr(v, "item") else v)
                    for k, v in d.items()})
    return out


def format_points(pds) -> str:
    lines = []
    for n, d in enumerate(pds):
        lines.append(f"point {n + 1}: lat={d['lat']:.2f} lon={d['lon']:.2f}")
        lines.append(
            f"  aice={d['aice']:.6f} hi={d['hiavg']:.4f} hs={d['hsavg']:.4f}"
            f" Tsfc={d['Tsfc']:.3f} sst={d['sst']:.3f}"
            f" frzmlt={d['frzmlt']:.2f}")
        lines.append(
            f"  atm: Tair={d['Tair']:.3f} Qa={d['Qa']:.2e}"
            f" flw={d['flw']:.2f} snow={d['fsnow']:.2e}"
            f" rain={d['frain']:.2e}")
        lines.append(
            f"  sfc: fswabs={d['fswabs']:.2f} flwout={d['flwout']:.2f}"
            f" fsens={d['fsens']:.2f} flat={d['flat']:.2f}"
            f" fsurf={d['fsurf']:.2f} fcondtop={d['fcondtop']:.2f}")
        lines.append(
            f"  dhi: meltt={d['meltt']:.2e} meltb={d['meltb']:.2e}"
            f" meltl={d['meltl']:.2e} congel={d['congel']:.2e}"
            f" frazil={d['frazil']:.2e} snoice={d['snoice']:.2e}"
            f" evap={d['evap']:.2e} fhocn={d['fhocn']:.2f}")
    return "\n".join(lines)


def print_state(state: State, grid: Grid, j: int, i: int) -> str:
    """Full single-cell state dump (``ice_diagnostics.F90
    print_state:1071-1220``) — the `debug_ice` probe."""
    lines = [f"cell (j={j}, i={i})  "
             f"lat={float(grid.tlat[j, i]) * cn.rad_to_deg:.3f} "
             f"lon={float(grid.tlon[j, i]) * cn.rad_to_deg:.3f}"]
    for n in range(state.ncat):
        lines.append(
            f" cat {n}: aicen={float(state.aicen[n, j, i]):.6e}"
            f" vicen={float(state.vicen[n, j, i]):.6e}"
            f" vsnon={float(state.vsnon[n, j, i]):.6e}"
            f" Tsf={float(state.tsfcn[n, j, i]):.4f}")
        for k in range(state.eicen.shape[1]):
            lines.append(f"   eicen[{k}]={float(state.eicen[n, k, j, i]):.6e}")
    lines.append(f" uvel={float(state.uvel[j, i]):.6e}"
                 f" vvel={float(state.vvel[j, i]):.6e}"
                 f" sst={float(state.sst[j, i]):.4f}"
                 f" frzmlt={float(state.frzmlt[j, i]):.4f}")
    return "\n".join(lines)
