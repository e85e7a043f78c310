"""The model: one fully-jitted time step composing all physics.

JAX equivalent of ``source/ice_step_mod.F90`` +
``drivers/cice4/CICE_RunMod.F90 ice_step:164-242``.  The entire step —
radiation, per-category vertical thermo, ITD conversions, EVP dynamics,
transport, ridging, cleanup, slab ocean — is one traced program; XLA
fuses across phases and (under sharding) inserts all communication.

Ordering note vs the reference: the reference computes the next step's
shortwave at the *end* of each step (`step_radiation`) and rescales it
at the start of the next (`prep_radiation`) because a coupler may have
changed the SW forcing in between.  Standalone, with forcing known at
step start, we compute radiation at the beginning of the step from the
current forcing — the CICE5-style ordering; `scale_factor` is still
maintained in the state for coupled parity.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from cice4_tpu import constants as cn
from cice4_tpu.config import Config
from cice4_tpu.forcing import Forcing
from cice4_tpu.grid import Grid
from cice4_tpu.ops import itd as itd_ops
from cice4_tpu.ops import mechred, therm_itd, transport
from cice4_tpu.ops.atmo import atmo_boundary_const, atmo_boundary_layer
from cice4_tpu.ops.evp import evp
from cice4_tpu.ops.ocean import ocean_mixed_layer
from cice4_tpu.ops.orbital import compute_coszen
from cice4_tpu.ops.shortwave import shortwave_ccsm3
from cice4_tpu.ops.therm_vertical import (ThermoParams,
                                          frzmlt_bottom_lateral,
                                          make_thermo_params,
                                          thermo_vertical_category)
from cice4_tpu.state import (ItdParams, State, freezing_temperature,
                             make_itd_params)


@dataclasses.dataclass(frozen=True)
class Model:
    """Bundles static configuration for the jitted step."""

    cfg: Config
    itd: ItdParams
    thermo: ThermoParams

    @classmethod
    def create(cls, cfg: Config) -> "Model":
        itd = make_itd_params(cfg)
        return cls(cfg=cfg, itd=itd, thermo=make_thermo_params(cfg, itd))


def _step_radiation(model: Model, state: State, grid: Grid, f: Forcing,
                    yday, sec, dt):
    """Zenith angle + per-category shortwave
    (``ice_step_mod.F90 step_radiation:764-973``)."""
    cfg = model.cfg
    coszen = compute_coszen(grid.tlat, grid.tlon, yday, sec, dt)

    if cfg.radiation.shortwave == "dEdd":
        from cice4_tpu.ops.meltpond import dpthfrac
        from cice4_tpu.ops.shortwave_dedd import shortwave_dEdd

        if "volpn" in state.trcrn:
            apond = jnp.minimum(
                jnp.sqrt(jnp.maximum(state.trcrn["volpn"], 0.0)
                         / dpthfrac), 1.0)
            hpond = dpthfrac * apond
        else:
            apond = hpond = None

        def cat(a, v, vs, t, ap, hp):
            return shortwave_dEdd(
                cfg.radiation, model.itd.nilyr, model.itd.nslyr,
                a, v, vs, t, coszen, f.swvdr, f.swvdf, f.swidr, f.swidf,
                apond=ap, hpond=hp)

        if apond is None:
            sw = jax.vmap(lambda a, v, vs, t: cat(a, v, vs, t, None, None)
                          )(state.aicen, state.vicen, state.vsnon,
                            state.tsfcn)
        else:
            sw = jax.vmap(cat)(state.aicen, state.vicen, state.vsnon,
                               state.tsfcn, apond, hpond)
    else:
        sw = jax.vmap(
            lambda a, v, vs, t: shortwave_ccsm3(
                cfg.radiation, model.itd.nilyr, model.itd.nslyr,
                cfg.thermo.heat_capacity, a, v, vs, t,
                f.swvdr, f.swvdf, f.swidr, f.swidf),
        )(state.aicen, state.vicen, state.vsnon, state.tsfcn)
    sw["coszen"] = coszen
    return sw


def _prep_radiation(model: Model, state: State, f: Forcing):
    """Coupled-mode SW rescale at step start (``ice_step_mod.F90
    prep_radiation:84-218``): multiply last step's absorbed-SW
    components (carried in state.swn) by netsw_new / scale_factor."""
    swn = state.swn
    aice = jnp.sum(state.aicen, 0)
    netsw = (f.swvdr * (1.0 - swn["alvdr_gbm"])
             + f.swvdf * (1.0 - swn["alvdf_gbm"])
             + f.swidr * (1.0 - swn["alidr_gbm"])
             + f.swidf * (1.0 - swn["alidf_gbm"]))
    ok = (aice > 0.0) & (state.scale_factor > cn.puny)
    scale = jnp.where(ok, netsw / jnp.maximum(state.scale_factor,
                                              cn.puny), 1.0)
    sw = dict(
        fswsfc=scale[None] * swn["fswsfcn"],
        fswint=scale[None] * swn["fswintn"],
        fswthru=scale[None] * swn["fswthrun"],
        Sswabs=scale[None, None] * swn["Sswabsn"],
        Iswabs=scale[None, None] * swn["Iswabsn"],
        fswfac=scale,
    )
    return sw


def _step_therm1(model: Model, state: State, grid: Grid, f: Forcing,
                 sw, Tf, yday, dt):
    """Per-category vertical thermo + flux merging
    (``CICE_RunMod.F90 step_therm1:260-598``)."""
    cfg = model.cfg
    aicen_init = state.aicen
    vicen_init = state.vicen

    agg = itd_ops.aggregate(state, grid.tmask)
    Tbot, fbot, rside = frzmlt_bottom_lateral(
        model.thermo, dt, agg["aice"], state.frzmlt, state.eicen,
        state.esnon, state.sst, Tf, state.strocnxT, state.strocnyT)

    prescribed = (not cfg.thermo.calc_Tsfc) and f.fsurfn_f is not None

    def percat(aicen, vicen, vsnon, tsfcn, eicen, esnon,
               fswsfc, fswint, fswthru, Sswabs, Iswabs,
               fsurfn_f=None, fcondtopn_f=None, flatn_f=None):
        if cfg.thermo.atmbndy == "constant":
            bl = atmo_boundary_const("ice", f.uatm, f.vatm, f.wind, f.rhoa,
                                     cfg.thermo.calc_strair)
        else:
            bl = atmo_boundary_layer("ice", tsfcn, f.potT, f.uatm, f.vatm,
                                     f.wind, f.zlvl, f.Qa, f.rhoa,
                                     cfg.thermo.calc_strair)
        pre = {}
        ex = None
        if not cfg.thermo.calc_Tsfc:
            if prescribed:
                # coupler-supplied per-category fluxes (set_sfcflux,
                # CICE_RunMod.F90:787-920; raicen=1 standalone)
                pre = dict(fsurfn_pre=fsurfn_f,
                           fcondtopn_pre=fcondtopn_f,
                           flatn_pre=flatn_f)
            else:
                # ice-only testing mode: explicit surface scheme
                # (CICE_RunMod.F90:465-499)
                from cice4_tpu.ops.therm_vertical import explicit_calc_tsfc
                ex = explicit_calc_tsfc(
                    model.thermo, dt, aicen, vicen, vsnon, tsfcn,
                    eicen, esnon, f.rhoa, f.flw, f.potT, f.Qa,
                    bl["shcoef"], bl["lhcoef"], fswsfc)
                tsfcn = ex["Tsf"]
                pre = dict(fsurfn_pre=ex["fsurfn"],
                           fcondtopn_pre=ex["fcondtopn"],
                           flatn_pre=ex["flatn"])
        st, fx = thermo_vertical_category(
            model.thermo, dt, aicen, vicen, vsnon, tsfcn, eicen, esnon,
            f.flw, f.potT, f.Qa, f.rhoa, f.fsnow, fbot, Tbot, Tf,
            bl["lhcoef"], bl["shcoef"], fswsfc, fswint, fswthru,
            Sswabs, Iswabs, **pre)
        if ex is not None:
            fx["fsensn"] = ex["fsensn"]
            fx["flwoutn"] = ex["flwoutn"]
        fx["strairxn"] = bl["strx"]
        fx["strairyn"] = bl["stry"]
        fx["Trefn"] = bl["Tref"]
        fx["Qrefn"] = bl["Qref"]
        return st, fx

    cat_args = (state.aicen, state.vicen, state.vsnon, state.tsfcn,
                state.eicen, state.esnon,
                sw["fswsfc"], sw["fswint"], sw["fswthru"],
                sw["Sswabs"], sw["Iswabs"])
    if prescribed:
        st, fx = jax.vmap(percat)(*cat_args, f.fsurfn_f, f.fcondtopn_f,
                                  f.flatn_f)
    else:
        st, fx = jax.vmap(lambda *a: percat(*a))(*cat_args)

    guards = {}
    if cfg.run.guards:
        # conservation_check_vthermo (ice_therm_vertical.F90:4511-4613)
        from cice4_tpu.guards import check_vthermo
        # NB: fx["fswint"] is the solve's ADJUSTED interior absorption
        # (thin-layer SW moved to the surface), the value the reference
        # passes to the check (intent(inout), ice_therm_vertical.F90
        # :1563-1591, :461)
        guards["thermo energy conservation (W/m^2)"] = check_vthermo(
            dt, fx["fsurfn"], fx["flatn"], fx["fswint"],
            fx["fhocnn"], f.fsnow[None], fx["einit"], fx["efinal"],
            aicen_init > cn.a_negligible(aicen_init.dtype))

    trcrn = dict(state.trcrn)
    if "iage" in trcrn:
        # increment_age (ice_age.F90:87-123)
        trcrn["iage"] = jnp.where(st["aicen"] > cn.puny,
                                  trcrn["iage"] + dt, 0.0)
    if "volpn" in trcrn and cfg.radiation.shortwave == "dEdd":
        # explicit melt ponds (ice_meltpond.F90 compute_ponds:88-230)
        from cice4_tpu.ops.meltpond import compute_ponds
        volpn, _ap, _hp = jax.vmap(
            lambda mt, ms, a, v, vs, t, vp: compute_ponds(
                dt, mt, ms, f.frain, a, v, vs, t, vp)
        )(fx["meltt"], fx["melts"], st["aicen"], st["vicen"],
          st["vsnon"], st["tsfcn"], trcrn["volpn"])
        trcrn["volpn"] = volpn

    state = state.replace(aicen=st["aicen"], vicen=st["vicen"],
                          vsnon=st["vsnon"], tsfcn=st["tsfcn"],
                          eicen=st["eicen"], esnon=st["esnon"],
                          trcrn=trcrn)

    # merge_fluxes (ice_flux.F90:613-762): category -> cell means,
    # weighted by the *pre-thermo* areas
    w = aicen_init
    merged = {}
    for name, per_ice in [
        ("strairxT", "strairxn"), ("strairyT", "strairyn"),
        ("fsurf", "fsurfn"), ("fcondtop", "fcondtopn"),
        ("fsens", "fsensn"), ("flat", "flatn"), ("fswabs", "fswabsn"),
        ("flwout", "flwoutn"), ("evap", "evapn"),
        ("Tref", "Trefn"), ("Qref", "Qrefn"),
        ("fresh", "freshn"), ("fsalt", "fsaltn"), ("fhocn", "fhocnn"),
        ("fswthru", None), ("meltt", "meltt"), ("melts", "melts"),
        ("meltb", "meltb"), ("congel", "congel"), ("snoice", "snoice"),
    ]:
        src = sw["fswthru"] if per_ice is None else fx[per_ice]
        merged[name] = jnp.sum(src * w, axis=0)
    # the coupler-facing flwout includes the REFLECTED downwelling LW
    # (the surface absorbs only emissivity*flw; the atmosphere needs
    # the full upward radiative BC) — ice_flux.F90 merge_fluxes:739-740
    merged["flwout"] = merged["flwout"] \
        - (1.0 - cn.emissivity) * f.flw * jnp.sum(w, axis=0)
    ponds_active = ("volpn" in state.trcrn
                    and cfg.radiation.shortwave == "dEdd")
    if not ponds_active:
        # rain over ice passes through to the ocean.  The reference
        # books rain as a budget INPUT (runtime_diags rnn,
        # ice_diagnostics.F90:461-466) but, with melt ponds off,
        # never adds it to `fresh` — its standalone water ledger
        # leaks the full rain-over-ice flux (later CICE versions add
        # it to fresh; with tr_pond the reference stores part of it
        # in the virtual pond volume instead).
        merged["fresh"] = merged["fresh"] + f.frain * jnp.sum(w, axis=0)
    merged["rside"] = rside
    merged["fbot"] = fbot
    # step-start freezing potential: the frazil formed THIS step used
    # this value; coupling_prep overwrites state.frzmlt for the next
    # step, so the budget-closure diagnostic needs the saved copy (the
    # reference diags read the post-update field, ice_diagnostics.F90
    # :448-452, and carry the resulting O(1e-4) herr noise — we close
    # tightly instead)
    merged["frzmlt_init"] = state.frzmlt
    # pre-step total concentration, the weight the reference's budget
    # diagnostics use for rain/snow input (ice_diagnostics.F90:461-474)
    merged["aice_init"] = jnp.sum(aicen_init, axis=0)
    # calc_strair=F with a prescribed-stress dataset (monthly): the
    # boundary layer returned zero stress; take the file stress instead
    # (already rotated + aice-weighted, ice_dyn_evp.F90:255-277)
    if not model.cfg.thermo.calc_strair and f.strax is not None:
        merged["strairxT"] = f.strax
        merged["strairyT"] = f.stray
    # per-category grid-cell-mean fluxes for the 3Dc history fields
    # (ice_history.F90 f_fsurfn_ai etc.; "_ai" = times category area)
    for name, per_ice in [("fsurfn_ai", "fsurfn"),
                          ("fcondtopn_ai", "fcondtopn"),
                          ("flatn_ai", "flatn")]:
        merged[name] = fx[per_ice] * w
    # instantaneous surface-melt heat flux, NOT realized-melt energy
    # (ice_history.F90:1711-1714: max(fsurfn-fcondtopn,0)*aicen_init)
    merged["fmelttn_ai"] = jnp.maximum(fx["fsurfn"] - fx["fcondtopn"],
                                       0.0) * w
    merged["vice_init"] = jnp.sum(vicen_init, axis=0)
    # per-category, per-cell Newton iterations of the temperature solve
    # (read by the column-physics probe; `ice_step` drops them)
    merged["niter_cell"] = fx["niter_cell"]
    import os as _os
    if _os.environ.get("CICE4_DEBUG_THERM1"):
        merged["_dbg_therm1"] = {k: fx[k] for k in
                                 ("einit", "efinal", "evapn", "fswint",
                                  "fsurfn", "flatn", "fhocnn")}
    merged["_guards"] = guards
    return state, merged, dict(aicen_init=aicen_init,
                               vicen_init=vicen_init)


def _step_therm2(model: Model, state: State, grid: Grid, fluxes,
                 init, Tf, dt):
    """ITD conversions (``ice_step_mod.F90 step_therm2:239-516``)."""
    cfg, itd = model.cfg, model.itd
    if cfg.thermo.kitd == 1:
        vice_before = jnp.sum(state.vicen, 0)
        state = therm_itd.linear_itd(state, itd, init["aicen_init"],
                                     init["vicen_init"])
        if cfg.run.guards:
            # column_conservation_check (ice_itd.F90:1409-1473), as
            # called after linear_itd (ice_therm_itd.F90:330-360)
            from cice4_tpu.guards import check_column_conservation
            fluxes["_guards"]["column conservation: vice after "
                              "linear_itd"] = check_column_conservation(
                vice_before, jnp.sum(state.vicen, 0), grid.tmask)
    state, dg = therm_itd.add_new_ice(state, itd, cfg, dt,
                                      state.frzmlt, Tf, grid.tmask)
    fluxes["frazil"] = dg["frazil"]
    if "dfresh" in dg:
        fluxes["fresh"] = fluxes["fresh"] + dg["dfresh"]
        fluxes["fsalt"] = fluxes["fsalt"] + dg["dfsalt"]

    state, lm = therm_itd.lateral_melt(state, itd, dt, fluxes["rside"])
    fluxes["fresh"] = fluxes["fresh"] + lm["fresh"]
    fluxes["fsalt"] = fluxes["fsalt"] + lm["fsalt"]
    fluxes["fhocn"] = fluxes["fhocn"] + lm["fhocn"]
    fluxes["meltl"] = lm["meltl"]

    state, zap = itd_ops.cleanup_itd(state, itd, grid.tmask, dt)
    fluxes["fresh"] = fluxes["fresh"] + zap["dfresh"]
    fluxes["fsalt"] = fluxes["fsalt"] + zap["dfsalt"]
    fluxes["fhocn"] = fluxes["fhocn"] + zap["dfhocn"]
    return state, fluxes


def _step_dynamics(model: Model, state: State, grid: Grid, f: Forcing,
                   fluxes, dt):
    """EVP + transport + ridging
    (``ice_step_mod.F90 step_dynamics:538-745``)."""
    cfg, itd = model.cfg, model.itd
    agg = itd_ops.aggregate(state, grid.tmask)

    if cfg.dynamics.kdyn == 1:
        state, dyn_diag = evp(
            state, grid, cfg.dynamics, dt,
            agg["aice"], agg["vice"], agg["vsno"],
            state.aicen, state.vicen, agg["aice0"],
            f.uocn, f.vocn, f.ss_tltx, f.ss_tlty,
            fluxes["strairxT"], fluxes["strairyT"])
    else:
        z = jnp.zeros_like(agg["aice"])
        dyn_diag = dict(rdg_conv=z, rdg_shear=z, divu=z, shear=z,
                        strength=z, prs_sig=z)

    if cfg.transport.advection == "remap":
        from cice4_tpu.ops.remap import (remap_sharded_eligible,
                                         transport_remap,
                                         transport_remap_sharded)
        from cice4_tpu.parallel.mesh import get_active_mesh
        tchecks = (cfg.transport.conservation_check
                   or cfg.transport.monotonicity_check)
        mesh = get_active_mesh()
        if remap_sharded_eligible(grid, mesh, cfg.transport):
            # k-halo aggregated-exchange fast path (one batched halo
            # move instead of ~50 per-roll GSPMD permutes)
            state, aice0_adv = transport_remap_sharded(
                state, grid, dt, mesh, cfg.transport.integral_order,
                cfg.transport.l_dp_midpt, cfg.transport.l_fixed_area)
        else:
            out = transport_remap(
                state, grid, dt, cfg.transport.integral_order,
                cfg.transport.l_dp_midpt, cfg.transport.l_fixed_area,
                conservation_check=cfg.transport.conservation_check,
                monotonicity_check=cfg.transport.monotonicity_check)
            if tchecks:
                state, aice0_adv, tguards = out
                fluxes["_guards"].update(tguards)
            else:
                state, aice0_adv = out
    elif cfg.transport.advection == "upwind":
        state, aice0_adv = transport.transport_upwind(state, grid, dt)
    else:
        aice0_adv = None

    state, rdg = mechred.ridge_ice(state, itd, cfg.dynamics, dt,
                                   dyn_diag["rdg_conv"],
                                   dyn_diag["rdg_shear"], grid.tmask,
                                   aice0=aice0_adv, guards=cfg.run.guards)
    if "_guard" in rdg:
        fluxes["_guards"]["ridging: area sum != 1"] = rdg.pop("_guard")
    fluxes["fresh"] = fluxes["fresh"] + rdg["fresh"]
    fluxes["fhocn"] = fluxes["fhocn"] + rdg["fhocn"]
    for k in ("dardg1dt", "dardg2dt", "dvirdgdt", "opening"):
        fluxes[k] = rdg[k]

    state, zap = itd_ops.cleanup_itd(state, itd, grid.tmask, dt)
    fluxes["fresh"] = fluxes["fresh"] + zap["dfresh"]
    fluxes["fsalt"] = fluxes["fsalt"] + zap["dfsalt"]
    fluxes["fhocn"] = fluxes["fhocn"] + zap["dfhocn"]

    for k in ("divu", "shear", "strength", "prs_sig"):
        fluxes[k] = dyn_diag[k]
    for k in ("strintx", "strinty", "strocnx", "strocny",
              "strtltx", "strtlty", "strcorx", "strcory"):
        if k in dyn_diag:
            fluxes[k] = dyn_diag[k]

    # principal stresses sig1/sig2 + stress trace for history
    # (``principal_stress``, ice_dyn_evp.F90:1558-1609)
    if cfg.dynamics.kdyn == 1:
        sp1, sm1, s12_1 = (state.stressp[0], state.stressm[0],
                           state.stress12[0])
        rad = jnp.sqrt(sm1**2 + 4.0 * s12_1**2)
        prs = dyn_diag["prs_sig"]
        ok = prs > cn.puny
        safe = jnp.maximum(prs, cn.puny)
        fluxes["sig1"] = jnp.where(ok, 0.5 * (sp1 + rad) / safe, cn.spval)
        fluxes["sig2"] = jnp.where(ok, 0.5 * (sp1 - rad) / safe, cn.spval)
        fluxes["trsig"] = 0.25 * jnp.sum(state.stressp, axis=0)
    return state, fluxes


def _coupling_prep(model: Model, state: State, grid: Grid, f: Forcing,
                   sw, fluxes, Tf, dt):
    """Albedo aggregation, slab ocean, SW scale factor
    (``CICE_RunMod.F90 coupling_prep:615-764``)."""
    cfg = model.cfg
    agg = itd_ops.aggregate(state, grid.tmask)
    aice = agg["aice"]

    albs = {}
    for name in ("alvdf", "alidf", "alvdr", "alidr"):
        albs[name] = jnp.sum(sw[name + "n"] * state.aicen, 0)
    scale_factor = (f.swvdr * (1.0 - albs["alvdr"])
                    + f.swvdf * (1.0 - albs["alvdf"])
                    + f.swidr * (1.0 - albs["alidr"])
                    + f.swidf * (1.0 - albs["alidf"]))

    sst, frzmlt = state.sst, state.frzmlt
    if cfg.thermo.oceanmixed_ice:
        ml = ocean_mixed_layer(
            dt, grid.tmask, aice, state.sst, Tf, f.qdp, f.hmix,
            f.uatm, f.vatm, f.wind, f.zlvl, f.potT, f.Qa, f.rhoa, f.flw,
            f.swvdr, f.swvdf, f.swidr, f.swidf,
            fluxes["fhocn"], fluxes["fswthru"],
            atmbndy=cfg.thermo.atmbndy)
        sst, frzmlt = ml["sst"], ml["frzmlt"]
        fluxes.update({k: v for k, v in ml.items()
                       if k not in ("sst", "frzmlt", "qdp")})

    swn = state.swn
    if cfg.radiation.prep_radiation:
        # carry the absorbed-SW components + gridbox albedos to the
        # next step's prep_radiation rescale
        swn = dict(fswsfcn=sw["fswsfc"], fswintn=sw["fswint"],
                   fswthrun=sw["fswthru"], Sswabsn=sw["Sswabs"],
                   Iswabsn=sw["Iswabs"],
                   alvdr_gbm=albs["alvdr"], alvdf_gbm=albs["alvdf"],
                   alidr_gbm=albs["alidr"], alidf_gbm=albs["alidf"])

    state = state.replace(sst=sst, frzmlt=frzmlt,
                          scale_factor=scale_factor, swn=swn)
    fluxes.update(albs)
    fluxes["coszen"] = sw["coszen"]
    fluxes["albice"] = jnp.sum(sw["albin"] * state.aicen, 0)
    fluxes["albsno"] = jnp.sum(sw["albsn"] * state.aicen, 0)

    # grid-box-mean copies kept for the budget diagnostics before
    # scale_fluxes divides by aice (the reference's fresh_gbm/fsalt_gbm/
    # fhocn_gbm/fswthru_gbm, ice_flux.F90 + ice_diagnostics.F90:370-445)
    for name in ("fresh", "fsalt", "fhocn", "fswthru", "evap",
                 "fsens", "flwout", "fswabs", "flat", "fsurf"):
        fluxes[name + "_gbm"] = fluxes[name]
    fluxes["aice"] = aice

    # scale_fluxes (ice_flux.F90:776-888): divide the merged fluxes by
    # aice so the coupler receives per-unit-ice-area values; zero (or
    # the documented defaults) where there is no ice
    ice = grid.tmask & (aice > 0.0)
    ar = jnp.where(ice, 1.0 / jnp.maximum(aice, cn.puny), 0.0)
    for name in ("strairxT", "strairyT", "fsens", "flat", "fswabs",
                 "evap", "Tref", "Qref", "fresh", "fsalt", "fhocn",
                 "fswthru", "alvdr", "alidr", "alvdf", "alidf"):
        fluxes[name] = fluxes[name] * ar
    fluxes["flwout"] = jnp.where(
        ice, fluxes["flwout"] * ar,
        -cn.stefan_boltzmann * (Tf + cn.Tffresh) ** 4)
    fluxes["Tref"] = jnp.where(ice, fluxes["Tref"], f.Tair)
    fluxes["Qref"] = jnp.where(ice, fluxes["Qref"], f.Qa)
    return state, fluxes


def ice_step(model: Model, state: State, grid: Grid, f: Forcing,
             yday=80.0, sec=0.0, dt=None):
    """One model step (``CICE_RunMod.F90 ice_step:164-242``).

    Returns (new_state, fluxes) where fluxes holds every merged
    coupler/diagnostic field of the step.
    """
    cfg = model.cfg
    if dt is None:
        dt = cfg.run.dt
    Tf = freezing_temperature(cfg, f.sss)

    if cfg.radiation.prep_radiation:
        # coupled ordering (CICE_RunMod.F90 ice_step:164-242): rescale
        # last step's absorbed SW now, run radiation at the END
        sw = _prep_radiation(model, state, f)
    else:
        # standalone/CICE5-style ordering: radiation at step start
        sw = _step_radiation(model, state, grid, f, yday, sec, dt)
    state, fluxes, init = _step_therm1(model, state, grid, f, sw, Tf,
                                       yday, dt)
    del fluxes["niter_cell"]
    state, fluxes = _step_therm2(model, state, grid, fluxes, init, Tf, dt)
    # thermodynamic area/volume tendencies (init_history_therm,
    # ice_flux.F90:513-604; accumulated as daidtt/dvidtt in 1/s, m/s)
    aice_mid = jnp.sum(state.aicen, 0)
    vice_mid = jnp.sum(state.vicen, 0)
    fluxes["daidtt"] = (aice_mid - fluxes["aice_init"]) / dt
    fluxes["dvidtt"] = (vice_mid - fluxes["vice_init"]) / dt
    state, fluxes = _step_dynamics(model, state, grid, f, fluxes, dt)
    # dynamic tendencies (init_history_dyn)
    fluxes["daidtd"] = (jnp.sum(state.aicen, 0) - aice_mid) / dt
    fluxes["dvidtd"] = (jnp.sum(state.vicen, 0) - vice_mid) / dt
    if cfg.radiation.prep_radiation:
        sw = _step_radiation(model, state, grid, f, yday, sec, dt)
    state, fluxes = _coupling_prep(model, state, grid, f, sw, fluxes,
                                   Tf, dt)
    return state, fluxes


def make_step_fn(model: Model):
    """Jitted step function; grid passes through as a pytree argument."""

    @jax.jit
    def step(state, grid, forcing, yday, sec):
        return ice_step(model, state, grid, forcing, yday, sec)

    return step
