"""Vertical thermodynamics: energy-conserving multilayer column physics.

JAX reworking of ``source/ice_therm_vertical.F90`` (Bitz &
Lipscomb 1999).  One call handles one thickness category over the whole
``(ny, nx)`` plane; the caller vmaps/loops over categories.

The reference's Newton-iterated implicit solve compacts the set of
unconverged cells into index lists each iteration
(``temperature_changes:1613-1656``); here the iteration is a
`lax.while_loop` whose body updates only unconverged cells through
masks — dense elementwise arithmetic replaces gather/scatter
compaction, and
the loop exits when every cell satisfies the five convergence
conditions (or `nitermax` is reached).

Layout: layer arrays are ``(nlyr, ny, nx)``; the tridiagonal system has
``nmat = nslyr + nilyr + 1`` rows and is solved by an unrolled Thomas
algorithm over rows (each row a dense (ny, nx) plane).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from cice4_tpu import constants as cn

# module parameters (ice_therm_vertical.F90:44-66)
hs_min = 1.0e-4      # min snow thickness for computing Tsno (m)
betak = 0.13         # conductivity salinity constant (W/m/ppt)
kimin = 0.10         # min conductivity of saline ice (W/m/K)
ferrmax = 1.0e-3     # max allowed energy flux error (W/m^2)
Tsf_errmax = 5.0e-4  # max allowed Tsf error (K)
nitermax = 100
saltmax_default = 3.2


@dataclasses.dataclass(frozen=True)
class ThermoParams:
    """Static thermo configuration + fixed vertical profiles."""

    nilyr: int
    nslyr: int
    salin: tuple        # (nilyr+1,) fixed salinity profile
    tmlt: tuple         # (nilyr+1,) melting temperatures (C)
    l_brine: bool
    heat_capacity: bool = True
    calc_Tsfc: bool = True
    conduct: str = "MU71"
    ustar_min: float = 0.05


def make_thermo_params(cfg, itd) -> ThermoParams:
    return ThermoParams(
        nilyr=itd.nilyr, nslyr=itd.nslyr,
        salin=tuple(float(s) for s in itd.salin),
        tmlt=tuple(float(t) for t in itd.tmlt),
        l_brine=bool(itd.salin[0] > 0.1) and cfg.thermo.heat_capacity,
        heat_capacity=cfg.thermo.heat_capacity,
        calc_Tsfc=cfg.thermo.calc_Tsfc,
        conduct=cfg.thermo.conduct,
        ustar_min=cfg.thermo.ustar_min,
    )


def _profile_const(vals, nilyr, like=None):
    """Fixed vertical profile built from python scalars.  With `like`
    (a reference plane) the profile is materialized at
    (nilyr, *like.shape)."""
    if like is not None:
        return jnp.stack([jnp.full_like(like, float(v))
                          for v in vals[:nilyr]])
    return jnp.stack([jnp.full((1, 1), float(v)) for v in vals[:nilyr]])


def tin_from_qin(p: ThermoParams, qin, tmlt_k):
    """Invert layer enthalpy -> temperature (``calculate_Tin_from_qin``,
    ice_therm_vertical.F90:1227-1260)."""
    if p.l_brine:
        aa1 = cn.cp_ice
        bb1 = (cn.cp_ocn - cn.cp_ice) * tmlt_k - qin / cn.rhoi - cn.Lfresh
        cc1 = cn.Lfresh * tmlt_k
        disc = jnp.maximum(bb1 * bb1 - 4.0 * aa1 * cc1, 0.0)
        return (-bb1 - jnp.sqrt(disc)) / (2.0 * aa1)
    return (cn.Lfresh + qin / cn.rhoi) / cn.cp_ice


def qin_of_tin(p: ThermoParams, tin, tmlt_k):
    """Layer temperature -> enthalpy (J/m^3, negative)."""
    if p.l_brine:
        tin_safe = jnp.minimum(tin, -cn.puny)
        return -cn.rhoi * (cn.cp_ice * (tmlt_k - tin_safe)
                           + cn.Lfresh * (1.0 - tmlt_k / tin_safe)
                           - cn.cp_ocn * tmlt_k)
    return -cn.rhoi * (-cn.cp_ice * tin + cn.Lfresh)


def qsn_of_tsn(tsn):
    return -cn.rhos * (cn.Lfresh - cn.cp_ice * tsn)


def frzmlt_bottom_lateral(p: ThermoParams, dt, aice, frzmlt, eicen_all,
                          esnon_all, sst, Tf, strocnxT, strocnyT):
    """Ocean heat available for bottom/lateral melt
    (``ice_therm_vertical.F90 frzmlt_bottom_lateral:605-824``).

    eicen_all/esnon_all: (ncat, nlyr, ny, nx).  Returns (Tbot, fbot,
    rside).
    """
    floediam, alpha, m1, m2 = 300.0, 0.66, 1.6e-6, 1.36
    cpchr = -cn.cp_ocn * cn.rhow * 0.006

    Tbot = Tf
    melt = (aice > cn.puny) & (frzmlt < 0.0)
    deltaT = jnp.maximum(sst - Tbot, 0.0)
    ustar = jnp.sqrt(jnp.sqrt(strocnxT**2 + strocnyT**2) / cn.rhow)
    ustar = jnp.maximum(ustar, p.ustar_min)
    fbot = cpchr * deltaT * ustar
    fbot = jnp.maximum(fbot, frzmlt)
    fbot = jnp.where(melt, fbot, 0.0)

    wlat = m1 * deltaT**m2
    rside = jnp.clip(wlat * dt * cn.pi / (alpha * floediam), 0.0, 1.0)
    rside = jnp.where(melt, rside, 0.0)

    etot = jnp.sum(eicen_all, (0, 1)) + jnp.sum(esnon_all, (0, 1))
    fside = rside * etot / dt  # <= 0

    xtmp = frzmlt / (fbot + fside + cn.puny)
    xtmp = jnp.minimum(xtmp, 1.0)
    xtmp = jnp.where(melt, xtmp, 1.0)
    return Tbot, fbot * xtmp, rside * xtmp


def _conductivity(p: ThermoParams, l_snow, hilyr, hslyr, Tin):
    """Interface conductivities kh (nmat = nslyr+nilyr+1 entries,
    0-based kh[i] == reference kh(i+1)) (``conductivity:2169-2295``)."""
    nilyr, nslyr = p.nilyr, p.nslyr
    salin = _profile_const(p.salin, nilyr, like=hilyr)
    kslyr = jnp.full((nslyr,) + Tin.shape[1:], cn.ksno, Tin.dtype)
    if p.conduct == "MU71":
        kilyr = cn.kice + betak * salin / jnp.minimum(-cn.puny, Tin)
    else:  # bubbly brine (Pringle et al 2007)
        kilyr = (2.11 - 0.011 * Tin
                 + 0.09 * salin / jnp.minimum(-cn.puny, Tin)) \
            * cn.rhoi / 917.0
    kilyr = jnp.maximum(kilyr, kimin)

    kh = []
    # kh[0]: top of snow (0 without snow)
    kh.append(jnp.where(l_snow, 2.0 * kslyr[0] / jnp.maximum(hslyr, cn.puny),
                        0.0))
    # interior snow interfaces
    for k in range(1, nslyr):
        kh.append(jnp.where(
            l_snow,
            2.0 * kslyr[k - 1] * kslyr[k]
            / jnp.maximum((kslyr[k - 1] + kslyr[k]) * hslyr, cn.puny), 0.0))
    # snow/ice interface (or top ice surface without snow)
    kh.append(jnp.where(
        l_snow,
        2.0 * kslyr[nslyr - 1] * kilyr[0]
        / jnp.maximum(kslyr[nslyr - 1] * hilyr + kilyr[0] * hslyr, cn.puny),
        2.0 * kilyr[0] / jnp.maximum(hilyr, cn.puny)))
    # interior ice interfaces
    for k in range(1, nilyr):
        kh.append(2.0 * kilyr[k - 1] * kilyr[k]
                  / jnp.maximum((kilyr[k - 1] + kilyr[k]) * hilyr, cn.puny))
    # bottom surface
    kh.append(2.0 * kilyr[nilyr - 1] / jnp.maximum(hilyr, cn.puny))
    return jnp.stack(kh)


def _surface_fluxes(Tsf, fswsfc, rhoa, flw, potT, Qa, shcoef, lhcoef):
    """Surface flux linearization (``surface_fluxes:2314-2423``)."""
    TsfK = Tsf + cn.Tffresh
    inv = 1.0 / TsfK
    qsat = cn.qqqice * jnp.exp(-cn.TTTice * inv)
    Qsfc = qsat / rhoa
    dQsfcdT = cn.TTTice * inv * inv * Qsfc
    flwdabs = cn.emissivity * flw
    flwoutn = -cn.emissivity * cn.stefan_boltzmann * TsfK**4
    fsensn = shcoef * (potT - TsfK)
    flatn = lhcoef * (Qa - Qsfc)
    dflwout_dT = -cn.emissivity * cn.stefan_boltzmann * 4.0 * TsfK**3
    dfsens_dT = -shcoef
    dflat_dT = -lhcoef * dQsfcdT
    fsurfn = fswsfc + flwdabs + flwoutn + fsensn + flatn
    dfsurf_dT = dflwout_dT + dfsens_dT + dflat_dT
    return dict(flwoutn=flwoutn, fsensn=fsensn, flatn=flatn, fsurfn=fsurfn,
                dflwout_dT=dflwout_dT, dfsens_dT=dfsens_dT,
                dflat_dT=dflat_dT, dfsurf_dT=dfsurf_dT)


def _tridiag(sb, d, sp, rhs):
    """Thomas algorithm, rows unrolled (row count static & small)."""
    n = len(d)
    d = list(d)
    rhs = list(rhs)
    for k in range(1, n):
        w = sb[k] / d[k - 1]
        d[k] = d[k] - w * sp[k - 1]
        rhs[k] = rhs[k] - w * rhs[k - 1]
    x = [None] * n
    x[n - 1] = rhs[n - 1] / d[n - 1]
    for k in range(n - 2, -1, -1):
        x[k] = (rhs[k] - sp[k] * x[k + 1]) / d[k]
    return x


def temperature_changes(p: ThermoParams, dt, has_ice,
                        rhoa, flw, potT, Qa, shcoef, lhcoef,
                        fswsfc, fswint, fswthrun, Sswabs, Iswabs,
                        hilyr, hslyr, qin, Tin, qsn, Tsn, Tsf, Tbot,
                        einit):
    """Newton-iterated implicit temperature solve
    (``temperature_changes:1288-2148``).

    All (ny, nx)-shaped (layer arrays (nlyr, ny, nx)).  `has_ice` masks
    active cells.  Returns dict of updated fields + fluxes.

    The whole grid iterates in one `lax.while_loop` until every ice
    cell has converged; `niter` is that global count and `niter_cell`
    the iterations each cell took before its own convergence.
    """
    nilyr, nslyr = p.nilyr, p.nslyr
    nmat = nslyr + nilyr + 1
    tmlt = _profile_const(p.tmlt, nilyr, like=hilyr)

    l_snow = has_ice & (hslyr > hs_min / nslyr)
    dt_rhoi_hlyr = dt / (cn.rhoi * jnp.maximum(hilyr, cn.puny))
    etas = jnp.where(l_snow,
                     dt / (cn.rhos * cn.cp_ice * jnp.maximum(hslyr, cn.puny)),
                     0.0)

    Tsn_init = Tsn
    Tin_init = Tin

    kh = _conductivity(p, l_snow, hilyr, hslyr, Tin)

    # --- move excess absorbed SW into the surface (":1531-1599") -----------
    frac, dTemp = 0.9, 0.02
    if p.l_brine:
        ci0 = cn.cp_ice - cn.Lfresh * tmlt / jnp.minimum(Tin_init,
                                                         -cn.puny) ** 2
        room = frac * (tmlt - Tin_init) * ci0 / dt_rhoi_hlyr
    else:
        room = frac * (-Tin_init) * cn.cp_ice / dt_rhoi_hlyr
    is_cold = Tin_init <= (tmlt - dTemp) if p.l_brine \
        else Tin_init <= -dTemp
    Iswabs_tmp = jnp.where(is_cold, jnp.minimum(Iswabs, room), 0.0)
    Iswabs_tmp = jnp.where(Iswabs_tmp < cn.puny, 0.0, Iswabs_tmp)
    isw = [Iswabs[k] for k in range(nilyr)]
    for k in range(nilyr):
        dswabs = jnp.minimum(isw[k] - Iswabs_tmp[k], fswint)
        fswsfc = fswsfc + dswabs
        fswint = fswint - dswabs
        isw[k] = isw[k] - dswabs
    Iswabs = jnp.stack(isw)
    Sswabs_tmp = jnp.where(Tsn_init <= -dTemp,
                           jnp.minimum(Sswabs, -frac * Tsn_init
                                       / jnp.maximum(etas, cn.puny)), 0.0)
    Sswabs_tmp = jnp.where(Sswabs < cn.puny, 0.0, Sswabs_tmp)
    ssw = [Sswabs[k] for k in range(nslyr)]
    for k in range(nslyr):
        dswabs = jnp.where(l_snow,
                           jnp.minimum(ssw[k] - Sswabs_tmp[k], fswint), 0.0)
        fswsfc = fswsfc + dswabs
        fswint = fswint - dswabs
        ssw[k] = ssw[k] - dswabs
    Sswabs = jnp.stack(ssw)

    fswabsn = fswsfc + fswint + fswthrun

    zero = jnp.zeros_like(Tsf)

    def assemble_and_solve(Tsf_c, Tsn_c, Tin_c, kh_c, l_cold, sf):
        """Build the nmat-row tridiagonal system and solve."""
        # specific heat update uses latest Tin guess
        if p.l_brine:
            ci = cn.cp_ice - cn.Lfresh * tmlt / \
                (jnp.minimum(Tin_c, -cn.puny) * jnp.minimum(Tin_init, -cn.puny))
        else:
            ci = jnp.full_like(Tin_c, cn.cp_ice)
        etai = dt_rhoi_hlyr[None] / ci

        sb, d, sp, rhs = [], [], [], []
        one = jnp.ones_like(Tsf_c)
        # row 0: Tsf equation (cold, snow) or dummy
        cold_snow = l_cold & l_snow
        sb.append(zero)
        d.append(jnp.where(cold_snow, sf["dfsurf_dT"] - kh_c[0], 1.0))
        sp.append(jnp.where(cold_snow, kh_c[0], 0.0))
        rhs.append(jnp.where(cold_snow,
                             sf["dfsurf_dT"] * Tsf_c - sf["fsurfn"], 0.0))
        # snow rows 1..nslyr (row nslyr doubles as Tsf eq when no snow)
        for k in range(nslyr):
            r = k + 1
            sbk = -etas * kh_c[k]
            spk = -etas * kh_c[k + 1]
            dk = 1.0 + etas * (kh_c[k] + kh_c[k + 1])
            rhk = Tsn_init[k] + etas * Sswabs[k]
            if k == 0:
                # melting surface: no coupling above; Tsf=0 enters rhs
                sbk = jnp.where(l_cold, sbk, 0.0)
                rhk = rhk + jnp.where(l_cold, 0.0, etas * kh_c[0] * Tsf_c)
            row_is_tsf = (r == nslyr) & True
            # when no snow: row nslyr holds the Tsf equation (if cold)
            if r == nslyr:
                cold_nosnow = l_cold & ~l_snow
                sbk = jnp.where(l_snow, sbk, 0.0)
                dk = jnp.where(l_snow, dk,
                               jnp.where(cold_nosnow,
                                         sf["dfsurf_dT"] - kh_c[nslyr], 1.0))
                spk = jnp.where(l_snow, spk,
                                jnp.where(cold_nosnow, kh_c[nslyr], 0.0))
                rhk = jnp.where(l_snow, rhk,
                                jnp.where(cold_nosnow,
                                          sf["dfsurf_dT"] * Tsf_c
                                          - sf["fsurfn"], 0.0))
            else:
                dk = jnp.where(l_snow, dk, 1.0)
                sbk = jnp.where(l_snow, sbk, 0.0)
                spk = jnp.where(l_snow, spk, 0.0)
                rhk = jnp.where(l_snow, rhk, 0.0)
            sb.append(sbk)
            d.append(dk)
            sp.append(spk)
            rhs.append(rhk)
        # ice rows
        for ki in range(nilyr):
            k = ki + nslyr  # kh interface index above this layer
            sbk = -etai[ki] * kh_c[k]
            spk = -etai[ki] * kh_c[k + 1]
            dk = 1.0 + etai[ki] * (kh_c[k] + kh_c[k + 1])
            rhk = Tin_init[ki] + etai[ki] * Iswabs[ki]
            if ki == 0:
                # warm surface without snow: Tsf=0 in rhs, no coupling above
                warm_nosnow = ~l_snow & ~l_cold
                rhk = rhk + jnp.where(warm_nosnow,
                                      etai[ki] * kh_c[k] * Tsf_c, 0.0)
                sbk = jnp.where(warm_nosnow, 0.0, sbk)
            if ki == nilyr - 1:
                rhk = rhk + etai[ki] * kh_c[k + 1] * Tbot
                spk = zero
            sb.append(sbk)
            d.append(dk)
            sp.append(spk)
            rhs.append(rhk)

        x = _tridiag(sb, d, sp, rhs)
        return x, etai

    def cond(carry):
        return (~carry["all_conv"]) & (carry["niter"] < nitermax)

    def body(carry):
        # converged rides the carry as a 0/1 mask in the compute dtype
        active = (carry["converged"] == 0.0) & has_ice
        Tsf_c, Tsn_c, Tin_c = carry["Tsf"], carry["Tsn"], carry["Tin"]
        kh_c = carry["kh"]

        sf = _surface_fluxes(Tsf_c, fswsfc, rhoa, flw, potT, Qa,
                             shcoef, lhcoef)
        # fcondtop with current temps
        fct = jnp.where(l_snow, kh_c[0] * (Tsf_c - Tsn_c[0]),
                        kh_c[nslyr] * (Tsf_c - Tin_c[0]))
        Tsf_c = jnp.where(active & (sf["fsurfn"] < fct),
                          jnp.minimum(Tsf_c, -cn.puny), Tsf_c)
        Tsf_start = Tsf_c
        l_cold = Tsf_c <= -cn.puny

        x, etai = assemble_and_solve(Tsf_c, Tsn_c, Tin_c, kh_c, l_cold, sf)

        # extract solution
        Tsf_new = jnp.where(l_cold, jnp.where(l_snow, x[0], x[nslyr]), 0.0)
        dTsf = Tsf_new - Tsf_start
        newly_unconv = jnp.zeros_like(l_cold)
        avg_Tsi = zero
        avg_Tsf = zero
        # condition 1: Tsf > 0
        c1v = Tsf_new > cn.puny
        Tsf_new = jnp.where(c1v, 0.0, Tsf_new)
        dTsf = jnp.where(c1v, -Tsf_start, dTsf)
        if p.l_brine:
            avg_Tsi = jnp.where(c1v, 1.0, avg_Tsi)
        newly_unconv = newly_unconv | c1v
        # condition 2: oscillation
        c2v = ((carry["niter"] > 0)
               & (Tsf_start <= -cn.puny)
               & (jnp.abs(dTsf) > cn.puny)
               & (jnp.abs(carry["dTsf_prev"]) > cn.puny)
               & (-dTsf / (carry["dTsf_prev"] + cn.puny**2) > 0.5))
        if p.l_brine:
            avg_Tsf = jnp.where(c2v, 1.0, avg_Tsf)
            avg_Tsi = jnp.where(c2v, 1.0, avg_Tsi)
        dTsf = jnp.where(c2v, 0.5 * dTsf, dTsf)
        newly_unconv = newly_unconv | c2v
        Tsf_new = Tsf_new + avg_Tsf * 0.5 * (Tsf_start - Tsf_new)

        # snow temps
        Tsn_new = []
        for k in range(nslyr):
            t = jnp.where(l_snow, x[k + 1], 0.0)
            if p.l_brine:
                t = jnp.minimum(t, 0.0)
            t = t + avg_Tsi * 0.5 * (Tsn_c[k] - t)
            Tsn_new.append(t)
        Tsn_new = jnp.stack(Tsn_new)
        qsn_new = qsn_of_tsn(Tsn_new)

        # ice temps with Tmlt limiting (+ conductivity reduction bookkeeping)
        Tin_new = []
        dqmat = []
        reduce_kh = []
        for ki in range(nilyr):
            t = x[nslyr + 1 + ki]
            tm = tmlt[ki, 0, 0] if tmlt.ndim == 3 else tmlt[ki]
            if p.l_brine:
                over = t > (tm - cn.puny)
                dT = jnp.where(over, t - tm, 0.0)
                dq = jnp.where(over,
                               cn.rhoi * dT * (cn.cp_ice - cn.Lfresh * tm
                                               / jnp.minimum(t, -cn.puny)**2),
                               0.0)
                t = jnp.where(over, tm, t)
                reduce_kh.append(over)
                dqmat.append(dq)
            else:
                reduce_kh.append(jnp.zeros_like(t, bool))
                dqmat.append(zero)
            t = t + avg_Tsi * 0.5 * (Tin_c[ki] - t)
            Tin_new.append(t)
        Tin_new = jnp.stack(Tin_new)
        dqmat = jnp.stack(dqmat)
        reduce_kh = jnp.stack(reduce_kh)
        qin_new = qin_of_tin(p, Tin_new, tmlt)

        enew = jnp.sum(hslyr[None] * qsn_new, 0) \
            + jnp.sum(hilyr[None] * (qin_new - dqmat), 0)
        # energy removed by clamping over-warm layers back to Tmlt.
        # The reference books it out of `enew` (":1996") so condition 5
        # can pass with dqmat > 0, and then leaks it: efinal is built
        # from the clamped qin, so conservation_check_vthermo sees a
        # deficit of hilyr*dqmat/dt W/m^2 and aborts (the ACCESS branch
        # simply disables that abort, ":4581").  We instead return it
        # to the ocean via fhocnn, as the reference's own "echmod:
        # return this energy to the ocean" note (":1943") intends —
        # the column then conserves exactly and the guard stays strict.
        dq_col = jnp.sum(hilyr[None] * dqmat, 0)

        # update fluxes for dTsf
        fsurfn_new = sf["fsurfn"] + dTsf * sf["dfsurf_dT"]
        fct_new = jnp.where(l_snow, kh_c[0] * (Tsf_new - Tsn_new[0]),
                            kh_c[nslyr] * (Tsf_new - Tin_new[0]))
        # condition 3
        newly_unconv = newly_unconv | (jnp.abs(dTsf) > Tsf_errmax)
        # condition 4
        newly_unconv = newly_unconv | ((Tsf_new > -cn.puny)
                                       & (fsurfn_new < fct_new))
        # condition 5: energy conservation.  The reference's fixed
        # ferrmax (1e-3 W/m^2) assumes float64; in float32 the residual
        #   (enew - einit)/dt - (fcondtop - fcondbot + fswint)
        # carries quantization noise from every term: the energy sums
        # (eps*|e|/dt), the conductive fluxes (kh * ulp(T), large for
        # thin snow/ice layers where kh ~ 1/h), and the enthalpy
        # reconstruction qin(Tin) (a few ulps of rhoi*Lfresh per layer).
        # The threshold therefore gets a dtype-adaptive floor scaled by
        # the magnitudes actually entering the residual; in f64 the
        # floor is ~1e-10 W/m^2 and never binds, preserving exact
        # reference semantics.  Without this, a cell whose *solution*
        # is converged can fail the check forever (observed: thin
        # sunlit ice runs to nitermax=100 in f32 every step).
        fcondbot = kh_c[nslyr + nilyr] * (Tin_new[nilyr - 1] - Tbot)
        ferr = jnp.abs((enew - einit) / dt - (fct_new - fcondbot + fswint))
        eps = jnp.finfo(ferr.dtype).eps
        noise_scale = (jnp.abs(einit) / dt + jnp.abs(fct_new)
                       + jnp.abs(fcondbot) + jnp.abs(fswint))
        ferrmax_eff = jnp.maximum(ferrmax, 32.0 * eps * noise_scale)
        bad_e = ferr > 0.9 * ferrmax_eff
        newly_unconv = newly_unconv | bad_e

        # conductivity reduction for overshooting layers (":2060-2072"),
        # keeping the chained row updates (row ki+nslyr+1 is read back
        # by the next ki's new_above)
        khr = [kh_c[r] for r in range(kh_c.shape[0])]
        denom = jnp.maximum(jnp.abs(fct_new - fcondbot), cn.puny)
        fracr = jnp.maximum(0.5 * (1.0 - ferr / denom), 0.1)
        for ki in range(nilyr):
            sel = bad_e & reduce_kh[ki] & (dqmat[ki] > 0.0)
            new_below = jnp.where(sel, khr[ki + nslyr + 1] * fracr,
                                  khr[ki + nslyr + 1])
            new_above = jnp.where(sel, new_below * fracr,
                                  khr[ki + nslyr])
            khr[ki + nslyr + 1] = new_below
            khr[ki + nslyr] = new_above
        kh_new = jnp.stack(khr)

        conv_now = ~newly_unconv

        # debug: bitmask of which conditions failed this iteration
        why = (c1v.astype(jnp.int32) * 1
               + c2v.astype(jnp.int32) * 2
               + (jnp.abs(dTsf) > Tsf_errmax).astype(jnp.int32) * 4
               + ((Tsf_new > -cn.puny)
                  & (fsurfn_new < fct_new)).astype(jnp.int32) * 8
               + bad_e.astype(jnp.int32) * 16)

        # merge: only active cells update
        def mrg(new, old):
            m = active
            if new.ndim == old.ndim and new.ndim == 3:
                m = active[None]
            return jnp.where(m, new, old)

        out = dict(carry)
        out["Tsf"] = mrg(Tsf_new, carry["Tsf"])
        out["Tsn"] = mrg(Tsn_new, carry["Tsn"])
        out["Tin"] = mrg(Tin_new, carry["Tin"])
        out["qsn"] = mrg(qsn_new, carry["qsn"])
        out["qin"] = mrg(qin_new, carry["qin"])
        out["kh"] = jnp.where(active[None], kh_new, carry["kh"])
        out["dTsf_prev"] = jnp.where(active, dTsf, carry["dTsf_prev"])
        out["converged"] = jnp.where(active,
                                     conv_now.astype(carry["converged"].dtype),
                                     carry["converged"])
        out["fsurfn"] = mrg(fsurfn_new, carry["fsurfn"])
        out["fcondtopn"] = mrg(fct_new, carry["fcondtopn"])
        out["fcondbot"] = mrg(fcondbot, carry["fcondbot"])
        out["fsensn"] = mrg(sf["fsensn"] + dTsf * sf["dfsens_dT"],
                            carry["fsensn"])
        out["flatn"] = mrg(sf["flatn"] + dTsf * sf["dflat_dT"],
                           carry["flatn"])
        out["flwoutn"] = mrg(sf["flwoutn"] + dTsf * sf["dflwout_dT"],
                             carry["flwoutn"])
        out["dq_col"] = jnp.where(active, dq_col, carry["dq_col"])
        out["why"] = jnp.where(active, why, carry["why"])
        out["niter_cell"] = carry["niter_cell"] + active.astype(jnp.int32)
        out["all_conv"] = jnp.all((out["converged"] != 0.0) | ~has_ice)
        out["niter"] = carry["niter"] + 1
        return out

    carry0 = dict(
        Tsf=Tsf, Tsn=Tsn, Tin=Tin, qsn=qsn, qin=qin, kh=kh,
        dTsf_prev=zero, converged=zero,
        fsurfn=zero, fcondtopn=zero, fcondbot=zero,
        fsensn=zero, flatn=zero, flwoutn=zero, dq_col=zero,
        why=jnp.zeros_like(has_ice, jnp.int32),
        niter_cell=jnp.zeros_like(has_ice, jnp.int32),
        all_conv=jnp.asarray(False), niter=jnp.asarray(0),
    )
    res = jax.lax.while_loop(cond, body, carry0)

    return dict(
        Tsf=res["Tsf"], Tsn=res["Tsn"], Tin=res["Tin"],
        qsn=res["qsn"], qin=res["qin"],
        fsurfn=res["fsurfn"], fcondtopn=res["fcondtopn"],
        fcondbot=res["fcondbot"], fsensn=res["fsensn"],
        flatn=res["flatn"], flwoutn=res["flwoutn"], fswabsn=fswabsn,
        fswsfc=fswsfc, fswint=fswint, Sswabs=Sswabs, Iswabs=Iswabs,
        dq_flux=res["dq_col"] / dt,
        converged=res["converged"] != 0.0, niter=res["niter"],
        niter_cell=res["niter_cell"], why=res["why"],
    )


def temperature_changes_know_tsfc(p: ThermoParams, dt, has_ice,
                                  fcondtopn,
                                  fswsfc, fswint, fswthrun, Sswabs, Iswabs,
                                  hilyr, hslyr, qin, Tin, qsn, Tsn,
                                  Tbot, einit):
    """Implicit temperature solve with a *prescribed* top conductive
    flux (``get_matrix_elements_know_Tsfc:2777-3050`` + the
    ``calc_Tsfc=F`` branches of ``temperature_changes``): the surface
    temperature is not solved — the coupler supplies ``fcondtopn`` —
    so the top active layer's boundary condition is the prescribed
    flux and the surface row is a dummy equation.

    Convergence = no oscillation in the top ice temperature
    (condition 2b, ``:1961-1975``) + energy conservation (condition 5).
    """
    nilyr, nslyr = p.nilyr, p.nslyr
    tmlt = _profile_const(p.tmlt, nilyr, like=hilyr)

    l_snow = has_ice & (hslyr > hs_min / nslyr)
    dt_rhoi_hlyr = dt / (cn.rhoi * jnp.maximum(hilyr, cn.puny))
    etas = jnp.where(l_snow,
                     dt / (cn.rhos * cn.cp_ice * jnp.maximum(hslyr, cn.puny)),
                     0.0)

    Tsn_init = Tsn
    Tin_init = Tin
    kh = _conductivity(p, l_snow, hilyr, hslyr, Tin)
    zero = jnp.zeros_like(hilyr)
    fswabsn = fswsfc + fswint + fswthrun

    def body(carry):
        active = ~carry["converged"] & has_ice
        Tsn_c, Tin_c, kh_c = carry["Tsn"], carry["Tin"], carry["kh"]

        # specific heat from latest guess (same scheme as calc_Tsfc=T)
        if p.l_brine:
            ci = cn.cp_ice - cn.Lfresh * tmlt / \
                (jnp.minimum(Tin_c, -cn.puny) * jnp.minimum(Tin_init,
                                                            -cn.puny))
        else:
            ci = jnp.full_like(Tin_c, cn.cp_ice)
        etai = dt_rhoi_hlyr[None] / ci

        # tridiagonal rows: surface + snow-when-absent rows are dummies
        sb, d, sp, rhs = [zero], [jnp.ones_like(zero)], [zero], [zero]
        for k in range(nslyr):
            sbk = jnp.where(l_snow, -etas * kh_c[k], 0.0)
            spk = jnp.where(l_snow, -etas * kh_c[k + 1], 0.0)
            dk = jnp.where(l_snow, 1.0 + etas * (kh_c[k] + kh_c[k + 1]),
                           1.0)
            rhk = jnp.where(l_snow, Tsn_init[k] + etas * Sswabs[k], 0.0)
            if k == 0:
                # prescribed flux enters the top snow layer; no
                # coupling to the (unsolved) surface above
                sbk = zero
                dk = jnp.where(l_snow, 1.0 + etas * kh_c[1], 1.0)
                rhk = jnp.where(l_snow, rhk + etas * fcondtopn, 0.0)
            sb.append(sbk), d.append(dk), sp.append(spk), rhs.append(rhk)
        for ki in range(nilyr):
            k = ki + nslyr
            sbk = -etai[ki] * kh_c[k]
            spk = -etai[ki] * kh_c[k + 1]
            dk = 1.0 + etai[ki] * (kh_c[k] + kh_c[k + 1])
            rhk = Tin_init[ki] + etai[ki] * Iswabs[ki]
            if ki == 0:
                # no snow: prescribed flux enters the top ice layer
                sbk = jnp.where(l_snow, sbk, 0.0)
                dk = jnp.where(l_snow, dk,
                               1.0 + etai[ki] * kh_c[k + 1])
                rhk = rhk + jnp.where(l_snow, 0.0, etai[ki] * fcondtopn)
            if ki == nilyr - 1:
                rhk = rhk + etai[ki] * kh_c[k + 1] * Tbot
                spk = zero
            sb.append(sbk), d.append(dk), sp.append(spk), rhs.append(rhk)

        x = _tridiag(sb, d, sp, rhs)

        Tsn_new = jnp.stack([jnp.where(l_snow, x[k + 1], 0.0)
                             for k in range(nslyr)])
        if p.l_brine:
            Tsn_new = jnp.minimum(Tsn_new, 0.0)
        qsn_new = qsn_of_tsn(Tsn_new)

        # condition 2b: oscillating top ice temperature
        Ti1_raw = x[nslyr + 1]
        dTi1 = Ti1_raw - carry["Ti1_prev"]
        osc = ((carry["niter"] > 0)
               & (jnp.abs(dTi1) > cn.puny)
               & (jnp.abs(carry["dTi1_prev"]) > cn.puny)
               & (-dTi1 / (carry["dTi1_prev"] + cn.puny**2) > 0.5))
        avg_Tsi = jnp.where(osc & p.l_brine, 1.0, 0.0)
        dTi1 = jnp.where(osc, 0.5 * dTi1, dTi1)
        newly_unconv = osc

        Tin_new, dqmat, reduce_kh = [], [], []
        for ki in range(nilyr):
            t = x[nslyr + 1 + ki]
            tm = tmlt[ki, 0, 0] if tmlt.ndim == 3 else tmlt[ki]
            if p.l_brine:
                over = t > (tm - cn.puny)
                dT = jnp.where(over, t - tm, 0.0)
                dq = jnp.where(over,
                               cn.rhoi * dT * (cn.cp_ice - cn.Lfresh * tm
                                               / jnp.minimum(t,
                                                             -cn.puny)**2),
                               0.0)
                t = jnp.where(over, tm, t)
                reduce_kh.append(over)
                dqmat.append(dq)
            else:
                reduce_kh.append(jnp.zeros_like(t, bool))
                dqmat.append(zero)
            t = t + avg_Tsi * 0.5 * (Tin_c[ki] - t)
            Tin_new.append(t)
        Tin_new = jnp.stack(Tin_new)
        dqmat = jnp.stack(dqmat)
        reduce_kh = jnp.stack(reduce_kh)
        qin_new = qin_of_tin(p, Tin_new, tmlt)

        enew = jnp.sum(hslyr[None] * qsn_new, 0) \
            + jnp.sum(hilyr[None] * (qin_new - dqmat), 0)
        # Tmlt-clamp energy returned to the ocean (see the matching
        # comment in temperature_changes)
        dq_col = jnp.sum(hilyr[None] * dqmat, 0)

        # condition 5: energy conservation with prescribed fcondtopn
        # (same dtype-adaptive noise floor as temperature_changes)
        fcondbot = kh_c[nslyr + nilyr] * (Tin_new[nilyr - 1] - Tbot)
        ferr = jnp.abs((enew - einit) / dt
                       - (fcondtopn - fcondbot + fswint))
        eps = jnp.finfo(ferr.dtype).eps
        noise_scale = (jnp.abs(einit) / dt + jnp.abs(fcondtopn)
                       + jnp.abs(fcondbot) + jnp.abs(fswint))
        ferrmax_eff = jnp.maximum(ferrmax, 32.0 * eps * noise_scale)
        bad_e = ferr > 0.9 * ferrmax_eff
        newly_unconv = newly_unconv | bad_e

        kh_new = kh_c
        denom = jnp.maximum(jnp.abs(fcondtopn - fcondbot), cn.puny)
        fracr = jnp.maximum(0.5 * (1.0 - ferr / denom), 0.1)
        for ki in range(nilyr):
            sel = bad_e & reduce_kh[ki] & (dqmat[ki] > 0.0)
            new_below = jnp.where(sel, kh_new[ki + nslyr + 1] * fracr,
                                  kh_new[ki + nslyr + 1])
            new_above = jnp.where(sel, new_below * fracr,
                                  kh_new[ki + nslyr])
            kh_new = kh_new.at[ki + nslyr + 1].set(new_below)
            kh_new = kh_new.at[ki + nslyr].set(new_above)

        def mrg(new, old):
            m = active
            if new.ndim == old.ndim and new.ndim == 3:
                m = active[None]
            return jnp.where(m, new, old)

        out = dict(carry)
        out["Tsn"] = mrg(Tsn_new, carry["Tsn"])
        out["Tin"] = mrg(Tin_new, carry["Tin"])
        out["qsn"] = mrg(qsn_new, carry["qsn"])
        out["qin"] = mrg(qin_new, carry["qin"])
        out["kh"] = jnp.where(active[None], kh_new, carry["kh"])
        out["Ti1_prev"] = jnp.where(active, Ti1_raw, carry["Ti1_prev"])
        out["dTi1_prev"] = jnp.where(active, dTi1, carry["dTi1_prev"])
        out["dq_col"] = jnp.where(active, dq_col, carry["dq_col"])
        out["fcondbot"] = mrg(fcondbot, carry["fcondbot"])
        out["converged"] = jnp.where(active, ~newly_unconv,
                                     carry["converged"])
        out["all_conv"] = jnp.all(out["converged"] | ~has_ice)
        out["niter_cell"] = carry["niter_cell"] + active.astype(jnp.int32)
        out["niter"] = carry["niter"] + 1
        return out

    carry0 = dict(
        Tsn=Tsn, Tin=Tin, qsn=qsn, qin=qin, kh=kh,
        Ti1_prev=Tin[0], dTi1_prev=zero, dq_col=zero,
        converged=jnp.zeros_like(has_ice), fcondbot=zero,
        niter_cell=jnp.zeros_like(has_ice, jnp.int32),
        all_conv=jnp.asarray(False), niter=jnp.asarray(0),
    )
    res = jax.lax.while_loop(
        lambda c: (~c["all_conv"]) & (c["niter"] < nitermax), body, carry0)

    return dict(
        Tsn=res["Tsn"], Tin=res["Tin"], qsn=res["qsn"], qin=res["qin"],
        fcondbot=res["fcondbot"], fswabsn=fswabsn,
        fswsfc=fswsfc, fswint=fswint, Sswabs=Sswabs, Iswabs=Iswabs,
        dq_flux=res["dq_col"] / dt,
        converged=res["converged"], niter=res["niter"],
        niter_cell=res["niter_cell"],
    )


def explicit_calc_tsfc(p: ThermoParams, dt, aicen, vicen, vsnon, tsfcn,
                       eicen, esnon, rhoa, flw, potT, Qa, shcoef, lhcoef,
                       fswsfcn):
    """Explicit (one-Newton-step) surface temperature and fluxes for
    the ``calc_Tsfc=F`` ice-only mode
    (``drivers/cice4/CICE_RunMod.F90 explicit_calc_Tsfc:1014-1257``).

    Returns dict(Tsf, flwoutn, fsensn, flatn, fsurfn, fcondtopn) —
    used as the prescribed fluxes when no coupler supplies them.
    """
    has_ice = aicen > cn.puny
    a_safe = jnp.maximum(aicen, cn.puny)
    hslyr = vsnon / a_safe / p.nslyr
    l_snow = (hslyr * p.nslyr > hs_min) & has_ice

    # temperature of the top layer (snow if present, else top ice)
    vs_safe = jnp.maximum(vsnon, cn.puny)
    qsn0 = esnon[0] * p.nslyr / vs_safe
    Tis_snow = jnp.minimum((cn.Lfresh + qsn0 / cn.rhos) / cn.cp_ice, 0.0)

    vi_safe = jnp.maximum(vicen, cn.puny)
    qin0 = eicen[0] * p.nilyr / vi_safe
    tmlt0 = p.tmlt[0]
    if p.l_brine:
        Tis_ice = jnp.minimum(tin_from_qin(p, qin0, tmlt0), tmlt0)
        ci = cn.cp_ice - cn.Lfresh * tmlt0 / \
            jnp.minimum(Tis_ice, -cn.puny) ** 2
    else:
        Tis_ice = jnp.minimum((cn.Lfresh + qin0 / cn.rhoi) / cn.cp_ice, 0.0)
        ci = jnp.full_like(Tis_ice, cn.cp_ice)
    Tis = jnp.where(l_snow, Tis_snow, Tis_ice)

    # conductivity/thickness of top layer, CFL-limited
    hilyr = vicen / a_safe / p.nilyr
    kilyr = jnp.maximum(cn.kice + betak * p.salin[0]
                        / jnp.minimum(-cn.puny, Tis_ice), kimin)
    khis = jnp.where(l_snow,
                     2.0 * cn.ksno / jnp.maximum(hslyr, cn.puny),
                     2.0 * kilyr / jnp.maximum(hilyr, cn.puny))
    khmax = jnp.where(l_snow, cn.rhos * cn.cp_ice * hslyr / dt,
                      cn.rhoi * ci * hilyr / dt)
    khis = jnp.minimum(khis, khmax)

    Tsf = tsfcn
    sf = _surface_fluxes(Tsf, fswsfcn, rhoa, flw, potT, Qa, shcoef, lhcoef)
    dTsf = (sf["fsurfn"] - khis * (Tsf - Tis)) \
        / (khis - sf["dfsurf_dT"])
    Tsf = Tsf + dTsf
    over = Tsf > 0.0
    dTsf = jnp.where(over, dTsf - Tsf, dTsf)
    Tsf = jnp.where(over, 0.0, Tsf)

    def z(x):
        return jnp.where(has_ice, x, 0.0)

    return dict(
        Tsf=jnp.where(has_ice, Tsf, tsfcn),
        flwoutn=z(sf["flwoutn"] + dTsf * sf["dflwout_dT"]),
        fsensn=z(sf["fsensn"] + dTsf * sf["dfsens_dT"]),
        flatn=z(sf["flatn"] + dTsf * sf["dflat_dT"]),
        fsurfn=z(sf["fsurfn"] + dTsf * sf["dfsurf_dT"]),
        fcondtopn=z(khis * (Tsf - Tis)),
    )


def zerolayer_temperature(p: ThermoParams, dt, has_ice,
                          rhoa, flw, potT, Qa, shcoef, lhcoef,
                          fswsfc, fswthru, hilyr, hslyr, Tsf, Tbot):
    """Zero-heat-capacity surface temperature solve
    (``zerolayer_temperature:3168-3603``): a single surface energy
    balance through the effective slab conductivity
    kh = kseaice / (hi + hs*kseaice/ksno)."""
    kratio = cn.kseaice / cn.ksno
    zero = jnp.zeros_like(Tsf)

    def cond(c):
        return (~c["all_conv"]) & (c["niter"] < nitermax)

    def body(c):
        active = ~c["converged"] & has_ice
        Tsf_c = c["Tsf"]
        sf = _surface_fluxes(Tsf_c, fswsfc, rhoa, flw, potT, Qa,
                             shcoef, lhcoef)
        heff = hilyr * p.nilyr + kratio * hslyr * p.nslyr
        kh = cn.kseaice / jnp.maximum(heff, cn.puny)
        fct = kh * (Tsf_c - Tbot)
        Tsf_c = jnp.where(active & (sf["fsurfn"] < fct),
                          jnp.minimum(Tsf_c, -cn.puny), Tsf_c)
        Tsf_start = Tsf_c

        diag = sf["dfsurf_dT"] - kh
        rhs = sf["dfsurf_dT"] * Tsf_c - sf["fsurfn"] - kh * Tbot
        Tsf_new = rhs / jnp.where(jnp.abs(diag) > cn.puny, diag, -cn.puny)

        dTsf = Tsf_new - Tsf_start
        unconv = jnp.zeros_like(active)
        hot = Tsf_new > cn.puny
        Tsf_new = jnp.where(hot, 0.0, Tsf_new)
        dTsf = jnp.where(hot, -Tsf_start, dTsf)
        osc = ((c["niter"] > 0) & (Tsf_start <= -cn.puny)
               & (jnp.abs(dTsf) > cn.puny)
               & (jnp.abs(c["dTsf_prev"]) > cn.puny)
               & (-dTsf / (c["dTsf_prev"] + cn.puny**2) > 0.5))
        dTsf = jnp.where(osc, 0.5 * dTsf, dTsf)
        Tsf_new = Tsf_new + jnp.where(osc, 0.5 * (Tsf_start - Tsf_new), 0.0)
        unconv = unconv | osc | (jnp.abs(dTsf) > Tsf_errmax)

        fsurfn = sf["fsurfn"] + dTsf * sf["dfsurf_dT"]
        fct_new = kh * (Tsf_new - Tbot)
        unconv = unconv | ((Tsf_new > -cn.puny) & (fsurfn < fct_new))

        def mrg(new, old):
            return jnp.where(active, new, old)

        out = dict(c)
        out["Tsf"] = mrg(Tsf_new, c["Tsf"])
        out["dTsf_prev"] = mrg(dTsf, c["dTsf_prev"])
        out["fsurfn"] = mrg(fsurfn, c["fsurfn"])
        out["fcondtopn"] = mrg(fct_new, c["fcondtopn"])
        out["fsensn"] = mrg(sf["fsensn"] + dTsf * sf["dfsens_dT"],
                            c["fsensn"])
        out["flatn"] = mrg(sf["flatn"] + dTsf * sf["dflat_dT"], c["flatn"])
        out["flwoutn"] = mrg(sf["flwoutn"] + dTsf * sf["dflwout_dT"],
                             c["flwoutn"])
        out["converged"] = jnp.where(active, ~unconv, c["converged"])
        out["all_conv"] = jnp.all(out["converged"] | ~has_ice)
        out["niter_cell"] = c["niter_cell"] + active.astype(jnp.int32)
        out["niter"] = c["niter"] + 1
        return out

    c0 = dict(Tsf=Tsf, dTsf_prev=zero, fsurfn=zero, fcondtopn=zero,
              fsensn=zero, flatn=zero, flwoutn=zero,
              converged=jnp.zeros_like(has_ice),
              niter_cell=jnp.zeros_like(has_ice, jnp.int32),
              all_conv=jnp.asarray(False), niter=jnp.asarray(0))
    r = jax.lax.while_loop(cond, body, c0)
    fswabsn = fswsfc + fswthru
    return dict(Tsf=r["Tsf"], fsurfn=r["fsurfn"],
                fcondtopn=r["fcondtopn"], fcondbot=r["fcondtopn"],
                fsensn=r["fsensn"], flatn=r["flatn"],
                flwoutn=r["flwoutn"], fswabsn=fswabsn, niter=r["niter"],
                niter_cell=r["niter_cell"])


def thickness_changes(p: ThermoParams, dt, has_ice, hilyr, hslyr,
                      qin, qsn, fbot, Tbot, flatn, fsurfn, fcondtopn,
                      fcondbot, fsnow):
    """Growth/melt at surfaces + snowfall + snow-ice + layer regridding
    (``thickness_changes:3622-4224``, ``freeboard:4244-4377``,
    ``adjust_enthalpy:4396-4492``).

    Returns dict with new hin/hsn/hilyr/hslyr/qin/qsn, fluxes and melt
    diagnostics (all per-unit-ice-area; caller multiplies by aicen).
    """
    nilyr, nslyr = p.nilyr, p.nslyr
    tmlt_bot = p.tmlt[nilyr]
    qbotmax = -0.5 * cn.rhoi * cn.Lfresh

    dzi = jnp.stack([hilyr] * nilyr)
    dzs = jnp.stack([hslyr] * nslyr)
    hin = hilyr * nilyr
    hsn = hslyr * nslyr

    if not p.l_brine:
        Ts = (cn.Lfresh + qsn / cn.rhos) / cn.cp_ice
        dhs_f = jnp.where(Ts > 0.0, cn.cp_ice * Ts * dzs / cn.Lfresh, 0.0)
        dzs = dzs - dhs_f
        qsn = jnp.where(Ts > 0.0, -cn.rhos * cn.Lfresh, qsn)
        Ti = (cn.Lfresh + qin / cn.rhoi) / cn.cp_ice
        dhi_f = jnp.where(Ti > 0.0, cn.cp_ice * Ti * dzi / cn.Lfresh, 0.0)
        dzi = dzi - dhi_f
        qin = jnp.where(Ti > 0.0, -cn.rhoi * cn.Lfresh, qin)

    wk1 = -flatn * dt
    esub = jnp.maximum(wk1, 0.0)
    econ = jnp.minimum(wk1, 0.0)
    etop_mlt = jnp.maximum((fsurfn - fcondtopn) * dt, 0.0)
    wk1 = (fcondbot - fbot) * dt
    ebot_mlt = jnp.maximum(wk1, 0.0)
    ebot_gro = jnp.minimum(wk1, 0.0)

    evapn = jnp.zeros_like(hin)

    # condensation into top snow or ice layer
    snow_present = hsn > cn.puny
    dhs_c = jnp.where(snow_present, econ / (qsn[0] - cn.rhos * cn.Lvap), 0.0)
    dzs = dzs.at[0].add(dhs_c)
    evapn = evapn + dhs_c * cn.rhos
    dhi_c = jnp.where(snow_present, 0.0, econ / (qin[0] - cn.rhoi * cn.Lvap))
    dzi = dzi.at[0].add(dhi_c)
    evapn = evapn + dhi_c * cn.rhoi

    # bottom growth
    if p.heat_capacity:
        if p.l_brine:
            tbot_safe = jnp.minimum(Tbot, -cn.puny)
            qbot = -cn.rhoi * (cn.cp_ice * (tmlt_bot - tbot_safe)
                               + cn.Lfresh * (1.0 - tmlt_bot / tbot_safe)
                               - cn.cp_ocn * tmlt_bot)
            qbot = jnp.minimum(qbot, qbotmax)
        else:
            qbot = -cn.rhoi * (cn.cp_ice * Tbot + cn.Lfresh)
    else:
        qbot = jnp.full_like(Tbot, -cn.rhoi * cn.Lfresh)
    dhi_g = ebot_gro / qbot  # >= 0
    hqtot = dzi[nilyr - 1] * qin[nilyr - 1] + dhi_g * qbot
    dzb = dzi[nilyr - 1] + dhi_g
    qin = qin.at[nilyr - 1].set(
        jnp.where(dzb > cn.puny, hqtot / jnp.maximum(dzb, cn.puny),
                  qin[nilyr - 1]))
    dzi = dzi.at[nilyr - 1].set(dzb)
    congel = dhi_g

    # snow sublimation + top melt (top down)
    melts = jnp.zeros_like(hin)
    meltt = jnp.zeros_like(hin)
    meltb = jnp.zeros_like(hin)
    for k in range(nslyr):
        qsub = qsn[k] - cn.rhos * cn.Lvap
        dhs = jnp.maximum(-dzs[k], esub / qsub)
        dzs = dzs.at[k].add(dhs)
        esub = jnp.maximum(esub - dhs * qsub, 0.0)
        evapn = evapn + dhs * cn.rhos
        dhs = jnp.maximum(-dzs[k], etop_mlt / qsn[k])
        dzs = dzs.at[k].add(dhs)
        etop_mlt = jnp.maximum(etop_mlt - dhs * qsn[k], 0.0)
        melts = melts - dhs
    for k in range(nilyr):
        qsub = qin[k] - cn.rhoi * cn.Lvap
        dhi = jnp.maximum(-dzi[k], esub / qsub)
        dzi = dzi.at[k].add(dhi)
        esub = jnp.maximum(esub - dhi * qsub, 0.0)
        evapn = evapn + dhi * cn.rhoi
        dhi = jnp.maximum(-dzi[k], etop_mlt / qin[k])
        dzi = dzi.at[k].add(dhi)
        etop_mlt = jnp.maximum(etop_mlt - dhi * qin[k], 0.0)
        meltt = meltt - dhi
    # bottom melt (bottom up)
    for k in range(nilyr - 1, -1, -1):
        dhi = jnp.maximum(-dzi[k], ebot_mlt / qin[k])
        dzi = dzi.at[k].add(dhi)
        ebot_mlt = jnp.maximum(ebot_mlt - dhi * qin[k], 0.0)
        meltb = meltb - dhi
    for k in range(nslyr - 1, -1, -1):
        dhs = jnp.maximum(-dzs[k], ebot_mlt / qsn[k])
        dzs = dzs.at[k].add(dhs)
        ebot_mlt = jnp.maximum(ebot_mlt - dhs * qsn[k], 0.0)

    fhocnn = fbot + (esub + etop_mlt + ebot_mlt) / dt

    # new snowfall
    hsn_new = jnp.where(fsnow > 0.0, fsnow / cn.rhos * dt, 0.0)
    qsnew = -cn.rhos * cn.Lfresh
    hstot = dzs[0] + hsn_new
    qs0 = jnp.where(hstot > 0.0,
                    jnp.minimum((dzs[0] * qsn[0] + hsn_new * qsnew)
                                / jnp.maximum(hstot, cn.puny),
                                -cn.rhos * cn.Lfresh),
                    qsn[0])
    qsn = qsn.at[0].set(qs0)
    dzs = dzs.at[0].set(jnp.where(hstot > 0.0, hstot, dzs[0]))

    hin = jnp.sum(dzi, 0)
    hsn = jnp.sum(dzs, 0)

    # freeboard: snow-ice conversion
    wk1 = hsn - hin * (cn.rhow - cn.rhoi) / cn.rhos
    below = (wk1 > cn.puny) & (hsn > cn.puny)
    dhsn_tot = jnp.where(below, jnp.minimum(wk1 * cn.rhoi / cn.rhow, hsn), 0.0)
    dhin = dhsn_tot * cn.rhos / cn.rhoi
    dhsn = dhsn_tot
    hqs = jnp.zeros_like(hin)
    for k in range(nslyr - 1, -1, -1):
        dhs = jnp.where(dhin > cn.puny, jnp.minimum(dhsn, dzs[k]), 0.0)
        hsn = hsn - dhs
        dzs = dzs.at[k].add(-dhs)
        dhsn = jnp.maximum(dhsn - dhs, 0.0)
        hqs = hqs + dhs * qsn[k]
    active_fb = dhin > cn.puny
    wk2 = dzi[0] + dhin
    hin = jnp.where(active_fb, hin + dhin, hin)
    qin = qin.at[0].set(jnp.where(active_fb,
                                  (dzi[0] * qin[0] + hqs)
                                  / jnp.maximum(wk2, cn.puny), qin[0]))
    dzi = dzi.at[0].set(jnp.where(active_fb, wk2, dzi[0]))
    snoice = jnp.where(active_fb, dhin, 0.0)

    # repartition into equal layers, conserving energy
    hin = jnp.maximum(hin, 0.0)
    hsn = jnp.maximum(hsn, 0.0)
    hilyr_new = hin / nilyr
    hslyr_new = hsn / nslyr

    if p.heat_capacity:
        qin = _adjust_enthalpy(dzi, hilyr_new, hin, qin)
        if nslyr > 1:
            qsn = _adjust_enthalpy(dzs, hslyr_new, hsn, qsn)
    else:
        qin = jnp.full_like(qin, -cn.rhoi * cn.Lfresh)
        qsn = jnp.full_like(qsn, -cn.rhos * cn.Lfresh)

    efinal = -evapn * cn.Lvap \
        + jnp.sum(hslyr_new[None] * qsn, 0) \
        + jnp.sum(hilyr_new[None] * qin, 0)
    evapn = evapn / dt

    return dict(hin=hin, hsn=hsn, hilyr=hilyr_new, hslyr=hslyr_new,
                qin=qin, qsn=qsn, fhocnn=fhocnn, evapn=evapn,
                efinal=efinal, hsn_new=hsn_new,
                meltt=meltt, melts=melts, meltb=meltb,
                congel=congel, snoice=snoice)


def _adjust_enthalpy(dz, hlyr_new, hn, qn):
    """Conservative remap of layer enthalpy onto equal layers
    (``adjust_enthalpy:4396-4492``)."""
    nlyr = dz.shape[0]
    z1 = jnp.concatenate([jnp.zeros_like(dz[:1]),
                          jnp.cumsum(dz, 0)], 0)
    k = jnp.arange(nlyr + 1, dtype=dz.dtype).reshape(
        (nlyr + 1,) + (1,) * (dz.ndim - 1))
    z2 = k * hlyr_new[None]
    rhlyr = jnp.where(hn > cn.puny, 1.0 / jnp.maximum(hlyr_new, cn.puny), 0.0)
    # overlap(k1, k2) = max(0, min(z1[k1+1], z2[k2+1]) - max(z1[k1], z2[k2]))
    lo = jnp.maximum(z1[None, :-1], z2[:-1, None])        # (k2, k1, ...)
    hi = jnp.minimum(z1[None, 1:], z2[1:, None])
    ovl = jnp.maximum(hi - lo, 0.0)
    hq = jnp.sum(ovl * qn[None], axis=1)
    return hq * rhlyr[None]


def thermo_vertical_category(p: ThermoParams, dt, aicen, vicen, vsnon,
                             tsfcn, eicen, esnon,
                             flw, potT, Qa, rhoa, fsnow,
                             fbot, Tbot, Tf, lhcoef, shcoef,
                             fswsfc, fswint, fswthrun, Sswabs, Iswabs,
                             fsurfn_pre=None, fcondtopn_pre=None,
                             flatn_pre=None):
    """Full per-category vertical thermo driver
    (``thermo_vertical:108-515``).

    Returns (new category state dict, flux/diagnostic dict).  All
    fluxes are per unit ice area; the caller applies aicen weighting
    via merge_fluxes.

    When ``p.calc_Tsfc`` is False the surface fluxes come from the
    coupler: ``fsurfn_pre/fcondtopn_pre/flatn_pre`` are required and
    the temperature solve uses the prescribed-flux boundary condition
    (``thermo_vertical:321-421`` calc_Tsfc branches).
    """
    nilyr, nslyr = p.nilyr, p.nslyr
    # dtype-aware floor: below a_negligible the category's v/a and e/v
    # ratios are f32 roundoff noise and the Newton solve cannot conserve
    # energy (cn.a_negligible docstring); such cells are zapped by
    # cleanup_itd anyway.
    has_ice = aicen > cn.a_negligible(aicen.dtype)
    a_safe = jnp.maximum(aicen, cn.puny)
    tmlt = _profile_const(p.tmlt, nilyr, like=aicen)

    # --- init_vertical_profile (":844-1211") ------------------------------
    Tsf = tsfcn
    hin = jnp.where(has_ice, vicen / a_safe, 0.0)
    hsn = jnp.where(has_ice, vsnon / a_safe, 0.0)
    hilyr = jnp.where(has_ice, hin / nilyr, 1.0)  # safe placeholder on land
    hslyr = hsn / nslyr

    v_safe = jnp.maximum(vsnon, cn.puny)
    snow_ok = (hslyr > hs_min / nslyr) & has_ice
    qsn = jnp.where(snow_ok[None], esnon * nslyr / v_safe[None],
                    -cn.rhos * cn.Lfresh)
    Tsn = (cn.Lfresh + qsn / cn.rhos) / cn.cp_ice
    Tsn = jnp.minimum(Tsn, 0.0)
    qsn = jnp.where(Tsn >= 0.0, -cn.rhos * cn.Lfresh, qsn)

    vi_safe = jnp.maximum(vicen, cn.puny)
    qin = jnp.where(has_ice[None], eicen * nilyr / vi_safe[None],
                    -cn.rhoi * cn.Lfresh)
    Tin = tin_from_qin(p, qin, tmlt)
    fix = Tin > 0.0
    Tin = jnp.where(fix, 0.0, Tin)
    qin = jnp.where(fix, -cn.rhoi * cn.Lfresh, qin)

    einit = jnp.sum(hslyr[None] * qsn, 0) + jnp.sum(hilyr[None] * qin, 0)
    hin0, hsn0 = hin, hsn

    # --- temperature solve -------------------------------------------------
    if not p.calc_Tsfc:
        if fsurfn_pre is None or fcondtopn_pre is None or flatn_pre is None:
            raise ValueError("calc_Tsfc=False requires prescribed "
                             "fsurfn/fcondtopn/flatn")
        zeros = jnp.zeros_like(Tsf)
        if p.heat_capacity:
            kt = temperature_changes_know_tsfc(
                p, dt, has_ice, fcondtopn_pre, fswsfc, fswint, fswthrun,
                Sswabs, Iswabs, hilyr, hslyr, qin, Tin, qsn, Tsn, Tbot,
                einit)
            tc = dict(Tsf=Tsf, Tsn=kt["Tsn"], Tin=kt["Tin"],
                      qsn=kt["qsn"], qin=kt["qin"],
                      fcondbot=kt["fcondbot"],
                      fswabsn=kt["fswabsn"], fswsfc=kt["fswsfc"],
                      fswint=kt["fswint"], Sswabs=kt["Sswabs"],
                      Iswabs=kt["Iswabs"], converged=kt["converged"],
                      dq_flux=kt["dq_flux"], niter=kt["niter"],
                      niter_cell=kt["niter_cell"])
        else:
            # zero layer: fcondbot = fcondtopn (thermo_vertical:409-418)
            tc = dict(Tsf=Tsf, Tsn=Tsn, Tin=Tin, qsn=qsn, qin=qin,
                      fcondbot=jnp.where(has_ice, fcondtopn_pre, 0.0),
                      fswabsn=fswsfc + fswthrun, fswsfc=fswsfc,
                      fswint=jnp.zeros_like(fswsfc), Sswabs=Sswabs,
                      Iswabs=Iswabs, converged=jnp.ones_like(has_ice),
                      niter=jnp.asarray(0),
                      niter_cell=jnp.zeros(has_ice.shape, jnp.int32))
        tc["fsurfn"] = jnp.where(has_ice, fsurfn_pre, 0.0)
        tc["fcondtopn"] = jnp.where(has_ice, fcondtopn_pre, 0.0)
        tc["flatn"] = jnp.where(has_ice, flatn_pre, 0.0)
        # radiative/turbulent components belong to the coupler in this
        # mode (driver merges the coupler's own values); zero here
        tc["fsensn"] = zeros
        tc["flwoutn"] = zeros
    elif p.heat_capacity:
        tc = temperature_changes(p, dt, has_ice, rhoa, flw, potT, Qa,
                                 shcoef, lhcoef, fswsfc, fswint, fswthrun,
                                 Sswabs, Iswabs, hilyr, hslyr, qin, Tin,
                                 qsn, Tsn, Tsf, Tbot, einit)
    else:
        z = zerolayer_temperature(p, dt, has_ice, rhoa, flw, potT, Qa,
                                  shcoef, lhcoef, fswsfc, fswthrun,
                                  hilyr, hslyr, Tsf, Tbot)
        tc = dict(Tsf=z["Tsf"], Tsn=Tsn, Tin=Tin, qsn=qsn, qin=qin,
                  fsurfn=z["fsurfn"], fcondtopn=z["fcondtopn"],
                  fcondbot=z["fcondbot"], fsensn=z["fsensn"],
                  flatn=z["flatn"], flwoutn=z["flwoutn"],
                  fswabsn=z["fswabsn"], fswsfc=fswsfc,
                  fswint=jnp.zeros_like(fswsfc), Sswabs=Sswabs,
                  Iswabs=Iswabs, converged=jnp.ones_like(has_ice),
                  niter=z["niter"], niter_cell=z["niter_cell"])

    # --- thickness changes -------------------------------------------------
    th = thickness_changes(p, dt, has_ice, hilyr, hslyr,
                           tc["qin"], tc["qsn"], fbot, Tbot,
                           tc["flatn"], tc["fsurfn"], tc["fcondtopn"],
                           tc["fcondbot"], fsnow)
    # Tmlt-clamp energy removed by the temperature solve goes to the
    # ocean (keeps the column budget exact; see temperature_changes)
    th["fhocnn"] = th["fhocnn"] + tc.get("dq_flux", 0.0)

    # --- water/salt fluxes (":466-480") ------------------------------------
    dhi = th["hin"] - hin0
    dhs = th["hsn"] - hsn0
    freshn = tc["flatn"] * 0.0 + th["evapn"] \
        - (cn.rhoi * dhi + cn.rhos * (dhs - th["hsn_new"])) / dt
    fsaltn = -cn.rhoi * dhi * cn.ice_ref_salinity * 0.001 / dt

    # --- update_state_vthermo (":4634-4747") -------------------------------
    alive = has_ice & (th["hin"] > 0.0)
    aicen_new = jnp.where(alive, aicen, 0.0)
    vicen_new = jnp.where(alive, aicen * th["hin"], 0.0)
    vsnon_new = jnp.where(alive, aicen * th["hsn"], 0.0)
    tsfcn_new = jnp.where(alive, tc["Tsf"], Tf)
    tsfcn_new = jnp.where(has_ice, tsfcn_new, tsfcn)
    eicen_new = jnp.where(alive[None], th["qin"] * vicen_new[None] / nilyr,
                          0.0)
    esnon_new = jnp.where(alive[None], th["qsn"] * vsnon_new[None] / nslyr,
                          0.0)
    # untouched cells keep original state
    aicen_new = jnp.where(has_ice, aicen_new, aicen)
    vicen_new = jnp.where(has_ice, vicen_new, vicen)
    vsnon_new = jnp.where(has_ice, vsnon_new, vsnon)
    eicen_new = jnp.where(has_ice[None], eicen_new, eicen)
    esnon_new = jnp.where(has_ice[None], esnon_new, esnon)

    def m(x):
        return jnp.where(has_ice, x, 0.0)

    state_out = dict(aicen=aicen_new, vicen=vicen_new, vsnon=vsnon_new,
                     tsfcn=tsfcn_new, eicen=eicen_new, esnon=esnon_new)
    flux_out = dict(
        fsensn=m(tc["fsensn"]), flatn=m(tc["flatn"]),
        fswabsn=m(tc["fswabsn"]), flwoutn=m(tc["flwoutn"]),
        evapn=m(th["evapn"]), freshn=m(freshn), fsaltn=m(fsaltn),
        fhocnn=m(th["fhocnn"]), fsurfn=m(tc["fsurfn"]),
        fcondtopn=m(tc["fcondtopn"]),
        # the SW the solve actually absorbed in the interior: the
        # thin-layer adjustment (":1563-1591") moves part of
        # Sswabs/Iswabs out of fswint, and the reference passes the
        # ADJUSTED value (intent(inout)) to conservation_check_vthermo
        fswint=m(tc["fswint"]),
        meltt=m(th["meltt"]), melts=m(th["melts"]), meltb=m(th["meltb"]),
        congel=m(th["congel"]), snoice=m(th["snoice"]),
        einit=m(einit), efinal=m(th["efinal"]),
        niter=tc["niter"],
        niter_cell=tc["niter_cell"],
    )
    return state_out, flux_out
