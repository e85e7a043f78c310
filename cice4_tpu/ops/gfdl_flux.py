"""GFDL ocean-surface flux physics (ACCESS-OM coupled driver).

JAX port of the GFDL/FMS surface-layer package the ACCESS-OM
driver uses to compute open-water atmosphere fluxes routed through the
ice model (``drivers/access-om/cpl_forcing_handler.F90
gfdl_ocean_fluxes:925-1056``):

* ``escomp`` — Goff-Gratch saturation vapor pressure with the
  ice/supercooled-water blend (``sat_vapor_pres_k_mod.F90
  compute_es_k:131-192``; the Fortran builds a lookup table from this
  formula — here it is evaluated directly, transcendentals are cheap
  and the table's gather is not).
* ``compute_ocean_roughness`` — charnock / beljaars / fixed schemes
  (``ocean_rough_mod.F90:63-199``).
* ``mo_drag`` — Monin-Obukhov similarity drag coefficients with the
  masked Newton iteration for zeta (``monin_obukhov_kernel.F90
  monin_obukhov_drag_1d:101-222, monin_obukhov_solve_zeta:224-400``).
  The reference's per-point convergence masks become dense masked
  updates inside a ``lax.while_loop``.
* ``surface_flux`` — the full bulk-flux assembly
  (``surface_flux_mod.F90 surface_flux_1d:339-586``).
* ``ncar_ocean_fluxes`` — the Large-Yeager alternative
  (``surface_flux_mod.F90:822-960``, corrected branch).
* ``gfdl_ocean_fluxes`` — the driver-level wrapper: previous-step
  u_star -> roughness -> MO drag -> fluxes, sign-flipped for MOM.

All functions are dense (ny, nx) masked jnp — no compressed index
lists — and run under jit/vmap/shard_map unchanged.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from cice4_tpu import constants as cn

# GFDL gas constants (drivers/access-om/ice_constants.F90:254-255)
rdgas = 287.04
rvgas = 461.50
d622 = rdgas / rvgas
d378 = 1.0 - d622
d608 = d378 / d622
kappa = 2.0 / 7.0          # rdgas/cp_air, GFDL convention

# monin_obukhov_mod.F90 namelist defaults (:70-86)
RICH_CRIT = 2.0
DRAG_MIN = 1.0e-5
ZETA_TRANS = 0.5
MO_ERROR = 1.0e-4
ZETA_MIN = 1.0e-6
MO_MAX_ITER = 20
MO_SMALL = 1.0e-4

# ocean_rough_mod.F90 defaults (:19-31,55)
ROUGHNESS_MIN = 1.0e-6
CHARNOCK = 0.032
ROUGH_FIXED = 5.8e-5
GNU = 1.5e-5
# Beljaars scheme coefficients (ocean_rough_mod.F90:50-54)
ZCOM1 = 0.0110         # alpha (charnock-like term)
ZCOM2 = 0.11           # viscosity term
ZCOH1 = 0.0
ZCOH2 = 0.40
ZCOQ1 = 0.0
ZCOQ2 = 0.62


def escomp(T):
    """Saturation vapor pressure (Pa) at temperature T (K): Goff-
    Gratch over water/ice with linear blend in [-20C, 0C]
    (``compute_es_k:131-192``)."""
    TBASI = cn.Tffresh            # 273.15
    TBASW = cn.Tffresh + 100.0
    ESBASW = 101324.60
    ESBASI = 610.71
    Ts = jnp.maximum(T, 100.0)    # avoid 1/T blowup on masked points
    xi = (-9.09718 * (TBASI / Ts - 1.0)
          - 3.56654 * jnp.log10(TBASI / Ts)
          + 0.876793 * (1.0 - Ts / TBASI) + jnp.log10(ESBASI))
    esice = 10.0 ** xi
    xw = (-7.90298 * (TBASW / Ts - 1.0)
          + 5.02808 * jnp.log10(TBASW / Ts)
          - 1.3816e-7 * (10.0 ** ((1.0 - Ts / TBASW) * 11.344) - 1.0)
          + 8.1328e-3 * (10.0 ** ((TBASW / Ts - 1.0) * -3.49149) - 1.0)
          + jnp.log10(ESBASW))
    esh2o = 10.0 ** xw
    blend = 0.05 * ((TBASI - Ts) * esice + (Ts - TBASI + 20.0) * esh2o)
    return jnp.where(Ts <= TBASI - 20.0, esice,
                     jnp.where(Ts >= TBASI, esh2o, blend))


def compute_ocean_roughness(u_star, scheme: str = "beljaars"):
    """(rough_mom, rough_heat, rough_moist) from the previous-step
    friction velocity (``ocean_rough_mod.F90
    compute_ocean_roughness:63-199``; highwind options off)."""
    if scheme == "fixed":
        r = jnp.full_like(u_star, ROUGH_FIXED)
        return r, r, r
    ustar2 = jnp.maximum(GNU * GNU, u_star * u_star)
    xx1 = GNU / jnp.sqrt(ustar2)
    xx2 = ustar2 / cn.gravit
    if scheme == "charnock":
        rough_mom = jnp.maximum(CHARNOCK * xx2, ROUGHNESS_MIN)
        return rough_mom, rough_mom, rough_mom
    if scheme != "beljaars":
        raise ValueError(f"unknown rough_scheme {scheme!r}")
    rough_mom = jnp.maximum(ZCOM1 * xx2 + ZCOM2 * xx1, ROUGHNESS_MIN)
    rough_heat = jnp.maximum(ZCOH1 * xx2 + ZCOH2 * xx1, ROUGHNESS_MIN)
    rough_moist = jnp.maximum(ZCOQ1 * xx2 + ZCOQ2 * xx1, ROUGHNESS_MIN)
    return rough_mom, rough_heat, rough_moist


def _phi(zeta, stable_option=1):
    """Differential similarity function (t and m are identical in the
    reference for the unstable-exponent choices used;
    ``monin_obukhov_derivative_t:402-450``)."""
    b_stab = 1.0 / RICH_CRIT
    unstable = (1.0 - 16.0 * jnp.minimum(zeta, 0.0)) ** (-0.5)
    if stable_option == 1:
        zp = jnp.maximum(zeta, 0.0)
        stable = 1.0 + zp * (5.0 + b_stab * zp) / (1.0 + zp)
    else:
        lam = 1.0 + (5.0 - b_stab) * ZETA_TRANS
        zp = jnp.maximum(zeta, 0.0)
        stable = jnp.where(zp < ZETA_TRANS, 1.0 + 5.0 * zp,
                           lam + b_stab * zp)
    return jnp.where(zeta >= 0.0, stable, unstable)


def _phi_m(zeta, stable_option=1):
    """``monin_obukhov_derivative_m:452-505`` (unstable exponent -1/4)."""
    b_stab = 1.0 / RICH_CRIT
    unstable = (1.0 - 16.0 * jnp.minimum(zeta, 0.0)) ** (-0.25)
    if stable_option == 1:
        zp = jnp.maximum(zeta, 0.0)
        stable = 1.0 + zp * (5.0 + b_stab * zp) / (1.0 + zp)
    else:
        lam = 1.0 + (5.0 - b_stab) * ZETA_TRANS
        zp = jnp.maximum(zeta, 0.0)
        stable = jnp.where(zp < ZETA_TRANS, 1.0 + 5.0 * zp,
                           lam + b_stab * zp)
    return jnp.where(zeta >= 0.0, stable, unstable)


def _psi_m(zeta, zeta_0, ln_z_z0, stable_option=1):
    """Integral similarity function for momentum
    (``monin_obukhov_integral_m:619-697``)."""
    b_stab = 1.0 / RICH_CRIT
    # unstable branch
    zn = jnp.minimum(zeta, 0.0)
    zn0 = jnp.minimum(zeta_0, 0.0)
    x = jnp.sqrt(jnp.sqrt(1.0 - 16.0 * zn))
    x0 = jnp.sqrt(jnp.sqrt(1.0 - 16.0 * zn0))
    x1, x1_0 = 1.0 + x, 1.0 + x0
    num = x1 * x1 * (1.0 + x * x)
    den = x1_0 * x1_0 * (1.0 + x0 * x0)
    unst = ln_z_z0 - jnp.log(num / den) \
        + 2.0 * (jnp.arctan(x) - jnp.arctan(x0))
    # stable branch
    zp = jnp.maximum(zeta, cn.puny)
    zp0 = jnp.maximum(zeta_0, 0.0)
    if stable_option == 1:
        st = ln_z_z0 + (5.0 - b_stab) * jnp.log((1.0 + zp)
                                                / (1.0 + zp0)) \
            + b_stab * (zp - zp0)
    else:
        lam = 1.0 + (5.0 - b_stab) * ZETA_TRANS
        weak = ln_z_z0 + 5.0 * (zp - zp0)
        xs = (lam - 1.0) * jnp.log(zp / ZETA_TRANS) \
            + b_stab * (zp - ZETA_TRANS)
        strong = jnp.where(zp0 <= ZETA_TRANS,
                           ln_z_z0 + xs + 5.0 * (ZETA_TRANS - zp0),
                           lam * ln_z_z0 + b_stab * (zp - zp0))
        st = jnp.where(zp <= ZETA_TRANS, weak, strong)
    return jnp.where(zeta >= 0.0, st, unst)


def _psi_t(zeta, zeta_t, ln_z_zt, stable_option=1):
    """Integral similarity function for tracers
    (``monin_obukhov_integral_tq:699-782``)."""
    b_stab = 1.0 / RICH_CRIT
    zn = jnp.minimum(zeta, 0.0)
    znt = jnp.minimum(zeta_t, 0.0)
    x = jnp.sqrt(1.0 - 16.0 * zn)
    xt = jnp.sqrt(1.0 - 16.0 * znt)
    unst = ln_z_zt - 2.0 * jnp.log((1.0 + x) / (1.0 + xt))
    zp = jnp.maximum(zeta, cn.puny)
    zpt = jnp.maximum(zeta_t, 0.0)
    if stable_option == 1:
        st = ln_z_zt + (5.0 - b_stab) * jnp.log((1.0 + zp)
                                                / (1.0 + zpt)) \
            + b_stab * (zp - zpt)
    else:
        lam = 1.0 + (5.0 - b_stab) * ZETA_TRANS
        weak = ln_z_zt + 5.0 * (zp - zpt)
        xs = (lam - 1.0) * jnp.log(zp / ZETA_TRANS) \
            + b_stab * (zp - ZETA_TRANS)
        strong = jnp.where(zpt <= ZETA_TRANS,
                           ln_z_zt + xs + 5.0 * (ZETA_TRANS - zpt),
                           lam * ln_z_zt + b_stab * (zp - zpt))
        st = jnp.where(zp <= ZETA_TRANS, weak, strong)
    return jnp.where(zeta >= 0.0, st, unst)


def _solve_zeta(rich, z, z0, zt, zq, mask, stable_option=1):
    """Newton iteration for the stability parameter zeta
    (``monin_obukhov_solve_zeta:224-400``).  Returns (f_m, f_t, f_q).

    The reference shrinks its active-point set as points converge; here
    every point iterates (masked), and converged points simply stop
    moving — identical fixed point, no gathers.
    """
    z_z0, z_zt, z_zq = z / z0, z / zt, z / zq
    ln_z_z0, ln_z_zt, ln_z_zq = (jnp.log(z_z0), jnp.log(z_zt),
                                 jnp.log(z_zq))

    zeta0 = rich * ln_z_z0 * ln_z_z0 / ln_z_zt
    zeta0 = jnp.where(rich >= 0.0,
                      zeta0 / jnp.maximum(1.0 - rich / RICH_CRIT,
                                          cn.puny),
                      zeta0)

    def body(k, carry):
        zeta, live = carry
        # points whose zeta collapsed to ~0 use neutral logs and stop
        tiny = jnp.abs(zeta) < ZETA_MIN
        live = live & ~tiny
        zs = jnp.where(live, zeta, jnp.sign(zeta) * 1.0 + ZETA_MIN)
        rzeta = 1.0 / zs
        zeta_0 = zs / z_z0
        zeta_t = zs / z_zt
        f_m = _psi_m(zs, zeta_0, ln_z_z0, stable_option)
        f_t = _psi_t(zs, zeta_t, ln_z_zt, stable_option)
        df_m = (_phi_m(zs, stable_option)
                - _phi_m(zeta_0, stable_option)) * rzeta
        df_t = (_phi(zs, stable_option)
                - _phi(zeta_t, stable_option)) * rzeta
        rich_1 = zs * f_t / jnp.maximum(f_m * f_m, cn.puny)
        d_rich = rich_1 * (rzeta + df_t / jnp.where(f_t != 0.0, f_t, 1.0)
                           - 2.0 * df_m / jnp.where(f_m != 0.0, f_m, 1.0))
        corr = (rich - rich_1) / jnp.where(jnp.abs(d_rich) > cn.puny,
                                           d_rich, 1.0)
        crit = jnp.minimum(jnp.abs(corr), jnp.abs(corr * rzeta))
        conv = crit <= MO_ERROR
        zeta = jnp.where(live & ~conv, zeta + corr, zeta)
        live = live & ~conv
        return zeta, live

    zeta, _live = jax.lax.fori_loop(
        0, MO_MAX_ITER, body, (zeta0, mask & (jnp.abs(zeta0) >= 0.0)))

    tiny = jnp.abs(zeta) < ZETA_MIN
    zs = jnp.where(tiny, 1.0, zeta)
    f_m = jnp.where(tiny, ln_z_z0, _psi_m(zs, zs / z_z0, ln_z_z0,
                                          stable_option))
    f_t = jnp.where(tiny, ln_z_zt, _psi_t(zs, zs / z_zt, ln_z_zt,
                                          stable_option))
    f_q = jnp.where(tiny, ln_z_zq, _psi_t(zs, zs / z_zq, ln_z_zq,
                                          stable_option))
    return f_m, f_t, f_q


def mo_drag(thv_atm, thv_surf, z, rough_mom, rough_heat, rough_moist,
            speed, mask=None, neutral=False, stable_option=1):
    """Monin-Obukhov drag coefficients
    (``monin_obukhov_drag_1d:101-222``).

    Returns (cd_m, cd_t, cd_q, u_star, b_star)."""
    if mask is None:
        mask = jnp.ones_like(speed, bool)
    z0, zt, zq = rough_mom, rough_heat, rough_moist
    delta_b = cn.gravit * (thv_surf - thv_atm) \
        / jnp.maximum(thv_surf, cn.puny)
    rich = -z * delta_b / (speed * speed + MO_SMALL)
    rich = jnp.where(mask, rich, 0.0)
    zz = jnp.maximum(jnp.maximum(z, z0), jnp.maximum(zt, zq))

    if neutral:
        fm = jnp.log(zz / z0)
        ft = jnp.log(zz / zt)
        fq = jnp.log(zz / zq)
    else:
        r_crit = 0.95 * RICH_CRIT
        fm, ft, fq = _solve_zeta(rich, zz, z0, zt, zq,
                                 mask & (rich < r_crit), stable_option)
        big = jnp.sqrt(1.0 / DRAG_MIN) * cn.vonkar  # -> drag == DRAG_MIN
        fm = jnp.where(rich >= r_crit, big, fm)
        ft = jnp.where(rich >= r_crit, big, ft)
        fq = jnp.where(rich >= r_crit, big, fq)

    sqrt_drag_min = jnp.sqrt(DRAG_MIN) if not neutral else 0.0
    us = jnp.maximum(cn.vonkar / fm, sqrt_drag_min)
    bs = jnp.maximum(cn.vonkar / ft, sqrt_drag_min)
    qs = jnp.maximum(cn.vonkar / fq, sqrt_drag_min)
    cd_m = us * us
    cd_t = us * bs
    cd_q = us * qs
    u_star = us * speed
    b_star = bs * delta_b
    zero = jnp.zeros_like(speed)
    pick = lambda a: jnp.where(mask, a, zero)  # noqa: E731
    return (pick(cd_m), pick(cd_t), pick(cd_q), pick(u_star),
            pick(b_star))


def ncar_ocean_fluxes(u_del, t, ts, q, qs, z, mask):
    """Large & Yeager (2004) neutral-10m coefficient scheme
    (``surface_flux_mod.F90 ncar_ocean_fluxes:822-960``, the corrected
    non-orig branch).  Returns (cd, ch, ce, ustar, bstar)."""
    tv = t * (1.0 + 0.608 * q)
    u = jnp.maximum(u_del, 0.5)
    u10 = u

    def n10(u10, stab):
        cd_n10 = (2.7 / u10 + 0.142 + 0.0764 * u10) / 1e3
        rt = jnp.sqrt(cd_n10)
        ce_n10 = 34.6 * rt / 1e3
        ch_n10 = (18.0 * stab + 32.7 * (1.0 - stab)) * rt / 1e3
        return cd_n10, ch_n10, ce_n10, rt

    stab0 = 0.5 + 0.5 * jnp.sign(t - ts)
    cd, ch, ce, cd_n10_rt = n10(u10, stab0)
    cd_n10 = cd
    ustar = jnp.sqrt(cd) * u
    bstar = jnp.zeros_like(u)
    for _ in range(2):  # n_itts = 2
        cd_rt = jnp.sqrt(cd)
        ustar = cd_rt * u
        tstar = (ch / cd_rt) * (t - ts)
        qstar = (ce / cd_rt) * (q - qs)
        bstar = cn.gravit * (tstar / tv + qstar / (q + 1.0 / 0.608))
        zeta = cn.vonkar * bstar * z / (ustar * ustar)
        zeta = jnp.sign(zeta) * jnp.minimum(jnp.abs(zeta), 10.0)
        x2 = jnp.maximum(jnp.sqrt(jnp.abs(1.0 - 16.0 * zeta)), 1.0)
        x = jnp.sqrt(x2)
        psi_m = jnp.where(
            zeta > 0.0, -5.0 * zeta,
            jnp.log((1.0 + 2.0 * x + x2) * (1.0 + x2) / 8.0)
            - 2.0 * (jnp.arctan(x) - jnp.arctan(1.0)))
        psi_h = jnp.where(zeta > 0.0, -5.0 * zeta,
                          2.0 * jnp.log((1.0 + x2) / 2.0))
        u10 = u / (1.0 + cd_n10_rt * (jnp.log(z / 10.0) - psi_m)
                   / cn.vonkar)
        stab = 0.5 + 0.5 * jnp.sign(zeta)
        cd_n10, ch_n10, ce_n10, cd_n10_rt = n10(u10, stab)
        xxm = (jnp.log(z / 10.0) - psi_m) / cn.vonkar
        xxh = (jnp.log(z / 10.0) - psi_h) / cn.vonkar
        cd = cd_n10 / (1.0 + cd_n10_rt * xxm) ** 2
        ch = ch_n10 / (1.0 + ch_n10 * xxh / cd_n10_rt) ** 2
        ce = ce_n10 / (1.0 + ce_n10 * xxh / cd_n10_rt) ** 2
    zero = jnp.zeros_like(u)
    pick = lambda a: jnp.where(mask, a, zero)  # noqa: E731
    return pick(cd), pick(ch), pick(ce), pick(ustar), pick(bstar)


def surface_flux(t_atm, q_atm_in, u_atm, v_atm, p_atm, z_atm,
                 p_surf, t_surf, u_surf, v_surf,
                 rough_mom, rough_heat, rough_moist, rough_scale,
                 gust, mask, *, use_ncar=False, gust_min=0.0,
                 stable_option=1):
    """Bulk surface fluxes over open water
    (``surface_flux_mod.F90 surface_flux_1d:339-586``; seawater-only —
    the ACCESS driver sets avail = seawater, so the land branches are
    dead there).

    Returns a dict with flux_t/q/r/u/v, derivatives, transfer
    coefficients, w_atm, u_star, b_star, q_star.
    """
    del_temp = 0.1

    t_surf0 = jnp.where(mask, t_surf, 200.0)
    e_sat = escomp(t_surf0)
    e_sat1 = escomp(t_surf0 + del_temp)
    # surface specific humidity at saturation (use_mixing_ratio=F)
    q_sat = d622 * e_sat / (p_surf - d378 * e_sat)
    q_sat1 = d622 * e_sat1 / (p_surf - d378 * e_sat1)
    q_surf0 = q_sat                       # saturated surface
    q_atm = jnp.maximum(q_atm_in, 0.0)    # no_neg_q

    p_ratio = (p_surf / p_atm) ** kappa
    tv_atm = t_atm * (1.0 + d608 * q_atm)
    th_atm = t_atm * p_ratio
    thv_atm = tv_atm * p_ratio
    thv_surf = t_surf0 * (1.0 + d608 * q_surf0)

    u_dif = u_surf - u_atm
    v_dif = v_surf - v_atm
    w_gust = jnp.maximum(gust, gust_min) if gust_min > 0.0 else gust
    w_atm = jnp.sqrt(u_dif * u_dif + v_dif * v_dif + w_gust * w_gust)
    dw_atmdu = u_dif / jnp.maximum(w_atm, cn.puny)
    dw_atmdv = v_dif / jnp.maximum(w_atm, cn.puny)

    cd_m, cd_t, cd_q, u_star, b_star = mo_drag(
        thv_atm, thv_surf, z_atm, rough_mom, rough_heat, rough_moist,
        w_atm, mask, stable_option=stable_option)
    if use_ncar:
        cd_m, cd_t, cd_q, u_star, b_star = ncar_ocean_fluxes(
            w_atm, th_atm, t_surf0, q_atm, q_surf0, z_atm, mask)

    # orographic roughness rescale (:508-513; rough_scale=1 in the
    # ACCESS driver so this is a no-op there)
    cd_m = cd_m * (jnp.log(z_atm / rough_mom + 1.0)
                   / jnp.log(z_atm / (rough_scale * rough_mom)
                             + 1.0)) ** 2

    drag_t = cd_t * w_atm
    drag_q = cd_q * w_atm
    drag_m = cd_m * w_atm
    rho = p_atm / (rdgas * tv_atm)

    rho_drag_t = cn.cp_air * drag_t * rho
    flux_t = rho_drag_t * (t_surf0 - th_atm)
    dhdt_surf = rho_drag_t
    dhdt_atm = -rho_drag_t * p_ratio

    rho_drag_q = drag_q * rho
    flux_q = rho_drag_q * (q_surf0 - q_atm)
    dedt_surf = rho_drag_q * (q_sat1 - q_sat) / del_temp
    dedq_surf = jnp.zeros_like(flux_q)
    dedq_atm = -rho_drag_q
    q_star = flux_q / jnp.maximum(u_star * rho, cn.puny)

    flux_r = cn.stefan_boltzmann * t_surf0 ** 4
    drdt_surf = 4.0 * cn.stefan_boltzmann * t_surf0 ** 3

    rho_drag_m = drag_m * rho
    flux_u = rho_drag_m * u_dif
    flux_v = rho_drag_m * v_dif
    dtaudu_atm = -cd_m * rho * (dw_atmdu * u_dif + w_atm)
    dtaudv_atm = -cd_m * rho * (dw_atmdv * v_dif + w_atm)

    out = dict(flux_t=flux_t, flux_q=flux_q, flux_r=flux_r,
               flux_u=flux_u, flux_v=flux_v,
               dhdt_surf=dhdt_surf, dedt_surf=dedt_surf,
               dedq_surf=dedq_surf, drdt_surf=drdt_surf,
               dhdt_atm=dhdt_atm, dedq_atm=dedq_atm,
               dtaudu_atm=dtaudu_atm, dtaudv_atm=dtaudv_atm,
               w_atm=w_atm, u_star=u_star, b_star=b_star,
               q_star=q_star, cd_m=cd_m, cd_t=cd_t, cd_q=cd_q)
    zero = jnp.zeros_like(flux_t)
    return {k: jnp.where(mask, v, zero) for k, v in out.items()}


@partial(jax.jit, static_argnames=("rough_scheme", "use_ncar"))
def gfdl_ocean_fluxes(tair, qair, uwnd, vwnd, press, sst, ssu, ssv,
                      u_star_prev, tmask, *, zlvl=10.0,
                      rough_scheme="beljaars", use_ncar=False):
    """Open-water fluxes for the coupled OM configuration
    (``cpl_forcing_handler.F90 gfdl_ocean_fluxes:925-1056``).

    sst in Kelvin (values < 250 are treated as Celsius and shifted, as
    the reference does).  Returns (fluxes dict sign-flipped for the
    ocean: sh, lh, lwo, taox, taoy) plus the new u_star and roughness
    fields to carry to the next coupling interval.
    """
    mask = tmask
    t_surf = jnp.where(sst < 250.0, sst + cn.Tffresh, sst)
    tv_atm = tair * (1.0 + d608 * qair)
    d_atm = press / (rdgas * tv_atm)
    p_atm = press - d_atm * cn.gravit * zlvl

    rough_mom, rough_heat, rough_moist = compute_ocean_roughness(
        u_star_prev, rough_scheme)
    rough_mom = jnp.where(mask, rough_mom, ROUGHNESS_MIN)
    rough_heat = jnp.where(mask, rough_heat, ROUGHNESS_MIN)
    rough_moist = jnp.where(mask, rough_moist, ROUGHNESS_MIN)

    z_atm = jnp.full_like(tair, zlvl)
    gust = jnp.ones_like(tair)            # gust0 = 1.0
    out = surface_flux(tair, qair, uwnd, vwnd, p_atm, z_atm,
                       press, t_surf, ssu, ssv,
                       rough_mom, rough_heat, rough_moist,
                       jnp.ones_like(tair), gust, mask,
                       use_ncar=use_ncar)
    return dict(
        sh=-out["flux_t"],
        lh=-out["flux_q"] * cn.Lvap,
        lwo=-out["flux_r"],
        taox=-out["flux_u"],
        taoy=-out["flux_v"],
        u_star=out["u_star"],
        rough_mom=rough_mom, rough_heat=rough_heat,
        rough_moist=rough_moist,
    )
