"""Ice thickness distribution utilities.

Dense, masked JAX reworking of ``source/ice_itd.F90``: category
aggregation, rebinning into thickness bounds, conservative transfers
between categories, small-area elimination.  The reference builds
compressed active-cell index lists and loops `do ij = 1, icells`
(`ice_itd.F90:279-485` etc.); here every operation is dense over the
``(ny, nx)`` plane with `jnp.where` masks — the "wasted" land/ice-free
work costs little in a memory-bound elementwise fusion, and there is no
data-dependent shape anywhere.

Tracer dependency (``ice_init.F90:848-852``): area tracers (Tsfc, alvl,
volpn) are carried as ``aicen * t``; volume tracers (iage, vlvl) as
``vicen * t``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cice4_tpu import constants as cn
from cice4_tpu.state import ItdParams, State

# tracer name -> dependency (0: aicen-weighted, 1: vicen, 2: vsnon)
TRACER_DEPEND = {"iage": 1, "alvl": 0, "vlvl": 1, "volpn": 0}


def aggregate(state: State, tmask):
    """Category sums -> cell means (``ice_itd.F90 aggregate:279-485``).

    Returns dict with aice, vice, vsno, eice, esno, aice0, tsfc, trcr.
    """
    m = tmask
    aice = jnp.where(m, jnp.sum(state.aicen, 0), 0.0)
    vice = jnp.where(m, jnp.sum(state.vicen, 0), 0.0)
    vsno = jnp.where(m, jnp.sum(state.vsnon, 0), 0.0)
    eice = jnp.where(m, jnp.sum(state.eicen, (0, 1)), 0.0)
    esno = jnp.where(m, jnp.sum(state.esnon, (0, 1)), 0.0)
    aice0 = jnp.where(m, jnp.maximum(1.0 - aice, 0.0), 1.0)

    def mean_tracer(t, weight, denom):
        num = jnp.sum(t * weight, 0)
        return jnp.where(denom > cn.puny, num / jnp.maximum(denom, cn.puny), 0.0)

    tsfc_num = jnp.sum(state.tsfcn * state.aicen, 0)
    tsfc = jnp.where(aice > cn.puny, tsfc_num / jnp.maximum(aice, cn.puny),
                     cn.Tocnfrz)
    trcr = {}
    for name, t in state.trcrn.items():
        dep = TRACER_DEPEND[name]
        w, d = {0: (state.aicen, aice), 1: (state.vicen, vice),
                2: (state.vsnon, vsno)}[dep]
        trcr[name] = mean_tracer(t, w, d)
    return dict(aice=aice, vice=vice, vsno=vsno, eice=eice, esno=esno,
                aice0=aice0, tsfc=tsfc, trcr=trcr)


def aggregate_area(aicen):
    """(``ice_itd.F90 aggregate_area:494-548``)"""
    aice = jnp.sum(aicen, 0)
    aice0 = jnp.maximum(1.0 - aice, 0.0)
    return aice, aice0


def _compute_tracers(atrcrn, tsfc_a, aicen, vicen, vsnon, tracer_names):
    """atrcrn (weighted) -> tracer values (``ice_itd.F90
    compute_tracers:1482-1590``).  Open-water Tsfc resets to Tocnfrz."""
    tsfcn = jnp.where(aicen > cn.puny,
                      tsfc_a / jnp.maximum(aicen, cn.puny), cn.Tocnfrz)
    trcrn = {}
    for name in tracer_names:
        dep = TRACER_DEPEND[name]
        denom = {0: aicen, 1: vicen, 2: vsnon}[dep]
        thresh = cn.puny if dep == 0 else 0.0
        trcrn[name] = jnp.where(denom > thresh,
                                atrcrn[name] / jnp.maximum(denom, cn.puny), 0.0)
    return tsfcn, trcrn


def shift_ice(state: State, donor, daice, dvice) -> State:
    """Conservatively move ice between adjacent categories.

    Dense version of ``ice_itd.F90 shift_ice:892-1340``.

    Args:
      donor: int array ``(ncat-1, ny, nx)``; per boundary b: 0 = no
        transfer, +1 = donor is category b (moves up to b+1), -1 = donor
        is category b+1 (moves down to b).
      daice, dvice: area/volume transferred across each boundary (>= 0).

    Out-of-range transfers are clamped as in the reference (roundoff
    amounts to zero or full-category transfers); hard violations abort
    in the reference and are clamped here (use the conservation checks
    for validation instead of in-graph aborts).
    """
    ncat = state.ncat
    aicen = state.aicen
    vicen = state.vicen
    vsnon = state.vsnon
    eicen = state.eicen
    esnon = state.esnon

    # weighted working tracers
    tsfc_a = state.tsfcn * aicen
    atrcrn = {}
    for name, t in state.trcrn.items():
        w = {0: aicen, 1: vicen, 2: vsnon}[TRACER_DEPEND[name]]
        atrcrn[name] = t * w

    for b in range(ncat - 1):
        up = donor[b] == 1
        dn = donor[b] == -1
        active = up | dn
        # donor-category values
        a_d = jnp.where(up, aicen[b], aicen[b + 1])
        v_d = jnp.where(up, vicen[b], vicen[b + 1])

        da = daice[b]
        dv = dvice[b]
        # clamp roundoff (ice_itd.F90:1043-1092)
        da = jnp.maximum(da, 0.0)
        dv = jnp.maximum(dv, 0.0)
        full = (da > a_d * (1.0 - cn.puny)) | (dv > v_d * (1.0 - cn.puny))
        da = jnp.where(full, a_d, da)
        dv = jnp.where(full, v_d, dv)
        active = active & (da > 0.0)
        da = jnp.where(active, da, 0.0)
        dv = jnp.where(active, dv, 0.0)

        frac_v = jnp.where(v_d > 0.0, dv / jnp.maximum(v_d, cn.puny), 0.0)

        # signed delta: +1 means subtract from b, add to b+1
        sgn = jnp.where(up, 1.0, -1.0)

        def apply2(arr, amount):
            d = sgn * amount
            arr = arr.at[b].add(-d)
            arr = arr.at[b + 1].add(d)
            return arr

        aicen = apply2(aicen, da)
        vicen = apply2(vicen, dv)
        vs_d = jnp.where(up, vsnon[b], vsnon[b + 1])
        dvs = vs_d * frac_v
        vsnon = apply2(vsnon, dvs)

        e_d = jnp.where(up, eicen[b], eicen[b + 1])      # (nilyr, ny, nx)
        de = e_d * frac_v[None]
        d_e = sgn[None] * de
        eicen = eicen.at[b].add(-d_e).at[b + 1].add(d_e)
        es_d = jnp.where(up, esnon[b], esnon[b + 1])
        des = es_d * frac_v[None]
        d_es = sgn[None] * des
        esnon = esnon.at[b].add(-d_es).at[b + 1].add(d_es)

        frac_a = jnp.where(a_d > 0.0, da / jnp.maximum(a_d, cn.puny), 0.0)
        t_d = jnp.where(up, tsfc_a[b], tsfc_a[b + 1])
        tsfc_a = apply2(tsfc_a, t_d * frac_a)

        for name in atrcrn:
            dep = TRACER_DEPEND[name]
            t_dn = jnp.where(up, atrcrn[name][b], atrcrn[name][b + 1])
            frac = frac_a if dep == 0 else frac_v
            atrcrn[name] = apply2(atrcrn[name], t_dn * frac)

    tsfcn, trcrn = _compute_tracers(atrcrn, tsfc_a, aicen, vicen, vsnon,
                                    list(state.trcrn.keys()))
    return state.replace(aicen=aicen, vicen=vicen, vsnon=vsnon,
                         eicen=eicen, esnon=esnon, tsfcn=tsfcn, trcrn=trcrn)


def rebin(state: State, itd: ItdParams) -> State:
    """Force every category thickness into its bounds (``ice_itd.F90
    rebin:557-793``): sweep boundaries upward moving too-thick
    categories up, then downward moving too-thin categories down.  Each
    active transfer moves the *entire* donor category."""
    ncat = itd.ncat
    hin_max = itd.hin_max

    def hicen_of(aicen, vicen):
        return jnp.where(aicen > cn.puny,
                         vicen / jnp.maximum(aicen, cn.puny), 0.0)

    # category 1 minimum thickness (delta-function ITD only)
    if hin_max[0] > 0.0:
        h0 = hicen_of(state.aicen[0], state.vicen[0])
        fix = (state.aicen[0] > cn.puny) & (h0 <= hin_max[0])
        a0 = jnp.where(fix, state.vicen[0] / hin_max[0], state.aicen[0])
        state = state.replace(aicen=state.aicen.at[0].set(a0))

    zero_b = jnp.zeros((ncat - 1,) + state.aicen.shape[1:], state.aicen.dtype)
    izero = jnp.zeros_like(zero_b, dtype=jnp.int32)

    # upward sweep; boundary b separates cat b and b+1, bound hin_max[b+1]
    for b in range(ncat - 1):
        h = hicen_of(state.aicen[b], state.vicen[b])
        move = (state.aicen[b] > cn.puny) & (h > hin_max[b + 1])
        donor = izero.at[b].set(jnp.where(move, 1, 0))
        daice = zero_b.at[b].set(jnp.where(move, state.aicen[b], 0.0))
        dvice = zero_b.at[b].set(jnp.where(move, state.vicen[b], 0.0))
        state = shift_ice(state, donor, daice, dvice)

    # downward sweep
    for b in range(ncat - 2, -1, -1):
        h = hicen_of(state.aicen[b + 1], state.vicen[b + 1])
        move = (state.aicen[b + 1] > cn.puny) & (h <= hin_max[b + 1])
        donor = izero.at[b].set(jnp.where(move, -1, 0))
        daice = zero_b.at[b].set(jnp.where(move, state.aicen[b + 1], 0.0))
        dvice = zero_b.at[b].set(jnp.where(move, state.vicen[b + 1], 0.0))
        state = shift_ice(state, donor, daice, dvice)

    return state


def zap_small_areas(state: State, tmask, dt) -> tuple[State, dict]:
    """Remove categories with area <= puny, melting them into the ocean,
    and normalize total area to <= 1 (``ice_itd.F90
    zap_small_areas:1844-2160``).  Returns (state, fluxes) where fluxes
    carries dfresh (kg/m^2/s), dfsalt, dfhocn (W/m^2) for strict
    conservation with the ocean."""
    aicen, vicen, vsnon = state.aicen, state.vicen, state.vsnon
    eicen, esnon, tsfcn = state.eicen, state.esnon, state.tsfcn
    trcrn = dict(state.trcrn)

    # dtype-aware threshold: in f32, categories at ~1e-11 area carry
    # roundoff-inconsistent volume/energy ratios (see cn.a_negligible)
    a_zap = cn.a_negligible(aicen.dtype)
    zap = (jnp.abs(aicen) > 0.0) & (jnp.abs(aicen) <= a_zap) & tmask[None]
    dfhocn = jnp.sum(jnp.where(zap[:, None], eicen, 0.0), (0, 1)) / dt
    dfhocn = dfhocn + jnp.sum(jnp.where(zap[:, None], esnon, 0.0), (0, 1)) / dt
    dfresh = jnp.sum(jnp.where(zap, cn.rhoi * vicen + cn.rhos * vsnon, 0.0), 0) / dt
    dfsalt = jnp.sum(jnp.where(zap, cn.rhoi * vicen, 0.0), 0) \
        * cn.ice_ref_salinity * 0.001 / dt

    aicen = jnp.where(zap, 0.0, aicen)
    vicen = jnp.where(zap, 0.0, vicen)
    vsnon = jnp.where(zap, 0.0, vsnon)
    eicen = jnp.where(zap[:, None], 0.0, eicen)
    esnon = jnp.where(zap[:, None], 0.0, esnon)
    tsfcn = jnp.where(zap, cn.Tocnfrz, tsfcn)
    for name in trcrn:
        trcrn[name] = jnp.where(zap, 0.0, trcrn[name])

    # normalize excess total area from roundoff (reference condition is
    # simply aice > c1, ice_itd.F90:2040; f32 roundoff excess is ~1e-7)
    aice = jnp.sum(aicen, 0)
    excess = aice > 1.0
    scale = jnp.where(excess, 1.0 / jnp.maximum(aice, cn.puny), 1.0)
    zapfrac = jnp.where(excess, (aice - 1.0) / jnp.maximum(aice, cn.puny), 0.0)
    dfhocn = dfhocn + (jnp.sum(eicen, (0, 1)) + jnp.sum(esnon, (0, 1))) \
        * zapfrac / dt
    dfresh = dfresh + jnp.sum(cn.rhoi * vicen + cn.rhos * vsnon, 0) * zapfrac / dt
    dfsalt = dfsalt + jnp.sum(cn.rhoi * vicen, 0) \
        * cn.ice_ref_salinity * 0.001 * zapfrac / dt

    aicen = aicen * scale[None]
    vicen = vicen * scale[None]
    vsnon = vsnon * scale[None]
    eicen = eicen * scale[None, None]
    esnon = esnon * scale[None, None]

    state = state.replace(aicen=aicen, vicen=vicen, vsnon=vsnon,
                          eicen=eicen, esnon=esnon, tsfcn=tsfcn, trcrn=trcrn)
    return state, dict(dfresh=dfresh, dfsalt=dfsalt, dfhocn=dfhocn)


def cleanup_itd(state: State, itd: ItdParams, tmask, dt,
                limit_aice: bool = True) -> tuple[State, dict]:
    """Rebin + zap small areas (``ice_itd.F90 cleanup_itd:1600-1835``).
    Returns (state, ocean-flux corrections)."""
    state = rebin(state, itd)
    if limit_aice:
        return zap_small_areas(state, tmask, dt)
    zero = jnp.zeros_like(state.sst)
    return state, dict(dfresh=zero, dfsalt=zero, dfhocn=zero)


def column_sums(state: State):
    """Per-cell conservation sums (``ice_itd.F90 column_sum:1349-1400``)."""
    return dict(
        vice=jnp.sum(state.vicen, 0),
        vsno=jnp.sum(state.vsnon, 0),
        eice=jnp.sum(state.eicen, (0, 1)),
        esno=jnp.sum(state.esnon, (0, 1)),
    )


def reduce_area(tmask, hin_max0, aicen1, vicen1, aicen1_init, vicen1_init):
    """Open-water adjustment when melting with ncat = 1
    (``ice_itd.F90 reduce_area:802-883``): reduce the single category's
    area as it thins so open water can form.  Returns new aicen1."""
    hi0 = jnp.where(aicen1_init > 0.0,
                    vicen1_init / jnp.maximum(aicen1_init, cn.puny), 0.0)
    hi1 = jnp.where(aicen1 > 0.0,
                    vicen1 / jnp.maximum(aicen1, cn.puny), 0.0)
    thin = (hi1 <= hin_max0) & (hin_max0 > 0.0)
    aicen1 = jnp.where(thin, vicen1 / max(hin_max0, cn.puny), aicen1)
    hi1 = jnp.where(thin, hin_max0, hi1)
    melting = (aicen1 > 0.0) & (hi1 - hi0 < 0.0)
    hi1m = jnp.where(aicen1 > 0.0, vicen1 / jnp.maximum(aicen1, cn.puny),
                     hi1)
    aicen1 = jnp.where(melting,
                       2.0 * vicen1 / jnp.maximum(hi1m + hi0, cn.puny),
                       aicen1)
    return jnp.where(tmask, aicen1, 0.0)
