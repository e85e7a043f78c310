"""Elastic-viscous-plastic (EVP) sea-ice dynamics.

JAX reworking of ``source/ice_dyn_evp.F90`` (Hunke & Dukowicz 1997).
The reference runs `ndte` (120) subcycles of per-block `stress`
(4-corner bilinear strain rates / stress relaxation, ``:947-1293``) and
`stepu` (closed-form 2x2 implicit momentum solve, ``:1302-1443``) with
two MPI halo exchanges *per subcycle* (``:397-402``) — 25% of reference
runtime was halo wait (`Bound` timer).  Here the whole subcycle loop is
one `lax.fori_loop` inside a single jitted program on dense global
arrays: stencils are `jnp.roll`-style neighbor shifts.  On one device
XLA fuses the loop body; over a mesh the k-halo path
(`evp_sharded.py`) exchanges ghost rings with NCCL collective-permutes
once per k subcycles — no hand-written message schedule exists.

Math follows the reference exactly (see SURVEY.md "EVP math spec"):
corner strain rates from the stencil coefficients cyp/cxp/cym/cxm and
dxt/dyt, viscosity c0 = P/max(Delta, tinyarea), stress relaxation with
denom1/denom2, bilinear quadrature assembly of 8 `str` flux
combinations, and the closed-form momentum update.

Grid staggering (B-grid): T cell (j, i) has U corners
NE = U(j, i), NW = U(j, i-1), SW = U(j-1, i-1), SE = U(j-1, i).
Corner order in the stress arrays: index 0 = ne, 1 = nw, 2 = sw, 3 = se
(matching the reference's `stress*_1..4`).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from cice4_tpu import constants as cn
from cice4_tpu.config import DynamicsConfig
from cice4_tpu.constants import FieldLoc, FieldType
from cice4_tpu.grid import Grid, to_tgrid, to_ugrid
from cice4_tpu.ops.mechred_strength import ice_strength
from cice4_tpu.parallel import halo as h
from cice4_tpu.state import State

# ice-presence thresholds (ice_dyn_evp.F90:87-88)
a_min = 0.001   # minimum ice area fraction
m_min = 0.01    # minimum ice mass (kg/m^2)

# bilinear quadrature weights (ice_constants.F90:166-172)
p055 = 1.0 / 18.0
p111 = 1.0 / 9.0
p166 = 1.0 / 6.0
p222 = 2.0 / 9.0
p25 = 0.25
p333 = 1.0 / 3.0
p5 = 0.5


@dataclasses.dataclass(frozen=True)
class EvpParams:
    """Derived EVP constants (``ice_dyn_evp.F90 set_evp_parameters:535-577``)."""

    ndte: int
    dtei: float      # 1/dte
    dte2T: float     # dte / (2 eyc dt)
    denom1: float
    denom2: float
    rcon: float      # damping bound (kg/s)
    ecci: float      # 1/e^2
    cosw: float
    sinw: float
    dragw: float     # dragio * rhow
    evp_damping: bool
    hemi_turning: bool  # flip turning-angle sign in S hemisphere (AusCOM)


def make_evp_params(dyn: DynamicsConfig, dt: float) -> EvpParams:
    dte = dt / dyn.ndte
    dtei = 1.0 / dte
    tdamp2 = 2.0 * dyn.eyc * dt
    dte2T = dte / tdamp2
    return EvpParams(
        ndte=dyn.ndte, dtei=dtei, dte2T=dte2T,
        denom1=1.0 / (1.0 + dte2T),
        denom2=1.0 / (1.0 + dte2T * dyn.ecc),
        rcon=1230.0 * dyn.eyc * dt * dtei**2,
        ecci=1.0 / dyn.ecc,
        cosw=dyn.cosw, sinw=dyn.sinw,
        dragw=dyn.dragio * cn.rhow,
        evp_damping=dyn.evp_damping,
        hemi_turning=(dyn.sinw != 0.0),
    )


# 180-degree corner pairing of the str8 flux pieces under the tripole
# fold: u pieces (ne, nw, se, sw) -> (sw, se, nw, ne), same for v
_STR8_PAIR = (3, 2, 1, 0, 7, 6, 5, 4)


class JnpNbr:
    """Neighbor-shift provider over the halo module (global jnp arrays).

    The EVP math below is written against this tiny interface so that
    the same code runs (a) on global arrays with boundary-aware,
    GSPMD-friendly shifts (this class) and (b) on locally padded
    blocks inside the k-halo sharded loop (`evp_sharded.PadNbr`, plain
    rolls).  loc/ftype only matter for tripole folds.
    """

    def __init__(self, bc):
        self.bc = bc

    def w(self, f, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
        return h.nbr_w(f, self.bc, loc, ftype)

    def e(self, f, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
        return h.nbr_e(f, self.bc, loc, ftype)

    def n(self, f, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
        return h.nbr_n(f, self.bc, loc, ftype)

    def s(self, f, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
        return h.nbr_s(f, self.bc, loc, ftype)

    def ne(self, f, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
        return h.nbr_ne(f, self.bc, loc, ftype)

    # -- north shifts of the str8 momentum-flux planes ---------------
    # Under the tripole fold the 8 flux combinations are NOT scalars:
    # the cell beyond the fold is the 180-degree-rotated physical cell,
    # so its ne/nw/se/sw corner pieces are the sw/se/nw/ne pieces of
    # the mirror cell with flipped sign (x/y momentum flip under the
    # rotation).  Verified bit-exact against redundant ghost-zone
    # computation with mirror-consistent geometry (round-5 derivation;
    # the reference gets this implicitly by exchanging uvel/vvel with
    # the U-fold and recomputing stress locally per block,
    # ``ice_dyn_evp.F90:397-402`` + ``mpi/ice_boundary.F90`` tripole
    # sections).  Non-tripole boundaries devolve to the plain shifts.

    def _str8_ghost(self, str8, k, ne_shift):
        nx = str8.shape[-1]
        if ne_shift:     # ghost(i) = -pair[ny_src, (nx-2-i) mod nx]
            idx = jnp.mod(jnp.arange(nx - 2, -2, -1), nx)
        else:            # ghost(i) = -pair[ny_src, nx-1-i]
            idx = jnp.arange(nx - 1, -1, -1)
        src_row = -1 if self.bc.ns == "tripole" else -2
        row = -str8[_STR8_PAIR[k]][..., src_row, :][..., idx]
        return row[..., None, :]

    def n_str(self, str8, k):
        if self.bc.ns not in ("tripole", "tripoleT"):
            return self.n(str8[k])
        s = jnp.roll(str8[k], -1, axis=-2)
        return jnp.concatenate(
            [s[..., :-1, :], self._str8_ghost(str8, k, False)], axis=-2)

    def ne_str(self, str8, k):
        if self.bc.ns not in ("tripole", "tripoleT"):
            return self.ne(str8[k])
        s = jnp.roll(jnp.roll(str8[k], -1, axis=-1), -1, axis=-2)
        return jnp.concatenate(
            [s[..., :-1, :], self._str8_ghost(str8, k, True)], axis=-2)


def _corner_velocities(nbr, uvel, vvel):
    """Velocities at the 4 U corners of every T cell plus the helper
    shifts used by the strain-rate stencil."""
    kw = dict(loc=FieldLoc.NE_CORNER, ftype=FieldType.VECTOR)
    u_w = nbr.w(uvel, **kw)
    u_s = nbr.s(uvel, **kw)
    u_sw = nbr.s(u_w, **kw)
    v_w = nbr.w(vvel, **kw)
    v_s = nbr.s(vvel, **kw)
    v_sw = nbr.s(v_w, **kw)
    return (uvel, u_w, u_s, u_sw, vvel, v_w, v_s, v_sw)


def _strain_rates(geom, nbr, uvel, vvel):
    """Corner strain rates * area (m^2/s) (``ice_dyn_evp.F90:1065-1092``).

    Returns (div, ten, shr) each of shape (4, ny, nx), corners (ne, nw,
    sw, se).  `geom` is any namespace carrying the stencil coefficient
    fields (the Grid object, or a block-local view in `evp_sharded`).
    """
    u, u_w, u_s, u_sw, v, v_w, v_s, v_sw = _corner_velocities(nbr, uvel, vvel)
    cyp, cxp, cym, cxm = geom.cyp, geom.cxp, geom.cym, geom.cxm
    dxt, dyt = geom.dxt, geom.dyt

    divne = cyp * u - dyt * u_w + cxp * v - dxt * v_s
    divnw = cym * u_w + dyt * u + cxp * v_w - dxt * v_sw
    divsw = cym * u_sw + dyt * u_s + cxm * v_sw + dxt * v_w
    divse = cyp * u_s - dyt * u_sw + cxm * v_s + dxt * v

    tenne = -cym * u - dyt * u_w + cxm * v + dxt * v_s
    tennw = -cyp * u_w + dyt * u + cxm * v_w + dxt * v_sw
    tensw = -cyp * u_sw + dyt * u_s + cxp * v_sw - dxt * v_w
    tense = -cym * u_s - dyt * u_sw + cxp * v_s - dxt * v

    shrne = -cym * v - dyt * v_w - cxm * u - dxt * u_s
    shrnw = -cyp * v_w + dyt * v - cxm * u_w - dxt * u_sw
    shrsw = -cyp * v_sw + dyt * v_s - cxp * u_sw + dxt * u_w
    shrse = -cym * v_s - dyt * v_sw - cxp * u_s + dxt * u

    div = jnp.stack([divne, divnw, divsw, divse])
    ten = jnp.stack([tenne, tennw, tensw, tense])
    shr = jnp.stack([shrne, shrnw, shrsw, shrse])
    return div, ten, shr


def _stress_relax(p: EvpParams, geom, nbr, strength, tmask_ice,
                  uvel, vvel, stressp, stressm, stress12):
    """Strain rates + stress relaxation (``ice_dyn_evp.F90:1065-1190``):
    the per-cell half of `stress`, without the str8 flux assembly.
    Returns (stressp, stressm, stress12, diag)."""
    div, ten, shr = _strain_rates(geom, nbr, uvel, vvel)
    delta = jnp.sqrt(div**2 + p.ecci * (ten**2 + shr**2))

    if p.evp_damping:
        floor = 4.0 * geom.tinyarea
        c0 = jnp.minimum(strength / jnp.maximum(delta, floor), p.rcon)
        prs_sig = strength * delta[0] / jnp.maximum(delta[0], floor)
    else:
        c0 = strength / jnp.maximum(delta, geom.tinyarea)
        prs_sig = c0[0] * delta[0]
    c1 = c0 * p.dte2T

    stressp = jnp.where(tmask_ice,
                        (stressp + c1 * (div - delta)) * p.denom1, 0.0)
    stressm = jnp.where(tmask_ice, (stressm + c1 * ten) * p.denom2, 0.0)
    stress12 = jnp.where(tmask_ice,
                         (stress12 + c1 * shr * p5) * p.denom2, 0.0)
    diag = dict(div=div, delta=delta, ten=ten, shr=shr, prs_sig=prs_sig)
    return stressp, stressm, stress12, diag


def _str8_from_stress(geom, tmask_ice, stressp, stressm, stress12):
    """Pointwise assembly of the 8 momentum flux combinations from the
    (already-updated) corner stresses (``ice_dyn_evp.F90:1196-1289``).
    Depends only on same-cell stresses + geometry."""
    sp1, sp2, sp3, sp4 = stressp
    sm1, sm2, sm3, sm4 = stressm
    s121, s122, s123, s124 = stress12
    dxt, dyt, dxhy, dyhx = geom.dxt, geom.dyt, geom.dxhy, geom.dyhx

    # edge sums and corner-weighted combinations (":1196-1289")
    ssigpn = sp1 + sp2
    ssigps = sp3 + sp4
    ssigpe = sp1 + sp4
    ssigpw = sp2 + sp3
    ssigp1 = (sp1 + sp3) * p055
    ssigp2 = (sp2 + sp4) * p055

    ssigmn = sm1 + sm2
    ssigms = sm3 + sm4
    ssigme = sm1 + sm4
    ssigmw = sm2 + sm3
    ssigm1 = (sm1 + sm3) * p055
    ssigm2 = (sm2 + sm4) * p055

    ssig12n = s121 + s122
    ssig12s = s123 + s124
    ssig12e = s121 + s124
    ssig12w = s122 + s123
    ssig121 = (s121 + s123) * p111
    ssig122 = (s122 + s124) * p111

    csigpne = p111 * sp1 + ssigp2 + (p055 * p5) * sp3
    csigpnw = p111 * sp2 + ssigp1 + (p055 * p5) * sp4
    csigpsw = p111 * sp3 + ssigp2 + (p055 * p5) * sp1
    csigpse = p111 * sp4 + ssigp1 + (p055 * p5) * sp2

    csigmne = p111 * sm1 + ssigm2 + (p055 * p5) * sm3
    csigmnw = p111 * sm2 + ssigm1 + (p055 * p5) * sm4
    csigmsw = p111 * sm3 + ssigm2 + (p055 * p5) * sm1
    csigmse = p111 * sm4 + ssigm1 + (p055 * p5) * sm2

    csig12ne = p222 * s121 + ssig122 + p055 * s123
    csig12nw = p222 * s122 + ssig121 + p055 * s124
    csig12sw = p222 * s123 + ssig122 + p055 * s121
    csig12se = p222 * s124 + ssig121 + p055 * s122

    str12ew = p5 * dxt * (p333 * ssig12e + p166 * ssig12w)
    str12we = p5 * dxt * (p333 * ssig12w + p166 * ssig12e)
    str12ns = p5 * dyt * (p333 * ssig12n + p166 * ssig12s)
    str12sn = p5 * dyt * (p333 * ssig12s + p166 * ssig12n)

    # u momentum flux pieces
    strp = p25 * dyt * (p333 * ssigpn + p166 * ssigps)
    strm = p25 * dyt * (p333 * ssigmn + p166 * ssigms)
    str0 = -strp - strm - str12ew + dxhy * (-csigpne + csigmne) + dyhx * csig12ne
    str1 = strp + strm - str12we + dxhy * (-csigpnw + csigmnw) + dyhx * csig12nw
    strp = p25 * dyt * (p333 * ssigps + p166 * ssigpn)
    strm = p25 * dyt * (p333 * ssigms + p166 * ssigmn)
    str2 = -strp - strm + str12ew + dxhy * (-csigpse + csigmse) + dyhx * csig12se
    str3 = strp + strm + str12we + dxhy * (-csigpsw + csigmsw) + dyhx * csig12sw

    # v momentum flux pieces
    strp = p25 * dxt * (p333 * ssigpe + p166 * ssigpw)
    strm = p25 * dxt * (p333 * ssigme + p166 * ssigmw)
    str4 = -strp + strm - str12ns - dyhx * (csigpne + csigmne) + dxhy * csig12ne
    str5 = strp - strm - str12sn - dyhx * (csigpse + csigmse) + dxhy * csig12se
    strp = p25 * dxt * (p333 * ssigpw + p166 * ssigpe)
    strm = p25 * dxt * (p333 * ssigmw + p166 * ssigme)
    str6 = -strp + strm + str12ns - dyhx * (csigpnw + csigmnw) + dxhy * csig12nw
    str7 = strp - strm + str12sn - dyhx * (csigpsw + csigmsw) + dxhy * csig12sw

    str8 = jnp.stack([str0, str1, str2, str3, str4, str5, str6, str7])
    return jnp.where(tmask_ice[None], str8, 0.0)


def _stress_update(p: EvpParams, geom, nbr, strength, tmask_ice,
                   uvel, vvel, stressp, stressm, stress12):
    """One `stress` call (``ice_dyn_evp.F90:947-1293``): update the 12
    corner stresses and assemble the 8 momentum flux combinations.

    Returns (stressp, stressm, stress12, str8, diag) where str8 is
    (8, ny, nx) and diag carries strain invariants for ridging.
    """
    stressp, stressm, stress12, diag = _stress_relax(
        p, geom, nbr, strength, tmask_ice, uvel, vvel,
        stressp, stressm, stress12)
    str8 = _str8_from_stress(geom, tmask_ice, stressp, stressm, stress12)
    return stressp, stressm, stress12, str8, diag


def _stepu(p: EvpParams, geom, nbr, iceumask, aiu, str8,
           uocn, vocn, waterx, watery, forcex, forcey,
           umassdtei, fm, uvel, vvel):
    """Momentum solve (``ice_dyn_evp.F90 stepu:1302-1443``)."""
    vrel = aiu * p.dragw * jnp.sqrt((uocn - uvel) ** 2 + (vocn - vvel) ** 2)
    taux = vrel * waterx
    tauy = vrel * watery

    cca = umassdtei + vrel * p.cosw
    if p.hemi_turning:
        sgn = jnp.where(fm < 0.0, -1.0, 1.0)
    else:
        sgn = 1.0
    ccb = fm + sgn * vrel * p.sinw
    ab2 = cca**2 + ccb**2

    if hasattr(nbr, "n_str"):
        n2, ne3 = nbr.n_str(str8, 2), nbr.ne_str(str8, 3)
        n5, ne7 = nbr.n_str(str8, 5), nbr.ne_str(str8, 7)
    else:
        n2, ne3 = nbr.n(str8[2]), nbr.ne(str8[3])
        n5, ne7 = nbr.n(str8[5]), nbr.ne(str8[7])
    strintx = geom.uarear * (str8[0] + nbr.e(str8[1]) + n2 + ne3)
    strinty = geom.uarear * (str8[4] + n5 + nbr.e(str8[6]) + ne7)

    cc1 = strintx + forcex + taux + umassdtei * uvel
    cc2 = strinty + forcey + tauy + umassdtei * vvel

    unew = (cca * cc1 + ccb * cc2) / jnp.maximum(ab2, cn.puny)
    vnew = (cca * cc2 - ccb * cc1) / jnp.maximum(ab2, cn.puny)
    unew = jnp.where(iceumask, unew, 0.0)
    vnew = jnp.where(iceumask, vnew, 0.0)
    strintx = jnp.where(iceumask, strintx, 0.0)
    strinty = jnp.where(iceumask, strinty, 0.0)
    strocnx = jnp.where(iceumask, taux, 0.0)
    strocny = jnp.where(iceumask, tauy, 0.0)
    return unew, vnew, strintx, strinty, strocnx, strocny


def _evp_subcycle_jnp(p: EvpParams, grid: Grid, strength, icetmask,
                      iceumask, aiu, uocn, vocn, waterx, watery,
                      forcex, forcey, umassdtei, fm,
                      uvel, vvel, stressp, stressm, stress12):
    """ndte subcycles of stress+stepu as a lax.fori_loop over global
    arrays (``ice_dyn_evp.F90:347-408``).  Returns the updated state
    plus last-subcycle strain diagnostics for ridging."""
    nbr = JnpNbr(grid.bc)

    def body(_, carry):
        uvel, vvel, stressp, stressm, stress12 = carry
        stressp, stressm, stress12, str8, _d = _stress_update(
            p, grid, nbr, strength, icetmask, uvel, vvel,
            stressp, stressm, stress12)
        uvel, vvel, *_rest = _stepu(
            p, grid, nbr, iceumask, aiu, str8, uocn, vocn, waterx, watery,
            forcex, forcey, umassdtei, fm, uvel, vvel)
        return uvel, vvel, stressp, stressm, stress12

    carry = (uvel, vvel, stressp, stressm, stress12)
    carry = jax.lax.fori_loop(0, p.ndte - 1, body, carry)
    uvel, vvel, stressp, stressm, stress12 = carry

    # final subcycle, with ridging diagnostics (":1103-1115")
    stressp, stressm, stress12, str8, d = _stress_update(
        p, grid, nbr, strength, icetmask, uvel, vvel,
        stressp, stressm, stress12)
    uvel, vvel, strintx, strinty, strocnx, strocny = _stepu(
        p, grid, nbr, iceumask, aiu, str8, uocn, vocn, waterx, watery,
        forcex, forcey, umassdtei, fm, uvel, vvel)
    diag = dict(div_sum=jnp.sum(d["div"], 0),
                delta_sum=jnp.sum(d["delta"], 0),
                ten_sum=jnp.sum(d["ten"], 0),
                shr_sum=jnp.sum(d["shr"], 0),
                prs_sig=d["prs_sig"])
    return (uvel, vvel, stressp, stressm, stress12, diag,
            strintx, strinty, strocnx, strocny)


def evp(state: State, grid: Grid, dyn: DynamicsConfig, dt: float,
        aice, vice, vsno, aicen, vicen, aice0,
        uocn, vocn, ss_tltx, ss_tlty, strairxT, strairyT,
        tilt_from_currents: bool = True):
    """EVP dynamics driver (``ice_dyn_evp.F90 evp:119-432``).

    Args:
      aice..aice0: aggregates (up to date with category state).
      uocn/vocn: ocean surface current at U points (m/s).
      ss_tltx/y: sea surface slope at U points (used when
        `tilt_from_currents` is False — the coupled configuration).
      strairxT/yT: wind stress on the T grid (incl. aice factor).

    Returns (state, diag) with updated velocity/stress/iceumask/ocean
    stress in state and ridging inputs + history fields in diag.
    """
    p = make_evp_params(dyn, dt)
    bc = grid.bc

    # --- evp_prep1 (":586-694") -------------------------------------------
    tmass = jnp.where(grid.tmask, cn.rhoi * vice + cn.rhos * vsno, 0.0)
    tmphm = grid.tmask & (aice > a_min) & (tmass > m_min)
    # 9-point dilation of the ice mask
    f = tmphm.astype(tmass.dtype)
    dil = (f + h.nbr_e(f, bc) + h.nbr_w(f, bc) + h.nbr_n(f, bc)
           + h.nbr_s(f, bc) + h.nbr_ne(f, bc) + h.nbr_nw(f, bc)
           + h.nbr_se(f, bc) + h.nbr_sw(f, bc))
    icetmask = (dil > 0.0) & grid.tmask

    # --- T -> U interpolation ---------------------------------------------
    umass = to_ugrid(grid, tmass)
    aiu = to_ugrid(grid, aice)
    strairx = to_ugrid(grid, strairxT)
    strairy = to_ugrid(grid, strairyT)

    # --- evp_prep2 (":703-938") -------------------------------------------
    zero = jnp.zeros_like(aice)
    stressp = jnp.where(icetmask[None], state.stressp, 0.0)
    stressm = jnp.where(icetmask[None], state.stressm, 0.0)
    stress12 = jnp.where(icetmask[None], state.stress12, 0.0)

    iceumask_old = state.iceumask
    iceumask = grid.umask & (aiu > a_min) & (umass > m_min)
    new_pts = iceumask & ~iceumask_old
    uvel = jnp.where(new_pts, uocn, jnp.where(iceumask, state.uvel, 0.0))
    vvel = jnp.where(new_pts, vocn, jnp.where(iceumask, state.vvel, 0.0))

    umassdtei = jnp.where(iceumask, umass * p.dtei, 0.0)
    fm = jnp.where(iceumask, grid.fcor * umass, 0.0)
    if p.hemi_turning:
        sgn = jnp.where(fm < 0.0, -1.0, 1.0)
    else:
        sgn = 1.0
    waterx = jnp.where(iceumask, uocn * p.cosw - vocn * p.sinw * sgn, 0.0)
    watery = jnp.where(iceumask, vocn * p.cosw + uocn * p.sinw * sgn, 0.0)
    if tilt_from_currents:
        strtltx = -fm * vocn
        strtlty = fm * uocn
    else:
        strtltx = -cn.gravit * umass * ss_tltx
        strtlty = -cn.gravit * umass * ss_tlty
    forcex = jnp.where(iceumask, strairx + strtltx, 0.0)
    forcey = jnp.where(iceumask, strairy + strtlty, 0.0)

    # --- ice strength ------------------------------------------------------
    strength = ice_strength(dyn, aice, vice, aice0, aicen, vicen, icetmask)

    if bc.ns == "tripole":
        # The top row of U points lies ON the U-fold: (ny-1, i) and
        # (ny-1, (nx-2-i) mod nx) are the same physical point stored
        # twice.  Enforce the constraint (scalars equal, vector
        # components negated) on every U-point input, as the
        # reference's tripole halo does for NE_CORNER fields
        # (``mpi/ice_boundary.F90`` tripole unpack) — with consistent
        # inputs the discrete operators preserve the constraint
        # bit-exactly (round-5 equivariance derivation), which the
        # k-halo sharded fold relies on.
        nxg = grid.nx
        idx = jnp.mod(nxg - 2 - jnp.arange(nxg), nxg)

        def _sym(f, sign):
            top = f[..., -1, :]
            top = 0.5 * (top + sign * top[..., idx])
            return f.at[..., -1, :].set(top)

        iceumask = iceumask.at[..., -1, :].set(
            iceumask[..., -1, :] & iceumask[..., -1, idx])
        uvel = jnp.where(iceumask, uvel, 0.0)
        vvel = jnp.where(iceumask, vvel, 0.0)
        umassdtei = jnp.where(iceumask, umassdtei, 0.0)
        fm = jnp.where(iceumask, fm, 0.0)
        waterx = jnp.where(iceumask, waterx, 0.0)
        watery = jnp.where(iceumask, watery, 0.0)
        forcex = jnp.where(iceumask, forcex, 0.0)
        forcey = jnp.where(iceumask, forcey, 0.0)
        uvel, vvel = _sym(uvel, -1.0), _sym(vvel, -1.0)
        uocn, vocn = _sym(uocn, -1.0), _sym(vocn, -1.0)
        waterx, watery = _sym(waterx, -1.0), _sym(watery, -1.0)
        forcex, forcey = _sym(forcex, -1.0), _sym(forcey, -1.0)
        aiu = _sym(aiu, 1.0)
        umassdtei = _sym(umassdtei, 1.0)
        fm = _sym(fm, 1.0)

    # --- subcycling (":347-408") ------------------------------------------
    subcycle_args = (strength, icetmask, iceumask, aiu, uocn, vocn,
                     waterx, watery, forcex, forcey, umassdtei, fm,
                     uvel, vvel, stressp, stressm, stress12)
    from cice4_tpu.ops.evp_sharded import (evp_subcycle_sharded,
                                           sharded_eligible)
    from cice4_tpu.parallel.mesh import get_active_mesh
    mesh = get_active_mesh()
    if sharded_eligible(grid, mesh):
        # k-halo fast path: one exchange per H-1 subcycles instead of
        # GSPMD's per-roll permutes (SURVEY §7 hard-part 1)
        (uvel, vvel, stressp, stressm, stress12, d, strintx, strinty,
         strocnx, strocny) = evp_subcycle_sharded(p, grid, mesh,
                                                  *subcycle_args)
    else:
        (uvel, vvel, stressp, stressm, stress12, d, strintx, strinty,
         strocnx, strocny) = _evp_subcycle_jnp(p, grid, *subcycle_args)

    divu = p25 * d["div_sum"] * grid.tarear
    delta_mean = p25 * d["delta_sum"] * grid.tarear
    rdg_conv = -jnp.minimum(divu, 0.0)
    rdg_shear = p5 * (delta_mean - jnp.abs(divu))
    shear = p25 * grid.tarear * jnp.sqrt(
        d["ten_sum"] ** 2 + d["shr_sum"] ** 2)

    # --- evp_finish (":1452-1549") ----------------------------------------
    vrel = p.dragw * jnp.sqrt((uocn - uvel) ** 2 + (vocn - vvel) ** 2)
    if p.hemi_turning:
        sgn = jnp.where(fm < 0.0, -1.0, 1.0)
    else:
        sgn = 1.0
    strocnx = strocnx - vrel * (uvel * p.cosw - sgn * vvel * p.sinw) * aiu
    strocny = strocny - vrel * (vvel * p.cosw + sgn * uvel * p.sinw) * aiu
    strocnxT_u = jnp.where(iceumask,
                           strocnx / jnp.maximum(aiu, cn.puny), 0.0)
    strocnyT_u = jnp.where(iceumask,
                           strocny / jnp.maximum(aiu, cn.puny), 0.0)
    strocnxT = to_tgrid(grid, strocnxT_u)
    strocnyT = to_tgrid(grid, strocnyT_u)

    state = state.replace(uvel=uvel, vvel=vvel, stressp=stressp,
                          stressm=stressm, stress12=stress12,
                          iceumask=iceumask,
                          strocnxT=strocnxT, strocnyT=strocnyT)
    diag = dict(divu=jnp.where(icetmask, divu, 0.0),
                shear=jnp.where(icetmask, shear, 0.0),
                rdg_conv=jnp.where(icetmask, rdg_conv, 0.0),
                rdg_shear=jnp.where(icetmask, rdg_shear, 0.0),
                prs_sig=jnp.where(icetmask, d["prs_sig"], 0.0),
                strength=strength, strintx=strintx, strinty=strinty,
                strocnx=strocnx, strocny=strocny,
                strairx=strairx, strairy=strairy, fm=fm,
                strtltx=jnp.where(iceumask, strtltx, 0.0),
                strtlty=jnp.where(iceumask, strtlty, 0.0),
                strcorx=fm * vvel, strcory=-fm * uvel,
                icetmask=icetmask)
    return state, diag


def principal_stress(stressp1, stressm1, stress121, prs_sig):
    """Principal stresses sig1/sig2 normalized by the replacement
    pressure (``ice_dyn_evp.F90 principal_stress:1558-1609``)."""
    root = jnp.sqrt(stressm1**2 + 4.0 * stress121**2)
    ok = prs_sig > cn.puny
    denom = jnp.maximum(prs_sig, cn.puny)
    sig1 = jnp.where(ok, 0.5 * (stressp1 + root) / denom, cn.spval)
    sig2 = jnp.where(ok, 0.5 * (stressp1 - root) / denom, cn.spval)
    return sig1, sig2
