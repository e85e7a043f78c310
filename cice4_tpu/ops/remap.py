"""Incremental remapping transport (Dukowicz & Baumgardner 2000;
Lipscomb & Hunke 2004).

Dense JAX reworking of ``source/ice_transport_remap.F90`` +
``ice_transport_driver.F90 transport_remap:179-663``.  Second-order,
monotone (van-Leer-limited linear reconstruction), conservative, and
cheap per tracer.

The reference builds compressed triangle lists per edge with ~1400
lines of branchy geometry (`locate_triangles:1763-3146`); here every
edge of the grid carries a dense set of up-to-6 departure triangles
(the reference's `ngroups = 6`), selected with nested `jnp.where`
over the mutually-exclusive geometric cases — no data-dependent
shapes, fully vectorized over the plane.

As in the reference, all local geometry is computed on the *scaled*
grid (cell = unit square; `horizontal_remap` passes 1.0 for
HTN/HTE/dxt/dyt, and `init_remap:266-319` sets xav = yav = 0,
xxav = yyav = 1/12); physical areas enter only through the corner
area factors dxu*dyu and the final 1/tarea.

Transported quantities (`state_to_tracers:847-1003`): open water and
per-category area are the "mass"; thickness hi = v/a and hs, surface
temperature and area tracers ride on the mass; layer enthalpies
q = e/v and volume tracers ride on hi (tracer_type 2 with dependents).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cice4_tpu import constants as cn
from cice4_tpu.constants import FieldLoc, FieldType
from cice4_tpu.grid import Grid
from cice4_tpu.ops.itd import TRACER_DEPEND
from cice4_tpu.parallel import halo as h
from cice4_tpu.state import State

NGROUPS = 6

# neighbor-position codes for flux cells
TL, BL, TR, BR, TC, BC = 0, 1, 2, 3, 4, 5

# which positions each triangle group can flux into (static): the
# corner groups touch only their own corner cells, the three central
# groups only TC/BC — this bounds the gather-select chains
GROUP_POSITIONS = ((TL, BL), (TR, BR), (TL, BL, TR, BR),
                   (TC, BC), (TC, BC), (TC, BC))

# (ishift, jshift) per position, per edge (ice_transport_remap.F90:1990-2030)
SHIFTS = {
    "north": {TL: (-1, 1), BL: (-1, 0), TR: (1, 1), BR: (1, 0),
              TC: (0, 1), BC: (0, 0)},
    "east": {TL: (1, 1), BL: (0, 1), TR: (1, -1), BR: (0, -1),
             TC: (1, 0), BC: (0, 0)},
}


class JnpShift:
    """Global-view neighbor shifts with boundary conditions (wraps
    :mod:`cice4_tpu.parallel.halo`).  Every geometry/reconstruction/
    divergence helper below takes the shift provider as an argument, so
    the k-halo sharded path runs them unchanged on padded blocks with
    cyclic local boundaries."""

    __slots__ = ("bc",)

    def __init__(self, bc):
        self.bc = bc

    def e(self, f, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
        return h.nbr_e(f, self.bc, loc, ftype)

    def w(self, f, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
        return h.nbr_w(f, self.bc, loc, ftype)

    def n(self, f, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
        return h.nbr_n(f, self.bc, loc, ftype)

    def s(self, f, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
        return h.nbr_s(f, self.bc, loc, ftype)


def _shift9(f, sh, loc=FieldLoc.CENTER, ftype=FieldType.SCALAR):
    """All 3x3 neighbor shifts of `f`, keyed by offset ``(di, dj)``
    (di = +1 means the value one cell east, dj = +1 one cell north).

    Shifts are built incrementally (x first, then y — the halo module's
    composite order) so the 9 planes cost 8 roll ops total, shared by
    every consumer instead of re-deriving composites per edge/position.
    """
    fe = sh.e(f, loc, ftype)
    fw = sh.w(f, loc, ftype)
    out = {(0, 0): f, (1, 0): fe, (-1, 0): fw}
    for di, g in ((0, f), (1, fe), (-1, fw)):
        out[(di, 1)] = sh.n(g, loc, ftype)
        out[(di, -1)] = sh.s(g, loc, ftype)
    return out


def _limited_gradient_shifted(phi, p9, m9, phimask, cnx, cny):
    """Van-Leer limited gradient from pre-shifted neighbor tables
    (``limited_gradient:1392-1556`` with dxt = dyt = HTN = HTE = 1).

    p9/m9: `_shift9` tables of phi and its mask — shared between
    callers so one (stack-deep) set of rolls serves every gradient.
    cnx/cny: coordinates of the reference point the reconstruction is
    centered on (e.g. center of mass); may broadcast against phi.
    """
    def nb(off):
        m = m9[off]
        return m * p9[off] + (1.0 - m) * phi

    phi_e = nb((1, 0))
    phi_w = nb((-1, 0))
    phi_n = nb((0, 1))
    phi_s = nb((0, -1))
    phi_ne = nb((1, 1))
    phi_nw = nb((-1, 1))
    phi_se = nb((1, -1))
    phi_sw = nb((-1, -1))

    # reference: (phi_e-phi)/2 + (phi-phi_w)/2 = (phi_e - phi_w)/2
    gx = 0.5 * (phi_e - phi_w)
    gy = 0.5 * (phi_n - phi_s)

    pmn = jnp.minimum(
        jnp.minimum(jnp.minimum(phi_nw, phi_n),
                    jnp.minimum(phi_ne, phi_w)),
        jnp.minimum(jnp.minimum(phi, phi_e),
                    jnp.minimum(jnp.minimum(phi_sw, phi_s), phi_se)))
    pmx = jnp.maximum(
        jnp.maximum(jnp.maximum(phi_nw, phi_n),
                    jnp.maximum(phi_ne, phi_w)),
        jnp.maximum(jnp.maximum(phi, phi_e),
                    jnp.maximum(jnp.maximum(phi_sw, phi_s), phi_se)))
    pmn = pmn - phi
    pmx = pmx - phi

    # reconstruction at the 4 cell corners (scaled widths = 1)
    w1 = (0.5 - cnx) * gx + (0.5 - cny) * gy
    w2 = (0.5 - cnx) * gx - (0.5 + cny) * gy
    w3 = -(0.5 + cnx) * gx - (0.5 + cny) * gy
    w4 = (0.5 - cny) * gy - (0.5 + cnx) * gx

    qmn = jnp.minimum(jnp.minimum(w1, w2), jnp.minimum(w3, w4))
    qmx = jnp.maximum(jnp.maximum(w1, w2), jnp.maximum(w3, w4))

    wa = jnp.where(jnp.abs(qmn) > 0.0,
                   jnp.maximum(0.0, pmn / jnp.where(qmn != 0.0, qmn, 1.0)),
                   1.0)
    wb = jnp.where(jnp.abs(qmx) > 0.0,
                   jnp.maximum(0.0, pmx / jnp.where(qmx != 0.0, qmx, 1.0)),
                   1.0)
    lim = jnp.minimum(1.0, jnp.minimum(wa, wb))
    lim = lim * phimask  # no gradient where the center itself is masked
    return lim * gx, lim * gy


def _edge_geometry(edge, afac, dx, dy, sh, edgearea=None):
    """Departure-triangle geometry for all edges of one direction
    (``locate_triangles:1763-3146``, 0-based groups).

    dx/dy: scaled departure displacements at U corners (= -dt*u/dxu).
    edgearea: prescribed signed area flux per edge (m^2) for the
    ``l_fixed_area = T`` mode (``:2352-2487``): the trajectory midpoint
    is shifted so the departure region has exactly this area.  None =
    the default free-area mode.
    Returns per group g: verts[g] = (x1,y1,x2,y2,x3,y3) in edge-local
    coordinates, pos[g] (int code), fac[g] (signed physical area
    factor).  All arrays (ny, nx), indexed by the cell whose
    north/east edge this is.
    """
    kw = dict(loc=FieldLoc.NE_CORNER, ftype=FieldType.VECTOR)
    zero = jnp.zeros_like(dx)

    if edge == "north":
        dxl = sh.w(dx, **kw)
        dyl = sh.w(dy, **kw)
        xdl = -0.5 + dxl
        ydl = dyl
        xdr = 0.5 + dx
        ydr = dy
        afl = sh.w(afac)
        afr = afac
    else:  # east edge; rotate trajectory by pi/2
        xdl = -0.5 - dy
        ydl = dx
        xdr = 0.5 - sh.s(dy, **kw)
        ydr = sh.s(dx, **kw)
        afl = afac
        afr = sh.s(afac)
    afc = 0.5 * (afl + afr)

    xcl, ycl = -0.5, 0.0
    xcr, ycr = 0.5, 0.0

    xdm = 0.5 * (xdr + xdl)
    ydm = 0.5 * (ydr + ydl)

    dxseg = jnp.where(jnp.abs(xdm - xdl) > 0.0, xdm - xdl, cn.puny)
    yil = (xcl * (ydm - ydl) + xdm * ydl - xdl * ydm) / dxseg
    dxseg = jnp.where(jnp.abs(xdr - xdm) > 0.0, xdr - xdm, cn.puny)
    yir = (xcr * (ydr - ydm) - xdm * ydr + xdr * ydm) / dxseg

    md = (ydr - ydl) / jnp.where(jnp.abs(xdr - xdl) > 0.0,
                                 xdr - xdl, cn.puny)
    xic = jnp.where(jnp.abs(md) > cn.puny,
                    xdl - ydl / jnp.where(md != 0.0, md, 1.0), 0.0)
    yic = zero
    xil = jnp.full_like(dx, xcl)
    xir = jnp.full_like(dx, xcr)

    def tri(x1, y1, x2, y2, x3, y3):
        return (x1, y1, x2, y2, x3, y3)

    ZTRI = tri(zero, zero, zero, zero, zero, zero)
    iZ = jnp.full_like(dx, BC, dtype=jnp.int32)

    verts = [ZTRI] * NGROUPS
    pos = [iZ] * NGROUPS
    fac = [zero] * NGROUPS

    def sel_tri(cond, newtri, newpos, newfac, g):
        v = tuple(jnp.where(cond, nv, ov)
                  for nv, ov in zip(newtri, verts[g]))
        p = jnp.where(cond, newpos, pos[g])
        f = jnp.where(cond, newfac, fac[g])
        verts[g] = v
        pos[g] = p
        fac[g] = f

    CL = jnp.full_like(dx, xcl)
    CR = jnp.full_like(dx, xcr)
    Z = zero

    # ---- left corner triangles (groups 0 and 2) ---------------------------
    left = xdl < xcl
    c_tl = left & (yil > 0.0) & (ydl >= 0.0)
    c_bl = left & (yil < 0.0) & (ydl < 0.0)
    c_tl1 = left & (yil < 0.0) & (ydl >= 0.0)
    c_tl2 = left & (yil > 0.0) & (ydl < 0.0)

    sel_tri(c_tl, tri(CL, Z, xil, yil, xdl, ydl), TL, -afl, 0)
    sel_tri(c_bl, tri(CL, Z, xdl, ydl, xil, yil), BL, afl, 0)
    sel_tri(c_tl1, tri(CL, Z, xdl, ydl, xic, yic), TL, afl, 0)
    sel_tri(c_tl1, tri(CL, Z, xic, yic, xil, yil), BL, afl, 2)
    sel_tri(c_tl2, tri(CL, Z, xil, yil, xic, yic), TL, -afl, 2)
    sel_tri(c_tl2, tri(CL, Z, xic, yic, xdl, ydl), BL, -afl, 0)

    # ---- right corner triangles (groups 1 and 2) --------------------------
    right = xdr >= xcr
    c_tr = right & (yir > 0.0) & (ydr >= 0.0)
    c_br = right & (yir < 0.0) & (ydr < 0.0)
    c_tr1 = right & (yir < 0.0) & (ydr >= 0.0)
    c_tr2 = right & (yir > 0.0) & (ydr < 0.0)

    sel_tri(c_tr, tri(CR, Z, xdr, ydr, xir, yir), TR, -afr, 1)
    sel_tri(c_br, tri(CR, Z, xir, yir, xdr, ydr), BR, afr, 1)
    sel_tri(c_tr1, tri(CR, Z, xic, yic, xdr, ydr), TR, afr, 1)
    sel_tri(c_tr1, tri(CR, Z, xir, yir, xic, yic), BR, afr, 2)
    sel_tri(c_tr2, tri(CR, Z, xic, yic, xir, yir), TR, -afr, 2)
    sel_tri(c_tr2, tri(CR, Z, xdr, ydr, xic, yic), BR, -afr, 1)

    # note: c_tl1 & c_tr* combinations can both claim group 2; the
    # reference guarantees exclusivity (left and right corner cannot
    # both split in the same cell unless flow is wildly divergent, in
    # which case one of the pair overwrites as in the sequential code).

    # ---- redefine DL/DR to the edge intersections if beyond corners -------
    xdl2 = jnp.where(left, xil, xdl)
    ydl2 = jnp.where(left, yil, ydl)
    xdr2 = jnp.where(right, xir, xdr)
    ydr2 = jnp.where(right, yir, ydr)
    icl = xic
    icr = xic

    if edgearea is not None:
        # l_fixed_area = T (":2352-2487"): shift the trajectory
        # midpoint so the total departure-region area equals the
        # prescribed edgearea; the corner triangles stay put.
        def _area(g):
            x1, y1, x2, y2, x3, y3 = verts[g]
            return 0.5 * ((x2 - x1) * (y3 - y1)
                          - (y2 - y1) * (x3 - x1)) * fac[g]

        area123 = _area(0) + _area(1) + _area(2)

        def safe(x):
            return jnp.where(jnp.abs(x) > cn.puny, x,
                             jnp.where(x >= 0, cn.puny, -cn.puny))

        def _intersect(x_a, y_a, x_b, y_b):
            """x-axis crossing of segment a->b (0 where ~horizontal)."""
            m = (y_b - y_a) / safe(x_b - x_a)
            return jnp.where(jnp.abs(m) > cn.puny, x_a - y_a / m, 0.0)

        # branch 1: both DPs on the same side of the x-axis
        area_c = edgearea - area123
        w1 = (2.0 * area_c / afc + (xdr2 - xcl) * ydl2
              + (xcr - xdl2) * ydr2)
        w1 = w1 / safe((xdr2 - xdl2) ** 2 + (ydr2 - ydl2) ** 2)
        xdm_1 = xdm + (ydr2 - ydl2) * w1
        ydm_1 = ydm - (xdr2 - xdl2) * w1
        xicl_1 = _intersect(xdl2, ydl2, xdm_1, ydm_1)
        xicr_1 = _intersect(xdm_1, ydm_1, xdr2, ydr2)

        # branch 2 (xic < 0): fix ICL at IC, adjust the right part
        area4_2 = 0.5 * (xcl - xic) * ydl2 * afl
        area_c = edgearea - area123 - area4_2
        w1 = (2.0 * area_c / afc + (xcr - xic) * ydr2)
        w1 = w1 / safe((xdr2 - xic) ** 2 + ydr2 ** 2)
        xdm_2 = 0.5 * (xdr2 + xic) + ydr2 * w1
        ydm_2 = 0.5 * ydr2 - (xdr2 - xic) * w1
        xicr_2 = _intersect(xdm_2, ydm_2, xdr2, ydr2)

        # branch 3 (xic >= 0): fix ICR at IC, adjust the left part
        area4_3 = 0.5 * (xic - xcr) * ydr2 * afr
        area_c = edgearea - area123 - area4_3
        w1 = (2.0 * area_c / afc + (xic - xcl) * ydl2)
        w1 = w1 / safe((xic - xdl2) ** 2 + ydl2 ** 2)
        xdm_3 = 0.5 * (xic + xdl2) - ydl2 * w1
        ydm_3 = 0.5 * ydl2 - (xic - xdl2) * w1
        xicl_3 = _intersect(xdl2, ydl2, xdm_3, ydm_3)

        same = ydl2 * ydr2 >= 0.0
        neg = xic < 0.0
        xdm = jnp.where(same, xdm_1, jnp.where(neg, xdm_2, xdm_3))
        ydm = jnp.where(same, ydm_1, jnp.where(neg, ydm_2, ydm_3))
        icl = jnp.where(same, xicl_1, jnp.where(neg, xic, xicl_3))
        icr = jnp.where(same, xicr_1, jnp.where(neg, xicr_2, xic))

    # ---- center triangles (groups 3, 4, 5) --------------------------------
    dlp = ydl2 >= 0.0
    drp = ydr2 >= 0.0
    dmp = ydm >= 0.0
    icp = xic >= 0.0

    DL = (xdl2, ydl2)
    DR = (xdr2, ydr2)
    DM = (xdm, ydm)
    ICL = (icl, yic)
    ICR = (icr, yic)
    CLt = (CL, Z)
    CRt = (CR, Z)

    def T(a, b, c):
        return tri(a[0], a[1], b[0], b[1], c[0], c[1])

    cases = [
        # (condition, [(tri, pos, fac) for groups 3,4,5])
        (dlp & drp & dmp,
         [(T(CLt, CRt, DL), TC, -afc), (T(CRt, DR, DL), TC, -afc),
          (T(DL, DR, DM), TC, -afc)]),
        (dlp & drp & ~dmp,
         [(T(CLt, ICL, DL), TC, -afc), (T(CRt, DR, ICR), TC, -afc),
          (T(ICR, ICL, DM), BC, afc)]),
        (~dlp & ~drp & ~dmp,
         [(T(CLt, DL, CRt), BC, afc), (T(CRt, DL, DR), BC, afc),
          (T(DL, DM, DR), BC, afc)]),
        (~dlp & ~drp & dmp,
         [(T(CLt, DL, ICL), BC, afc), (T(CRt, ICR, DR), BC, afc),
          (T(ICL, ICR, DM), TC, -afc)]),
        (dlp & ~drp & icp & dmp,
         [(T(CLt, ICR, DL), TC, -afc), (T(CRt, ICR, DR), BC, afr),
          (T(DL, ICR, DM), TC, -afc)]),
        (dlp & ~drp & icp & ~dmp,
         [(T(CLt, ICL, DL), TC, -afc), (T(CRt, ICR, DR), BC, afr),
          (T(ICR, ICL, DM), BC, afc)]),
        (dlp & ~drp & ~icp & ~dmp,
         [(T(CLt, ICL, DL), TC, -afl), (T(CRt, ICL, DR), BC, afc),
          (T(DR, ICL, DM), BC, afc)]),
        (dlp & ~drp & ~icp & dmp,
         [(T(CLt, ICL, DL), TC, -afl), (T(CRt, ICR, DR), BC, afc),
          (T(ICL, ICR, DM), TC, -afc)]),
        (~dlp & drp & ~icp & dmp,
         [(T(CLt, DL, ICL), BC, afl), (T(CRt, DR, ICL), TC, -afc),
          (T(ICL, DR, DM), TC, -afc)]),
        (~dlp & drp & ~icp & ~dmp,
         [(T(CLt, DL, ICL), BC, afl), (T(CRt, DR, ICR), TC, -afc),
          (T(ICR, ICL, DM), BC, afc)]),
        (~dlp & drp & icp & ~dmp,
         [(T(CLt, DL, ICR), BC, afc), (T(CRt, DR, ICR), TC, -afr),
          (T(ICR, DL, DM), BC, afc)]),
        (~dlp & drp & icp & dmp,
         [(T(CLt, DL, ICL), BC, afc), (T(CRt, DR, ICR), TC, -afr),
          (T(ICL, ICR, DM), TC, -afc)]),
    ]
    for cond, tris in cases:
        for k, (tv, tp, tf) in enumerate(tris):
            sel_tri(cond, tv, tp, tf, 3 + k)

    # ---- triangle areas ----------------------------------------------------
    triarea = []
    for g in range(NGROUPS):
        x1, y1, x2, y2, x3, y3 = verts[g]
        a = 0.5 * ((x2 - x1) * (y3 - y1) - (y2 - y1) * (x3 - x1)) * fac[g]
        a = jnp.where(jnp.abs(a) < cn.eps16 * afc, 0.0, a)
        triarea.append(a)

    # ---- transform vertices to flux-cell coordinates ----------------------
    ish = {p: SHIFTS[edge][p][0] for p in range(6)}
    jsh = {p: SHIFTS[edge][p][1] for p in range(6)}
    local = []
    for g in range(NGROUPS):
        x1, y1, x2, y2, x3, y3 = verts[g]
        isg = sum(jnp.where(pos[g] == p, ish[p], 0) for p in range(6))
        jsg = sum(jnp.where(pos[g] == p, jsh[p], 0) for p in range(6))
        if edge == "north":
            lx = tuple(x - isg for x in (x1, x2, x3))
            ly = tuple(y + 0.5 - jsg for y in (y1, y2, y3))
        else:
            lx = tuple(y + 0.5 - isg for y in (y1, y2, y3))
            ly = tuple(-x - jsg for x in (x1, x2, x3))
        local.append((lx, ly))

    return dict(verts=local, pos=pos, triarea=triarea)


def _quad_points(lx, ly, order):
    """Quadrature points + weights from triangle vertices
    (``triangle_coordinates:3155-3297``)."""
    x0 = (lx[0] + lx[1] + lx[2]) / 3.0
    y0 = (ly[0] + ly[1] + ly[2]) / 3.0
    if order == 1:
        return [(x0, y0, 1.0)]
    if order == 2:
        pts = []
        for k in range(3):
            pts.append((0.5 * lx[k] + 0.5 * x0, 0.5 * ly[k] + 0.5 * y0,
                        1.0 / 3.0))
        return pts
    # cubic 4-point
    pts = [(x0, y0, -0.5625)]
    for k in range(3):
        pts.append((0.4 * lx[k] + 0.6 * x0, 0.4 * ly[k] + 0.6 * y0,
                    0.52083333333333333))
    return pts


def _tracer_meta(tracer_names, nilyr, nslyr):
    """Static transported-tracer table (``init_transport:81-170``):
    (name, tracer_type, parent_row).  Rows ordered type-1-first (all
    independent tracers, then all parent-riding ones) so the
    reconstruction splits the stack with static contiguous slices:
    hi, hs, Tsfc, area tracers | volume/snow tracers, qice layers
    (depend on hi), qsno layers (depend on hs)."""
    meta = [("hi", 1, -1), ("hs", 1, -1), ("Tsfc", 1, -1)]
    for name in tracer_names:
        if TRACER_DEPEND[name] == 0:
            meta.append((name, 1, -1))
    for name in tracer_names:
        dep = TRACER_DEPEND[name]
        if dep != 0:
            meta.append((name, 2, 0 if dep == 1 else 1))
    for k in range(nilyr):
        meta.append((f"qi{k}", 2, 0))
    for k in range(nslyr):
        meta.append((f"qs{k}", 2, 1))
    return meta


def _n_type1(meta):
    """Length of the type-1 prefix (meta is ordered type-1-first)."""
    n1 = sum(1 for (_n, tt, _p) in meta if tt == 1)
    assert all(tt == 1 for (_n, tt, _p) in meta[:n1]) and \
        all(tt == 2 for (_n, tt, _p) in meta[n1:]), \
        "tracer meta must be ordered type-1-first"
    return n1


def _construct(mm, hm_real, tm, meta, sh):
    """Batched reconstruction for one category
    (``construct_fields:1069-1382``).  tm: (T, ny, nx) stacked tracers,
    ordered type-1-first (see `_tracer_meta`) so the stack splits with
    static slices (no gathers).

    Returns (mc, mx, my, tc, tx, ty) with tracer arrays stacked.
    """
    n1 = _n_type1(meta)
    par2 = [meta[k][2] for k in range(n1, len(meta))]

    mmask = (mm > cn.puny).astype(mm.dtype)
    zero = jnp.zeros_like(mm)
    mm9 = _shift9(mm, sh)
    hm9 = _shift9(hm_real, sh)
    mx, my = _limited_gradient_shifted(mm, mm9, hm9, hm_real, zero, zero)
    mc = mm
    safe_mm = jnp.maximum(mm, cn.puny)
    mxav = jnp.where(mmask > 0, mx / (12.0 * safe_mm), 0.0)
    myav = jnp.where(mmask > 0, my / (12.0 * safe_mm), 0.0)

    if not len(meta):
        e = tm[:0]
        return mc, mx, my, e, e, e

    tmask = (jnp.abs(tm) > 0.0).astype(mm.dtype) * mmask[None]

    # one set of 8 rolls serves every tracer gradient: the full stack
    # is shifted once, and shifted MASKS are derived from the shifted
    # fields (exact: open/closed ghost fill is 0, cyclic/tripole are
    # permutations, so mask(shift(f)) == shift(mask(f)))
    tm9 = _shift9(tm, sh)
    mmask9 = {off: (v > cn.puny).astype(mm.dtype)
              for off, v in mm9.items()}

    # type-1 tracers: batched gradient about the center of mass (the
    # 2-D mass mask/center broadcast against the stack)
    tm1 = tm[:n1]
    tm1_9 = {off: v[:n1] for off, v in tm9.items()}
    tx1, ty1 = _limited_gradient_shifted(tm1, tm1_9, mmask9, mmask,
                                         mxav, myav)
    tc1 = tm1 - tx1 * mxav[None] - ty1 * myav[None]

    # centers of mass*tracer for rows with dependents
    w2 = mc[None] * tx1 + mx[None] * tc1
    w3 = mc[None] * ty1 + my[None] * tc1
    denom = mm[None] * tm1
    good = (mmask[None] > 0) & (jnp.abs(tm1) > cn.puny)
    mtxav1 = jnp.where(good, w2 / (12.0 * jnp.where(jnp.abs(denom) > cn.puny,
                                                    denom, 1.0)), 0.0)
    mtyav1 = jnp.where(good, w3 / (12.0 * jnp.where(jnp.abs(denom) > cn.puny,
                                                    denom, 1.0)), 0.0)

    # type-2 tracers: batched gradient about parent's mass*tracer center
    if par2:
        tm2 = tm[n1:]
        tm2_9 = {off: v[n1:] for off, v in tm9.items()}
        pick = lambda s: jnp.stack([s[p] for p in par2])  # noqa: E731
        pmask = pick(tmask)
        pmask9 = {off: pick((jnp.abs(v) > 0.0).astype(mm.dtype))
                  * mmask9[off] for off, v in tm9.items()}
        pmx = pick(mtxav1)
        pmy = pick(mtyav1)
        tx2, ty2 = _limited_gradient_shifted(tm2, tm2_9, pmask9, pmask,
                                             pmx, pmy)
        tc2 = tm2 - tx2 * pmx - ty2 * pmy
        tc = jnp.concatenate([tc1, tc2], axis=0)
        tx = jnp.concatenate([tx1, tx2], axis=0)
        ty = jnp.concatenate([ty1, ty2], axis=0)
    else:
        tc, tx, ty = tc1, tx1, ty1
    return mc, mx, my, tc, tx, ty


# all 9 donor offsets a flux divergence can draw from (union of the
# 6 edge positions of both edges and their upstream-shifted twins)
ALL_OFFSETS = tuple((di, dj) for dj in (1, 0, -1) for di in (-1, 0, 1))


def _geom_moments(edge, afac, dx, dy, order, sh, edgearea=None):
    """Category-independent quadrature moments per donor position
    (``transport_integrals:3307-3632``, factored).

    Restructured from the reference, which
    folds the *mass* reconstruction into the triangle quadrature, so
    the moment planes had to be recomputed per category.  The mass and
    tracer reconstructions are linear, so the quadrature factorizes:
    accumulate the pure GEOMETRIC moments ``Σ_tri area·w·x^a y^b`` (all
    10 monomials up to cubic) per donor position ONCE, then each
    category's mass-weighted moments are 3-term contractions of these
    planes with its shifted mass coefficients.  Exact reassociation of
    the same quadrature sums.

    Returns {pos: [S1, Sx, Sy, Sxx, Sxy, Syy, Sxxx, Sxxy, Sxyy, Syyy]}.
    """
    geom = _edge_geometry(edge, afac, dx, dy, sh, edgearea)
    used = sorted({p for ps in GROUP_POSITIONS for p in ps})
    G = {p: [0.0] * 10 for p in used}
    for g in range(NGROUPS):
        lx, ly = geom["verts"][g]
        pos = geom["pos"][g]
        area = geom["triarea"][g]
        pts = _quad_points(lx, ly, order)
        mono = [0.0] * 10
        for (px, py, w) in pts:
            pxx, pxy, pyy = px * px, px * py, py * py
            for k, v in enumerate((w, w * px, w * py, w * pxx, w * pxy,
                                   w * pyy, w * pxx * px, w * pxx * py,
                                   w * pxy * py, w * pyy * py)):
                mono[k] = mono[k] + v
        for p in GROUP_POSITIONS[g]:
            ag = jnp.where(pos == p, area, 0.0)
            acc = G[p]
            for k in range(10):
                acc[k] = acc[k] + ag * mono[k]
    return G


def _mass_moments(edge, G, mc9, mx9, my9):
    """Mass-weighted quadrature moments per donor position for one
    category: W[p] = (Wm, Wx, Wy, Wxx, Wxy, Wyy) where
    ``W_ab = Σ_tri area·w·x^a y^b·(mc + x·mx + y·my)`` at the donor.
    mc9/mx9/my9: `_shift9` tables of the mass reconstruction planes.
    """
    W = {}
    for p, g in G.items():
        off = SHIFTS[edge][p]
        mc, mx, my = mc9[off], mx9[off], my9[off]
        W[p] = (g[0] * mc + g[1] * mx + g[2] * my,
                g[1] * mc + g[3] * mx + g[4] * my,
                g[2] * mc + g[4] * mx + g[5] * my,
                g[3] * mc + g[6] * mx + g[7] * my,
                g[4] * mc + g[7] * mx + g[8] * my,
                g[5] * mc + g[8] * mx + g[9] * my)
    return W


def _acc_divergence(A, W, edge, sh):
    """Fold one edge direction's moment planes into the per-donor-offset
    divergence accumulators.

    The flux divergence at cell c is ``mtf(c) - mtf(c-ê)`` summed over
    both edge directions; instead of materializing (and then shifting)
    the T-deep edge fluxes, each moment plane is scattered into A at
    its donor offset with +, and its west/south-shifted copy at
    ``offset - ê`` with −.  The tracer contraction then touches each
    shifted tracer stack exactly once.  Pure reassociation — each
    product W·coef still appears with + at one cell and − at its
    neighbor, so conservation is exact.
    """
    if edge == "east":
        back, bo = sh.w, (-1, 0)
    else:
        back, bo = sh.s, (0, -1)
    for p, w6 in W.items():
        d = SHIFTS[edge][p]
        g2 = (d[0] + bo[0], d[1] + bo[1])
        accp, accm = A[d], A[g2]
        for k in range(6):
            accp[k] = accp[k] + w6[k]
            accm[k] = accm[k] - back(w6[k])


def _flux_divergence(G_e, G_n, mc, mx, my, tc, tx, ty, meta, sh):
    """Mass and mass·tracer flux divergence (pre-1/tarea) for one
    category (``transport_integrals`` + the update differences of
    ``update_fields:3642-3868``, reassociated — see `_acc_divergence`).

    Returns (div, divt) with divt of shape (T, ny, nx).
    """
    T = len(meta)
    mc9 = _shift9(mc, sh)
    mx9 = _shift9(mx, sh)
    my9 = _shift9(my, sh)

    A = {off: [0.0] * 6 for off in ALL_OFFSETS}
    for edge, G in (("east", G_e), ("north", G_n)):
        _acc_divergence(A, _mass_moments(edge, G, mc9, mx9, my9), edge, sh)

    div = 0.0
    for off in ALL_OFFSETS:
        div = div + A[off][0]

    if not T:
        return div, jnp.zeros((0,) + mc.shape, mc.dtype)

    n1 = _n_type1(meta)
    par2 = [meta[k][2] for k in range(n1, T)]

    tc9 = _shift9(tc, sh)
    tx9 = _shift9(tx, sh)
    ty9 = _shift9(ty, sh)

    divt = 0.0
    for off in ALL_OFFSETS:
        wm, wx, wy, wxx, wxy, wyy = A[off]
        tcp, txp, typ = tc9[off], tx9[off], ty9[off]
        # type-1 rows: Σ area·(m·tc + mx·tx + my·ty) at the donor
        mts1 = (wm[None] * tcp[:n1] + wx[None] * txp[:n1]
                + wy[None] * typ[:n1])
        if par2:
            # type-2 rows ride on the parent: moments of m·t_parent
            pick = lambda s: jnp.stack([s[p] for p in par2])  # noqa: E731
            pc, px_, py_ = pick(tcp), pick(txp), pick(typ)
            g0 = wm[None] * pc + wx[None] * px_ + wy[None] * py_
            g1 = wx[None] * pc + wxx[None] * px_ + wxy[None] * py_
            g2 = wy[None] * pc + wxy[None] * px_ + wyy[None] * py_
            mts2 = g0 * tcp[n1:] + g1 * txp[n1:] + g2 * typ[n1:]
            mts = jnp.concatenate([mts1, mts2], axis=0)
        else:
            mts = mts1
        divt = divt + mts
    return div, divt


def _local_max_min(mm, tm, meta, sh):
    """Quasilocal tracer bounds before transport
    (``ice_transport_driver.F90 local_max_min:1230-1345`` +
    ``quasilocal_max_min:1360-1410``): per tracer, the min/max over the
    3x3 neighborhood (masked cells contribute the home value), then
    extended one more ring — remapping is monotone for the quasilocal
    bounds."""
    # mm: (ncat, ny, nx); tm: (ncat, T, ny, nx)
    aimask = (mm > cn.puny).astype(mm.dtype)[:, None]
    tmask = (jnp.abs(tm) > 0.0).astype(mm.dtype) * aimask
    # per-row mask: aimask for type-1, parent tracer mask for type-2
    par = jnp.asarray([max(p, 0) for (_n, _t, p) in meta])
    is2 = jnp.asarray([t == 2 for (_n, t, _p) in meta])[:, None, None]
    phimask = jnp.where(is2, tmask[:, par], aimask)

    m9 = _shift9(phimask, sh)
    p9 = _shift9(tm, sh)
    tmin = tm
    tmax = tm
    for off in ALL_OFFSETS:
        if off == (0, 0):
            continue
        v = m9[off] * p9[off] + (1.0 - m9[off]) * tm
        tmin = jnp.minimum(tmin, v)
        tmax = jnp.maximum(tmax, v)
    # quasilocal extension: one more ring of plain min/max
    lo9 = _shift9(tmin, sh)
    hi9 = _shift9(tmax, sh)
    for off in ALL_OFFSETS:
        tmin = jnp.minimum(tmin, lo9[off])
        tmax = jnp.maximum(tmax, hi9[off])
    return tmin, tmax


def _check_monotonicity(tmin, tmax, mm_new, tm_new, meta):
    """``check_monotonicity:1416-1559``: new tracer values must lie
    within the pre-transport quasilocal bounds.  Returns a guard
    record (see :mod:`cice4_tpu.guards`)."""
    from cice4_tpu.guards import record
    # mm_new: (ncat, ny, nx); tm_new/tmin/tmax: (ncat, T, ny, nx)
    par = jnp.asarray([max(p, 0) for (_n, _t, p) in meta])
    is2 = jnp.asarray([t == 2 for (_n, t, _p) in meta])[:, None, None]
    l_check = jnp.where(is2, jnp.abs(tm_new[:, par]) > cn.puny,
                        (mm_new > cn.puny)[:, None])
    # allow roundoff where |trm| is big; scale the reference's f64 puny
    # up for f32 state (division noise is ~1e-7 relative)
    eps = cn.puny if jnp.finfo(tm_new.dtype).bits >= 64 else 1.0e-4
    w1 = jnp.maximum(1.0, jnp.abs(tmin))
    w2 = jnp.maximum(1.0, jnp.abs(tmax))
    err = jnp.maximum(tmin - tm_new, tm_new - tmax)
    bad = l_check & ((tm_new < tmin - w1 * eps)
                     | (tm_new > tmax + w2 * eps))
    return record(bad, jnp.where(bad, err, 0.0))


def _check_global_conservation(masum0, masum1, mtsum0, mtsum1):
    """``global_conservation:1147-1218``: global sums of mass (per
    category + open water) and mass*tracer (per category, per tracer)
    must be unchanged by transport.  As in the reference, the final
    sums are taken MID-transport — after ``update_fields`` but before
    the clamping in ``tracers_to_state`` (driver ``:563-610`` runs the
    check on aim/trm before ``tracers_to_state:1012``).  Relative puny
    tolerance; the reference assumes float64 — in float32 the
    global-sum representation noise alone is ~1e-7 relative, so the
    threshold is lifted.  Returns a guard record (scalar; j/i are
    meaningless 0)."""
    eps = cn.puny if jnp.finfo(masum0.dtype).bits >= 64 else 1.0e-4
    rel_m = jnp.abs(masum1 - masum0) / jnp.maximum(masum0, cn.puny)
    bad_m = (masum0 > cn.puny) & (rel_m > eps)
    rel = jnp.abs(mtsum1 - mtsum0) / jnp.maximum(jnp.abs(mtsum0), cn.puny)
    bad_t = (jnp.abs(mtsum0) > cn.puny) & (rel > eps)
    worst = jnp.maximum(
        jnp.max(jnp.where(bad_t, rel, 0.0)),
        jnp.max(jnp.where(bad_m, rel_m, 0.0)))
    count = jnp.sum(bad_t) + jnp.sum(bad_m)
    zero = jnp.zeros((), jnp.int32)
    return dict(count=count.astype(jnp.int32), j=zero, i=zero, worst=worst)


def _departure_midpoint(uvel, vvel, dx, dy, dt, grid: Grid, bc):
    """Second-order departure points via corrected midpoint velocity
    (``departure_points:1673-1751``, l_dp_midpt = T).

    dx/dy are the scaled first-order displacements (-dt u / dxu); the
    returned displacements are scaled the same way.  The reference's
    quadrant branch (which of the four cells around the corner holds
    the trajectory midpoint) becomes a 4-way masked select; the
    bilinear velocity estimate uses the 8 neighboring U corners.
    """
    from cice4_tpu.constants import FieldLoc, FieldType
    kw = dict(loc=FieldLoc.NE_CORNER, ftype=FieldType.VECTOR)

    def nbrs(f):
        e = h.nbr_e(f, bc, **kw)
        w = h.nbr_w(f, bc, **kw)
        n = h.nbr_n(f, bc, **kw)
        s = h.nbr_s(f, bc, **kw)
        return dict(c=f, e=e, w=w, n=n, s=s,
                    ne=h.nbr_n(e, bc, **kw), nw=h.nbr_n(w, bc, **kw),
                    se=h.nbr_s(e, bc, **kw), sw=h.nbr_s(w, bc, **kw))

    u, v = nbrs(uvel), nbrs(vvel)
    mpx, mpy = 0.5 * dx, 0.5 * dy
    px, py = mpx >= 0.0, mpy >= 0.0

    def bilin(f, c00, c10, c11, c01, mpxt, mpyt):
        # f(i2-1,j2-1)*(x-.5)(y-.5) - f(i2,j2-1)*(x+.5)(y-.5)
        # + f(i2,j2)*(x+.5)(y+.5) - f(i2-1,j2)*(x-.5)(y+.5)
        return (f[c00] * (mpxt - 0.5) * (mpyt - 0.5)
                - f[c10] * (mpxt + 0.5) * (mpyt - 0.5)
                + f[c11] * (mpxt + 0.5) * (mpyt + 0.5)
                - f[c01] * (mpxt - 0.5) * (mpyt + 0.5))

    # quadrant corner names: (i2-1,j2-1), (i2,j2-1), (i2,j2), (i2-1,j2)
    quads = [
        (px & py, ("c", "e", "ne", "n"), mpx - 0.5, mpy - 0.5),    # NE cell
        (~px & ~py, ("sw", "s", "c", "w"), mpx + 0.5, mpy + 0.5),  # SW cell
        (px & ~py, ("s", "se", "e", "c"), mpx - 0.5, mpy + 0.5),   # SE cell
        (~px & py, ("w", "c", "n", "nw"), mpx + 0.5, mpy - 0.5),   # NW cell
    ]
    ump = jnp.zeros_like(uvel)
    vmp = jnp.zeros_like(vvel)
    for sel, (c00, c10, c11, c01), mpxt, mpyt in quads:
        ump = jnp.where(sel, bilin(u, c00, c10, c11, c01, mpxt, mpyt), ump)
        vmp = jnp.where(sel, bilin(v, c00, c10, c11, c01, mpxt, mpyt), vmp)

    moving = (uvel != 0.0) | (vvel != 0.0)
    dx_new = jnp.where(moving, -dt * ump / grid.dxu, dx)
    dy_new = jnp.where(moving, -dt * vmp / grid.dyu, dy)
    return dx_new, dy_new


def _update_category(mm, tm, div, divt, tmask_land, tarear, meta):
    """``update_fields:3642-3868`` for one category given the flux
    divergences: new mass/tracers + the unclamped mid-transport fields
    (for the reference's pre-``tracers_to_state`` conservation check).
    """
    n1 = _n_type1(meta)
    par2 = [meta[k][2] for k in range(n1, len(meta))]
    if not par2:
        pick = lambda s: s[:0]  # noqa: E731
    else:
        pick = lambda s: jnp.stack([s[p] for p in par2])  # noqa: E731

    mtold1 = mm[None] * tm[:n1]
    mtold2 = mm[None] * tm[n1:] * pick(tm)
    mtold = jnp.concatenate([mtold1, mtold2], axis=0)

    div = div * tarear
    mm_mid = mm - div
    mm_new = jnp.maximum(mm_mid, 0.0)
    mm_new = jnp.where(tmask_land, mm_new, 0.0)
    pos_m = mm_new > 0.0
    safe = jnp.maximum(mm_new, cn.puny)

    divt = divt * tarear[None]
    mt = mtold - divt
    t1 = jnp.where(pos_m[None], mt / safe[None], 0.0)
    # type-2: divide by (mm * parent); parents (hi, hs) are nonnegative
    pv = pick(t1)
    t2 = jnp.where(pos_m[None] & (pv > 0.0),
                   mt[n1:] / jnp.maximum(mm_new[None] * pv, cn.puny), 0.0)
    tm_new = jnp.concatenate([t1[:n1], t2], axis=0)
    return mm_new, tm_new, (mm_mid, mt)


def _remap_category(mm, tm, hm_real, tmask_land, tarear, G_e, G_n,
                    meta, sh, want_mid=False):
    """Advect one category: reconstruction, flux divergence, update.

    mm: (ny, nx) area; tm: (T, ny, nx) stacked tracers.  G_e/G_n: the
    shared geometric moment planes (`_geom_moments`).
    """
    mc, mx, my, tc, tx, ty = _construct(mm, hm_real, tm, meta, sh)
    div, divt = _flux_divergence(G_e, G_n, mc, mx, my, tc, tx, ty,
                                 meta, sh)
    mm_new, tm_new, mid = _update_category(mm, tm, div, divt,
                                           tmask_land, tarear, meta)
    if want_mid:
        return mm_new, tm_new, mid
    return mm_new, tm_new


def _geom_accumulators(afac, dx, dy, order, sh, ea_e=None, ea_n=None):
    """Category-independent divergence accumulators in geometric space:
    GA[off][k] for the 10 monomial moments, such that for any donor
    polynomial field f with monomial coefficients U_k,
    ``divergence(c) = Σ_off Σ_k GA_k[off](c) · U_k(c + off)``.

    This hoists `_acc_divergence`'s ± scatter (which `_flux_divergence`
    performs per category on mass-contracted planes) to the purely
    geometric moments — computed ONCE for all categories.
    """
    GA = {off: [0.0] * 10 for off in ALL_OFFSETS}
    for edge, ea in (("east", ea_e), ("north", ea_n)):
        G = _geom_moments(edge, afac, dx, dy, order, sh, ea)
        back, bo = (sh.w, (-1, 0)) if edge == "east" else (sh.s, (0, -1))
        for p, g10 in G.items():
            d = SHIFTS[edge][p]
            g2 = (d[0] + bo[0], d[1] + bo[1])
            for k in range(10):
                GA[d][k] = GA[d][k] + g10[k]
                GA[g2][k] = GA[g2][k] - back(g10[k])
    return GA


def _flux_divergence_ga(GSH, mc, mx, my, tc, tx, ty, meta, sh):
    """GA-factored flux divergence for one category.

    ``div(c) = Σ_off S_off( Σ_k S_-off(GA_k[off]) · U_k )(c)`` where
    GA are the category-INDEPENDENT geometric divergence accumulators
    (`_geom_accumulators`) and U_k the monomial coefficients of the
    donor-cell product polynomial (distributivity only, so the two
    paths agree to roundoff).  Vs `_flux_divergence` this removes the
    per-category
    mass-moment contraction and the 27 shifted tracer stacks: the
    back-shifted GA planes in `GSH` are computed once per step for all
    categories, and only the T+1 result planes are shifted per offset.
    """
    T = len(meta)
    n1 = _n_type1(meta)
    par2 = [meta[k][2] for k in range(n1, T)]
    c1_, x1_, y1_ = tc[:n1], tx[:n1], ty[:n1]
    if par2:
        pick = lambda s: jnp.stack([s[p] for p in par2])  # noqa: E731
        pc, px_, py_ = pick(tc), pick(tx), pick(ty)
        c2, x2, y2 = tc[n1:], tx[n1:], ty[n1:]
        mpc, mpx, mpy = mc * pc, mc * px_, mc * py_
        xpc, xpx, xpy = mx * pc, mx * px_, mx * py_
        ypc, ypx, ypy = my * pc, my * px_, my * py_

    div = 0.0
    divt = 0.0
    for off in ALL_OFFSETS:
        g0, g1, g2, g3, g4, g5, g6, g7, g8, g9 = GSH[off]
        p_mass = g0 * mc + g1 * mx + g2 * my
        div = div + _shift_by_jnp(sh, p_mass, off)
        if not T:
            continue
        p1 = (g0 * (mc * c1_) + g1 * (mc * x1_ + mx * c1_)
              + g2 * (mc * y1_ + my * c1_) + g3 * (mx * x1_)
              + g4 * (mx * y1_ + my * x1_) + g5 * (my * y1_))
        if par2:
            p2 = (g0 * (mpc * c2)
                  + g1 * (xpc * c2 + mpx * c2 + mpc * x2)
                  + g2 * (ypc * c2 + mpy * c2 + mpc * y2)
                  + g3 * (xpx * c2 + xpc * x2 + mpx * x2)
                  + g4 * (xpy * c2 + ypx * c2 + xpc * y2
                          + ypc * x2 + mpx * y2 + mpy * x2)
                  + g5 * (ypy * c2 + ypc * y2 + mpy * y2)
                  + g6 * (xpx * x2)
                  + g7 * (xpx * y2 + xpy * x2 + ypx * x2)
                  + g8 * (xpy * y2 + ypx * y2 + ypy * x2)
                  + g9 * (ypy * y2))
            p = jnp.concatenate([p1, p2], axis=0)
        else:
            p = p1
        divt = divt + _shift_by_jnp(sh, p, off)
    if not T:
        divt = jnp.zeros((0,) + mc.shape, mc.dtype)
    return div, divt


def _shift_by_jnp(sh, f, off):
    """Composite masked shift by offset (di, dj), x then y (the
    composition order of `_shift9`)."""
    di, dj = off
    if di == 1:
        f = sh.e(f)
    elif di == -1:
        f = sh.w(f)
    if dj == 1:
        f = sh.n(f)
    elif dj == -1:
        f = sh.s(f)
    return f


DIAGS = ((1, 1), (-1, 1), (1, -1), (-1, -1))


def _grad_stream(sh, phi, phimask, cnx, cny, sval, smask):
    """`_limited_gradient_shifted` in streaming form: neighbor planes
    are produced one offset at a time (sval/smask callables) and folded
    into running min/max, so no 9-offset table is ever live.  Same
    formulas — min/max folding is order-exact, and the gx/gy axis
    neighbors are the identical masked values.
    """
    def nb(off):
        m = smask(off)
        return m * sval(off) + (1.0 - m) * phi

    phi_e = nb((1, 0))
    phi_w = nb((-1, 0))
    phi_n = nb((0, 1))
    phi_s = nb((0, -1))

    gx = 0.5 * (phi_e - phi_w)
    gy = 0.5 * (phi_n - phi_s)

    pmn = jnp.minimum(jnp.minimum(phi_e, phi_w),
                      jnp.minimum(phi_n, phi_s))
    pmx = jnp.maximum(jnp.maximum(phi_e, phi_w),
                      jnp.maximum(phi_n, phi_s))
    pmn = jnp.minimum(pmn, phi)
    pmx = jnp.maximum(pmx, phi)
    for off in DIAGS:
        v = nb(off)
        pmn = jnp.minimum(pmn, v)
        pmx = jnp.maximum(pmx, v)
    pmn = pmn - phi
    pmx = pmx - phi

    w1 = (0.5 - cnx) * gx + (0.5 - cny) * gy
    w2 = (0.5 - cnx) * gx - (0.5 + cny) * gy
    w3 = -(0.5 + cnx) * gx - (0.5 + cny) * gy
    w4 = (0.5 - cny) * gy - (0.5 + cnx) * gx

    qmn = jnp.minimum(jnp.minimum(w1, w2), jnp.minimum(w3, w4))
    qmx = jnp.maximum(jnp.maximum(w1, w2), jnp.maximum(w3, w4))

    wa = jnp.where(jnp.abs(qmn) > 0.0,
                   jnp.maximum(0.0, pmn / jnp.where(qmn != 0.0, qmn, 1.0)),
                   1.0)
    wb = jnp.where(jnp.abs(qmx) > 0.0,
                   jnp.maximum(0.0, pmx / jnp.where(qmx != 0.0, qmx, 1.0)),
                   1.0)
    lim = jnp.minimum(1.0, jnp.minimum(wa, wb)) * phimask
    return lim * gx, lim * gy


def _construct_streaming(mm, hm_real, tm, meta, sh):
    """`_construct` with every neighbor shift produced on demand
    instead of via the 9-offset `_shift9` tables (which would hold 9
    copies of the T-deep stacks live): identical reconstruction (same
    masked-neighbor values, same limiter), the reassociation trick of
    the GA contraction applied to the reconstruction."""
    n1 = _n_type1(meta)
    T = len(meta)
    par2 = [meta[k][2] for k in range(n1, T)]

    def shift(f, off):
        return _shift_by_jnp(sh, f, off)

    mmask = (mm > cn.puny).astype(mm.dtype)
    zero = jnp.zeros_like(mm)
    mx, my = _grad_stream(
        sh, mm, hm_real, zero, zero,
        lambda off: shift(mm, off),
        lambda off: shift(hm_real, off))
    mc = mm
    safe_mm = jnp.maximum(mm, cn.puny)
    mxav = jnp.where(mmask > 0, mx / (12.0 * safe_mm), 0.0)
    myav = jnp.where(mmask > 0, my / (12.0 * safe_mm), 0.0)

    def mmask_sh(off):
        return (shift(mm, off) > cn.puny).astype(mm.dtype)

    # type-1 tracers
    tm1 = tm[:n1]
    tx1, ty1 = _grad_stream(
        sh, tm1, mmask, mxav, myav,
        lambda off: shift(tm1, off),
        lambda off: mmask_sh(off))
    tc1 = tm1 - tx1 * mxav[None] - ty1 * myav[None]

    w2 = mc[None] * tx1 + mx[None] * tc1
    w3 = mc[None] * ty1 + my[None] * tc1
    denom = mm[None] * tm1
    good = (mmask[None] > 0) & (jnp.abs(tm1) > cn.puny)
    mtxav1 = jnp.where(good, w2 / (12.0 * jnp.where(
        jnp.abs(denom) > cn.puny, denom, 1.0)), 0.0)
    mtyav1 = jnp.where(good, w3 / (12.0 * jnp.where(
        jnp.abs(denom) > cn.puny, denom, 1.0)), 0.0)

    if par2:
        tm2 = tm[n1:]
        tmask1 = (jnp.abs(tm1) > 0.0).astype(mm.dtype) * mmask[None]
        pick = lambda s: jnp.stack([s[p] for p in par2])  # noqa: E731
        pmask = pick(tmask1)
        parstack = pick(tm1)
        pmx_, pmy_ = pick(mtxav1), pick(mtyav1)
        tx2, ty2 = _grad_stream(
            sh, tm2, pmask, pmx_, pmy_,
            lambda off: shift(tm2, off),
            lambda off: ((jnp.abs(shift(parstack, off)) > 0.0)
                         .astype(mm.dtype) * mmask_sh(off)))
        tc2 = tm2 - tx2 * pmx_ - ty2 * pmy_
        tc = jnp.concatenate([tc1, tc2], axis=0)
        tx = jnp.concatenate([tx1, tx2], axis=0)
        ty = jnp.concatenate([ty1, ty2], axis=0)
    else:
        tc, tx, ty = tc1, tx1, ty1
    return mc, mx, my, tc, tx, ty


def transport_remap(state: State, grid: Grid, dt,
                    integral_order: int = 2, dp_midpt: bool = False,
                    fixed_area: bool = False,
                    conservation_check: bool = False,
                    monotonicity_check: bool = False):
    """Full incremental-remapping advection of the ice state.

    Returns (state, aice0) — the advected open-water fraction feeds the
    ridging opening/closing rates — plus a guard-record dict as a third
    element when `conservation_check` or `monotonicity_check` is set
    (``ice_transport_driver.F90:596-648``).
    """
    bc = grid.bc
    sh = JnpShift(bc)
    ncat = state.ncat
    nilyr = state.eicen.shape[1]
    nslyr = state.esnon.shape[1]
    tracer_names = list(state.trcrn.keys())
    meta = _tracer_meta(tracer_names, nilyr, nslyr)

    # scaled departure displacements at U corners (departure_points)
    dx = -dt * state.uvel / grid.dxu
    dy = -dt * state.vvel / grid.dyu
    if dp_midpt:
        dx, dy = _departure_midpoint(state.uvel, state.vvel, dx, dy, dt,
                                     grid, bc)

    if fixed_area:
        # l_fixed_area = T: prescribe the signed area flux across each
        # edge from the edge-mean normal velocity
        # (``ice_transport_driver.F90:474-509``)
        kw = dict(loc=FieldLoc.NE_CORNER, ftype=FieldType.VECTOR)
        ea_e = (state.uvel + h.nbr_s(state.uvel, bc, **kw)) \
            * 0.5 * grid.hte * dt
        ea_n = (state.vvel + h.nbr_w(state.vvel, bc, **kw)) \
            * 0.5 * grid.htn * dt
    else:
        ea_e = ea_n = None

    afac = grid.dxu * grid.dyu

    # --- state_to_tracers (driver ":847-1003") -----------------------------
    aice0 = jnp.maximum(1.0 - jnp.sum(state.aicen, 0), 0.0)
    has = state.aicen > cn.puny
    a_s = jnp.maximum(state.aicen, cn.puny)
    v_s = jnp.maximum(state.vicen, cn.puny)
    vs_s = jnp.maximum(state.vsnon, cn.puny)
    hi = jnp.where(has, state.vicen / a_s, 0.0)
    hs = jnp.where(has, state.vsnon / a_s, 0.0)

    src = {"hi": hi, "hs": hs, "Tsfc": jnp.where(has, state.tsfcn, 0.0)}
    for name in tracer_names:
        src[name] = jnp.where(has, state.trcrn[name], 0.0)
    for k in range(nilyr):
        src[f"qi{k}"] = jnp.where(has, state.eicen[:, k] / v_s, 0.0)
    for k in range(nslyr):
        qs = state.esnon[:, k] / vs_s + cn.rhos * cn.Lfresh
        src[f"qs{k}"] = jnp.where(has & (hs > cn.puny), qs, 0.0)
    tm = jnp.stack([src[name] for (name, _t, _p) in meta],
                   axis=1)               # (ncat, T, ny, nx)

    empty = jnp.zeros((0,) + aice0.shape, aice0.dtype)
    # GA-factored contraction (the default): category-independent
    # geometry accumulators, back-shifted once for all categories;
    # agrees with the legacy per-category contraction to roundoff.
    # CICE4_REMAP_GA=0 selects the legacy path.
    import os as _os
    if _os.environ.get("CICE4_REMAP_GA", "1") != "0":
        GA = _geom_accumulators(afac, dx, dy, integral_order,
                                sh, ea_e, ea_n)
        zero = jnp.zeros_like(afac)
        # back-shift each offset's 10 moment planes as ONE stacked
        # shift (9 stacked shifts instead of 90 separate pad/mask ops)
        GSH = {}
        for off in ALL_OFFSETS:
            st = jnp.stack([GA[off][k] + zero for k in range(10)])
            st = _shift_by_jnp(sh, st, (-off[0], -off[1]))
            GSH[off] = [st[k] for k in range(10)]

        def _cat_ga(mmn, tmn):
            mcn, mxn, myn, tcn, txn, tyn = _construct_streaming(
                mmn, grid.hm, tmn, list(meta), sh)
            dv, dvt = _flux_divergence_ga(GSH, mcn, mxn, myn,
                                          tcn, txn, tyn, meta, sh)
            return _update_category(mmn, tmn, dv, dvt, grid.tmask,
                                    grid.tarear, meta)

        mc0, mx0, my0, *_ = _construct_streaming(aice0, grid.hm, empty,
                                                 [], sh)
        div0, _ = _flux_divergence_ga(GSH, mc0, mx0, my0,
                                      empty, empty, empty, [], sh)
        mm_new, tm_new, (mm_mid, mt_mid) = jax.vmap(_cat_ga)(
            state.aicen, tm)
    else:
        G_e = _geom_moments("east", afac, dx, dy, integral_order,
                            sh, ea_e)
        G_n = _geom_moments("north", afac, dx, dy, integral_order,
                            sh, ea_n)

        # advect open water (mass only); feeds ridging
        mc0, mx0, my0, _tc, _tx, _ty = _construct(
            aice0, grid.hm, empty, [], sh)
        div0, _ = _flux_divergence(G_e, G_n, mc0, mx0, my0,
                                   empty, empty, empty, [], sh)

        out = jax.vmap(
            lambda mmn, tmn: _remap_category(
                mmn, tmn, grid.hm, grid.tmask, grid.tarear,
                G_e, G_n, meta, sh, want_mid=True)
        )(state.aicen, tm)
        mm_new, tm_new, (mm_mid, mt_mid) = out

    aice0_mid = aice0 - div0 * grid.tarear
    aice0_new = jnp.where(grid.tmask, jnp.maximum(aice0_mid, 0.0), 0.0)

    guards = {}
    if monotonicity_check:
        tmin, tmax = _local_max_min(state.aicen, tm, meta, sh)
        guards["transport monotonicity"] = _check_monotonicity(
            tmin, tmax, mm_new, tm_new, meta)
    if conservation_check:
        # per-category mass (open water = row 0, as the reference's
        # asum(0)) and per-(category, tracer) mass*tracer sums; final
        # sums mid-transport, pre-clamp (driver ":563-610")
        ta = grid.tarea
        masum0 = jnp.concatenate(
            [jnp.sum(aice0 * ta)[None],
             jnp.sum(state.aicen * ta, axis=(1, 2))])
        masum1 = jnp.concatenate(
            [jnp.sum(aice0_mid * ta)[None],
             jnp.sum(mm_mid * ta, axis=(1, 2))])
        par = jnp.asarray([max(p, 0) for (_n, _t, p) in meta])
        is2 = jnp.asarray([1.0 if t == 2 else 0.0
                           for (_n, t, _p) in meta])[:, None, None]
        mt0 = state.aicen[:, None] * tm * jnp.where(is2 > 0, tm[:, par], 1.0)
        mtsum0 = jnp.sum(mt0 * ta, axis=(2, 3))
        mtsum1 = jnp.sum(mt_mid * ta, axis=(2, 3))
        guards["transport global conservation"] = \
            _check_global_conservation(masum0, masum1, mtsum0, mtsum1)

    # --- tracers_to_state (driver ":1012-1137") ----------------------------
    a = mm_new
    pos_m = a > 0.0
    row = {name: i for i, (name, _t, _p) in enumerate(meta)}
    hi_n = jnp.maximum(tm_new[:, row["hi"]], 0.0)
    hs_n = jnp.maximum(tm_new[:, row["hs"]], 0.0)
    tsfcn = jnp.where(pos_m, tm_new[:, row["Tsfc"]], cn.Tocnfrz)
    trcrn = {}
    for name in tracer_names:
        trcrn[name] = tm_new[:, row[name]]
    eicen = jnp.stack(
        [jnp.minimum(tm_new[:, row[f"qi{k}"]], 0.0) * a * hi_n
         for k in range(nilyr)], axis=1)
    esnon = jnp.stack(
        [jnp.minimum(tm_new[:, row[f"qs{k}"]] - cn.rhos * cn.Lfresh, 0.0)
         * a * hs_n for k in range(nslyr)], axis=1)

    state = state.replace(aicen=a, vicen=a * hi_n, vsnon=a * hs_n,
                          tsfcn=tsfcn, eicen=eicen, esnon=esnon,
                          trcrn=trcrn)
    if conservation_check or monotonicity_check:
        return state, aice0_new, guards
    return state, aice0_new


def remap_sharded_eligible(grid, mesh, transport_cfg=None) -> bool:
    """k-halo sharded remap eligibility: active multi-device mesh,
    divisible blocks tall/wide enough for the 6-ring halo, non-tripole
    (the global path folds intermediate reconstruction planes, which
    redundant ghost computation does not reproduce), and no global
    conservation/monotonicity checks (they need global reductions)."""
    import os
    if os.environ.get("CICE4_NO_SHARDED_REMAP"):
        return False
    if mesh is None:
        return False
    py, px = mesh.devices.shape
    if py * px <= 1:
        return False
    if grid.bc.ns in ("tripole", "tripoleT"):
        return False
    if transport_cfg is not None and (transport_cfg.conservation_check
                                      or transport_cfg.monotonicity_check):
        return False
    H = 6
    return (grid.ny % py == 0 and grid.nx % px == 0
            and grid.ny // py >= H and grid.nx // px >= H)


def transport_remap_sharded(state: State, grid: Grid, dt, mesh,
                            integral_order: int = 2,
                            dp_midpt: bool = False,
                            fixed_area: bool = False):
    """k-halo shard_map wrapper around `transport_remap`: ONE batched
    halo exchange of every remap input (≈70 planes as a single stack,
    4 collective-permutes), then the ENTIRE remap pipeline runs on
    locally padded blocks with redundant computation in the 6-wide
    ghost zone — the reference's 8 per-field `ice_HaloUpdate`s
    (``ice_transport_remap.F90:677-695``) and GSPMD's ~50 per-roll
    permutes collapse into one aggregated exchange.  Bit-exact vs the
    global path (ghost values equal global neighbor values, so every
    cell sees identical arithmetic).

    The full ring budget is 4 (geometry 2 + GSH 1 + divergence shift
    1) plus 1 each for the optional departure-midpoint correction and
    fixed-area edge velocities; H=6 covers all modes.
    """
    from cice4_tpu.ops.evp_sharded import _exchange

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    H = 6
    py, px = mesh.devices.shape
    ew_cyclic = grid.bc.ew == "cyclic"
    ns_cyclic = grid.bc.ns == "cyclic"
    dtype = state.aicen.dtype
    tracer_names = list(state.trcrn.keys())

    # spatial planes consumed by the remap, flattened to (P, ny, nx)
    fields = dict(
        aicen=state.aicen, vicen=state.vicen, vsnon=state.vsnon,
        eicen=state.eicen, esnon=state.esnon, tsfcn=state.tsfcn,
        uvel=state.uvel[None], vvel=state.vvel[None],
        dxu=grid.dxu[None], dyu=grid.dyu[None], hm=grid.hm[None],
        tmask=grid.tmask.astype(dtype)[None],
        tarear=grid.tarear[None], hte=grid.hte[None],
        htn=grid.htn[None],
        **{f"trc_{n}": state.trcrn[n] for n in tracer_names},
    )
    shapes = {k: v.shape for k, v in fields.items()}
    splits = {}
    off = 0
    for k, v in fields.items():
        n = 1
        for d in v.shape[:-2]:
            n *= int(d)
        splits[k] = (off, off + n)
        off += n
    stack = jnp.concatenate(
        [v.reshape((-1,) + v.shape[-2:]).astype(dtype)
         for v in fields.values()], axis=0)

    from cice4_tpu.parallel.halo import BoundaryConditions
    from types import SimpleNamespace
    bc_local = BoundaryConditions(ew="cyclic", ns="cyclic")

    def run(stack):
        xi = jax.lax.axis_index("x")
        yi = jax.lax.axis_index("y")
        a = jnp.pad(stack, ((0, 0), (H, H), (H, H)))
        a = _exchange(a, H, px, py, ew_cyclic, ns_cyclic, xi, yi)

        def take(name):
            lo, hi = splits[name]
            v = a[lo:hi]
            lead = shapes[name][:-2]
            byp, bxp = v.shape[-2:]
            if len(lead) == 1 and lead[0] == 1:
                return v[0]
            return v.reshape(tuple(lead) + (byp, bxp))

        hm = take("hm")
        zero = jnp.zeros_like(hm)
        z4 = jnp.zeros((4,) + hm.shape, dtype)
        gridlike = SimpleNamespace(
            bc=bc_local, dxu=take("dxu"), dyu=take("dyu"),
            hm=hm, tmask=take("tmask") > 0.5,
            tarear=take("tarear"), hte=take("hte"), htn=take("htn"),
            ny=hm.shape[-2], nx=hm.shape[-1])
        # untouched State fields are harmless block-local dummies (the
        # remap never reads them; outputs come from the remapped set)
        st = State(
            aicen=take("aicen"), vicen=take("vicen"),
            vsnon=take("vsnon"), eicen=take("eicen"),
            esnon=take("esnon"), tsfcn=take("tsfcn"),
            trcrn={n: take(f"trc_{n}") for n in tracer_names},
            uvel=take("uvel"), vvel=take("vvel"),
            stressp=z4, stressm=z4, stress12=z4,
            iceumask=hm > 2.0, sst=zero, frzmlt=zero,
            scale_factor=zero, strocnxT=zero, strocnyT=zero,
        )
        out, aice0 = transport_remap(
            st, gridlike, dt, integral_order, dp_midpt, fixed_area)
        core = lambda v: v[..., H:-H, H:-H]  # noqa: E731
        return (core(out.aicen), core(out.vicen), core(out.vsnon),
                core(out.eicen), core(out.esnon), core(out.tsfcn),
                tuple(core(out.trcrn[n]) for n in tracer_names),
                core(aice0))

    s2 = P(None, "y", "x")
    s3 = P(None, None, "y", "x")
    outspec = (s2, s2, s2, s3, s3, s2,
               tuple(s2 for _ in tracer_names), P("y", "x"))
    fn = shard_map(run, mesh=mesh, in_specs=(s2,), out_specs=outspec)
    (aicen, vicen, vsnon, eicen, esnon, tsfcn, trc,
     aice0) = fn(stack)
    state = state.replace(
        aicen=aicen, vicen=vicen, vsnon=vsnon, eicen=eicen,
        esnon=esnon, tsfcn=tsfcn,
        trcrn=dict(zip(tracer_names, trc)))
    return state, aice0
