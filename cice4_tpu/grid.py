"""Model grid: geometry, metrics, masks, and staggered-grid transforms.

JAX reworking of ``source/ice_grid.F90``.  Differences from the
reference:

* no block decomposition and no ghost cells — every field is a dense
  global ``(ny, nx)`` array (the reference's ``(i, j)`` with i fastest
  maps to our ``(y, x)`` with x as the minor, contiguous axis);
* all metric derivation happens once at init in NumPy float64 (matching
  the reference's global-array computation in ``popgrid`` /
  ``primary_grid_lengths_HTN/HTE``, ``ice_grid.F90:1139-1296``), then is
  cast to the compute dtype and shipped to device;
* the Grid object is a registered JAX pytree so it can be passed through
  `jit` boundaries and sharded like any other argument.

Grid conventions (B-grid, ``ice_transport_remap.F90:73-75``): scalars at
T points (cell centers), velocities at U points (NE cell corners).
``ulat[j, i]`` is the U point at the NE corner of T cell ``(j, i)``.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from cice4_tpu import constants as cn
from cice4_tpu.config import Config
from cice4_tpu.parallel.halo import BoundaryConditions


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "ulat", "ulon", "tlat", "tlon", "angle", "anglet",
        "htn", "hte", "dxt", "dyt", "dxu", "dyu",
        "tarea", "uarea", "tarear", "uarear", "tinyarea",
        "dxhy", "dyhx", "cyp", "cxp", "cym", "cxm",
        "hm", "uvm", "tmask", "umask",
        "lmask_n", "lmask_s", "tarean", "tareas", "fcor",
    ],
    meta_fields=["bc", "nx", "ny"],
)
@dataclasses.dataclass(frozen=True)
class Grid:
    """All grid geometry (cf. ``ice_grid.F90:60-135``). Arrays are (ny, nx)."""

    # geometry
    ulat: jax.Array     # latitude of U points (rad)
    ulon: jax.Array     # longitude of U points (rad)
    tlat: jax.Array     # latitude of T points (rad)
    tlon: jax.Array     # longitude of T points (rad)
    angle: jax.Array    # angle grid-x vs east at U points (rad)
    anglet: jax.Array   # angle at T points (rad)
    # metrics
    htn: jax.Array      # north cell-face width (m)
    hte: jax.Array      # east cell-face width (m)
    dxt: jax.Array      # x spacing centered at T (m)
    dyt: jax.Array
    dxu: jax.Array      # x spacing centered at U (m)
    dyu: jax.Array
    tarea: jax.Array    # T-cell area (m^2)
    uarea: jax.Array
    tarear: jax.Array   # reciprocal areas (0 where area 0)
    uarear: jax.Array
    tinyarea: jax.Array  # puny * tarea
    # EVP stencil coefficients (ice_grid.F90:79-85, init_grid2:263-365)
    dxhy: jax.Array     # 0.5*(HTE - HTE_w)
    dyhx: jax.Array     # 0.5*(HTN - HTN_s)
    cyp: jax.Array      # 1.5*HTE - 0.5*HTE_w
    cxp: jax.Array      # 1.5*HTN - 0.5*HTN_s
    cym: jax.Array      # -(1.5*HTE_w - 0.5*HTE)
    cxm: jax.Array      # -(1.5*HTN_s - 0.5*HTN)
    # masks
    hm: jax.Array       # land/ocean mask at T (1. ocean / 0. land)
    uvm: jax.Array      # mask at U
    tmask: jax.Array    # bool hm > 0.5
    umask: jax.Array    # bool uvm > 0.5
    lmask_n: jax.Array  # northern-hemisphere mask (bool)
    lmask_s: jax.Array
    tarean: jax.Array   # tarea * hm, N hemisphere only (m^2)
    tareas: jax.Array
    fcor: jax.Array     # Coriolis parameter at U points (1/s)
    # metadata (static)
    bc: BoundaryConditions
    nx: int
    ny: int

    @property
    def shape(self):
        return (self.ny, self.nx)

    def astype(self, dtype):
        float_cast = lambda a: (a.astype(dtype)
                                if jnp.issubdtype(a.dtype, jnp.floating) else a)
        return jax.tree_util.tree_map(float_cast, self)


# ---------------------------------------------------------------------------
# NumPy helpers for global-grid derivation (init-time only)
# ---------------------------------------------------------------------------


def _roll_e(a):  # value of east neighbor, cyclic
    return np.roll(a, -1, axis=-1)


def _roll_w(a):
    return np.roll(a, 1, axis=-1)


def _shift_s(a, fill=0.0):  # value of south neighbor; row 0 gets `fill`
    out = np.roll(a, 1, axis=-2)
    out[..., 0, :] = fill
    return out


def _shift_n(a, fill=0.0):
    out = np.roll(a, -1, axis=-2)
    out[..., -1, :] = fill
    return out


def _pad_south_extrapolate(a):
    """Row "-1" by linear extrapolation (ice_HaloExtrapolate analogue)."""
    return 2.0 * a[0, :] - a[1, :]


def _derive_metrics(htn, hte, ulat, ulon, angle, hm, bc: BoundaryConditions):
    """Global metric derivation; mirrors primary_grid_lengths_HTN/HTE +
    init_grid2 + makemask + Tlatlon (``ice_grid.F90:263-487,1139-1296,
    1298-1531``) on the full (ny, nx) grid in f64."""
    ny, nx = htn.shape

    # --- primary lengths (EW assumed cyclic as in the reference) -----------
    dxu = 0.5 * (htn + _roll_e(htn))
    dxt = 0.5 * (htn + _shift_s(htn))
    dxt[0, :] = 2.0 * htn[1, :] - htn[2, :]          # extrapolate row 0
    dyu = 0.5 * (hte + _shift_n(hte))
    dyu[-1, :] = 2.0 * hte[-2, :] - hte[-3, :]       # extrapolate top row
    dyt = 0.5 * (hte + _roll_w(hte))

    tarea = dxt * dyt
    uarea = dxu * dyu
    with np.errstate(divide="ignore"):
        tarear = np.where(tarea > 0, 1.0 / np.where(tarea > 0, tarea, 1.0), 0.0)
        uarear = np.where(uarea > 0, 1.0 / np.where(uarea > 0, uarea, 1.0), 0.0)
    tinyarea = cn.puny * tarea

    # --- EVP stencil coefficients ------------------------------------------
    hte_w = _roll_w(hte)
    htn_s = _shift_s(htn)
    htn_s[0, :] = htn[0, :]   # south ghost: clamp (land row anyway)
    dxhy = 0.5 * (hte - hte_w)
    dyhx = 0.5 * (htn - htn_s)
    cyp = 1.5 * hte - 0.5 * hte_w
    cxp = 1.5 * htn - 0.5 * htn_s
    cym = -(1.5 * hte_w - 0.5 * hte)
    cxm = -(1.5 * htn_s - 0.5 * htn)

    # --- ANGLET: 4-corner average with branch-cut handling ------------------
    a0 = angle
    aw = _roll_w(angle)
    a_s = _shift_s(angle)
    asw = _shift_s(_roll_w(angle))

    def _adjust(nbr):
        return np.where((a0 < 0.0) & (np.abs(nbr - a0) > np.pi),
                        nbr - 2.0 * np.pi, nbr)

    anglet = 0.25 * (a0 + _adjust(aw) + _adjust(a_s) + _adjust(asw))

    # --- TLAT/TLON: mean of 4 corner unit vectors ---------------------------
    ulat_pad = np.concatenate([_pad_south_extrapolate(ulat)[None], ulat], 0)
    ulon_pad = np.concatenate([_pad_south_extrapolate(ulon)[None], ulon], 0)

    z = np.sin(ulat_pad)
    c = np.cos(ulat_pad)
    x = np.cos(ulon_pad) * c
    y = np.sin(ulon_pad) * c
    # corners of T cell (j,i): U(j-1,i-1), U(j-1,i), U(j,i-1), U(j,i)
    def corner_mean(v):
        return 0.25 * (_roll_w(v[:-1]) + v[:-1] + _roll_w(v[1:]) + v[1:])

    tx, ty, tz = corner_mean(x), corner_mean(y), corner_mean(z)
    da = np.sqrt(tx**2 + ty**2 + tz**2)
    tlon = np.where((tx != 0) | (ty != 0), np.arctan2(ty, tx), 0.0)
    tlat = np.arcsin(np.clip(tz / np.where(da > 0, da, 1.0), -1.0, 1.0))

    # --- masks (makemask, ice_grid.F90:1298-1399) ---------------------------
    hm = np.where(hm >= 1.0, 1.0, 0.0)
    hm_e = _roll_e(hm)
    hm_n = _shift_n(hm)
    hm_ne = _shift_n(_roll_e(hm))
    uvm = np.minimum(np.minimum(hm, hm_e), np.minimum(hm_n, hm_ne))
    tmask = hm > 0.5
    umask = uvm > 0.5
    lmask_n = ulat >= -cn.puny
    lmask_s = ulat < -cn.puny
    tarean = np.where(lmask_n, tarea * hm, 0.0)
    tareas = np.where(lmask_s, tarea * hm, 0.0)

    fcor = 2.0 * cn.omega * np.sin(ulat)

    return dict(
        ulat=ulat, ulon=ulon, tlat=tlat, tlon=tlon, angle=angle,
        anglet=anglet, htn=htn, hte=hte, dxt=dxt, dyt=dyt, dxu=dxu, dyu=dyu,
        tarea=tarea, uarea=uarea, tarear=tarear, uarear=uarear,
        tinyarea=tinyarea, dxhy=dxhy, dyhx=dyhx, cyp=cyp, cxp=cxp, cym=cym,
        cxm=cxm, hm=hm, uvm=uvm, tmask=tmask, umask=umask,
        lmask_n=lmask_n, lmask_s=lmask_s, tarean=tarean, tareas=tareas,
        fcor=fcor,
    )


def _make_grid(fields: dict, bc: BoundaryConditions, dtype) -> Grid:
    ny, nx = fields["htn"].shape
    out = {}
    for k, v in fields.items():
        arr = np.asarray(v)
        if arr.dtype.kind == "f":
            arr = arr.astype(dtype)
        out[k] = jnp.asarray(arr)
    return Grid(bc=bc, nx=nx, ny=ny, **out)


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


def load_pop_grid(grid_file: str, kmt_file: str, nx: int, ny: int,
                  bc: BoundaryConditions, dtype=jnp.float32) -> Grid:
    """Read a POP displaced-pole/tripole binary grid.

    Format (``ice_grid.F90 popgrid:497-607``): 7 big-endian float64
    records of (ny, nx) — ULAT (rad), ULON (rad), HTN (cm), HTE (cm),
    HUS (cm), HUW (cm), ANGLE (rad); KMT is one big-endian int32 record.
    """
    raw = np.fromfile(grid_file, dtype=">f8", count=7 * nx * ny)
    recs = raw.reshape(7, ny, nx).astype(np.float64)
    ulat, ulon, htn, hte, _hus, _huw, angle = recs
    htn = htn * cn.cm_to_m
    hte = hte * cn.cm_to_m
    kmt = np.fromfile(kmt_file, dtype=">i4", count=nx * ny).reshape(ny, nx)
    hm = (kmt >= 1).astype(np.float64)
    fields = _derive_metrics(htn, hte, ulat, ulon, angle, hm, bc)
    return _make_grid(fields, bc, dtype)


def load_panarctic_grid(grid_file: str, nx: int, ny: int,
                        bc: BoundaryConditions,
                        dtype=jnp.float32) -> Grid:
    """Read the pan-Arctic (PIPS rotated-spherical) regional grid
    (``ice_grid.F90 panarctic_grid:848-967``).

    Single big-endian float64 file, 8 records of (ny, nx):
    KMT (land mask, in-file — no separate kmt file), ULAT (rad),
    ULON (rad), HTN (cm), HTE (cm), HUS (cm), HUW (cm), ANGLE (rad).
    Regional: open boundaries on all sides (pair with
    ``ice_restoring`` via ``forcing.restore_ice``).
    """
    raw = np.fromfile(grid_file, dtype=">f8", count=8 * nx * ny)
    recs = raw.reshape(8, ny, nx).astype(np.float64)
    kmt, ulat, ulon, htn, hte, _hus, _huw, angle = recs
    hm = np.minimum(kmt, 1.0)
    hm = np.where(hm >= 1.0, 1.0, 0.0)
    htn = htn * cn.cm_to_m
    hte = hte * cn.cm_to_m
    fields = _derive_metrics(htn, hte, ulat, ulon, angle, hm, bc)
    return _make_grid(fields, bc, dtype)


def make_rect_grid(nx: int, ny: int, bc: BoundaryConditions,
                   dx: float = 30.0e3, dy: float = 30.0e3,
                   lat_origin: float = 71.35, lon_origin: float = -156.5,
                   land_edges: bool = True, dtype=jnp.float32) -> Grid:
    """Uniform rectangular grid (``ice_grid.F90 rectgrid:976-1130``).

    Default placement mirrors the reference's "Barrow AK" corner.  With
    ``land_edges`` the top and bottom two rows are land (the reference's
    cyclic-EW mask); otherwise the domain is all ocean.
    """
    dlon = dx / cn.radius * cn.rad_to_deg
    dlat = dy / cn.radius * cn.rad_to_deg
    ulon = np.deg2rad(lon_origin + dlon * np.arange(nx))[None, :] * np.ones((ny, 1))
    ulat = np.deg2rad(lat_origin + dlat * np.arange(ny))[:, None] * np.ones((1, nx))
    htn = np.full((ny, nx), dx, dtype=np.float64)
    hte = np.full((ny, nx), dy, dtype=np.float64)
    angle = np.zeros((ny, nx))
    hm = np.ones((ny, nx))
    if land_edges:
        hm[:2, :] = 0.0
        hm[-2:, :] = 0.0
    fields = _derive_metrics(htn, hte, ulat, ulon, angle, hm, bc)
    return _make_grid(fields, bc, dtype)


def load_pop_grid_nc(grid_file: str, kmt_file: str,
                     bc: BoundaryConditions, dtype=jnp.float32) -> Grid:
    """Read a POP grid from netCDF (``ice_grid.F90 popgrid_nc:617-839``):
    variables ulat/ulon (rad), htn/hte (cm), angle (rad); kmt int."""
    from scipy.io import netcdf_file

    with netcdf_file(grid_file, "r", mmap=False) as f:
        ulat = np.array(f.variables["ulat"][:], dtype=np.float64)
        ulon = np.array(f.variables["ulon"][:], dtype=np.float64)
        htn = np.array(f.variables["htn"][:], dtype=np.float64) * cn.cm_to_m
        hte = np.array(f.variables["hte"][:], dtype=np.float64) * cn.cm_to_m
        angle = np.array(f.variables["angle"][:], dtype=np.float64)
    with netcdf_file(kmt_file, "r", mmap=False) as f:
        kmt = np.array(f.variables["kmt"][:])
    hm = (kmt >= 1).astype(np.float64)
    fields = _derive_metrics(htn, hte, ulat, ulon, angle, hm, bc)
    return _make_grid(fields, bc, dtype)


def make_latlon_grid(nx: int, ny: int, bc: BoundaryConditions,
                     kmt_file: str | None = None,
                     lat_south: float = -79.0, lat_north: float = 89.0,
                     dtype=jnp.float32) -> Grid:
    """Regular spherical latitude-longitude global grid.

    Used for production-scale configurations whose true curvilinear
    grid file is not distributed (the reference ships only the gx1 land
    mask, ``input_templates/gx1/global_gx1.kmt``): spherical metrics
    HTN = R cos(lat) dlon, HTE = R dlat, with the real KMT mask when
    given.  EW must be cyclic; the north cap row should be land.
    """
    dlon = 2.0 * np.pi / nx
    lats = np.deg2rad(np.linspace(lat_south, lat_north, ny))
    dlat = lats[1] - lats[0]
    ulat = np.broadcast_to(lats[:, None], (ny, nx)).copy()
    lons = -np.pi + dlon * np.arange(1, nx + 1)
    ulon = np.broadcast_to(lons[None, :], (ny, nx)).copy()
    htn = cn.radius * np.cos(ulat - 0.5 * dlat) * dlon  # T-row north face
    hte = np.full((ny, nx), cn.radius * dlat)
    angle = np.zeros((ny, nx))
    if kmt_file:
        kmt = np.fromfile(kmt_file, dtype=">i4",
                          count=nx * ny).reshape(ny, nx)
        hm = (kmt >= 1).astype(np.float64)
    else:
        hm = np.ones((ny, nx))
        hm[:1] = 0.0
        hm[-1:] = 0.0
    fields = _derive_metrics(htn, hte, ulat, ulon, angle, hm, bc)
    return _make_grid(fields, bc, dtype)


def make_grid(cfg: Config, dtype=jnp.float32) -> Grid:
    """Build the grid selected by the config (``init_grid1/2``)."""
    bc = BoundaryConditions(ew=cfg.domain.ew_boundary_type,
                            ns=cfg.domain.ns_boundary_type)
    g = cfg.grid
    if g.grid_type in ("displaced_pole", "tripole"):
        if g.grid_format == "nc":
            return load_pop_grid_nc(g.grid_file, g.kmt_file, bc, dtype)
        return load_pop_grid(g.grid_file, g.kmt_file,
                             cfg.domain.nx_global, cfg.domain.ny_global,
                             bc, dtype)
    if g.grid_type == "panarctic":
        return load_panarctic_grid(g.grid_file, cfg.domain.nx_global,
                                   cfg.domain.ny_global, bc, dtype)
    if g.grid_type in ("rectangular", "column"):
        return make_rect_grid(cfg.domain.nx_global, cfg.domain.ny_global, bc,
                              dx=g.dx_rect, dy=g.dy_rect,
                              lat_origin=g.lat_origin, lon_origin=g.lon_origin,
                              land_edges=(g.grid_type == "rectangular"),
                              dtype=dtype)
    if g.grid_type == "latlon":
        return make_latlon_grid(cfg.domain.nx_global, cfg.domain.ny_global,
                                bc, kmt_file=g.kmt_file or None, dtype=dtype)
    raise ValueError(f"unknown grid_type {g.grid_type!r}")


# ---------------------------------------------------------------------------
# staggered-grid transforms (ice_grid.F90:1540-1732)
# ---------------------------------------------------------------------------


def to_ugrid(grid: Grid, f):
    """Area-weighted T→U interpolation (``ice_grid.F90 to_ugrid:1540-1596``):
    u(j,i) = sum of tarea-weighted T values at the 4 cells sharing U(j,i)
    / (4 * uarea)."""
    from cice4_tpu.parallel import halo as h
    bc = grid.bc
    w = f * grid.tarea
    num = (w + h.nbr_e(w, bc) + h.nbr_n(w, bc) + h.nbr_ne(w, bc))
    return 0.25 * num * grid.uarear


def to_tgrid(grid: Grid, f):
    """Area-weighted U→T interpolation (``ice_grid.F90 to_tgrid:1599-1652``)."""
    from cice4_tpu.parallel import halo as h
    bc = grid.bc
    w = f * grid.uarea
    num = (w + h.nbr_w(w, bc) + h.nbr_s(w, bc) + h.nbr_sw(w, bc))
    return 0.25 * num * grid.tarear


def gridbox_corners(grid: Grid) -> dict:
    """Approximate cell-corner coordinates for history metadata
    (``ice_grid.F90 gridbox_verts:2128-2246`` for T cells from the U
    coordinates, ``gridbox_corners:1948-2122`` for U cells from the T
    coordinates; both use linear extrapolation at the open edges, so
    the fields are approximate by design).

    Returns numpy arrays (host-side metadata, not part of the compute
    graph): lont_bounds/latt_bounds/lonu_bounds/latu_bounds, each
    (4, ny, nx) in degrees, corner order SW, SE, NE, NW; longitudes
    normalized to [0, 360).
    """
    def shift_sw(a):                       # value at (j-1, i-1)
        v = np.empty_like(a)
        v[1:, 1:] = a[:-1, :-1]
        v[0, :] = 2.0 * v[1, :] - v[2, :]  # extrapolate row 0
        v[:, 0] = 2.0 * v[:, 1] - v[:, 2]  # extrapolate col 0
        return v

    def shift_s(a):                        # value at (j-1, i)
        v = np.empty_like(a)
        v[1:, :] = a[:-1, :]
        v[0, :] = 2.0 * v[1, :] - v[2, :]
        return v

    def shift_w(a):                        # value at (j, i-1)
        v = np.empty_like(a)
        v[:, 1:] = a[:, :-1]
        v[:, 0] = 2.0 * v[:, 1] - v[:, 2]
        return v

    def shift_ne(a):                       # value at (j+1, i+1)
        v = np.empty_like(a)
        v[:-1, :-1] = a[1:, 1:]
        v[-1, :] = 2.0 * v[-2, :] - v[-3, :]
        v[:, -1] = 2.0 * v[:, -2] - v[:, -3]
        return v

    def shift_n(a):                        # value at (j+1, i)
        v = np.empty_like(a)
        v[:-1, :] = a[1:, :]
        v[-1, :] = 2.0 * v[-2, :] - v[-3, :]
        return v

    def shift_e(a):                        # value at (j, i+1)
        v = np.empty_like(a)
        v[:, :-1] = a[:, 1:]
        v[:, -1] = 2.0 * v[:, -2] - v[:, -3]
        return v

    def lon_deg(a):
        return np.mod(np.rad2deg(a) + 360.0, 360.0)

    out = {}
    # T-cell corners are the surrounding U (NE-corner) points
    for name, fld, to_deg in (("lont_bounds", grid.ulon, lon_deg),
                              ("latt_bounds", grid.ulat, np.rad2deg)):
        a = np.asarray(fld, dtype=np.float64)
        sw, se = shift_sw(a), shift_s(a)
        ne, nw = a.copy(), shift_w(a)
        out[name] = to_deg(np.stack([sw, se, ne, nw]))
    # U-cell corners are the surrounding T points
    for name, fld, to_deg in (("lonu_bounds", grid.tlon, lon_deg),
                              ("latu_bounds", grid.tlat, np.rad2deg)):
        a = np.asarray(fld, dtype=np.float64)
        sw, se = a.copy(), shift_e(a)
        ne, nw = shift_ne(a), shift_n(a)
        out[name] = to_deg(np.stack([sw, se, ne, nw]))
    return out
