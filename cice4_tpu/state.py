"""Prognostic model state as a single JAX pytree.

Replaces ``source/ice_state.F90:66-137`` (category state, velocity,
tracers) plus the persistent pieces of ``source/ice_flux.F90`` (SST /
freeze-melt potential of the slab mixed layer, radiation scale factor,
ice-ocean stress) and the 12 EVP stress fields of
``source/ice_dyn_evp.F90``.  Everything the exact-restart dump of
``ice_restart.F90:176-246`` writes lives here.

Array layout: category/layer axes lead, spatial ``(ny, nx)`` axes are
minor so x is the contiguous dimension.

* ``aicen/vicen/vsnon/tsfcn``: ``(ncat, ny, nx)``
* ``eicen``: ``(ncat, nilyr, ny, nx)`` — layer energy of melting (J/m^2,
  negative); the reference's flattened ``eicen(ntilyr)`` unrolled to two
  axes
* ``esnon``: ``(ncat, nslyr, ny, nx)``
* ``trcrn``: dict of optional tracers (iage, alvl, vlvl, volpn), each
  ``(ncat, ny, nx)``
* ``uvel/vvel`` and the three corner stress tensors: ``(ny, nx)`` /
  ``(4, ny, nx)`` with corner order (ne, nw, sw, se)
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from cice4_tpu import constants as cn
from cice4_tpu.config import Config
from cice4_tpu.grid import Grid


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "aicen", "vicen", "vsnon", "eicen", "esnon", "tsfcn", "trcrn",
        "uvel", "vvel", "stressp", "stressm", "stress12", "iceumask",
        "sst", "frzmlt", "scale_factor", "strocnxT", "strocnyT", "swn",
    ],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class State:
    """Full prognostic state. See module docstring for shapes."""

    # category ice state (ice_state.F90:66-101)
    aicen: jax.Array     # ice area fraction per category
    vicen: jax.Array     # ice volume per unit area (m)
    vsnon: jax.Array     # snow volume per unit area (m)
    eicen: jax.Array     # ice layer energy of melting (J/m^2, <= 0)
    esnon: jax.Array     # snow layer energy of melting (J/m^2, <= 0)
    tsfcn: jax.Array     # surface temperature (C) — tracer 1 of the reference
    trcrn: dict          # optional tracers: iage (s), alvl, vlvl, volpn
    # dynamics (ice_state.F90:128-137 + ice_dyn_evp stress state)
    uvel: jax.Array      # x ice velocity at U points (m/s)
    vvel: jax.Array
    stressp: jax.Array   # sigma11+sigma22 at 4 corners (ne,nw,sw,se)
    stressm: jax.Array   # sigma11-sigma22
    stress12: jax.Array  # sigma12
    iceumask: jax.Array  # bool: ice present at U point last dynamics step
    # slab ocean mixed layer + coupling memory (ice_flux.F90)
    sst: jax.Array       # sea surface temperature (C)
    frzmlt: jax.Array    # freezing/melting potential (W/m^2)
    scale_factor: jax.Array  # shortwave scaling factor (ice_flux.F90)
    strocnxT: jax.Array  # ice-ocean stress at T points (N/m^2)
    strocnyT: jax.Array
    # coupled-mode carried shortwave (radiation.prep_radiation=True):
    # last step's absorbed-SW components + gridbox-mean albedos,
    # rescaled at step start (ice_step_mod.F90 prep_radiation:84-218).
    # Empty dict when the flag is off (pytree structure is per-config).
    swn: dict = dataclasses.field(default_factory=dict)

    @property
    def ncat(self):
        return self.aicen.shape[0]

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# ITD / thermo parameter vectors (static per config)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ItdParams:
    """Category bounds and fixed vertical profiles.

    ``hin_max`` per ``ice_itd.F90 init_itd:97-270`` (kcatbound 0/1/2);
    ``salin``/``Tmlt`` per ``ice_therm_vertical.F90
    init_thermo_vertical:533-584``.  Held as NumPy arrays: they are
    compile-time constants folded into the traced program.
    """

    hin_max: np.ndarray   # (ncat+1,) category thickness bounds (m)
    salin: np.ndarray     # (nilyr+1,) fixed salinity profile (ppt)
    tmlt: np.ndarray      # (nilyr+1,) melting temperature profile (C)
    ncat: int
    nilyr: int
    nslyr: int


def make_itd_params(cfg: Config) -> ItdParams:
    ncat = cfg.domain.ncat
    nilyr = cfg.domain.nilyr
    kcatbound = cfg.domain.kcatbound
    kitd = cfg.thermo.kitd
    hi_min = 0.01  # minimum ice thickness for delta-function ITD

    hin_max = np.zeros(ncat + 1)
    if kcatbound == 0:
        if kitd == 1:
            cc1 = 3.0 / ncat
            cc2 = 15.0 * cc1
            cc3 = 3.0
            hin_max[0] = 0.0
        else:
            cc1 = max(1.1 / ncat, hi_min)
            cc2 = 25.0 * cc1
            cc3 = 2.25
            hin_max[0] = hi_min
        for n in range(1, ncat + 1):
            x1 = (n - 1) / ncat
            hin_max[n] = hin_max[n - 1] + cc1 + cc2 * (1.0 + np.tanh(cc3 * (x1 - 1.0)))
    elif kcatbound == 1:
        d1, d2 = 3.0 / ncat, 0.5 / ncat
        for n in range(1, ncat + 1):
            hin_max[n] = n * (d1 + (n - 1) * d2)
    elif kcatbound == 2:
        wmo = {5: [0.30, 0.70, 1.20, 2.00, 999.0],
               6: [0.15, 0.30, 0.70, 1.20, 2.00, 999.0],
               7: [0.10, 0.15, 0.30, 0.70, 1.20, 2.00, 999.0]}[ncat]
        hin_max[1:] = wmo
    else:
        raise ValueError(f"kcatbound={kcatbound}")

    saltmax = cfg.thermo.saltmax
    l_brine = saltmax > 0.1 and cfg.thermo.heat_capacity
    salin = np.zeros(nilyr + 1)
    if l_brine:
        k = np.arange(1, nilyr + 1)
        zn = (k - 0.5) / nilyr
        salin[:nilyr] = (saltmax / 2.0) * (1.0 - np.cos(np.pi * zn ** (0.407 / (0.573 + zn))))
        salin[nilyr] = saltmax
    tmlt = -salin * cn.depressT
    return ItdParams(hin_max=hin_max, salin=salin, tmlt=tmlt,
                     ncat=ncat, nilyr=nilyr, nslyr=cfg.domain.nslyr)


# ---------------------------------------------------------------------------
# state construction
# ---------------------------------------------------------------------------


def zeros_state(cfg: Config, grid: Grid, dtype=jnp.float32) -> State:
    ncat, nilyr, nslyr = cfg.domain.ncat, cfg.domain.nilyr, cfg.domain.nslyr
    ny, nx = grid.ny, grid.nx
    z2 = jnp.zeros((ny, nx), dtype)
    zc = jnp.zeros((ncat, ny, nx), dtype)
    trcrn = {}
    if cfg.tracers.tr_iage:
        trcrn["iage"] = zc
    if cfg.tracers.tr_lvl:
        trcrn["alvl"] = zc
        trcrn["vlvl"] = zc
    if cfg.tracers.tr_pond:
        trcrn["volpn"] = zc
    swn = {}
    if cfg.radiation.prep_radiation:
        swn = dict(fswsfcn=zc, fswintn=zc, fswthrun=zc,
                   Sswabsn=jnp.zeros((ncat, nslyr, ny, nx), dtype),
                   Iswabsn=jnp.zeros((ncat, nilyr, ny, nx), dtype),
                   alvdr_gbm=z2, alvdf_gbm=z2, alidr_gbm=z2,
                   alidf_gbm=z2)
    return State(
        aicen=zc, vicen=zc, vsnon=zc,
        eicen=jnp.zeros((ncat, nilyr, ny, nx), dtype),
        esnon=jnp.zeros((ncat, nslyr, ny, nx), dtype),
        tsfcn=zc, trcrn=trcrn,
        uvel=z2, vvel=z2,
        stressp=jnp.zeros((4, ny, nx), dtype),
        stressm=jnp.zeros((4, ny, nx), dtype),
        stress12=jnp.zeros((4, ny, nx), dtype),
        iceumask=jnp.zeros((ny, nx), bool),
        sst=z2, frzmlt=z2, scale_factor=z2,
        strocnxT=z2, strocnyT=z2, swn=swn,
    )


def freezing_temperature(cfg: Config, sss):
    """Freezing temperature of seawater (C). `Tfrzpt` options of
    ``ice_nml`` (`linear_S`: Tf = -depressT * sss; `constant`: -1.8 C)."""
    if cfg.thermo.Tfrzpt == "linear_S":
        return -cn.depressT * sss
    return jnp.full_like(sss, cn.Tocnfrz)


def init_state(cfg: Config, grid: Grid, itd: ItdParams,
               Tair=None, sst=None, sss=None, dtype=jnp.float32) -> State:
    """Default cold-start state (``ice_init.F90 set_state_var:921-1195``).

    Ice is placed where the ocean surface is cold and poleward of the
    initial edges (70N / -60S), with a parabolic category-area profile
    peaked at hbar = 3 m, 0.20 m of snow, surface temperature
    min(Tsmelt, Tair - Tffresh), and linear-in-depth internal
    temperature profiles converted to enthalpy.
    """
    ncat, nilyr, nslyr = itd.ncat, itd.nilyr, itd.nslyr
    ny, nx = grid.ny, grid.nx
    s = zeros_state(cfg, grid, dtype)

    if sss is None:
        sss = jnp.full((ny, nx), 34.0, dtype)
    Tf = freezing_temperature(cfg, sss).astype(dtype)
    if sst is None:
        sst = Tf
    if Tair is None:
        Tair = jnp.full((ny, nx), 253.0, dtype)
    s = s.replace(sst=sst, tsfcn=jnp.broadcast_to(Tf, (ncat, ny, nx)))

    if cfg.run.ice_ic == "none":
        return s

    # category thickness/area profile
    hbar = 3.0
    hinit = np.zeros(ncat)
    for n in range(ncat):
        if n < ncat - 1:
            hinit[n] = 0.5 * (itd.hin_max[n] + itd.hin_max[n + 1])
        else:
            hinit[n] = itd.hin_max[n] + 1.0
    ainit = np.maximum(0.0, 2.0 * hbar * hinit - hinit**2)
    ainit = ainit / (ainit.sum() + cn.puny / ncat)

    # where to place ice
    if cfg.grid.grid_type == "rectangular":
        icemask = grid.tmask & (grid.ulon < np.deg2rad(-50.0))
    else:
        edge_nh = np.deg2rad(70.0)
        edge_sh = np.deg2rad(-60.0)
        cold = sst <= (Tf + 0.2)
        icemask = grid.tmask & cold & ((grid.ulat < edge_sh) | (grid.ulat > edge_nh))
    m = icemask.astype(dtype)

    ainit_a = jnp.asarray(ainit, dtype)[:, None, None]
    hinit_a = jnp.asarray(hinit, dtype)[:, None, None]
    aicen = m * ainit_a
    vicen = hinit_a * aicen
    vsnon = jnp.minimum(aicen * 0.20, 0.2 * vicen)

    tsfc_ice = jnp.minimum(cn.Tsmelt, Tair - cn.Tffresh)
    tsfcn = jnp.where(icemask, tsfc_ice, Tf)
    tsfcn = jnp.broadcast_to(tsfcn, (ncat, ny, nx))

    if cfg.thermo.heat_capacity:
        # linear temperature profile Tf..Tsfc -> enthalpy per layer
        k = jnp.arange(1, nilyr + 1, dtype=dtype)[None, :, None, None]
        slope = (Tf[None, None] - tsfcn[:, None])  # (ncat,1,ny,nx)
        Ti = tsfcn[:, None] + slope * (k - 0.5) / nilyr
        Ti = jnp.minimum(Ti, -cn.puny)  # guard 1/Ti
        tmlt = jnp.asarray(itd.tmlt[:nilyr], dtype)[None, :, None, None]
        qin = -(cn.rhoi * (cn.cp_ice * (tmlt - Ti)
                           + cn.Lfresh * (1.0 - tmlt / Ti)
                           - cn.cp_ocn * tmlt))
        eicen = qin * vicen[:, None] / nilyr
        Ts = jnp.minimum(0.0, tsfcn)[:, None]
        esnon = (-cn.rhos * (cn.Lfresh - cn.cp_ice * Ts)
                 * vsnon[:, None] / nslyr)
    else:
        eicen = jnp.broadcast_to(-cn.rhoi * cn.Lfresh * vicen[:, None] / nilyr,
                                 (ncat, nilyr, ny, nx))
        esnon = jnp.broadcast_to(-cn.rhos * cn.Lfresh * vsnon[:, None] / nslyr,
                                 (ncat, nslyr, ny, nx))

    # initial ice is all level ice (ice_lvl.F90 init: alvl = vlvl = 1)
    trcrn = dict(s.trcrn)
    if "alvl" in trcrn:
        ones = jnp.where(aicen > 0.0, 1.0, 0.0).astype(dtype)
        trcrn["alvl"] = ones
        trcrn["vlvl"] = ones
    return s.replace(aicen=aicen, vicen=vicen, vsnon=vsnon, tsfcn=tsfcn,
                     eicen=eicen, esnon=esnon, trcrn=trcrn)
