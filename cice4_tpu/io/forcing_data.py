"""Forcing engine: dataset readers, time interpolation, derived fields.

Equivalent of ``source/ice_forcing.F90`` (4269 LoC):

* bracketing record reads with year cycling and the reference's
  beginning/end-of-cycle rules (``read_data:869-1021``: persistence for
  sub-monthly data, periodicity for monthly data),
* linear time interpolation (``interp_coeff:1362-1423``,
  ``interp_coeff_monthly:1302-1352``),
* dataset families: `ncar` (NCAR bulk, ``ncar_files/ncar_data:
  1821-2056``), `LYq` (Large-Yeager CORE, ``LY_files/LY_data:
  2487-2761`` + ``Qa_fixLY:2825-2851`` + AOMIP ``compute_shortwave:
  2765-2821``), `monthly` (``monthly_files/monthly_data:3318-3553``),
* the derived-field pipeline ``prepare_forcing:1530-1809``: physical
  clamps, dataset bias corrections, Parkinson & Washington (1979) /
  Rosati & Miyakoda (1988) downward longwave, precipitation unit
  conversion, rain/snow partition at 0 C, 4-band shortwave split, and
  **rotation of geographic winds onto the grid x/y axes via ANGLET**,
* ocean climatology + SST restoring (``init_forcing_ocn:228-446``,
  ``ocn_data_clim:3564-...``): monthly SSS -> Tf, monthly SST with
  restoring timescale `trestore`.

File format is the reference's 'rda8' (direct-access big-endian
real*8 records of the full grid, ``ice_read_write.F90:357-451``).

Device/host split: record reads and bracketing live on the
host in NumPy (tiny 2D slabs, latency-insensitive); everything from
interpolation onward is one jitted device function per dataset family.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from cice4_tpu import constants as cn
from cice4_tpu.calendar import Calendar, daycal_365
from cice4_tpu.config import Config
from cice4_tpu.forcing import Forcing
from cice4_tpu.grid import Grid

daymo_365 = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]

# fixed 4-band split of total downward SW (prepare_forcing)
frcvdr, frcvdf, frcidr, frcidf = 0.28, 0.24, 0.31, 0.17


# ---------------------------------------------------------------------------
# time interpolation machinery
# ---------------------------------------------------------------------------


def interp_coeff(recnum, recslot, secint, dataloc, ftime, dayyr=365.0):
    """Linear interpolation weights for evenly spaced records
    (``interp_coeff:1362-1423``).  `ftime` = forcing-clock seconds."""
    secyr = dayyr * 86400.0
    tt = ftime % secyr
    if recslot == 2:
        t2 = (recnum - 0.5) * secint if dataloc == 1 else recnum * secint
        t1 = t2 - secint
    else:
        t1 = (recnum - 0.5) * secint if dataloc == 1 else recnum * secint
        t2 = t1 + secint
    c1 = abs((t2 - tt) / (t2 - t1))
    return c1, 1.0 - c1


def interp_coeff_monthly(recslot, month, ftime, dayyr=365.0):
    """Weights for mid-month-centered monthly data
    (``interp_coeff_monthly:1302-1352``)."""
    daymid = [14.0] * 14          # time frame ends 0 sec into day 15
    daymid0 = 14.0 - daymo_365[11]  # Dec 15 relative to Jan 1
    tt = (ftime / 86400.0) % dayyr
    if recslot == 2:              # first half of month
        t2 = daycal_365[month - 1] + daymid[month]
        t1 = daymid0 if month == 1 else (daycal_365[month - 2]
                                         + daymid[month - 1])
    else:                         # second half of month
        t1 = daycal_365[month - 1] + daymid[month]
        t2 = daycal_365[month] + daymid[month + 1] if month < 12 \
            else dayyr + daymid0 + daymo_365[11]
    c1 = (t2 - tt) / (t2 - t1)
    return c1, 1.0 - c1


def monthly_bracket(cal: Calendar):
    """Bracketing months around `now` (mid-month convention,
    ``ncar_data`` monthly section).  Returns 1-based months m1, m2 and
    their weights."""
    midmonth = 15
    month, mday = cal.month, cal.mday
    ftime = cal.time  # forcing clock == model clock (standalone)
    if mday >= midmonth:
        recslot = 1
        m1, m2 = month, month % 12 + 1
    else:
        recslot = 2
        m1, m2 = (month + 10) % 12 + 1, month
    c1, c2 = interp_coeff_monthly(recslot, month, ftime,
                                  float(cal.days_per_year))
    if mday >= midmonth:
        return m1, m2, c1, c2
    return m1, m2, c1, c2


def sixhourly_bracket(cal: Calendar):
    """Record numbers + weights for 6-hourly data located at interval
    end (NCEP convention, ``ncar_data`` 6-hourly section)."""
    sec6hr = 86400.0 / 4.0
    maxrec = 1460
    recnum = 4 * int(cal.yday) - 3 + int(cal.sec / sec6hr)
    ixm = (recnum + maxrec - 2) % maxrec + 1
    ixx = (recnum - 1) % maxrec + 1
    c1, c2 = interp_coeff(recnum, 2, sec6hr, 2, cal.time,
                          float(cal.days_per_year))
    return ixm, ixx, c1, c2, maxrec


# ---------------------------------------------------------------------------
# rda8 record files + year cycling
# ---------------------------------------------------------------------------


class RecordReader:
    """Cached reader of direct-access big-endian real*8 records."""

    def __init__(self, ny, nx, cache_records=128):
        self.ny, self.nx = ny, nx
        self._cache: dict = {}
        self._max = cache_records

    def read(self, path, rec1):
        """Read 1-based record `rec1` as (ny, nx) float64."""
        key = (path, rec1)
        if key not in self._cache:
            n = self.nx * self.ny
            with open(path, "rb") as f:
                f.seek((rec1 - 1) * n * 8)
                arr = np.fromfile(f, dtype=">f8", count=n)
            if arr.size != n:
                raise EOFError(f"{path}: record {rec1} truncated")
            self._cache[key] = arr.reshape(self.ny, self.nx)
            while len(self._cache) > self._max:
                self._cache.pop(next(iter(self._cache)))
        return self._cache[key]


def forcing_year(cal: Calendar, fyear_init: int, ycycle: int) -> int:
    """Cycled forcing year (``init_forcing_atmo:174-219``):
    fyear = fyear_init + mod(year - year_init, ycycle)."""
    return fyear_init + (cal.year - cal.year_init) % max(ycycle, 1)


class _FileDataset:
    """Shared record-bracketing logic over yearly rda8 files.

    `paths[name]` is either a static path (climatology) or a callable
    `year -> path` (yearly files, the reference's `file_year`).
    """

    def __init__(self, cfg: Config, grid: Grid):
        fc = cfg.forcing
        self.cfg = cfg
        self.reader = RecordReader(grid.ny, grid.nx)
        self.fyear_init = fc.fyear_init
        self.ycycle = max(fc.ycycle, 1)
        self.fyear_final = fc.fyear_init + self.ycycle - 1

    def _path(self, p, year):
        return p(year) if callable(p) else p

    def read_6hourly(self, pathfn, cal: Calendar):
        """Two bracketing 6-hourly records + weights, with the
        reference's persistence rule at cycle boundaries."""
        fyear = forcing_year(cal, self.fyear_init, self.ycycle)
        ixm, ixx, c1, c2, maxrec = sixhourly_bracket(cal)
        # record ixm (earlier)
        if ixx <= 1:  # first record of the year: look back
            if fyear > self.fyear_init:
                pm, rm = self._path(pathfn, fyear - 1), ixm
            else:  # persistence: duplicate the first record
                pm, rm = self._path(pathfn, fyear), ixx
        else:
            pm, rm = self._path(pathfn, fyear), ixm
        a = self.reader.read(pm, rm)
        b = self.reader.read(self._path(pathfn, fyear), ixx)
        return c1 * a + c2 * b

    def read_daily(self, pathfn, cal: Calendar):
        """Two bracketing DAILY records + weights; data located at the
        middle of each 24-hour period (``ECMWF_data:2399-2440``,
        dataloc=1, maxrec=365)."""
        fyear = forcing_year(cal, self.fyear_init, self.ycycle)
        maxrec = 365
        recnum = min(int(cal.yday), maxrec)
        ixm = (recnum + maxrec - 2) % maxrec + 1
        ixx = (recnum - 1) % maxrec + 1
        ixp = recnum % maxrec + 1
        first_half = cal.sec < 0.5 * 86400.0
        recslot = 2 if first_half else 1
        c1, c2 = interp_coeff(recnum, recslot, 86400.0, 1, cal.time,
                              float(cal.days_per_year))
        if first_half:
            # only r1 can cross into the PREVIOUS year; r2 = ixx is
            # always a current-year record (read_data reads n3=ixx
            # from the current file)
            r1, r2 = ixm, ixx
            y1 = fyear - 1 if (ixx == 1 and fyear > self.fyear_init) \
                else fyear
            if ixx == 1 and fyear == self.fyear_init:
                r1 = ixx      # persistence at cycle start
            y2 = fyear
        else:
            # only r2 can cross into the NEXT year; at the end of
            # fyear_final the reference persists the last record
            # (n4=ixx) instead of wrapping to Jan 1 of the same year
            r1, r2 = ixx, ixp
            y1 = fyear
            if r2 < r1:  # wrapped past Dec 31
                if fyear < self.fyear_final:
                    y2 = fyear + 1
                else:
                    y2, r2 = fyear, ixx   # persistence at cycle end
            else:
                y2 = fyear
        a = self.reader.read(self._path(pathfn, y1), r1)
        b = self.reader.read(self._path(pathfn, y2), r2)
        return c1 * a + c2 * b

    def read_monthly(self, pathfn, cal: Calendar, climatology=False):
        """Two bracketing mid-month records + weights; monthly data
        wraps periodically across the forcing cycle."""
        fyear = forcing_year(cal, self.fyear_init, self.ycycle)
        m1, m2, c1, c2 = monthly_bracket(cal)
        if climatology:
            y1 = y2 = fyear  # single file, path is static
        else:
            y1, y2 = fyear, fyear
            if m1 > m2 and cal.month == 1:      # m1 = December record
                y1 = fyear - 1 if fyear > self.fyear_init \
                    else self.fyear_final
            if m1 > m2 and cal.month == 12:     # m2 = January record
                y2 = fyear + 1 if fyear < self.fyear_final \
                    else self.fyear_init
        a = self.reader.read(self._path(pathfn, y1), m1)
        b = self.reader.read(self._path(pathfn, y2), m2)
        return c1 * a + c2 * b


# ---------------------------------------------------------------------------
# derived-field pipeline (prepare_forcing:1530-1809)
# ---------------------------------------------------------------------------


def _precip_factor(precip_units: str) -> float:
    if precip_units == "mm_per_month":
        return 12.0 / (86400.0 * 365.0)
    if precip_units == "mm_per_day":
        return 1.0 / 86400.0
    if precip_units in ("mm_per_sec", "mks"):
        return 1.0
    raise ValueError(f"unknown precip_units {precip_units!r}")


def _flw_parkinson_washington(Tair, cldf):
    """Downward longwave, Parkinson & Washington (1979)
    (``prepare_forcing:1628-1641``)."""
    return (cn.stefan_boltzmann * Tair**4
            * (1.0 - 0.261 * jnp.exp(-7.77e-4 * (cn.Tffresh - Tair)**2))
            * (1.0 + 0.275 * cldf))


def _flw_rosati_miyakoda(Tair, Qa, cldf, Tsfc, sst, aice, hm):
    """Downward longwave, Rosati & Miyakoda (1988) as used for LYq
    (``LY_data`` flw section, ``prepare_forcing:1672-1689``)."""
    fcc = 1.0 - 0.8 * cldf
    sstk = (Tsfc * aice + sst * (1.0 - aice)) + cn.Tffresh
    rtea = jnp.sqrt(1000.0 * Qa / (0.622 + 0.378 * Qa))
    ptem = Tair
    qlwm = ptem**3 * (ptem * (0.39 - 0.05 * rtea) * fcc
                      + 4.0 * (sstk - ptem))
    return cn.emissivity * cn.stefan_boltzmann * (sstk**4 - qlwm) * hm


def _qa_fix_ly(Tair, Qa):
    """Cap Qa at ice saturation (``Qa_fixLY:2825-2851``)."""
    w = Tair - cn.Tffresh
    w = 2.0 + (0.7859 + 0.03477 * w) / (1.0 + 0.00412 * w) + 0.00422 * w
    esat = jnp.maximum(10.0**w, cn.puny)           # Pa
    qsat = 0.622 * esat / (1.0e5 - 0.378 * esat)
    return jnp.minimum(Qa, qsat)


def _compute_shortwave_aomip(tlon, tlat, hm, Qa, cldf, yday, sec):
    """AOMIP downward shortwave from the sun position
    (``compute_shortwave:2765-2821``)."""
    deg2rad = jnp.pi / 180.0
    solar_time = (sec % 86400.0) / 3600.0 + 12.0 * jnp.sin(0.5 * tlon)
    hour_angle = (12.0 - solar_time) * jnp.pi / 12.0
    declin = 23.44 * jnp.cos((172.0 - yday) * 2.0 * jnp.pi / 365.0) \
        * deg2rad
    cosZ = jnp.maximum(jnp.sin(tlat) * jnp.sin(declin)
                       + jnp.cos(tlat) * jnp.cos(declin)
                       * jnp.cos(hour_angle), 0.0)
    e = 1.0e5 * Qa / (0.622 + 0.378 * Qa)
    d = (cosZ + 2.7) * e * 1.0e-5 + 1.085 * cosZ + 0.1
    sw0 = jnp.maximum(1353.0 * cosZ**2 / d, 0.0)
    return sw0 * (1.0 - 0.6 * cldf**3) * hm


def rotate_to_grid(uatm, vatm, anglet):
    """Rotate geographic E/N vectors onto grid x/y using ANGLET on the
    T grid (``prepare_forcing:1770-1788``).  First-order in the Arctic
    on displaced-pole grids."""
    ca, sa = jnp.cos(anglet), jnp.sin(anglet)
    return uatm * ca + vatm * sa, vatm * ca - uatm * sa


def split_shortwave(fsw):
    """Fixed 4-band partition of total downward SW (prepare_forcing)."""
    return fsw * frcvdr, fsw * frcvdf, fsw * frcidr, fsw * frcidf


def derived_atm_fields(f: Forcing, grid: Grid) -> Forcing:
    """Fill potT, rhoa, wind from basic fields (minimal subset of
    ``prepare_forcing`` for externally supplied Forcing pytrees)."""
    wind = jnp.sqrt(f.uatm**2 + f.vatm**2)
    rhoa = jnp.where(f.rhoa > 0, f.rhoa, 1.3)
    potT = jnp.where(f.potT > 0, f.potT, f.Tair)
    return f.replace(wind=wind, rhoa=rhoa, potT=potT)


# ---------------------------------------------------------------------------
# analytic idealized forcing
# ---------------------------------------------------------------------------


class AnalyticForcing:
    """Latitude/season idealized atmosphere + climatological ocean.

    Smooth, bounded fields that produce a realistic seasonal ice cycle:
    air temperature with latitude gradient + seasonal cycle, westerly/
    polar-easterly winds, humidity at fixed relative humidity, SW from
    zenith angle climatology, LW from air temperature.
    """

    def __init__(self, cfg: Config, grid: Grid, dtype=jnp.float32):
        self.cfg = cfg
        self.dtype = dtype
        self.lat = grid.tlat.astype(dtype)
        self.lon = grid.tlon.astype(dtype)
        self.ulat = grid.ulat.astype(dtype)

    def ocean_update(self, state, cal, dt):
        return state

    def __call__(self, yday: float, sec: float, cal=None,
                 state=None) -> Forcing:
        lat = self.lat
        dtype = self.dtype
        # season phase: NH summer solstice ~ day 172
        phase = 2.0 * jnp.pi * (yday - 172.0) / 365.0
        seasonal = jnp.cos(phase)  # +1 at NH midsummer
        hemi = jnp.sign(jnp.sin(lat))

        # surface air temperature: warm equator, cold poles, +- seasonal
        Tair = (cn.Tffresh + 28.0 * jnp.cos(lat) ** 2
                - 22.0 * jnp.abs(jnp.sin(lat)) ** 3
                + 12.0 * seasonal * hemi * jnp.sin(lat) ** 2)
        # winds: polar easterlies (~7 m/s with slight rotation)
        uatm = -4.0 * jnp.sin(lat) * jnp.sign(jnp.sin(lat))
        vatm = 2.0 * jnp.sin(2.0 * lat) * seasonal
        wind = jnp.sqrt(uatm**2 + vatm**2) + 1.0
        # humidity: 85% RH over saturation at Tair
        qsat = (cn.qqqice * jnp.exp(-cn.TTTice / Tair)) / 1.3
        Qa = 0.85 * qsat
        # longwave: bulk emissivity formula
        flw = 0.7855 * 1.15 * cn.stefan_boltzmann * Tair**4
        # shortwave from daily-mean zenith angle
        decl = 0.409 * jnp.cos(2.0 * jnp.pi * (yday - 172.0) / 365.0) * -1.0
        cosz_noon = jnp.maximum(
            jnp.sin(lat) * jnp.sin(decl) + jnp.cos(lat) * jnp.cos(decl),
            0.0)
        fsw = 900.0 * cosz_noon**1.4 * 0.45
        swvdr, swvdf, swidr, swidf = split_shortwave(fsw)
        # precipitation: snow when cold
        precip = 2.0e-5 * (0.8 + 0.5 * jnp.cos(lat))  # kg/m^2/s
        snow = Tair < cn.Tffresh
        fsnow = jnp.where(snow, precip, 0.0)
        frain = jnp.where(snow, 0.0, precip)

        z = jnp.zeros_like(lat)
        return Forcing(
            zlvl=z + 10.0, uatm=uatm.astype(dtype), vatm=vatm.astype(dtype),
            wind=wind.astype(dtype), potT=Tair.astype(dtype),
            Tair=Tair.astype(dtype), Qa=Qa.astype(dtype), rhoa=z + 1.3,
            flw=flw.astype(dtype), swvdr=swvdr.astype(dtype),
            swvdf=swvdf.astype(dtype), swidr=swidr.astype(dtype),
            swidf=swidf.astype(dtype), frain=frain.astype(dtype),
            fsnow=fsnow.astype(dtype),
            sss=z + 34.0, uocn=z, vocn=z, ss_tltx=z, ss_tlty=z,
            qdp=z, hmix=z + 20.0,
        )


# ---------------------------------------------------------------------------
# file-based atmosphere datasets
# ---------------------------------------------------------------------------


class _AtmFileForcing(_FileDataset):
    """Shared machinery for the file-based atmosphere datasets."""

    #: name -> (cadence, path template); template gets .format(year=)
    LAYOUT: dict = {}
    #: fallback flat layout: stem -> filename f"{stem}.{year}.dat"
    DATASET = ""

    def __init__(self, cfg: Config, grid: Grid, dtype=jnp.float32):
        super().__init__(cfg, grid)
        self.grid = grid
        self.dtype = dtype
        self.dir = cfg.forcing.atm_data_dir
        self.analytic = AnalyticForcing(cfg, grid, dtype)
        self.available = self._probe()
        self._prepare = jax.jit(self._prepare_impl)

    def _pathfn(self, name):
        tmpl = self.LAYOUT[name][1]
        ref = os.path.join(self.dir, tmpl)
        flat = os.path.join(self.dir, f"{name}.{{year}}.dat")

        def fn(year):
            p = ref.format(year=year)
            if os.path.exists(p):
                return p
            return flat.format(year=year)
        return fn

    def _probe(self):
        if not self.dir or not os.path.isdir(self.dir):
            return False
        for name in self.LAYOUT:
            if not os.path.exists(self._pathfn(name)(self.fyear_init)):
                return False
        return True

    def _read_all(self, cal: Calendar) -> dict:
        out = {}
        for name, (cadence, _t) in self.LAYOUT.items():
            fn = self._pathfn(name)
            if cadence == "6h":
                out[name] = self.read_6hourly(fn, cal)
            elif cadence == "mon":
                out[name] = self.read_monthly(fn, cal)
            else:  # climatology: single 12-record file
                out[name] = self.read_monthly(fn, cal, climatology=True)
        return out

    def ocean_update(self, state, cal, dt):
        return state

    def __call__(self, yday, sec, cal=None, state=None) -> Forcing:
        if not self.available:
            return self.analytic(yday, sec, cal=cal, state=state)
        if cal is None:
            cal = Calendar(dt=self.cfg.run.dt,
                           year_init=self.cfg.run.year_init)
            cal.time = (float(yday) - 1.0) * 86400.0 + float(sec)
            cal._recompute()
        raw = {k: jnp.asarray(v, self.dtype)
               for k, v in self._read_all(cal).items()}
        base = self.analytic(yday, sec)   # ocean fields baseline
        Tsfc = sst = aice = None
        if state is not None:
            sst = state.sst
            aice = jnp.sum(state.aicen, 0)
            Tsfc = jnp.where(aice > cn.puny,
                             jnp.sum(state.aicen * state.tsfcn, 0)
                             / jnp.maximum(aice, cn.puny), 0.0)
        else:
            z = jnp.zeros((self.grid.ny, self.grid.nx), self.dtype)
            Tsfc, sst, aice = z, z - 1.8, z
        return self._prepare(raw, base, jnp.asarray(float(yday)),
                             jnp.asarray(float(sec)), Tsfc, sst, aice)

    # implemented by subclasses: raw record dict -> Forcing
    def _prepare_impl(self, raw, base, yday, sec, Tsfc, sst, aice):
        raise NotImplementedError


def _finish_forcing(self, base, Tair, Qa, rhoa, uatm, vatm, fsw, flw,
                    precip, precip_units):
    """Common tail of prepare_forcing: clamps, precip conversion,
    rain/snow split, SW bands, wind rotation, potT/zlvl."""
    g = self.grid
    fsw = jnp.maximum(fsw, 0.0)
    Qa = jnp.maximum(Qa, 0.0)
    rhoa = jnp.maximum(rhoa, 0.0)
    precip = jnp.maximum(precip, 0.0) * _precip_factor(precip_units)
    # rain/snow partition at freezing (":1747-1760")
    snow = Tair < cn.Tffresh
    fsnow = jnp.where(snow, precip, 0.0)
    frain = jnp.where(snow, 0.0, precip)
    # rotate geographic winds onto grid axes (":1770-1788")
    uatm, vatm = rotate_to_grid(uatm, vatm, g.anglet)
    wind = jnp.sqrt(uatm**2 + vatm**2)
    swvdr, swvdf, swidr, swidf = split_shortwave(fsw)
    z10 = jnp.full_like(Tair, 10.0)
    return base.replace(
        zlvl=z10, uatm=uatm, vatm=vatm, wind=wind, potT=Tair, Tair=Tair,
        Qa=Qa, rhoa=rhoa, flw=flw, swvdr=swvdr, swvdf=swvdf,
        swidr=swidr, swidf=swidf, frain=frain, fsnow=fsnow)


class NcarBulkForcing(_AtmFileForcing):
    """NCAR bulk dataset: monthly fsw/cldf/prec + 6-hourly NCEP states
    (``ncar_files/ncar_data:1821-2056``); gx3's standard forcing."""

    LAYOUT = {
        "swdn": ("mon", "ISCCPM/MONTHLY/RADFLX/swdn.{year}.dat"),
        "cldf": ("mon", "ISCCPM/MONTHLY/RADFLX/cldf.{year}.dat"),
        "prec": ("mon", "MXA/MONTHLY/PRECIP/prec.{year}.dat"),
        "u_10": ("6h", "NCEP/4XDAILY/STATES/u_10.{year}.dat"),
        "v_10": ("6h", "NCEP/4XDAILY/STATES/v_10.{year}.dat"),
        "t_10": ("6h", "NCEP/4XDAILY/STATES/t_10.{year}.dat"),
        "q_10": ("6h", "NCEP/4XDAILY/STATES/q_10.{year}.dat"),
        "dn10": ("6h", "NCEP/4XDAILY/STATES/dn10.{year}.dat"),
    }

    def _prepare_impl(self, raw, base, yday, sec, Tsfc, sst, aice):
        cldf = jnp.clip(raw["cldf"], 0.0, 1.0)
        Tair = raw["t_10"]
        # NCAR bias corrections (":1619-1626")
        Qa = raw["q_10"] * 0.94
        fsw = raw["swdn"] * 0.92
        flw = _flw_parkinson_washington(Tair, cldf)
        return _finish_forcing(self, base, Tair, Qa, raw["dn10"],
                               raw["u_10"], raw["v_10"], fsw, flw,
                               raw["prec"],
                               self.cfg.forcing.precip_units)


class LYqForcing(_AtmFileForcing):
    """Large & Yeager (CORE) dataset: monthly climatological cldf/prec
    + 6-hourly states, AOMIP shortwave, Rosati-Miyakoda longwave
    (``LY_files/LY_data:2487-2761``)."""

    LAYOUT = {
        "cldf": ("clim", "MONTHLY/cldf.omip.dat"),
        "prec": ("clim", "MONTHLY/prec.nmyr.dat"),
        "u_10": ("6h", "4XDAILY/u_10.{year}.dat"),
        "v_10": ("6h", "4XDAILY/v_10.{year}.dat"),
        "t_10": ("6h", "4XDAILY/t_10.{year}.dat"),
        "q_10": ("6h", "4XDAILY/q_10.{year}.dat"),
    }

    def _pathfn(self, name):
        cadence, tmpl = self.LAYOUT[name]
        if cadence == "clim":
            ref = os.path.join(self.dir, tmpl)
            flat = os.path.join(self.dir, os.path.basename(tmpl))
            return lambda year: ref if os.path.exists(ref) else flat
        return super()._pathfn(name)

    def _prepare_impl(self, raw, base, yday, sec, Tsfc, sst, aice):
        g = self.grid
        cldf = jnp.clip(raw["cldf"], 0.0, 1.0)
        Qa = _qa_fix_ly(raw["t_10"], raw["q_10"]) * g.hm
        Tair = raw["t_10"] * g.hm
        uatm = raw["u_10"] * g.hm
        vatm = raw["v_10"] * g.hm
        fsw = _compute_shortwave_aomip(g.tlon, g.tlat, g.hm, Qa, cldf,
                                       yday, sec)
        flw = _flw_rosati_miyakoda(Tair, Qa, cldf, Tsfc, sst, aice, g.hm)
        rhoa = jnp.full_like(Tair, 1.3)  # LY supplies no density
        return _finish_forcing(self, base, Tair, Qa, rhoa, uatm, vatm,
                               fsw, flw, raw["prec"], "mm_per_sec")


class MonthlyForcing(_AtmFileForcing):
    """All-monthly dataset with prescribed wind stress
    (``monthly_files/monthly_data:3318-3553``; calc_strair = F)."""

    LAYOUT = {
        "cldf": ("clim", "MONTHLY/cldf.omip.dat"),
        "prec": ("clim", "MONTHLY/prec.nmyr.dat"),
        "tair": ("mon", "MONTHLY/t_10.{year}.dat"),
        "qa": ("mon", "MONTHLY/q_10.{year}.dat"),
        "strax": ("mon", "MONTHLY/strx.{year}.dat"),
        "stray": ("mon", "MONTHLY/stry.{year}.dat"),
        "wind": ("mon", "MONTHLY/wind.{year}.dat"),
    }

    def _pathfn(self, name):
        cadence, tmpl = self.LAYOUT[name]
        if cadence == "clim":
            ref = os.path.join(self.dir, tmpl)
            flat = os.path.join(self.dir, os.path.basename(tmpl))
            return lambda year: ref if os.path.exists(ref) else flat
        return super()._pathfn(name)

    def _prepare_impl(self, raw, base, yday, sec, Tsfc, sst, aice):
        g = self.grid
        cldf = jnp.clip(raw["cldf"], 0.0, 1.0)
        Tair = raw["tair"] * g.hm
        Qa = _qa_fix_ly(Tair, raw["qa"]) * g.hm
        fsw = _compute_shortwave_aomip(g.tlon, g.tlat, g.hm, Qa, cldf,
                                       yday, sec)
        flw = _flw_rosati_miyakoda(Tair, Qa, cldf, Tsfc, sst, aice, g.hm)
        # wind stress (not velocity) is prescribed: rotate stress
        strax, stray = rotate_to_grid(raw["strax"] * g.hm,
                                      raw["stray"] * g.hm, g.anglet)
        rhoa = jnp.full_like(Tair, 1.3)
        f = _finish_forcing(self, base, Tair, Qa, rhoa,
                            jnp.zeros_like(Tair), jnp.zeros_like(Tair),
                            fsw, flw, raw["prec"], "mm_per_sec")
        return f.replace(wind=raw["wind"] * g.hm, strax=strax,
                         stray=stray)


class EcmwfForcing(_AtmFileForcing):
    """ECMWF (Maslowski pan-Arctic) dataset: DAILY states/radiation +
    monthly climatological precip and air density
    (``ecmwf_files:2237-2312``, ``ECMWF_data:2316-2474``)."""

    LAYOUT = {
        "sol": ("day", "sol_{year}.r"),
        "flo": ("day", "flo_{year}.r"),
        "ucmp": ("day", "ucmp_{year}.r"),
        "vcmp": ("day", "vcmp_{year}.r"),
        "tair": ("day", "tair_{year}.r"),
        "qa": ("day", "qa_{year}.r"),
        "prec": ("clim", "prec_lanl_12.r"),
        "rhoa": ("clim", "rhoa_ncar85-88_12.r"),
    }

    def _pathfn(self, name):
        cadence, tmpl = self.LAYOUT[name]
        if cadence == "clim":
            p = os.path.join(self.dir, tmpl)
            return lambda year: p
        ref = os.path.join(self.dir, tmpl)
        return lambda year: ref.format(year=year)

    def _read_all(self, cal: Calendar) -> dict:
        out = {}
        for name, (cadence, _t) in self.LAYOUT.items():
            fn = self._pathfn(name)
            if cadence == "day":
                out[name] = self.read_daily(fn, cal)
            else:
                out[name] = self.read_monthly(fn, cal, climatology=True)
        return out

    def _prepare_impl(self, raw, base, yday, sec, Tsfc, sst, aice):
        return _finish_forcing(self, base, raw["tair"], raw["qa"],
                               raw["rhoa"], raw["ucmp"], raw["vcmp"],
                               raw["sol"], raw["flo"], raw["prec"],
                               self.cfg.forcing.precip_units)


class HadgemForcing(_AtmFileForcing):
    """HadGEM monthly netCDF dataset (``hadgem_files:2863-3041``,
    ``hadgem_data:3051-3297``, calc_Tsfc branch): monthly rain/snow,
    10 m winds, SW/LW down, t/rho/q at 10 m."""

    #: name -> (netCDF variable, filename stem)
    NC_FIELDS = {
        "rain": ("rainfall", "rainfall"),
        "snow": ("snowfall", "snowfall"),
        "u_10": ("u_10", "u_10"),
        "v_10": ("v_10", "v_10"),
        "fsw": ("SW_incoming", "SW_incoming"),
        "flw": ("LW_incoming", "LW_incoming"),
        "tair": ("t_10", "t_10"),
        "rhoa": ("rho_10", "rho_10"),
        "qa": ("q_10", "q_10"),
    }
    LAYOUT = {k: ("mon", f"MONTHLY/{stem}.{{year}}.nc")
              for k, (_v, stem) in NC_FIELDS.items()}

    def _read_nc_month(self, name, year, month):
        from scipy.io import netcdf_file
        path = self._pathfn(name)(year)
        var = self.NC_FIELDS[name][0]
        key = (path, var, month)
        cache = self.reader._cache
        if key not in cache:
            with netcdf_file(path, "r", mmap=False) as f:
                v = f.variables[var]
                arr = np.array(v[month - 1], dtype=np.float64)
            cache[key] = arr.reshape(self.reader.ny, self.reader.nx)
        return cache[key]

    def _probe(self):
        if not self.dir or not os.path.isdir(self.dir):
            return False
        return all(os.path.exists(self._pathfn(n)(self.fyear_init))
                   for n in self.LAYOUT)

    def _read_all(self, cal: Calendar) -> dict:
        fyear = forcing_year(cal, self.fyear_init, self.ycycle)
        m1, m2, c1, c2 = monthly_bracket(cal)
        y1 = y2 = fyear
        if m1 > m2 and cal.month == 1:
            y1 = fyear - 1 if fyear > self.fyear_init else self.fyear_final
        if m1 > m2 and cal.month == 12:
            y2 = fyear + 1 if fyear < self.fyear_final else self.fyear_init
        out = {}
        for name in self.NC_FIELDS:
            a = self._read_nc_month(name, y1, m1)
            b = self._read_nc_month(name, y2, m2)
            out[name] = c1 * a + c2 * b
        return out

    def _prepare_impl(self, raw, base, yday, sec, Tsfc, sst, aice):
        f = _finish_forcing(self, base, raw["tair"], raw["qa"],
                            raw["rhoa"], raw["u_10"], raw["v_10"],
                            raw["fsw"], raw["flw"],
                            raw["rain"] + raw["snow"], "mm_per_sec")
        # the dataset splits rain/snow itself (hadgem_data ":3118-3135")
        return f.replace(frain=jnp.maximum(raw["rain"], 0.0),
                         fsnow=jnp.maximum(raw["snow"], 0.0))


class RctForcing:
    """Hourly single-point (Barrow 1989) netCDF met dataset broadcast
    over the grid (``rct_data:2066-2226``; HARDWIRED for dt = 1 h).

    Qa is derived from relative humidity via the Hyland-Wexler
    saturation pressure exactly as the reference does."""

    MET_FILE = "hourlymet_brw1989_5yr.nc"
    SOLAR_FILE = "hourlysolar_brw1989_5yr.nc"
    RH_FILE = "hourlymet_rh_5yr.nc"

    def __init__(self, cfg: Config, grid: Grid, dtype=jnp.float32):
        self.cfg = cfg
        self.grid = grid
        self.dtype = dtype
        self.dir = cfg.forcing.atm_data_dir
        self.analytic = AnalyticForcing(cfg, grid, dtype)
        self.available = all(
            os.path.exists(os.path.join(self.dir or "", p))
            for p in (self.MET_FILE, self.SOLAR_FILE, self.RH_FILE)) \
            if self.dir else False
        self._nc = {}

    def _col(self, fname, var, rec):
        from scipy.io import netcdf_file
        path = os.path.join(self.dir, fname)
        if fname not in self._nc:
            self._nc[fname] = netcdf_file(path, "r", mmap=False)
        v = self._nc[fname].variables[var]
        return float(np.asarray(v[rec - 1]).reshape(-1)[0])

    @staticmethod
    def _qa_hyland_wexler(Temp, rh):
        """Specific humidity from T (K) + RH (%) (``rct_data`` local
        Hyland-Wexler block, constants ps1..ps6/ws1/Pair)."""
        ps1, ps2, ps3 = 0.58002206e4, 0.13914993e1, 0.48640239e-1
        ps4, ps5, ps6 = 0.41764768e-4, 0.14452093e-7, 0.65459673e1
        ws1, Pair = 621.97, 1020.0
        Psat = np.exp(-ps1 / Temp + ps2 - ps3 * Temp + ps4 * Temp**2
                      - ps5 * Temp**3 + ps6 * np.log(Temp)) * 0.01
        ws = ws1 * Psat / (Pair - Psat)   # g/kg
        return ws * rh / 100.0 * 0.001    # kg/kg

    def ocean_update(self, state, cal, dt):
        return state

    def __call__(self, yday, sec, cal=None, state=None) -> Forcing:
        base = self.analytic(yday, sec, cal=cal, state=state)
        if not self.available or cal is None:
            return base
        rec = max(cal.istep, 1)
        Temp = self._col(self.MET_FILE, "Tair", rec)
        uatm = self._col(self.MET_FILE, "Uatm", rec)
        vatm = self._col(self.MET_FILE, "Vatm", rec)
        fsw = max(self._col(self.SOLAR_FILE, "fsw", rec), 0.0)
        rh = self._col(self.RH_FILE, "rh", rec)
        Qa = self._qa_hyland_wexler(Temp, rh)
        g = self.grid
        full = lambda v: jnp.full((g.ny, g.nx), v, self.dtype)  # noqa
        swvdr, swvdf, swidr, swidf = split_shortwave(full(fsw))
        wind = float(np.hypot(uatm, vatm))
        return base.replace(
            Tair=full(Temp), potT=full(Temp), Qa=full(Qa),
            uatm=full(uatm), vatm=full(vatm), wind=full(wind),
            swvdr=swvdr, swvdf=swvdf, swidr=swidr, swidf=swidf)


# ---------------------------------------------------------------------------
# ocean climatology + SST restoring
# ---------------------------------------------------------------------------


class OceanClimForcing(_FileDataset):
    """Monthly SSS/SST climatology with optional SST restoring
    (``init_forcing_ocn:228-446``, ``ocn_data_clim:3564+``).

    `sss.mm.*.da` / `sst.mm.*.da`: 12 monthly rda8 records.  SSS is
    restored instantaneously (interpolated each step); prognostic SST
    (oceanmixed_ice) is nudged toward the interpolated climatology with
    timescale `trestore` days (`trestore = 0`: instantaneous).
    """

    def __init__(self, cfg: Config, grid: Grid, dtype=jnp.float32):
        super().__init__(cfg, grid)
        self.grid = grid
        self.dtype = dtype
        fc = cfg.forcing
        d = fc.ocn_data_dir
        self.sss_path = self._find(d, "sss")
        self.sst_path = self._find(d, "sst")
        self.restore_sst = fc.restore_sst
        self.trest = (cfg.run.dt if fc.trestore == 0
                      else fc.trestore * 86400.0)
        self.linear_S = cfg.thermo.Tfrzpt == "linear_S"

    @staticmethod
    def _find(d, stem):
        if not d or not os.path.isdir(d):
            return None
        for name in sorted(os.listdir(d)):
            if name.startswith(stem + ".") or name.startswith(stem + "_"):
                return os.path.join(d, name)
        return None

    @property
    def available(self):
        return self.sss_path is not None

    def initial_fields(self, month: int):
        """Annual-mean SSS + current-month SST (init_forcing_ocn)."""
        sss = np.mean([self.reader.read(self.sss_path, k)
                       for k in range(1, 13)], axis=0)
        sss = np.maximum(sss, 0.0)
        Tf = -cn.depressT * sss if self.linear_S \
            else np.full_like(sss, cn.Tocnfrz)
        sst = None
        if self.sst_path:
            sst = np.maximum(self.reader.read(self.sst_path, month), Tf)
        return (jnp.asarray(sss, self.dtype), jnp.asarray(Tf, self.dtype),
                None if sst is None else jnp.asarray(sst, self.dtype))

    def interp_month(self, path, cal: Calendar):
        return self.read_monthly(path, cal, climatology=True)

    def sss_now(self, cal: Calendar):
        sss = np.maximum(self.interp_month(self.sss_path, cal), 0.0)
        return jnp.asarray(sss, self.dtype)

    def ocean_update(self, state, cal: Calendar, dt):
        """Per-step get_forcing_ocn: restore prognostic SST toward the
        interpolated climatology (``ocn_data_clim`` restore section)."""
        if not (self.restore_sst and self.sst_path):
            return state
        sstdat = jnp.asarray(self.interp_month(self.sst_path, cal),
                             self.dtype)
        sst = state.sst + (sstdat - state.sst) * (dt / self.trest)
        return state.replace(sst=sst)


# ---------------------------------------------------------------------------
# provider factory
# ---------------------------------------------------------------------------


_ATM_DATASETS = {
    "ncar": NcarBulkForcing,
    "LYq": LYqForcing,
    "monthly": MonthlyForcing,
    "ecmwf": EcmwfForcing,
    "hadgem": HadgemForcing,
    "rct": RctForcing,
    "bin": NcarBulkForcing,
}


def make_forcing_provider(cfg: Config, grid: Grid, dtype=jnp.float32):
    kind = cfg.forcing.atm_data_type
    cls = _ATM_DATASETS.get(kind)
    atm = cls(cfg, grid, dtype) if cls else AnalyticForcing(cfg, grid,
                                                            dtype)
    if cfg.forcing.sss_data_type == "clim" \
            or cfg.forcing.sst_data_type == "clim":
        ocn = OceanClimForcing(cfg, grid, dtype)
        if ocn.available:
            return CombinedProvider(atm, ocn, cfg)
    return atm


class CombinedProvider:
    """Atmosphere dataset + ocean climatology, one provider object."""

    def __init__(self, atm, ocn: OceanClimForcing, cfg: Config):
        self.atm = atm
        self.ocn = ocn
        self.cfg = cfg
        self.available = getattr(atm, "available", True)

    def __call__(self, yday, sec, cal=None, state=None) -> Forcing:
        f = self.atm(yday, sec, cal=cal, state=state)
        if cal is not None and self.ocn.available:
            f = f.replace(sss=self.ocn.sss_now(cal))
        return f

    def ocean_update(self, state, cal, dt):
        return self.ocn.ocean_update(state, cal, dt)
