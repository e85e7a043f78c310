"""Vertical thermodynamics tests: convergence + the reference's own
energy-conservation identity (``conservation_check_vthermo``:
efinal - einit = (fsurf - flat + fswint - fhocn - fsnow*Lfresh) * dt).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cice4_tpu import constants as cn
from cice4_tpu.config import gx3_config
from cice4_tpu.ops import therm_vertical as tv
from cice4_tpu.state import make_itd_params


@pytest.fixture(scope="module")
def tp():
    cfg = gx3_config()
    itd = make_itd_params(cfg)
    return tv.make_thermo_params(cfg, itd), itd


def _column_inputs(tp_itd, ny=8, nx=8, Tair=250.0, hice=2.0, hsno=0.2,
                   aice=0.9, fsw=0.0, Tsf0=-20.0):
    p, itd = tp_itd
    sh = (ny, nx)
    f = lambda v: jnp.full(sh, v, jnp.float64)
    aicen = f(aice)
    vicen = aicen * hice
    vsnon = aicen * hsno
    tsfcn = f(Tsf0)
    # enthalpy from a linear temperature profile Tsf0 .. Tf
    Tf = -cn.depressT * 34.0
    k = jnp.arange(1, p.nilyr + 1, dtype=jnp.float64)[:, None, None]
    Ti = Tsf0 + (Tf - Tsf0) * (k - 0.5) / p.nilyr
    tmlt = jnp.asarray(p.tmlt)[:p.nilyr, None, None]
    qin = tv.qin_of_tin(p, Ti, tmlt)
    eicen = qin * vicen[None] / p.nilyr
    Tsn0 = jnp.minimum(Tsf0, 0.0)
    esnon = jnp.broadcast_to(tv.qsn_of_tsn(f(Tsn0)) * vsnon / p.nslyr,
                             (p.nslyr, ny, nx))
    forcing = dict(
        flw=f(180.0), potT=f(Tair), Qa=f(0.0005), rhoa=f(1.3),
        fsnow=f(0.0), fbot=f(0.0), Tbot=f(Tf), Tf=f(Tf),
        lhcoef=f(10.0), shcoef=f(15.0),
        fswsfc=f(fsw * 0.7), fswint=f(fsw * 0.2), fswthrun=f(fsw * 0.1),
        Sswabs=jnp.zeros((p.nslyr, ny, nx), jnp.float64),
        Iswabs=jnp.broadcast_to(f(fsw * 0.2 / p.nilyr),
                                (p.nilyr, ny, nx)),
    )
    return dict(aicen=aicen, vicen=vicen, vsnon=vsnon, tsfcn=tsfcn,
                eicen=eicen, esnon=esnon), forcing


def _run(p, stv, forcing, dt=3600.0):
    fn = jax.jit(lambda s, fo: tv.thermo_vertical_category(
        p, dt, s["aicen"], s["vicen"], s["vsnon"], s["tsfcn"],
        s["eicen"], s["esnon"], fo["flw"], fo["potT"], fo["Qa"],
        fo["rhoa"], fo["fsnow"], fo["fbot"], fo["Tbot"], fo["Tf"],
        fo["lhcoef"], fo["shcoef"], fo["fswsfc"], fo["fswint"],
        fo["fswthrun"], fo["Sswabs"], fo["Iswabs"]))
    return fn(stv, forcing)


def test_cold_growth(tp):
    """Cold air over warm ocean: ice cools, conserves energy."""
    p, itd = tp
    stv, fo = _column_inputs(tp, Tair=245.0)
    out, flux = _run(p, stv, fo)
    assert int(flux["niter"]) < tv.nitermax
    # surface cools below initial
    assert float(jnp.mean(out["tsfcn"])) < -15.0
    # energy conservation identity (per unit ice area)
    dt = 3600.0
    einp = (flux["fsurfn"] - flux["flatn"] + 0.2 * 0.0
            - flux["fhocnn"]) * dt  # fswint = 0, fsnow = 0
    err = np.asarray(jnp.abs(flux["efinal"] - flux["einit"] - einp)) / dt
    assert err.max() < 1.1 * tv.ferrmax


def test_melt_warm(tp):
    """Warm air + strong sun: surface hits melting, top melt occurs."""
    p, itd = tp
    stv, fo = _column_inputs(tp, Tair=278.0, Tsf0=-1.0, fsw=300.0)
    fo["flw"] = jnp.full_like(fo["flw"], 320.0)
    out, flux = _run(p, stv, fo)
    dt = 3600.0
    einp = (flux["fsurfn"] - flux["flatn"] + fo["fswint"]
            - flux["fhocnn"]) * dt
    err = np.asarray(jnp.abs(flux["efinal"] - flux["einit"] - einp)) / dt
    assert err.max() < 1.1 * tv.ferrmax
    # some melt happened (top or snow)
    total_melt = np.asarray(flux["meltt"] + flux["melts"]).mean()
    assert total_melt > 0.0
    # thickness decreased
    assert float(jnp.mean(out["vicen"])) <= float(jnp.mean(stv["vicen"]))


def test_bottom_growth_cold_ocean(tp):
    """Strongly cold conductive flux with no ocean heat: congelation."""
    p, itd = tp
    stv, fo = _column_inputs(tp, Tair=240.0, hice=0.5, hsno=0.0)
    out, flux = _run(p, stv, fo)
    assert np.asarray(flux["congel"]).min() >= 0.0
    assert np.asarray(flux["congel"]).mean() > 0.0
    assert float(jnp.mean(out["vicen"])) > float(jnp.mean(stv["vicen"]))


def test_no_ice_no_change(tp):
    p, itd = tp
    stv, fo = _column_inputs(tp, aice=0.0)
    out, flux = _run(p, stv, fo)
    for k in ["fsensn", "flatn", "fhocnn", "meltt", "congel"]:
        assert np.allclose(np.asarray(flux[k]), 0.0)
    assert np.allclose(np.asarray(out["vicen"]), np.asarray(stv["vicen"]))


def test_snowfall_added(tp):
    p, itd = tp
    stv, fo = _column_inputs(tp, Tair=250.0)
    fo["fsnow"] = jnp.full_like(fo["fsnow"], 1.0e-4)  # kg/m^2/s
    out, flux = _run(p, stv, fo)
    dt = 3600.0
    dhs_expect = 1.0e-4 / cn.rhos * dt
    hsn_before = 0.2
    hsn_after = np.asarray(out["vsnon"] / jnp.maximum(out["aicen"], 1e-30))
    assert hsn_after.mean() > hsn_before + 0.5 * dhs_expect
    # conservation incl. snowfall enthalpy
    einp = (flux["fsurfn"] - flux["flatn"] - flux["fhocnn"]
            - fo["fsnow"] * cn.Lfresh) * dt
    err = np.asarray(jnp.abs(flux["efinal"] - flux["einit"] - einp)) / dt
    assert err.max() < 1.1 * tv.ferrmax


def test_know_tsfc_matches_calc_tsfc(tp):
    """Prescribing the converged calc_Tsfc=T surface fluxes to the
    calc_Tsfc=F solve (know_Tsfc boundary condition) must reproduce
    the same internal temperatures — the two matrix assemblies agree
    when given a consistent top boundary condition."""
    import dataclasses
    p, itd = tp
    stv, fo = _column_inputs(tp, Tair=245.0)
    out_t, flux_t = _run(p, stv, fo)

    pf = dataclasses.replace(p, calc_Tsfc=False)
    dt = 3600.0
    fn = jax.jit(lambda s, fo2, fs, fc, fl: tv.thermo_vertical_category(
        pf, dt, s["aicen"], s["vicen"], s["vsnon"], s["tsfcn"],
        s["eicen"], s["esnon"], fo2["flw"], fo2["potT"], fo2["Qa"],
        fo2["rhoa"], fo2["fsnow"], fo2["fbot"], fo2["Tbot"], fo2["Tf"],
        fo2["lhcoef"], fo2["shcoef"], fo2["fswsfc"], fo2["fswint"],
        fo2["fswthrun"], fo2["Sswabs"], fo2["Iswabs"],
        fsurfn_pre=fs, fcondtopn_pre=fc, flatn_pre=fl))
    out_f, flux_f = fn(stv, fo, flux_t["fsurfn"], flux_t["fcondtopn"],
                       flux_t["flatn"])
    # ice/snow state evolves the same way under the equivalent boundary
    # condition (tolerances loose: T-solve iterates on Tsf, F-solve
    # holds the flux fixed — identical only at exact convergence)
    np.testing.assert_allclose(np.asarray(out_f["vicen"]),
                               np.asarray(out_t["vicen"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out_f["eicen"]),
                               np.asarray(out_t["eicen"]),
                               rtol=2e-3)
    np.testing.assert_allclose(np.asarray(flux_f["fhocnn"]),
                               np.asarray(flux_t["fhocnn"]),
                               rtol=0, atol=0.5)
    # surface temperature is NOT solved in the prescribed mode
    np.testing.assert_allclose(np.asarray(out_f["tsfcn"]),
                               np.asarray(stv["tsfcn"]), atol=1e-12)


def test_explicit_calc_tsfc(tp):
    """Explicit surface scheme: cold air drives Tsf below freezing and
    the returned fluxes satisfy fsurfn ~= fcondtopn at the solution
    (the scheme solves fsurf - kh (Tsf - Tis) = 0 by one Newton step)."""
    p, itd = tp
    stv, fo = _column_inputs(tp, Tair=245.0)
    ex = jax.jit(lambda s: tv.explicit_calc_tsfc(
        p, 3600.0, s["aicen"], s["vicen"], s["vsnon"], s["tsfcn"],
        s["eicen"], s["esnon"], fo["rhoa"], fo["flw"], fo["potT"],
        fo["Qa"], fo["shcoef"], fo["lhcoef"], fo["fswsfc"]))(stv)
    Tsf = np.asarray(ex["Tsf"])
    assert (Tsf < 0.0).all() and (Tsf > -60.0).all()
    # Newton step lands close to the surface balance
    resid = np.asarray(jnp.abs(ex["fsurfn"] - ex["fcondtopn"]))
    assert resid.max() < 5.0  # W/m^2


def test_full_step_calc_tsfc_false():
    """Full model step in the ice-only calc_Tsfc=F mode stays finite
    and bounded (explicit surface scheme supplies the fluxes)."""
    from cice4_tpu.config import (Config, DomainConfig, DynamicsConfig,
                                  GridConfig, ThermoConfig,
                                  TransportConfig)
    from cice4_tpu.forcing import default_forcing
    from cice4_tpu.grid import make_grid
    from cice4_tpu.model import Model, ice_step
    from cice4_tpu.state import init_state

    cfg = Config(
        domain=DomainConfig(nx_global=16, ny_global=16),
        grid=GridConfig(grid_type="rectangular", lat_origin=66.0),
        dynamics=DynamicsConfig(ndte=10),
        transport=TransportConfig(advection="upwind"),
        thermo=ThermoConfig(calc_Tsfc=False),
    )
    grid = make_grid(cfg, dtype=jnp.float64)
    model = Model.create(cfg)
    state = init_state(cfg, grid, model.itd, dtype=jnp.float64)
    f = default_forcing(grid.ny, grid.nx, jnp.float64)
    s, fluxes = jax.jit(lambda s: ice_step(model, s, grid, f, 80.0, 0.0)
                        )(state)
    a = np.asarray(jnp.sum(s.aicen, 0))
    assert np.isfinite(np.asarray(s.vicen)).all()
    assert np.isfinite(a).all() and a.max() <= 1.0 + 1e-9
    assert np.isfinite(np.asarray(s.tsfcn)).all()


def _banded_columns(p, ny=64, nx=128):
    """Random f64 column inputs with ice in two row bands (rows < 12 and
    >= 52, 80% of cells) and an ice-free middle; the argument tuple of
    `temperature_changes`."""
    rng = np.random.RandomState(3)
    f64 = jnp.float64

    def f(lo, hi, shape=(ny, nx)):
        return jnp.asarray(rng.uniform(lo, hi, shape), f64)

    row = np.arange(ny)[:, None] * np.ones((1, nx))
    has_ice = jnp.asarray(((row < 12) | (row >= 52))
                          & (rng.rand(ny, nx) > 0.2))
    hilyr = jnp.where(has_ice, f(0.1, 0.8), 0.0)
    hslyr = jnp.where(has_ice, f(0.0, 0.3), 0.0)
    Tsf = jnp.where(has_ice, f(-30.0, -0.5), 0.0)
    Tf = -cn.depressT * 34.0
    k = jnp.arange(1, p.nilyr + 1, dtype=f64)[:, None, None]
    Ti = Tsf[None] + (Tf - Tsf[None]) * (k - 0.5) / p.nilyr
    tmlt = jnp.asarray(p.tmlt)[:p.nilyr, None, None]
    qin = tv.qin_of_tin(p, Ti, tmlt)
    Tsn = jnp.broadcast_to(jnp.minimum(Tsf, 0.0), (p.nslyr, ny, nx))
    qsn = tv.qsn_of_tsn(Tsn)
    fswsfc, fswint = f(0.0, 60.0), f(0.0, 30.0)
    return (p, 3600.0, has_ice, f(1.1, 1.4), f(150.0, 300.0),
            f(240.0, 275.0), f(1e-4, 4e-3), f(5.0, 25.0), f(2.0, 15.0),
            fswsfc, fswint, f(0.0, 10.0),
            jnp.zeros((p.nslyr, ny, nx), f64) + 1.0,
            jnp.broadcast_to(f(0.0, 5.0)[None], (p.nilyr, ny, nx)),
            hilyr, hslyr, qin, Ti, qsn, Tsn, Tsf,
            jnp.full((ny, nx), Tf, f64),
            jnp.sum(qsn * hslyr[None], 0) + jnp.sum(qin * hilyr[None], 0))


def test_temperature_solve_is_per_cell(tp):
    """Each cell's Newton solve depends on that cell alone: solving the
    whole grid (which iterates until the slowest cell converges) and
    solving one ice band on its own give every cell the same result
    and the same iteration count.  Any later solver that gates or
    compacts ice cells relies on this."""
    p, itd = tp
    ny = 64
    args = _banded_columns(p, ny)

    whole = tv.temperature_changes(*args)
    assert int(whole["niter"]) == int(np.max(np.asarray(whole["niter_cell"])))
    assert int(whole["niter"]) > 1

    def rows(x, lo, hi):
        if isinstance(x, jax.Array) and x.ndim >= 2 and x.shape[-2] == ny:
            return x[..., lo:hi, :]
        return x

    for lo, hi in ((0, 12), (52, 64)):
        band = tv.temperature_changes(*[rows(x, lo, hi) for x in args])
        for key in ("Tsf", "Tsn", "Tin", "qsn", "qin", "fsurfn",
                    "fcondtopn", "fcondbot", "fsensn", "flatn", "flwoutn",
                    "fswabsn", "fswsfc", "fswint", "Sswabs", "Iswabs",
                    "dq_flux"):
            np.testing.assert_allclose(np.asarray(band[key]),
                                       np.asarray(rows(whole[key], lo, hi)),
                                       rtol=1e-12, atol=1e-12, err_msg=key)
        for key in ("converged", "niter_cell"):
            np.testing.assert_array_equal(
                np.asarray(band[key]), np.asarray(rows(whole[key], lo, hi)))


@pytest.mark.parametrize("solver", ["zero_layer", "know_tsfc"])
def test_other_solvers_count_newton_iterations_per_cell(tp, solver):
    """The zero-layer and prescribed-flux (calc_Tsfc=F) solves report
    per-cell iteration counts like the main solve: none off the ice,
    and the global count is the slowest cell's."""
    p, itd = tp
    (_, dt, has_ice, rhoa, flw, potT, Qa, shcoef, lhcoef, fswsfc, fswint,
     fswthru, Sswabs, Iswabs, hilyr, hslyr, qin, Tin, qsn, Tsn, Tsf, Tbot,
     einit) = _banded_columns(p)
    if solver == "zero_layer":
        out = tv.zerolayer_temperature(p, dt, has_ice, rhoa, flw, potT, Qa,
                                       shcoef, lhcoef, fswsfc, fswthru,
                                       hilyr, hslyr, Tsf, Tbot)
    else:
        fcondtopn = jnp.where(has_ice, -20.0, 0.0)
        out = tv.temperature_changes_know_tsfc(
            p, dt, has_ice, fcondtopn, fswsfc, fswint, fswthru, Sswabs,
            Iswabs, hilyr, hslyr, qin, Tin, qsn, Tsn, Tbot, einit)
    nc = np.asarray(out["niter_cell"])
    assert nc.shape == has_ice.shape
    assert not nc[~np.asarray(has_ice)].any()
    assert int(out["niter"]) == int(nc.max()) >= 1
