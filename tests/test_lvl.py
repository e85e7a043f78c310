"""Level-ice tracers through ridging (``ice_lvl.F90`` +
``ice_mechred.F90 ridge_shift:1470-1482``).

Ridging converts level ice to ridged ice: the level tracers leave the
donor category proportionally to the ridged area fraction and are NOT
deposited into the receiving categories, so total level area/volume
can only decrease under convergence, and ridged ice (ardg = aice -
Σ aicen·alvl) appears exactly where ridging occurred.
"""

import jax.numpy as jnp
import numpy as np

from cice4_tpu.config import Config, DomainConfig, DynamicsConfig, \
    GridConfig, TracerConfig, TransportConfig
from cice4_tpu.grid import make_grid
from cice4_tpu.model import Model
from cice4_tpu.ops import mechred
from cice4_tpu.state import init_state


def _setup():
    cfg = Config(
        domain=DomainConfig(nx_global=16, ny_global=16,
                            ew_boundary_type="cyclic",
                            ns_boundary_type="closed"),
        grid=GridConfig(grid_type="rectangular", lat_origin=70.0),
        dynamics=DynamicsConfig(ndte=10),
        transport=TransportConfig(advection="none"),
        tracers=TracerConfig(tr_iage=True, tr_lvl=True),
    )
    grid = make_grid(cfg, dtype=jnp.float64)
    model = Model.create(cfg)
    state = init_state(cfg, grid, model.itd, dtype=jnp.float64)
    return cfg, grid, model, state


def test_level_ice_ridges_away():
    cfg, grid, model, state = _setup()
    assert "alvl" in state.trcrn and "vlvl" in state.trcrn
    # initial ice is all level
    np.testing.assert_allclose(
        np.asarray(state.trcrn["alvl"])[np.asarray(state.aicen) > 0], 1.0)

    lvl_area0 = float(jnp.sum(state.aicen * state.trcrn["alvl"]))
    lvl_vol0 = float(jnp.sum(state.vicen * state.trcrn["vlvl"]))
    assert lvl_area0 > 0.0

    # strong uniform convergence everywhere with ice
    conv = jnp.where(grid.tmask, 1.0e-6, 0.0)  # 1/s, strong
    shear = jnp.zeros_like(conv)
    new_state, diag = mechred.ridge_ice(state, model.itd, cfg.dynamics,
                                        3600.0, conv, shear, grid.tmask)

    aice0 = np.asarray(jnp.sum(state.aicen, 0))
    aice1 = np.asarray(jnp.sum(new_state.aicen, 0))
    ridged = aice0 - aice1 > 1e-10     # cells where area was consumed

    alvl1 = np.asarray(new_state.trcrn["alvl"])
    a1 = np.asarray(new_state.aicen)
    lvl_area1 = float(np.sum(a1 * alvl1))
    lvl_vol1 = float(np.sum(np.asarray(new_state.vicen)
                            * np.asarray(new_state.trcrn["vlvl"])))

    # level ice decreased where ridging happened; never increased
    assert lvl_area1 < lvl_area0
    assert lvl_vol1 < lvl_vol0
    assert ridged.any()

    # tracer stays a fraction
    assert np.all(alvl1 <= 1.0 + 1e-9)
    assert np.all(alvl1 >= -1e-12)

    # ridged ice appeared exactly where area was consumed
    ardg = np.maximum(np.sum(a1 * (1.0 - alvl1), 0), 0.0)
    assert (ardg[np.asarray(grid.tmask) & ridged] > 1e-10).all()
    # cells that did not ridge remain all-level
    unridged = np.asarray(grid.tmask) & (aice0 > 0) & ~ridged
    if unridged.any():
        assert np.allclose(ardg[unridged], 0.0, atol=1e-9)


def test_level_tracers_ride_transport():
    """alvl/vlvl advect with the state (remap path, lvl enabled)."""
    from cice4_tpu.ops.remap import transport_remap
    cfg, grid, model, state = _setup()
    x = jnp.arange(grid.nx)[None, :] / grid.nx
    state = state.replace(
        uvel=0.2 * jnp.sin(6.283 * x) * jnp.ones((grid.ny, 1))
        * grid.umask)
    s1, _ = transport_remap(state, grid, 3600.0)
    # conserved: total level area unchanged by pure transport
    b = float(jnp.sum(state.aicen * state.trcrn["alvl"] * grid.tarea))
    a = float(jnp.sum(s1.aicen * s1.trcrn["alvl"] * grid.tarea))
    assert abs(a - b) < 1e-6 * max(b, 1.0)
    assert np.all(np.asarray(s1.trcrn["alvl"]) <= 1.0 + 1e-9)
