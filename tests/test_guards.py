"""In-graph abort-with-coordinates guards (``guards.py``; reference
`abort_ice` + `istop/jstop` threading, ``mpi/ice_exit.F90:41-82``).

Violations are packed into (count, j, i, worst) records inside the
jitted step; the driver raises on the host — no callbacks, so the
mechanism works on every backend."""

import jax
import jax.numpy as jnp
import pytest

from cice4_tpu.guards import (ConservationError, check_column_conservation,
                              check_ridge, check_vthermo, record,
                              raise_on_violation)


def test_record_reports_coordinates():
    bad = jnp.zeros((6, 8), bool).at[3, 5].set(True)
    err = jnp.zeros((6, 8)).at[3, 5].set(42.0)
    rec = jax.jit(record)(bad, err)
    with pytest.raises(ConservationError) as ei:
        raise_on_violation({"test invariant": rec})
    msg = str(ei.value)
    assert "j=3" in msg and "i=5" in msg and "test invariant" in msg
    assert "4.2" in msg


def test_no_raise_when_clean():
    rec = jax.jit(record)(jnp.zeros((6, 8), bool), jnp.zeros((6, 8)))
    raise_on_violation({"test invariant": rec})  # must not raise


def test_record_reduces_category_axis():
    bad = jnp.zeros((3, 4, 5), bool).at[2, 1, 3].set(True)
    rec = jax.jit(record)(bad)
    with pytest.raises(ConservationError) as ei:
        raise_on_violation({"cat invariant": rec})
    assert "j=1" in str(ei.value) and "i=3" in str(ei.value)


def test_column_conservation_triggers():
    before = jnp.ones((4, 4), jnp.float64)
    after = before.at[2, 2].set(1.5)
    tmask = jnp.ones((4, 4), bool)
    rec = jax.jit(check_column_conservation)(before, after, tmask)
    with pytest.raises(ConservationError) as ei:
        raise_on_violation({"column conservation: vice": rec})
    assert "j=2" in str(ei.value)


def test_vthermo_clean_passes():
    shape = (2, 4, 4)
    z = jnp.zeros(shape, jnp.float64)
    # einp == efinal - einit == 0 everywhere: conserved
    rec = check_vthermo(3600.0, z, z, z, z, z[:, :1], z, z,
                        jnp.ones(shape, bool))
    raise_on_violation({"thermo": rec})


def test_vthermo_violation_triggers():
    shape = (2, 4, 4)
    z = jnp.zeros(shape, jnp.float64)
    efinal = z.at[1, 2, 3].set(1.0e6)  # 1 MJ appears from nowhere
    rec = check_vthermo(3600.0, z, z, z, z, z[:, :1], z, efinal,
                        jnp.ones(shape, bool))
    with pytest.raises(ConservationError) as ei:
        raise_on_violation({"thermo energy": rec})
    assert "j=2" in str(ei.value) and "i=3" in str(ei.value)


def test_ridge_check_triggers():
    asum = jnp.ones((4, 4), jnp.float64).at[1, 2].set(1.1)
    tmask = jnp.ones((4, 4), bool)
    rec = jax.jit(check_ridge)(asum, tmask, jnp.asarray(False))
    with pytest.raises(ConservationError) as ei:
        raise_on_violation({"ridging: area sum != 1": rec})
    assert "ridging" in str(ei.value)


def test_full_step_with_guards_runs():
    """The default-config step (guards on) must run clean and carry
    the guard records in its flux dict."""
    from cice4_tpu.config import (Config, DomainConfig, DynamicsConfig,
                                  GridConfig)
    from cice4_tpu.grid import make_grid
    from cice4_tpu.io.forcing_data import AnalyticForcing
    from cice4_tpu.model import Model, ice_step
    from cice4_tpu.state import init_state

    cfg = Config(domain=DomainConfig(nx_global=24, ny_global=20),
                 grid=GridConfig(grid_type="rectangular",
                                 lat_origin=71.35),
                 dynamics=DynamicsConfig(ndte=20))
    assert cfg.run.guards
    grid = make_grid(cfg, dtype=jnp.float64)
    model = Model.create(cfg)
    state = init_state(cfg, grid, model.itd, dtype=jnp.float64)
    f = AnalyticForcing(cfg, grid, jnp.float64)(40.0, 0.0)
    state, fluxes = jax.jit(
        lambda s: ice_step(model, s, grid, f, 40.0, 0.0))(state)
    jax.block_until_ready(state.aicen)
    guards = fluxes["_guards"]
    assert len(guards) == 3   # vthermo + linear_itd column + ridge
    raise_on_violation(guards)   # clean run: must not raise
